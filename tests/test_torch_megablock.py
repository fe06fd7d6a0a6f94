"""Kernel B1 (the chained whole-block forward): the port's plain PyTorch
version against the JAX package's Pallas kernel in interpret mode. The
hand-written CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.ops.pallas_megablock import (
    megablock_chained as jax_megablock_chained)
from diffusionnet_tpu_torch.ops import megablock as mb
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

TILE_V = 256


def _inputs(seed, B=2, V=512, K=16, C=8, hidden=(8, 8)):
    """numpy inputs of one block; the last 40 rows are padding (mass 0,
    zero operator rows), as a bucket-padded mesh has them."""
    rs = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)
    x = r(B, V, C)
    evecs, gX, gY = (r(B, V, K, scale=1 / np.sqrt(V)) for _ in range(3))
    mass = rs.rand(B, V).astype(np.float32)
    for a in (evecs, gX, gY, mass):
        a[:, V - 40:] = 0
    coefs = rs.rand(B, K, C).astype(np.float32)
    A_re, A_im = r(C, C, scale=0.3), r(C, C, scale=0.3)
    widths = (3 * C,) + tuple(hidden) + (C,)
    Ws = [r(widths[i], widths[i + 1], scale=0.3)
          for i in range(len(widths) - 1)]
    bs = [r(widths[i + 1], scale=0.1) for i in range(len(widths) - 1)]
    x_hat = np.einsum("bvk,bvc->bkc", evecs, x * mass[..., None])
    return dict(x=x, evecs=evecs, gX=gX, gY=gY, mass=mass, coefs=coefs,
                A_re=A_re, A_im=A_im, Ws=Ws, bs=bs, x_hat=x_hat)


def _run_jax(a, emit_next, lowp):
    dt = jnp.bfloat16 if lowp else jnp.float32
    out, xn = jax_megablock_chained(
        jnp.asarray(a["x"], dt), jnp.asarray(a["evecs"], dt),
        jnp.asarray(a["gX"], dt), jnp.asarray(a["gY"], dt),
        jnp.asarray(a["mass"]), jnp.asarray(a["coefs"]),
        jnp.asarray(a["A_re"]), jnp.asarray(a["A_im"]),
        tuple(map(jnp.asarray, a["Ws"])), tuple(map(jnp.asarray, a["bs"])),
        jnp.zeros((), jnp.int32), jnp.asarray(a["x_hat"]), TILE_V, False,
        emit_next, True)
    return (np.asarray(out.astype(jnp.float32)),
            None if xn is None else np.asarray(xn))


def _torch_args(a, lowp):
    dt = torch.bfloat16 if lowp else torch.float32

    def t(v, dtype=torch.float32):
        return torch.from_numpy(v).to(dtype)
    return (t(a["x"], dt), t(a["evecs"], dt), t(a["gX"], dt), t(a["gY"], dt),
            t(a["mass"]), t(a["coefs"]), t(a["A_re"]), t(a["A_im"]),
            [t(W) for W in a["Ws"]], [t(b) for b in a["bs"]], t(a["x_hat"]))


# f32: the JAX kernel test's own bound (tests/test_pallas_megablock.py).
# lowp: both sides round the same operands to bf16, but an f32 sum taken in
# another order can round an intermediate (gx, gy, a hidden activation) to
# the neighbouring bf16 value, a relative step of 2^-8; `out` is itself
# stored in bf16 (another 2^-8). 3e-2 covers a few such steps at |out| ~ 5.
TOL = {False: dict(rtol=1e-4, atol=1e-5), True: dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("emit_next", [True, False])
def test_plain_b1_matches_jax_kernel(emit_next, lowp):
    """B=2, V=512, K=16, C=8, tile 256 against the Pallas kernel run in
    interpret mode; out and x_hat_next."""
    a = _inputs(0)
    want, want_xn = _run_jax(a, emit_next, lowp)
    out, xn = mb.megablock_chained(*_torch_args(a, lowp), emit_next=emit_next,
                                   lowp=lowp)
    assert out.dtype == (torch.bfloat16 if lowp else torch.float32)
    np.testing.assert_allclose(out.float().numpy(), want, **TOL[lowp])
    if emit_next:
        assert xn.dtype == torch.float32 and xn.shape == (2, 16, 8)
        np.testing.assert_allclose(xn.numpy(), want_xn, **TOL[lowp])
    else:
        assert xn is None


def test_plain_b1_general_mlp_depth():
    """Three hidden layers of unequal width (16, 32, 8)."""
    a = _inputs(1, B=1, V=512, K=8, C=8, hidden=(16, 32, 8))
    want, want_xn = _run_jax(a, True, False)
    out, xn = mb.megablock_chained(*_torch_args(a, False), emit_next=True)
    np.testing.assert_allclose(out.numpy(), want, **TOL[False])
    np.testing.assert_allclose(xn.numpy(), want_xn, **TOL[False])


def test_xhat_reduce_plain_sums_partials_in_order():
    """The (K, C) corners of the per-CTA slots; at S <= 8 slots there is
    one chunk, so the sum runs s = 0, 1, ..."""
    rs = np.random.RandomState(2)
    part = torch.from_numpy(
        rs.randn(2, 5, mb.SLOT, mb.SLOT).astype(np.float32))
    got = mb.xhat_reduce(part, 4, 3)
    want = part[:, 0, :4, :3]
    for s in range(1, 5):
        want = want + part[:, s, :4, :3]
    assert got.shape == (2, 4, 3) and torch.equal(got, want)
    assert mb.LAUNCHES["xhat_reduce"] == 0


@pytest.mark.parametrize("S", [132, 16, 37, 5])
def test_xhat_reduce_reference_follows_documented_order(S):
    """The plain version (the CPU route of xhat_reduce) is bit-equal to a
    numpy loop in the documented order: G = min(16, ceil(S / 8)) chunks of
    ceil(S / G) consecutive slots, each summed from +0 in ascending s, then
    the chunk sums added from +0 in chunk order. With more than one chunk
    that order differs from one pass over s."""
    rs = np.random.RandomState(S)
    B, K, C = 2, 24, 10
    part = rs.randn(B, S, mb.SLOT, mb.SLOT).astype(np.float32)
    G = min(16, -(-S // 8))
    assert mb.xhat_chunks(S) == G
    L = -(-S // G)
    want = np.zeros((B, K, C), np.float32)
    for g in range(G):
        acc = np.zeros((B, K, C), np.float32)
        for s in range(g * L, min(S, (g + 1) * L)):
            acc = acc + part[:, s, :K, :C]
        want = want + acc
    mb.reset_launches()
    got = mb.xhat_reduce(torch.from_numpy(part), K, C)
    assert mb.LAUNCHES["xhat_reduce"] == 0
    assert got.shape == (B, K, C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    one_pass = np.zeros((B, K, C), np.float32)
    for s in range(S):
        one_pass = one_pass + part[:, s, :K, :C]
    assert np.array_equal(one_pass, want) == (G == 1)


@pytest.mark.parametrize("S,G", [(1, 1), (8, 1), (9, 2), (16, 2), (32, 4),
                                 (128, 16), (132, 16)])
def test_xhat_chunks_follow_the_slot_count(S, G):
    """The partial sum's chunk count grows with S, 8 slots a chunk, up to
    16: B1's split-V grid gives S = 16 at B = 8 and 128 at B = 1."""
    assert mb.xhat_chunks(S) == G


@pytest.mark.parametrize("B,V,K,C,n_sm", [(8, 20480, 128, 128, 132),
                                          (1, 32768, 128, 128, 132),
                                          (2, 1000, 16, 8, 4),
                                          (1, 64, 256, 256, 132),
                                          (3, 33, 200, 136, 7)])
def test_xhat_splits_cover_every_row(B, V, K, C, n_sm):
    """The x_hat kernel's V ranges: L a multiple of 32, S L >= V with no
    empty split, and about one CTA per SM over (batch, piece, split)."""
    S, L = mb.xhat_splits(B, V, K, C, n_sm)
    assert L % 32 == 0 and S * L >= V and (S - 1) * L < V
    pieces = B * -(-K // mb.SLOT) * -(-C // mb.SLOT)
    assert S == 1 or pieces * S <= 2 * n_sm


@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_sm", [1, 4, 132], ids=["S1", "S4", "S16"])
def test_plain_xhat_split_matches_jax_kernel(n_sm, lowp):
    """x_hat_next as the card computes it: the split-V kernel's plain
    version (partials over ranges of V, from the f32 out and the mass) and
    its finish (`reduce_pieces`, the fixed-order sum) against the Pallas
    kernel's x_hat_next in interpret mode."""
    a = _inputs(4)
    want, want_xn = _run_jax(a, True, lowp)
    args = _torch_args(a, lowp)
    f = mb._forward_parts(*args, lowp, None, TILE_V)
    splits = mb.xhat_splits(2, 512, 16, 8, n_sm)
    part = mb.megablock_fwd_xhat(args[1], f["out"], args[4], splits, lowp)
    assert part.shape == (2, 1, 1, splits[0], mb.SLOT, mb.SLOT)
    assert not part[..., 16:, :].any() and not part[..., 8:].any()
    xn = mb.reduce_pieces(part, 2, 16, 8)
    np.testing.assert_allclose(xn.numpy(), want_xn, **TOL[lowp])
    # m (.) out given whole (a bf16 x's route) gives the same partials
    same = mb.megablock_fwd_xhat(args[1], f["out"] * args[4][..., None],
                                 None, splits, lowp)
    assert torch.equal(same, part)
    assert mb.LAUNCHES["megablock_fwd_xhat"] == 0


@pytest.mark.parametrize("lowp", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("C,hidden", [(8, (16, 32, 8)), (40, (13,)),
                                      (32, (32, 32))])
def test_fwd_b_operands_gather_equals_b_tiles(C, hidden, lowp):
    """The one gather that tiles B1's row-kernel operands gives, operand by
    operand, what `b_tiles` gives (and so what wgmma reads back): s^T per
    batch element; cmap^T with its rows re_c, im_c interleaved and its
    contraction over [gx | gy] with each C-wide segment padded to a
    multiple of 32 by zero columns; W_0^T over [x | xd | feat] padded the
    same way; W_l^T for the other layers."""
    a = _inputs(6, K=19, C=C, hidden=hidden)
    args = _torch_args(a, False)
    x_hat, coefs, A_re, A_im, Ws = args[10], args[5], args[6], args[7], args[8]
    tiles, ptr = mb._fwd_b_operands(coefs, x_hat, A_re, A_im, Ws, lowp)
    c32 = -(-C // 32) * 32

    def segments(bt, nseg):  # (N, nseg C) -> (N, nseg c32), zero columns
        out = bt.new_zeros((bt.shape[0], nseg * c32))
        for g in range(nseg):
            out[:, g * c32:g * c32 + C] = bt[:, g * C:(g + 1) * C]
        return out
    cmap = mb.cmap_of(A_re, A_im)
    il = torch.stack((torch.arange(C), torch.arange(C) + C), 1).reshape(-1)
    want = [mb.b_tiles((coefs * x_hat).transpose(1, 2), lowp),
            mb.b_tiles(segments(cmap.transpose(0, 1)[il], 2), lowp),
            mb.b_tiles(segments(Ws[0].transpose(0, 1), 3), lowp)]
    want += [mb.b_tiles(W.transpose(0, 1), lowp) for W in Ws[1:]]
    assert mb.segment_map(C, 2)[C:c32] == [-1] * (c32 - C)
    assert len(ptr) == len(want)
    base, size = tiles.data_ptr(), tiles.element_size()
    flat = tiles.reshape(-1)
    ends = []
    for i, (p, w) in enumerate(zip(ptr, want)):
        o = (p - base) // size
        assert torch.equal(flat[o:o + w.numel()], w.reshape(-1)), i
        ends.append(o + w.numel())
    assert ends[-1] == flat.numel()


@pytest.mark.parametrize("C,hidden", [(8, (16,)), (12, (12,)),
                                      (100, (100, 100))])
def test_pad_block_pads_with_zeros(C, hidden):
    """The kernels take C % 8 == 0: pad_block gives x, coefs, the complex
    map, W_0's three segments, the last layer and the per-channel tensors
    zero channels up to round8(C) (the inputs themselves where C % 8 == 0),
    the hidden layers keep their widths, and unpad_grads takes the padded
    parameters back to the model's shapes, values unmoved."""
    rs = np.random.RandomState(C)
    B, K, C8 = 2, 16, -(-C // 8) * 8

    def r(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))
    widths = (3 * C, *hidden, C)
    Ws = [r(widths[i], widths[i + 1]) for i in range(len(widths) - 1)]
    bs = [r(w) for w in widths[1:]]
    args = (r(B, 32, C), r(B, K, C), r(C, C), r(C, C), Ws, bs, r(B, K, C),
            None)
    x, coefs, A_re, A_im, pWs, pbs, xh, none = mb.pad_block(*args)
    assert none is None
    if C8 == C:
        for a, b in zip((x, coefs, A_re, A_im, *pWs, *pbs, xh),
                        (*args[:4], *Ws, *bs, args[6])):
            assert a is b
    for got, want in ((x, args[0]), (coefs, args[1]), (xh, args[6])):
        assert got.shape[-1] == C8 and torch.equal(got[..., :C], want)
        assert not got[..., C:].any()
    for got, want in ((A_re, args[2]), (A_im, args[3])):
        assert got.shape == (C8, C8) and torch.equal(got[:C, :C], want)
        assert not got[C:].any() and not got[:, C:].any()
    assert [tuple(W.shape) for W in pWs] == [
        (3 * C8, *hidden, C8)[i:i + 2] for i in range(len(widths) - 1)]
    seg = pWs[0].view(3, C8, -1)
    assert torch.equal(seg[:, :C], Ws[0].view(3, C, -1))
    assert not seg[:, C:].any()
    assert torch.equal(pWs[-1][:, :C], Ws[-1]) and not pWs[-1][:, C:].any()
    assert torch.equal(pbs[-1][:C], bs[-1]) and not pbs[-1][C:].any()
    ds, dA_re, dA_im, dWs, dbs = mb.unpad_grads(C, coefs, A_re, A_im, pWs,
                                                pbs)
    assert torch.equal(ds, args[1]) and torch.equal(dA_re, args[2])
    assert torch.equal(dA_im, args[3])
    for got, want in zip(dWs + dbs, Ws + bs):
        assert torch.equal(got, want)


def test_megablock_apply_xhat_reduce_hook_and_refusals():
    """megablock_apply equals the eager model; its xhat_reduce hook sees
    every block's x_hat (the block-0 projection and each emitted one);
    dropout in training mode runs on both paths (and changes the output),
    and dropout keys past the packing range are refused."""
    from diffusionnet_tpu_torch.models import (DiffusionNet, flat_params,
                                               megablock_apply)

    a = _inputs(4, B=1, V=64, K=8, C=8)
    model = DiffusionNet(c_in=8, c_out=3, c_width=8, n_block=3,
                         mlp_hidden_dims=(8, 8),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for blk in model.blocks:
            blk.diffusion.diffusion_time.uniform_(0.0, 0.05)
    ops = [torch.from_numpy(a[k]) for k in ("mass", "evecs", "gX", "gY")]
    mass, evecs, gX, gY = ops
    evals = torch.from_numpy(np.linspace(0.0, 20.0, 8, dtype=np.float32))[None]
    x = torch.from_numpy(a["x"])
    seen = []

    def hook(h):
        seen.append(h.shape)
        return h
    with torch.no_grad():
        got = megablock_apply(flat_params(model), x, mass, evals, evecs, gX,
                              gY, n_block=3, xhat_reduce=hook)
        want = model(x, mass, evals=evals, evecs=evecs, gradX=gX, gradY=gY)
    assert seen == [(1, 8, 8)] * 3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    with torch.no_grad():
        fast = megablock_apply(flat_params(model), x, mass, evals, evecs, gX,
                               gY, n_block=3, tile_v=32,
                               dropout_rng=torch.Generator().manual_seed(0))
        eager = model(x, mass, evals=evals, evecs=evecs, gradX=gX, gradY=gY,
                      deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    for dropped in (fast, eager):
        assert torch.isfinite(dropped).all()
        assert (dropped - want).abs().max() > 1e-3
    with pytest.raises(ValueError, match="key packing out of range"):
        megablock_apply(flat_params(model), x.expand(2049, -1, -1), mass,
                        evals, evecs, gX, gY, n_block=3,
                        dropout_rng=torch.Generator())
