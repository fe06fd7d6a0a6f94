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
    """The (K, C) corners of the per-CTA slots; with no more slots than
    chunks each chunk holds one slot, so the sum runs s = 0, 1, ..."""
    rs = np.random.RandomState(2)
    part = torch.from_numpy(
        rs.randn(2, 5, mb.SLOT, mb.SLOT).astype(np.float32))
    got = mb.xhat_reduce(part, 4, 3)
    want = part[:, 0, :4, :3]
    for s in range(1, 5):
        want = want + part[:, s, :4, :3]
    assert got.shape == (2, 4, 3) and torch.equal(got, want)
    assert mb.LAUNCHES["xhat_reduce"] == 0


@pytest.mark.parametrize("S", [132, 16, 37])
def test_xhat_reduce_reference_follows_documented_order(S):
    """The plain version (the CPU route of xhat_reduce) is bit-equal to a
    numpy loop in the documented order: XR_CHUNKS chunks of
    ceil(S / XR_CHUNKS) consecutive slots, each summed from +0 in ascending
    s, then the chunk sums added from +0 in chunk order. Past XR_CHUNKS
    slots that order differs from one pass over s."""
    rs = np.random.RandomState(S)
    B, K, C = 2, 24, 10
    part = rs.randn(B, S, mb.SLOT, mb.SLOT).astype(np.float32)
    L = -(-S // mb.XR_CHUNKS)
    want = np.zeros((B, K, C), np.float32)
    for g in range(mb.XR_CHUNKS):
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
    assert np.array_equal(one_pass, want) == (S <= mb.XR_CHUNKS)


@pytest.mark.parametrize("shape,padded", [((384, 128), (384, 128)),
                                          ((24, 8), (24, 16)),
                                          ((20, 10), (24, 16))])
def test_weight_layout_pads_with_zeros(shape, padded):
    """The kernel reads its weights in 8-row, 16-column fragments: widths
    that are not multiples get a zero-padded copy, others pass as they are."""
    # a copy in torch's own storage, which is 64-byte aligned (numpy's
    # need not be 32-byte aligned)
    W = torch.tensor(np.random.RandomState(3).randn(*shape)
                     .astype(np.float32))
    assert W.data_ptr() % 32 == 0
    got = mb._weight_layout(W)
    assert tuple(got.shape) == padded
    assert (got is W) == (shape == padded)
    assert torch.equal(got[:shape[0], :shape[1]], W)
    assert not got[shape[0]:].any() and not got[:, shape[1]:].any()


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
