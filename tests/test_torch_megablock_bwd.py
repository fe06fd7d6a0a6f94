"""Kernels B1 (with dropout) and B2 (the block's backward): the port's plain
PyTorch versions and its autograd Function against the JAX package's Pallas
kernels in interpret mode, at small sizes. The hand-written CUDA kernels are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.ops.pallas_megablock import (
    interpret_dropout_mask, megablock_chained as jax_megablock_chained)
from diffusionnet_tpu_torch.ops import megablock as mb
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

TILE_V = 256


def _inputs(seed, B=2, V=512, K=16, C=8, hidden=(16, 8)):
    """numpy inputs of one block; the last 40 rows are padding (mass 0,
    zero operator rows)."""
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
    Ws = [r(widths[i], widths[i + 1], scale=0.4)
          for i in range(len(widths) - 1)]
    bs = [r(widths[i + 1], scale=0.1) for i in range(len(widths) - 1)]
    x_hat = np.einsum("bvk,bvc->bkc", evecs, x * mass[..., None])
    dout = r(B, V, C)
    dxn = r(B, K, C)
    return dict(x=x, evecs=evecs, gX=gX, gY=gY, mass=mass, coefs=coefs,
                A_re=A_re, A_im=A_im, Ws=Ws, bs=bs, x_hat=x_hat, dout=dout,
                dxn=dxn)


def _torch_args(a, lowp, dtype=torch.float32, grad=False):
    """The block's arguments; with grad, the differentiable ones (x, coefs,
    A_re, A_im, Ws, bs, x_hat) are leaves that require grad."""
    dt = torch.bfloat16 if lowp else dtype

    def t(v, d=dtype, leaf=True):
        return torch.from_numpy(v).to(d).requires_grad_(grad and leaf)
    return (t(a["x"], dt), t(a["evecs"], dt, False), t(a["gX"], dt, False),
            t(a["gY"], dt, False), t(a["mass"], leaf=False), t(a["coefs"]),
            t(a["A_re"]), t(a["A_im"]), [t(W) for W in a["Ws"]],
            [t(b) for b in a["bs"]], t(a["x_hat"]))


# (a) the dropout hash ------------------------------------------------------

@pytest.mark.parametrize("width", [8, 128, 384])
def test_keep_mask_equals_interpret_dropout_mask(width):
    """Bit for bit, at the corners of the key ranges: seeds up to 2^31 - 2,
    batch up to 2047, tile up to 65535, layer up to 15."""
    for seed, b, i, layer in [(0, 0, 0, 0), (2 ** 31 - 2, 2047, 65535, 15),
                              (123456789, 5, 300, 3), (1, 2046, 1, 14)]:
        want = np.asarray(interpret_dropout_mask((64, width), 0.5, seed, b, i,
                                                 layer))
        got = mb.keep_mask((64, width), seed, b, i, layer).numpy()
        np.testing.assert_array_equal(got, want)


def test_hash_bits_wraps_like_uint32():
    """The raw bits, over a counter range that sets the high bits of every
    intermediate, against the JAX hash computed in uint32."""
    from diffusionnet_tpu.ops.pallas_megablock import _hash_bits
    want = np.asarray(_hash_bits((512, 384), 2 ** 31 - 2, 2 ** 31 - 1))
    idx = torch.arange(512 * 384, dtype=torch.int64).view(512, 384)
    got = mb.hash_bits(idx, 2 ** 31 - 2, 2 ** 31 - 1).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32


def test_dropout_masks_tile_the_batch():
    """dropout_masks cuts V into tile_v-row tiles keyed on (b, tile)."""
    got = mb.dropout_masks(2, 3 * 64, 16, 77, 2, 64)
    for b in range(2):
        for i in range(3):
            want = np.asarray(interpret_dropout_mask((64, 16), 0.5, 77, b, i,
                                                     2))
            np.testing.assert_array_equal(
                got[b, i * 64:(i + 1) * 64].numpy(), want)
    with pytest.raises(ValueError, match="multiple of tile_v"):
        mb.dropout_masks(1, 100, 16, 77, 0, 64)


# (b) the plain forward with dropout ----------------------------------------

# f32: the JAX kernel test's own bound (tests/test_pallas_megablock.py).
# bf16: both round the same operands to bf16, but an f32 sum taken in
# another order can round an intermediate to the neighbouring bf16 value
# (2^-8 relative), and `out` is stored in bf16.
TOL = {False: dict(rtol=1e-4, atol=1e-5), True: dict(rtol=3e-2, atol=3e-2)}


def _jax_block(a, lowp, seed, emit_next, dropout):
    dt = jnp.bfloat16 if lowp else jnp.float32
    ops = tuple(jnp.asarray(a[k], dt) for k in ("evecs", "gX", "gY"))

    def f(x, coefs, A_re, A_im, Ws, bs, x_hat):
        return jax_megablock_chained(
            x, *ops, jnp.asarray(a["mass"]), coefs, A_re, A_im, Ws, bs,
            jnp.asarray(seed, jnp.int32), x_hat, TILE_V, dropout, emit_next,
            True)
    primals = (jnp.asarray(a["x"], dt), jnp.asarray(a["coefs"]),
               jnp.asarray(a["A_re"]), jnp.asarray(a["A_im"]),
               tuple(map(jnp.asarray, a["Ws"])),
               tuple(map(jnp.asarray, a["bs"])), jnp.asarray(a["x_hat"]))
    return f, primals


@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
def test_plain_b1_with_dropout_matches_jax_kernel(lowp):
    a = _inputs(0, hidden=(16, 32, 8))
    f, primals = _jax_block(a, lowp, 987654321, True, True)
    want, want_xn = f(*primals)
    out, xn = mb.megablock_chained_reference(
        *_torch_args(a, lowp), emit_next=True, lowp=lowp, seed=987654321,
        tile_v=TILE_V)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[lowp])
    np.testing.assert_allclose(xn.numpy(), np.asarray(want_xn), **TOL[lowp])
    # the masks matter: without them the output moves
    off, _ = mb.megablock_chained_reference(*_torch_args(a, lowp),
                                            emit_next=True, lowp=lowp)
    assert (off.float() - out.float()).abs().max() > 0.1


# (c) the Function's gradients against jax.vjp --------------------------------

# f32: the acceptance bound of the training slice; sums of V = 512 rows
# taken in another order stay far inside it. bf16: each side rounds every
# product operand to bf16, and a cotangent that lands on the other side of a
# bf16 rounding boundary moves by 2^-8 relative and carries that into every
# later product: bound relative to the gradient's own scale.
GRAD_TOL = {False: dict(rtol=1e-4, atol=1e-5), True: 3e-2}


def _assert_grad_close(name, got, want, lowp):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, name
    if lowp:
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(got - want).max() / scale
        assert err <= GRAD_TOL[True], f"{name}: {err:.3e} of max |grad|"
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL[False])


@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("emit_next", [True, False], ids=["emit", "last"])
def test_function_vjp_matches_jax_vjp(emit_next, dropout, lowp):
    """dx, dcoefs, dA_re, dA_im, every dW and db, and dx_hat_in through the
    autograd Function (plain backward on the CPU) against jax.vjp of the
    Pallas kernel in interpret mode."""
    a = _inputs(1)
    seed = 424242
    f, primals = _jax_block(a, lowp, seed, emit_next, dropout)
    (out_j, xn_j), vjp = jax.vjp(f, *primals)
    dt = jnp.bfloat16 if lowp else jnp.float32
    ct = (jnp.asarray(a["dout"], dt),
          jnp.asarray(a["dxn"]) if emit_next else None)
    g_x, g_coefs, g_are, g_aim, g_Ws, g_bs, g_xhat = vjp(ct)

    args = _torch_args(a, lowp, grad=True)
    x, _, _, _, _, coefs, A_re, A_im, Ws, bs, x_hat = args
    out, xn = mb.megablock_chained(*args, emit_next=emit_next, lowp=lowp,
                                   seed=seed if dropout else None,
                                   tile_v=TILE_V)
    _assert_grad_close("out", out, out_j, lowp)
    loss = (out.float() * torch.from_numpy(a["dout"]).to(out.dtype).float()
            ).sum()
    if emit_next:
        loss = loss + (xn * torch.from_numpy(a["dxn"])).sum()
    loss.backward()
    _assert_grad_close("dx", x.grad, g_x, lowp)
    _assert_grad_close("dcoefs", coefs.grad, g_coefs, lowp)
    _assert_grad_close("dA_re", A_re.grad, g_are, lowp)
    _assert_grad_close("dA_im", A_im.grad, g_aim, lowp)
    _assert_grad_close("dx_hat_in", x_hat.grad, g_xhat, lowp)
    for l in range(len(Ws)):
        _assert_grad_close(f"dW{l}", Ws[l].grad, g_Ws[l], lowp)
        _assert_grad_close(f"db{l}", bs[l].grad, g_bs[l], lowp)


# (d) the explicit backward against autograd of the plain forward ----------

@pytest.mark.parametrize("dropout", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("emit_next", [True, False], ids=["emit", "last"])
def test_plain_backward_equals_autograd_float64(emit_next, dropout):
    """megablock_chained_bwd_reference, written product by product, against
    torch.autograd through megablock_chained_reference, both in float64
    (equal to rounding: rtol 1e-10)."""
    a = _inputs(2, hidden=(16, 32, 8))
    seed = 31337 if dropout else None
    args = _torch_args(a, False, dtype=torch.float64, grad=True)
    x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat = args
    dout = torch.from_numpy(a["dout"]).double()
    dxn = torch.from_numpy(a["dxn"]).double() if emit_next else None

    out, xn = mb.megablock_chained_reference(
        *args, emit_next=emit_next, seed=seed, tile_v=TILE_V)
    loss = (out * dout).sum() + ((xn * dxn).sum() if emit_next else 0)
    loss.backward()

    with torch.no_grad():
        dx, ds, dA_re, dA_im, dWs, dbs = mb.megablock_chained_bwd_reference(
            x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat, dout,
            dxn, seed=seed, tile_v=TILE_V)
    tol = dict(rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dx, x.grad, **tol)
    torch.testing.assert_close(ds * x_hat, coefs.grad, **tol)
    torch.testing.assert_close(ds * coefs, x_hat.grad, **tol)
    torch.testing.assert_close(dA_re, A_re.grad, **tol)
    torch.testing.assert_close(dA_im, A_im.grad, **tol)
    for l in range(len(Ws)):
        torch.testing.assert_close(dWs[l], Ws[l].grad, **tol)
        torch.testing.assert_close(dbs[l], bs[l].grad, **tol)


def test_grad_slot_layout_and_reduce_order():
    """The rows kernel's scratch layout (groups 32-aligned, in the order the
    kernel writes them), the grads kernel's parameter products and their
    slot offsets, and the plain reduce summing slots in order."""
    lay = mb.bwd_layout(16, 8, (24, 16, 32, 8))
    assert lay["off_in"] == [0, 32, 64]
    assert lay["off_dp"] == [96, 128, 160]
    assert (lay["off_gg"], lay["off_dvb"], lay["off_ds"], lay["ldr"]) == \
        (192, 224, 256, 288)
    assert lay["off_db"] == [0, 16, 48] and lay["ld_db"] == 56
    assert lay["prods"] == [(0, 96, 24, 16, 0), (32, 128, 16, 32, 384),
                            (64, 160, 32, 8, 896), (192, 224, 16, 16, 1152)]
    assert lay["P_par"] == 1152 + 256
    # K = C = 128, hidden [128, 128]: 1,920 values a vertex
    assert mb.bwd_layout(128, 128, (384, 128, 128, 128))["ldr"] == 1920
    rs = np.random.RandomState(3)
    part = torch.from_numpy(rs.randn(2, 5, 40).astype(np.float32))
    got = mb.grad_reduce(part, 8, 20)
    want = part[:, 0, 8:28].clone()
    for s in range(1, 5):
        want += part[:, s, 8:28]
    assert torch.equal(got, want) and mb.LAUNCHES["grad_reduce"] == 0


@pytest.mark.parametrize("B,V", [(1, 32768), (8, 20480), (2, 1000), (3, 64)])
def test_grads_splits_cover_every_row(B, V):
    """The grads kernel's V ranges: multiples of 32 rows that cover B V
    (parameters) and V (ds) with no range wholly past the end."""
    S_par, L_par, S_ds, L_ds = mb.grads_splits(B, V, 128, 128,
                                               (384, 128, 128, 128), 132)
    assert L_par % 32 == 0 and L_ds % 32 == 0
    assert S_par * L_par >= B * V > (S_par - 1) * L_par
    assert S_ds * L_ds >= V > (S_ds - 1) * L_ds


@pytest.mark.parametrize("lowp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("emit_next", [True, False], ids=["emit", "last"])
def test_rows_and_grads_references_compose_to_plain_backward(emit_next,
                                                             dropout, lowp):
    """The plain versions of B2's two kernels (rows: dx_direct, the scratch
    R, db's per-tile partials; grads: the split-V partials) and the
    fixed-order sums give the plain backward: dx_direct equal, every
    gradient within the bound of sums taken in another order (f32), or of
    R's values rounded to bf16 once more (bf16: relative to the gradient's
    largest entry). R's groups hold the values the backward reads."""
    a = _inputs(4, V=300, hidden=(16, 32, 8))
    args = _torch_args(a, lowp)
    dout = torch.from_numpy(a["dout"]).to(args[0].dtype)
    dxn = torch.from_numpy(a["dxn"]) if emit_next else None
    kw = dict(lowp=lowp, seed=1234 if dropout else None, tile_v=100)
    want = mb.megablock_chained_bwd_reference(*args, dout, dxn, **kw)
    dx, R, dbp = mb.megablock_bwd_rows(*args, dout, dxn, **kw)
    widths = (24, 16, 32, 8, 8)
    splits = mb.grads_splits(2, 300, 16, 8, widths, 3)
    assert splits[0] > 1 and splits[2] > 1
    part_par, part_ds = mb.megablock_bwd_grads(R, *args[1:4], 8, widths,
                                               splits, lowp)
    got = mb.bwd_grads_finish(part_par, part_ds, dbp, 16, 8, widths)
    assert mb.LAUNCHES["megablock_bwd_rows"] == 0
    assert mb.LAUNCHES["megablock_bwd_grads"] == 0
    assert dx.dtype == args[0].dtype
    if not lowp:
        torch.testing.assert_close(dx, want[0], rtol=1e-5, atol=1e-6)
    names = ["ds", "dA_re", "dA_im"] + [f"dW{l}" for l in range(4)] + \
        [f"db{l}" for l in range(4)]
    for name, g, w in zip(names, [*got[:3], *got[3], *got[4]],
                          [*want[1:4], *want[4], *want[5]]):
        scale = max(w.abs().max().item(), 1e-6)
        err = (g - w).abs().max().item() / scale
        assert err <= (2e-2 if lowp else 1e-5), f"{name}: {err:.3e}"
    lay = mb.bwd_layout(16, 8, widths)
    gx = R[:, lay["off_gg"]:lay["off_gg"] + 8].float().view(2, 300, 8)
    f = mb._forward_parts(*args, lowp, kw["seed"], 100)
    torch.testing.assert_close(gx, f["gx"].to(R.dtype).float())


@pytest.mark.parametrize("lowp", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("N,k", [(128, 32), (200, 70), (8, 19)])
def test_b_tiles_read_as_the_rows_kernel_reads_them(N, k, lowp):
    """The rows kernel's B stages, read back as wgmma reads them (K-major
    core matrices of 8 rows x 16 bytes in (row group, k group) order) with
    the chunk's contraction order (`_chunk_order`, the order of a thread's
    A fragments), give back B^T: hi + lo within TF32's split (f32), the
    bf16 rounding of B^T (lowp)."""
    rs = np.random.RandomState(N + k)
    bt = torch.from_numpy(rs.randn(N, k).astype(np.float32))
    t = mb.b_tiles(bt, lowp).float()
    npass, nk = -(-N // 128), -(-k // 32)
    e = 8 if lowp else 4
    order = mb._chunk_order(lowp)
    assert sorted(order) == list(range(32))
    got = torch.zeros(npass * 128, nk * 32)
    for p in range(npass):
        for c in range(nk):
            stage = t[p, c] if lowp else t[p, c, 0] + t[p, c, 1]
            for j in range(32):
                n = torch.arange(128)
                o = ((n // 8) * (32 // e) + j // e) * 8 * e + (n % 8) * e + j % e
                got[p * 128 + n, c * 32 + order[j]] = stage[o]
    want = bt.to(torch.bfloat16).float() if lowp else bt
    torch.testing.assert_close(got[:N, :k], want, rtol=2 ** -21, atol=0)
    assert not got[N:].any() and not got[:, k:].any()


@pytest.mark.parametrize("lowp", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("emit_next", [True, False], ids=["emit", "last"])
def test_rows_b_operands_gather_equals_b_tiles(emit_next, lowp):
    """The one gather that tiles every B operand of the rows kernel gives,
    operand by operand, what `b_tiles` gives for it: s^T and dx_hat_next^T
    per batch element, cmap^T with its rows re_c, im_c interleaved, cmap,
    W_l^T for all but the last layer, W_l."""
    a = _inputs(5, hidden=(16, 32, 8))
    args = _torch_args(a, False)
    x_hat, coefs, A_re, A_im, Ws = args[10], args[5], args[6], args[7], args[8]
    dxn = torch.from_numpy(a["dxn"]) if emit_next else None
    tiles, ptr = mb._rows_b_operands(coefs, x_hat, dxn, A_re, A_im, Ws, lowp)
    C = coefs.shape[-1]
    cmap = mb.cmap_of(A_re, A_im)
    il = torch.stack((torch.arange(C), torch.arange(C) + C), 1).reshape(-1)
    want = [mb.b_tiles((coefs * x_hat).transpose(1, 2), lowp),
            None if dxn is None else mb.b_tiles(dxn.transpose(1, 2), lowp),
            mb.b_tiles(cmap.transpose(0, 1)[il], lowp),
            mb.b_tiles(cmap, lowp)]
    want += [mb.b_tiles(W.transpose(0, 1), lowp) for W in Ws[:-1]]
    want += [mb.b_tiles(W, lowp) for W in Ws]
    assert len(ptr) == len(want)
    base, size = tiles.data_ptr(), tiles.element_size()
    flat = tiles.reshape(-1)
    for i, (p, w) in enumerate(zip(ptr, want)):
        if w is None:
            assert p is None
            continue
        o = (p - base) // size
        assert torch.equal(flat[o:o + w.numel()], w.reshape(-1)), i
