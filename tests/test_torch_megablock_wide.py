"""The block kernels B1 and B2 at the sampling_invariance model's widths:
C = 256 with hidden [256, 256], and K = 128 or 256. The JAX package's
Pallas kernel `megablock_chained` runs there (in interpret mode, forward
and `jax.vjp` through its custom VJP); the port's plain versions, which the
CUDA kernels are held against on the card, must agree with it.

Both sides run in f32 at full matmul precision (`highest`: tests/conftest.py
for JAX, torch.set_float32_matmul_precision here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.ops.pallas_megablock import (
    megablock_chained as jax_megablock_chained)
from diffusionnet_tpu_torch.ops import megablock as mb
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

B, V, C, HIDDEN, TILE_V = 2, 64, 256, (256, 256), 32
# f32 against f32: the same products summed in another order, over up to
# 3C = 768 terms per output and B V = 128 rows per gradient entry. The
# bound is relative to each output's largest entry, since a gradient is a
# sum over rows whose small entries are differences of large terms.
RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, K):
    """numpy inputs of one block; the last 8 rows are padding (mass 0,
    zero operator rows). Weights at 1/sqrt(fan-in) keep the activations of
    the 768-wide MLP input at O(1)."""
    rs = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)
    x = r(B, V, C)
    evecs, gX, gY = (r(B, V, K, scale=1 / np.sqrt(V)) for _ in range(3))
    mass = rs.rand(B, V).astype(np.float32)
    for a in (evecs, gX, gY, mass):
        a[:, V - 8:] = 0
    widths = (3 * C,) + HIDDEN + (C,)
    return dict(
        x=x, evecs=evecs, gX=gX, gY=gY, mass=mass,
        coefs=rs.rand(B, K, C).astype(np.float32),
        A_re=r(C, C, scale=C ** -0.5), A_im=r(C, C, scale=C ** -0.5),
        Ws=[r(widths[i], widths[i + 1], scale=widths[i] ** -0.5)
            for i in range(len(widths) - 1)],
        bs=[r(widths[i + 1], scale=0.1) for i in range(len(widths) - 1)],
        x_hat=np.einsum("bvk,bvc->bkc", evecs, x * mass[..., None]),
        dout=r(B, V, C), dxn=r(B, K, C))


def _close(name, got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("dropout", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("emit_next", [True, False], ids=["emit", "last"])
def test_plain_block_matches_jax_kernel_at_c256(K, dropout, emit_next):
    """Forward (out, x_hat_next) and backward (dx, dcoefs, dx_hat_in, dA_re,
    dA_im, every dW and db) of the port's plain versions against the JAX
    kernel in interpret mode through jax.vjp."""
    a = _inputs(K + 2 * dropout + emit_next, K)
    seed = 20240917
    ops = tuple(jnp.asarray(a[k]) for k in ("evecs", "gX", "gY"))

    def f(x, coefs, A_re, A_im, Ws, bs, x_hat):
        return jax_megablock_chained(
            x, *ops, jnp.asarray(a["mass"]), coefs, A_re, A_im, Ws, bs,
            jnp.asarray(seed, jnp.int32), x_hat, TILE_V, dropout, emit_next,
            True)
    primals = (jnp.asarray(a["x"]), jnp.asarray(a["coefs"]),
               jnp.asarray(a["A_re"]), jnp.asarray(a["A_im"]),
               tuple(map(jnp.asarray, a["Ws"])),
               tuple(map(jnp.asarray, a["bs"])), jnp.asarray(a["x_hat"]))
    (out_j, xn_j), vjp = jax.vjp(f, *primals)
    g_x, g_coefs, g_are, g_aim, g_Ws, g_bs, g_xhat = vjp(
        (jnp.asarray(a["dout"]),
         jnp.asarray(a["dxn"]) if emit_next else None))

    t = torch.from_numpy
    args = (t(a["x"]), t(a["evecs"]), t(a["gX"]), t(a["gY"]), t(a["mass"]),
            t(a["coefs"]), t(a["A_re"]), t(a["A_im"]),
            [t(W) for W in a["Ws"]], [t(b) for b in a["bs"]], t(a["x_hat"]))
    kw = dict(seed=seed if dropout else None, tile_v=TILE_V)
    out, xn = mb.megablock_chained_reference(*args, emit_next=emit_next, **kw)
    _close("out", out, out_j)
    if emit_next:
        _close("x_hat_next", xn, xn_j)
    else:
        assert xn is None and xn_j is None
    dx, ds, dA_re, dA_im, dWs, dbs = mb.megablock_chained_bwd_reference(
        *args, t(a["dout"]), t(a["dxn"]) if emit_next else None, **kw)
    _close("dx", dx, g_x)
    _close("dcoefs", ds * args[10], g_coefs)
    _close("dx_hat_in", ds * args[5], g_xhat)
    _close("dA_re", dA_re, g_are)
    _close("dA_im", dA_im, g_aim)
    for l in range(len(dWs)):
        _close(f"dW{l}", dWs[l], g_Ws[l])
        _close(f"db{l}", dbs[l], g_bs[l])


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("dropout", [False, True], ids=["nodrop", "drop"])
def test_plain_xhat_split_matches_jax_kernel_at_c256(K, dropout):
    """x_hat_next as the card computes it at C = 256: the split-V kernel's
    plain version over 128 x 128 pieces of (K, C) (2 x 2 at K = 256) and
    ranges of V, then `reduce_pieces`, against the Pallas kernel's
    x_hat_next in interpret mode."""
    a = _inputs(K + 7 * dropout, K)
    seed = 20240917
    out_j, xn_j = jax_megablock_chained(
        *(jnp.asarray(a[k]) for k in ("x", "evecs", "gX", "gY", "mass",
                                      "coefs", "A_re", "A_im")),
        tuple(map(jnp.asarray, a["Ws"])), tuple(map(jnp.asarray, a["bs"])),
        jnp.asarray(seed, jnp.int32), jnp.asarray(a["x_hat"]), TILE_V,
        dropout, True, True)
    t = torch.from_numpy
    args = (t(a["x"]), t(a["evecs"]), t(a["gX"]), t(a["gY"]), t(a["mass"]),
            t(a["coefs"]), t(a["A_re"]), t(a["A_im"]),
            [t(W) for W in a["Ws"]], [t(b) for b in a["bs"]], t(a["x_hat"]))
    f = mb._forward_parts(*args, False, seed if dropout else None, TILE_V)
    _close("out", f["out"], out_j)
    splits = mb.xhat_splits(B, V, K, C, 16)
    part = mb.megablock_fwd_xhat(args[1], f["out"], args[4], splits)
    assert part.shape == (B, K // 128, 2, splits[0], 128, 128)
    _close("x_hat_next", mb.reduce_pieces(part, B, K, C), xn_j)


@pytest.mark.parametrize("C,widths,want", [
    (128, (384, 128, 128, 128), ((2, 2, False), (2, 3, False))),
    (128, (384, 128, 128, 128), ((2, 2, False), (2, 3, False))),
    (256, (768, 256, 256, 256), ((1, 2, False), (1, 3, False))),
    (256, (768,) + (1024,) * 7 + (256,), ((2, 1, True), (2, 1, True))),
    (12, (36, 12, 12), ((2, 3, False), (2, 3, False)))],
    ids=["C128", "K256", "C256", "C256-1024x7", "C12"])
def test_block_kernel_takes_c256_and_1024_wide_layers(C, widths, want):
    """B1's row-kernel layout from its shared memory, computed from the
    shapes with the kernel's formulas against an H100's opt-in 232,448
    bytes, f32 and bf16 (K does not enter it: the segmentation model's
    K = 128 and K = 256 take the same layout): the segmentation model
    (C = 128) with two warpgroups (two tiles) a CTA, feat spilled to a
    device scratch in f32 (bf16's smaller B stages leave room for all three
    buffers); the sampling_invariance model (C = 256, hidden [256, 256])
    with one warpgroup, feat spilled in f32; hidden widths of 1024 (up to 8
    layers) with the hidden layers, gy and feat in device scratch and two
    warpgroups; C = 12, padded to 16, with everything in shared memory; a
    card without room for the B ring alone refuses with the bytes it
    needs."""
    limit = 232448
    for lowp, w in zip((False, True), want):
        assert mb.fwd_route(C, widths, lowp, limit) == w
    seg = (384, 128, 128, 128)
    assert mb.fwd_rows_smem_bytes(128, seg, False, (1, 3, False)) \
        == 3 * 32768 + 3 * 64 * 132 * 4
    assert mb.fwd_rows_smem_bytes(128, seg, False, (2, 2, False)) \
        == 2 * 32768 + 2 * 2 * 64 * 132 * 4 <= limit
    assert mb.fwd_rows_smem_bytes(128, seg, False, (2, 3, False)) > limit
    assert mb.fwd_rows_smem_bytes(256, (768, 256, 256, 256), False,
                                  (1, 2, False)) \
        == 3 * 32768 + 2 * 64 * 260 * 4 <= limit
    # the hidden layers in scratch: the buffers are C wide
    wide = (768, 1024, 1024, 256)
    assert mb.fwd_rows_smem_bytes(256, wide, False, (2, 1, True)) \
        == 2 * 32768 + 2 * 64 * 260 * 4
    assert mb.fwd_rows_smem_bytes(256, wide, False, (2, 2, True)) > limit
    need = mb.fwd_rows_smem_bytes(256, (768, 2048, 256), False,
                                  (2, 0, True))
    assert need == 2 * 32768
    with pytest.raises(ValueError, match=f"needs at least {need} bytes"):
        mb.fwd_route(256, (768, 2048, 256), False, need - 1)
