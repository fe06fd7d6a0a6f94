"""The block kernels B1 and B2 at channel counts that are not multiples of
8: C = 12 with hidden [12] and C = 100 with the default hidden [100, 100].
The kernels take C % 8 == 0, so `megablock_chained` pads C with zero
channels (`ops.megablock.pad_block`) and cuts the results back, on the card
and, around the plain versions, on the CPU. The JAX package's Pallas kernel
`megablock_chained` takes any C; here it runs in interpret mode, forward and
`jax.vjp` through its custom VJP, against the port's padded path through
its autograd Function.

Both sides run in f32 at full matmul precision (`highest`: tests/conftest.py
for JAX, torch.set_float32_matmul_precision here)."""

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

B, V, K, TILE_V = 2, 128, 16, 64
SHAPES = {"C12": (12, (12,)), "C100": (100, (100, 100))}
# test_torch_megablock_bwd.py's bounds, rtol 1e-4 and atol 1e-5, with
# atol relative to each output's largest entry as test_torch_megablock_wide.py
# takes it at C = 256: a gradient is a sum over B V = 256 rows of up to
# 3C = 300-term products, whose small entries are differences of large terms
# (at C = 100 the plain version without padding differs from the Pallas
# kernel by 3.4e-5 in a dW whose largest entry is 75, as the padded one does)
RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, C, hidden):
    """numpy inputs of one block; the last 16 rows are padding (mass 0,
    zero operator rows). Weights at 1/sqrt(fan-in) keep the activations at
    O(1)."""
    rs = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)
    x = r(B, V, C)
    evecs, gX, gY = (r(B, V, K, scale=1 / np.sqrt(V)) for _ in range(3))
    mass = rs.rand(B, V).astype(np.float32)
    for a in (evecs, gX, gY, mass):
        a[:, V - 16:] = 0
    widths = (3 * C,) + hidden + (C,)
    return dict(
        x=x, evecs=evecs, gX=gX, gY=gY, mass=mass,
        coefs=rs.rand(B, K, C).astype(np.float32),
        A_re=r(C, C, scale=C ** -0.5), A_im=r(C, C, scale=C ** -0.5),
        Ws=[r(widths[i], widths[i + 1], scale=widths[i] ** -0.5)
            for i in range(len(widths) - 1)],
        bs=[r(widths[i + 1], scale=0.1) for i in range(len(widths) - 1)],
        x_hat=np.einsum("bvk,bvc->bkc", evecs, x * mass[..., None]),
        dout=r(B, V, C), dxn=r(B, K, C))


def _torch_args(a, grad=False):
    def t(v, leaf=True):
        return torch.from_numpy(v).requires_grad_(grad and leaf)
    return (t(a["x"]), t(a["evecs"], False), t(a["gX"], False),
            t(a["gY"], False), t(a["mass"], False), t(a["coefs"]),
            t(a["A_re"]), t(a["A_im"]), [t(W) for W in a["Ws"]],
            [t(b) for b in a["bs"]], t(a["x_hat"]))


def _close(name, got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
@pytest.mark.parametrize("dropout", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("emit_next", [True, False], ids=["emit", "last"])
def test_padded_block_matches_jax_kernel(shape, dropout, emit_next):
    """Forward (out, x_hat_next) and backward (dx, dcoefs, dx_hat_in, dA_re,
    dA_im, every dW and db) of the port's autograd Function, which pads C
    to a multiple of 8 around the plain versions on the CPU, against the
    JAX kernel in interpret mode through jax.vjp, at the model's own C."""
    C, hidden = SHAPES[shape]
    a = _inputs(C + 2 * dropout + emit_next, C, hidden)
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

    args = _torch_args(a, grad=True)
    x, _, _, _, _, coefs, A_re, A_im, Ws, bs, x_hat = args
    out, xn = mb.megablock_chained(*args, emit_next=emit_next,
                                   seed=seed if dropout else None,
                                   tile_v=TILE_V)
    assert out.shape == (B, V, C)
    _close("out", out, out_j)
    loss = (out * torch.from_numpy(a["dout"])).sum()
    if emit_next:
        assert xn.shape == (B, K, C)
        _close("x_hat_next", xn, xn_j)
        loss = loss + (xn * torch.from_numpy(a["dxn"])).sum()
    else:
        assert xn is None and xn_j is None
    loss.backward()
    _close("dx", x.grad, g_x)
    _close("dcoefs", coefs.grad, g_coefs)
    _close("dx_hat_in", x_hat.grad, g_xhat)
    _close("dA_re", A_re.grad, g_are)
    _close("dA_im", A_im.grad, g_aim)
    for l in range(len(Ws)):
        assert Ws[l].grad.shape == Ws[l].shape
        _close(f"dW{l}", Ws[l].grad, g_Ws[l])
        _close(f"db{l}", bs[l].grad, g_bs[l])


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
def test_padded_block_draws_the_models_masks(shape):
    """The dropout masks of the padded block (the hidden layers keep their
    widths) are bit-equal to `interpret_dropout_mask` at the model's own
    widths, every batch element, tile and layer; and with them the padded
    forward equals the unpadded plain forward bit for bit."""
    C, hidden = SHAPES[shape]
    a = _inputs(7, C, hidden)
    seed = 987654321
    args = _torch_args(a)
    x, evecs, gX, gY, mass, coefs, A_re, A_im, Ws, bs, x_hat = args
    padded = mb.pad_block(x, coefs, A_re, A_im, Ws, bs, x_hat)
    assert padded[0].shape[-1] == -(-C // 8) * 8
    f = mb._forward_parts(padded[0], evecs, gX, gY, mass, *padded[1:6],
                          padded[6], False, seed, TILE_V)
    assert len(f["masks"]) == len(hidden)
    for layer, (keep, width) in enumerate(zip(f["masks"], hidden)):
        assert keep.shape == (B, V, width)
        for b in range(B):
            for i in range(V // TILE_V):
                want = np.asarray(interpret_dropout_mask(
                    (TILE_V, width), 0.5, seed, b, i, layer))
                np.testing.assert_array_equal(
                    keep[b, i * TILE_V:(i + 1) * TILE_V].numpy(), want)
    out, xn = mb.megablock_chained_fwd(*args, seed=seed, tile_v=TILE_V)
    ref, ref_xn = mb.megablock_chained_reference(*args, seed=seed,
                                                 tile_v=TILE_V)
    assert torch.equal(out, ref) and torch.equal(xn, ref_xn)
