"""The port's one-block op `megablock` (kernel B3: the projection kernel,
then B1 without emit_next; backward B2) against the JAX package's
`megablock` in interpret mode, on the CPU (both at full matmul precision)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.ops.pallas_megablock import (
    interpret_dropout_mask, megablock as jax_megablock)
from diffusionnet_tpu_torch.ops import fused, megablock as mb
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

B, V, K, C, TILE = 2, 256, 8, 8, 128


def _inputs(seed, hidden=(8, 8), B=B):
    """numpy inputs of tests/test_pallas_megablock.py's `_inputs`."""
    rs = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)
    x = r(B, V, C)
    ops = [r(B, V, K, scale=V ** -0.5) for _ in range(3)]
    mass = rs.rand(B, V).astype(np.float32)
    coefs = rs.rand(B, K, C).astype(np.float32)
    A_re, A_im = r(C, C, scale=0.3), r(C, C, scale=0.3)
    widths = (3 * C, *hidden, C)
    Ws = [r(widths[i], widths[i + 1], scale=0.3)
          for i in range(len(widths) - 1)]
    bs = [r(widths[i + 1], scale=0.1) for i in range(len(widths) - 1)]
    return [x, *ops, mass, coefs, A_re, A_im, Ws, bs]


# differentiated: x, coefs, A_re, A_im, Ws, bs
DIFF = (0, 5, 6, 7, 8, 9)
NAMES = ("dx", "dcoefs", "dA_re", "dA_im", "dWs", "dbs")


def _jax(args, seed, dropout, ct):
    ja = [tuple(map(jnp.asarray, a)) if isinstance(a, list)
          else jnp.asarray(a) for a in args]
    s = jnp.asarray(seed, jnp.int32)

    def loss(*a):
        out = jax_megablock(*a, s, TILE, dropout, True)
        return jnp.sum(out * ct), out
    (_, out), grads = jax.value_and_grad(loss, argnums=DIFF, has_aux=True)(
        *ja)
    return out, grads


def _port(args, seed, dropout, ct):
    ta = []
    for i, a in enumerate(args):
        if isinstance(a, list):
            ta.append([torch.from_numpy(t).requires_grad_(True) for t in a])
        else:
            ta.append(torch.from_numpy(a).requires_grad_(i in DIFF))
    mb.reset_launches()
    fused.reset_launches()
    out = mb.megablock(*ta, seed, TILE, dropout)
    (out * torch.from_numpy(ct)).sum().backward()
    # on the CPU the wrappers take the plain versions: nothing launches
    assert not any(mb.LAUNCHES.values()) and not any(fused.LAUNCHES.values())
    grads = [ta[i].grad if i < 8 else [t.grad for t in ta[i]] for i in DIFF]
    return out, grads


@pytest.mark.parametrize("hidden,dropout", [((8, 8), False), ((8, 8), True),
                                            ((16, 32, 8), False)],
                         ids=["nodrop", "dropout", "general-mlp"])
def test_megablock_matches_pallas(hidden, dropout):
    """The forward and the gradients in x, coefs, A_re, A_im, Ws and bs
    within rtol and atol 2e-4, the JAX test's own bound (f32 sums in other
    orders through a tanh and the MLP). With dropout both sides draw the
    interpret-mode hash masks."""
    args = _inputs(7 + len(hidden), hidden)
    ct = np.random.RandomState(3).randn(B, V, C).astype(np.float32)
    seed = 1234
    want, jgrads = _jax(args, seed, dropout, ct)
    got, tgrads = _port(args, seed, dropout, ct)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    for name, g, w in zip(NAMES, tgrads, jgrads):
        gs = g if isinstance(g, list) else [g]
        ws = w if isinstance(w, tuple) else [w]
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-4, err_msg=name)


def test_megablock_dropout_masks_bit_equal():
    """The masks B3 draws for (seed, batch, tile of TILE rows, layer) equal
    `interpret_dropout_mask` bit for bit, and they do drop: the op differs
    from its dropout-free self."""
    seed = 1234
    for layer, width in enumerate((8, 8)):
        got = mb.dropout_masks(B, V, width, seed, layer, TILE).numpy()
        want = np.stack([np.concatenate(
            [np.asarray(interpret_dropout_mask((TILE, width), 0.5,
                                               jnp.asarray(seed, jnp.int32),
                                               b, i, layer))
             for i in range(V // TILE)]) for b in range(B)])
        np.testing.assert_array_equal(got, want)
        assert 0.4 < got.mean() < 0.6
    args = [torch.from_numpy(a) if not isinstance(a, list)
            else [torch.from_numpy(t) for t in a] for a in _inputs(9)]
    on = mb.megablock(*args, seed, TILE, True)
    off = mb.megablock(*args, seed, TILE, False)
    assert not torch.equal(on, off)
    torch.testing.assert_close(
        off, mb.megablock_reference(*args, None, TILE), rtol=0, atol=0)


def test_megablock_refuses_ragged_tile():
    args = [torch.from_numpy(a) if not isinstance(a, list)
            else [torch.from_numpy(t) for t in a] for a in _inputs(10)]
    with pytest.raises(ValueError, match="multiple of tile_v=96"):
        mb.megablock(*args, 0, 96, False)
