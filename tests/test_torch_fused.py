"""The port's fused spectral block (kernel B4, ops/fused.py) against the JAX
package's Pallas op in interpret mode, on the CPU (both at full matmul
precision): forward, the autograd Function's VJP, bf16 x, the tile check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.ops.pallas_fused import (
    fused_spectral_block as jax_fused,
    fused_spectral_block_batched as jax_fused_batched)
from diffusionnet_tpu_torch.ops import fused

torch.set_float32_matmul_precision("highest")


def _inputs(seed, B=None, V=1024, K=32, C=16):
    """numpy inputs, with a leading batch dim B unless B is None."""
    rs = np.random.RandomState(seed)
    lead = () if B is None else (B,)

    def r(*shape, scale=1.0):
        return (rs.randn(*lead, *shape) * scale).astype(np.float32)
    return (r(V, C), r(V, K, scale=V ** -0.5), r(V, K, scale=V ** -0.5),
            r(V, K, scale=V ** -0.5), rs.rand(*lead, V).astype(np.float32),
            rs.rand(*lead, K, C).astype(np.float32))


@pytest.mark.parametrize("batched", [False, True], ids=["B4a", "B4b"])
def test_fused_forward_matches_pallas(batched):
    """(y, ygx, ygy) within rtol 1e-4 / atol 1e-5, the JAX test's own bound:
    f32 sums of the same products in another order. No launch on the CPU."""
    args = _inputs(0, B=3 if batched else None)
    jfn, tfn = ((jax_fused_batched, fused.fused_spectral_block_batched)
                if batched else (jax_fused, fused.fused_spectral_block))
    want = jfn(*map(jnp.asarray, args), 256, True)
    fused.reset_launches()
    got = tfn(*map(torch.from_numpy, args), 256)
    assert fused.LAUNCHES == {"spectral_project": 0, "spectral_apply": 0}
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("batched", [False, True], ids=["B4a", "B4b"])
def test_fused_vjp_matches_jax_grad(batched):
    """dx and dcoefs of the autograd Function against jax.grad of the Pallas
    op (its custom VJP), rtol and atol 1e-4, for a loss that weights the
    three outputs differently."""
    x, evecs, gX, gY, mass, coefs = _inputs(1, B=2 if batched else None,
                                            V=512, K=16, C=8)
    jfn, tfn = ((jax_fused_batched, fused.fused_spectral_block_batched)
                if batched else (jax_fused, fused.fused_spectral_block))
    ops = [jnp.asarray(a) for a in (evecs, gX, gY, mass)]

    def jloss(x, coefs):
        y, a, b = jfn(x, *ops, coefs, 256, True)
        return jnp.sum(y ** 2) + jnp.sum(a ** 2) + 2 * jnp.sum(b ** 3)
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(coefs))

    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(coefs).requires_grad_(True)
    y, a, b = tfn(tx, *map(torch.from_numpy, (evecs, gX, gY, mass)), tc, 256)
    ((y ** 2).sum() + (a ** 2).sum() + 2 * (b ** 3).sum()).backward()
    for g, w in zip((tx.grad, tc.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_fused_bf16_x_with_f32_operators():
    """compute_dtype=bf16 hands B4 a bf16 x beside f32 operators: the
    outputs are bf16 and agree with the Pallas op (same inputs) within 2e-2
    relative L2; the two frameworks round at other places."""
    x, evecs, gX, gY, mass, coefs = _inputs(2, B=2, V=512, K=16, C=8)
    want = jax_fused_batched(jnp.asarray(x, jnp.bfloat16),
                             *map(jnp.asarray, (evecs, gX, gY, mass, coefs)),
                             256, True)
    got = fused.fused_spectral_block_batched(
        torch.from_numpy(x).to(torch.bfloat16),
        *map(torch.from_numpy, (evecs, gX, gY, mass, coefs)), 256)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)


def test_fused_refuses_ragged_tile():
    """V % tile_v != 0 raises the JAX op's ValueError in both forms."""
    args = [torch.from_numpy(a) for a in _inputs(3, B=1, V=300, K=8, C=4)]
    for fn, a in ((fused.fused_spectral_block_batched, args),
                  (fused.fused_spectral_block, [t[0] for t in args])):
        with pytest.raises(ValueError, match="multiple of tile_v=128"):
            fn(*a, 128)


def test_project_and_apply_plain_pieces():
    """The kernels' plain versions compose to the whole function, and the
    projection's lowp mode rounds both operands to bf16 (B3 on bf16
    operators)."""
    x, evecs, gX, gY, mass, coefs = map(torch.from_numpy,
                                        _inputs(4, B=2, V=256, K=8, C=8))
    x_hat = fused.spectral_project(x, evecs, mass)
    outs = fused.spectral_apply(x_hat, coefs, evecs, gX, gY, torch.float32)
    for a, b in zip(outs, fused.fused_spectral_block_reference(
            x, evecs, gX, gY, mass, coefs)):
        assert torch.equal(a, b)
    lowp = fused.spectral_project(x, evecs.to(torch.bfloat16), mass, True)
    r = (lambda t: t.to(torch.bfloat16).double())
    want = r(evecs).transpose(1, 2) @ r(x * mass[..., None])
    torch.testing.assert_close(lowp.double(), want, rtol=1e-5, atol=1e-6)
