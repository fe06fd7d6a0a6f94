"""The inference slice end to end: the port's InferenceSession against the
JAX package's, both on the megakernel path, reading one operator cache."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionnet_tpu.models import DiffusionNet as JaxDiffusionNet
from diffusionnet_tpu.serving.export import _flatten_params, _unflatten_params
from diffusionnet_tpu.training import InferenceSession as JaxInferenceSession
from diffusionnet_tpu_torch.geometry import get_operators
from diffusionnet_tpu_torch.models import DiffusionNet
from diffusionnet_tpu_torch.ops import megablock as mb
from diffusionnet_tpu_torch.training import InferenceSession
from tests.meshgen import icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

K_EIG, WIDTH, N_BLOCK, C_OUT = 16, 16, 2, 8
ARCH = dict(c_in=16, c_out=C_OUT, c_width=WIDTH, n_block=N_BLOCK,
            mlp_hidden_dims=(WIDTH, WIDTH), dropout=True)


@pytest.fixture(scope="module")
def mesh_and_cache(tmp_path_factory):
    """icosphere(3), 642 vertices (bucket 1024), and a cache entry written
    with the host eigensolver: the JAX default ('device') would give another
    basis, so both sessions must read this one."""
    verts, faces = icosphere(3)
    cache = str(tmp_path_factory.mktemp("ops"))
    get_operators(verts, faces, k_eig=K_EIG, op_cache_dir=cache,
                  eigensolver="host")
    return verts, faces, cache


def _jax_flat_params(outputs_at):
    """Seeded JAX parameters, with diffusion times drawn away from zero so
    the spectral filter matters."""
    model = JaxDiffusionNet(**ARCH, outputs_at=outputs_at,
                            last_activation=jax.nn.log_softmax)
    V, z = 32, jnp.zeros((32, K_EIG))
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((V, 16)),
                        jnp.ones(V), evals=jnp.zeros(K_EIG), evecs=z,
                        gradX=z, gradY=z, faces=jnp.zeros((1, 3), jnp.int32))
    flat = _flatten_params(jax.tree.map(np.asarray, params))
    rs = np.random.RandomState(5)
    for k in flat:
        if k.endswith("diffusion_time"):
            flat[k] = (rs.rand(*flat[k].shape) * 0.05).astype(np.float32)
    return model, flat


def _port_session(outputs_at, flat, cache, **kw):
    model = DiffusionNet(**ARCH, outputs_at=outputs_at,
                         last_activation=functools.partial(torch.log_softmax,
                                                           dim=-1))
    return InferenceSession(model, flat, k_eig=K_EIG, op_cache_dir=cache,
                            device="cpu", **kw)


@pytest.mark.parametrize("outputs_at", ["faces", "vertices"])
def test_port_session_matches_jax_session(mesh_and_cache, outputs_at):
    """log-probabilities within rtol 1e-4 / atol 1e-5 (f32 on both sides,
    the Pallas kernel's own test bound: per-tile sums in another order)."""
    verts, faces, cache = mesh_and_cache
    jmodel, flat = _jax_flat_params(outputs_at)
    want = JaxInferenceSession(jmodel, _unflatten_params(flat), k_eig=K_EIG,
                               op_cache_dir=cache,
                               use_megakernel=True)(verts, faces)
    mb.reset_launches()
    got = _port_session(outputs_at, flat, cache,
                        use_megakernel=True)(verts, faces)
    rows = faces.shape[0] if outputs_at == "faces" else verts.shape[0]
    assert got.shape == want.shape == (rows, C_OUT)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # on the CPU the wrappers take the plain versions and launch nothing
    assert mb.LAUNCHES == {"megablock_fwd": 0, "megablock_fwd_xhat": 0,
                           "xhat_reduce": 0, "megablock_bwd_rows": 0,
                           "megablock_bwd_grads": 0, "grad_reduce": 0}


@pytest.mark.parametrize("outputs_at", ["faces", "global_mean"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_port_megakernel_session_matches_eager(mesh_and_cache, outputs_at,
                                               bf16):
    """The fast path against the eager DiffusionNet (the plain reference of
    the whole model). f32: rtol 1e-4 / atol 1e-5. bf16 operands: every
    product rounds its operands to bf16 (relative 2^-9 each) through two
    blocks of depth-3 MLPs; the log-probabilities are O(1), so atol 5e-2."""
    verts, faces, cache = mesh_and_cache
    _, flat = _jax_flat_params(outputs_at)
    eager = _port_session(outputs_at, flat, cache)(verts, faces)
    fast = _port_session(outputs_at, flat, cache, use_megakernel=True,
                         bf16=bf16)(verts, faces)
    assert fast.shape == eager.shape and np.isfinite(fast).all()
    tol = dict(rtol=0, atol=5e-2) if bf16 else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fast, eager, **tol)
    np.testing.assert_allclose(np.exp(fast).sum(-1), 1.0, rtol=1e-5)


def _jax_model_params(seed=6, **kw):
    """Seeded JAX parameters of a small xyz-input model, diffusion times
    drawn away from zero (drawn through the spectral model: every variant
    has the same tree)."""
    arch = dict(c_in=3, c_out=C_OUT, c_width=8, n_block=2, dropout=False,
                outputs_at="vertices")
    model = JaxDiffusionNet(**arch, **kw)
    z = jnp.zeros((64, 4))
    params = JaxDiffusionNet(**arch).init(jax.random.PRNGKey(seed), jnp.zeros((64, 3)),
                        jnp.ones(64), evals=jnp.zeros(4), evecs=z, gradX=z,
                        gradY=z)
    flat = _flatten_params(jax.tree.map(np.asarray, params))
    rs = np.random.RandomState(seed)
    for k in flat:
        if k.endswith("diffusion_time"):
            flat[k] = (rs.rand(*flat[k].shape) * 0.05).astype(np.float32)
    return model, arch, flat


def test_session_serves_implicit_dense_on_ell_operators(tmp_path):
    """An implicit_dense model with k_eig=0 operators: the session hands it
    the ELL gradients and L (the dense spectral operators are for
    diffusion_method='spectral' only), as the JAX session does; outputs
    within rtol 1e-4 / atol 1e-5. The megakernel path refuses the model."""
    verts, faces = icosphere(1)
    cache = str(tmp_path)
    get_operators(verts, faces, k_eig=0, op_cache_dir=cache)
    kw = dict(diffusion_method="implicit_dense")
    jmodel, arch, flat = _jax_model_params(**kw)
    want = JaxInferenceSession(jmodel, _unflatten_params(flat), k_eig=0,
                               input_features="xyz", op_cache_dir=cache,
                               buckets=(64,))(verts, faces)
    session = InferenceSession(DiffusionNet(**arch, **kw), flat, k_eig=0,
                               input_features="xyz", op_cache_dir=cache,
                               buckets=(64,), device="cpu")
    got = session(verts, faces)
    assert got.shape == want.shape == (verts.shape[0], C_OUT)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="spectral diffusion"):
        InferenceSession(DiffusionNet(**arch, **kw), flat, k_eig=0,
                         use_megakernel=True, device="cpu")


def test_session_serves_fused_model(mesh_and_cache, monkeypatch):
    """A use_pallas_fused model on the eager path: every block of the
    request (bucket 1024 = pallas_tile_v) runs kernel B4's Function, and
    the predictions match the JAX session's (Pallas in interpret mode)
    within rtol 1e-4 / atol 1e-5."""
    from diffusionnet_tpu_torch.ops import fused
    verts, faces, cache = mesh_and_cache
    kw = dict(use_pallas_fused=True)
    jmodel = JaxDiffusionNet(**ARCH, **kw, last_activation=jax.nn.log_softmax)
    _, flat = _jax_flat_params("vertices")
    want = JaxInferenceSession(jmodel, _unflatten_params(flat), k_eig=K_EIG,
                               op_cache_dir=cache)(verts, faces)
    model = DiffusionNet(**ARCH, **kw, last_activation=functools.partial(
        torch.log_softmax, dim=-1))
    calls = []
    real = fused._SpectralProject.apply
    monkeypatch.setattr(fused._SpectralProject, "apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    got = InferenceSession(model, flat, k_eig=K_EIG, op_cache_dir=cache,
                           device="cpu")(verts, faces)
    assert calls == [(1, 1024, WIDTH)] * N_BLOCK
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
