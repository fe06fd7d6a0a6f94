"""The functional-maps head against the JAX package on the CPU (both at full
matmul precision): `compute_fmap`, `FunctionalMapCorrespondence` on bridged
weights, and the `feature_extractor` keys through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffusionnet_tpu.models.fmaps import (
    FunctionalMapCorrespondence as JaxFMC, compute_fmap as jax_compute_fmap)
from diffusionnet_tpu.serving.export import _flatten_params
from diffusionnet_tpu_torch.geometry import compute_operators, pad_operators
from diffusionnet_tpu_torch.models import (FunctionalMapCorrespondence,
                                           compute_fmap, from_flat_jax_params,
                                           to_flat_jax_params)
from tests.meshgen import icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


def test_compute_fmap_matches_jax():
    """K 30, 3 pairs, 64 feature channels (more than K, as the head's 128
    are, so A A^T has full rank): the batched regularised solve within rtol
    1e-4 (atol 1e-5 of the map's largest entry): f32 solves of the same
    systems."""
    rs = np.random.RandomState(0)
    B, V, C, K = 3, 200, 64, 30
    fx, fy = (rs.randn(B, V, C).astype(np.float32) for _ in range(2))
    ex, ey = (np.sort(rs.rand(B, K) * 40, -1).astype(np.float32)
              for _ in range(2))
    tx, ty = ((rs.randn(B, K, V) / np.sqrt(V)).astype(np.float32)
              for _ in range(2))
    args = (fx, fy, ex, ey, tx, ty)
    want = np.asarray(jax_compute_fmap(*map(jnp.asarray, args)))
    got = compute_fmap(*map(torch.from_numpy, args))[0].numpy()
    assert got.shape == (B, K, K)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _shape(v, faces, k, v_pad, jax_side):
    ops = pad_operators(compute_operators(v, faces, k_eig=k,
                                          eigensolver="host"), v_pad)
    x = np.pad(v.astype(np.float32), ((0, v_pad - v.shape[0]), (0, 0)))
    arrs = dict(features=x, mass=ops.mass, evals=ops.evals, evecs=ops.evecs,
                gradX=ops.gradX_spec, gradY=ops.gradY_spec, L=None)
    if jax_side:
        return {k: None if a is None else jnp.asarray(a)
                for k, a in arrs.items()}
    return {k: None if a is None else torch.from_numpy(a)
            for k, a in arrs.items()}


def test_fmap_head_matches_jax_and_bridges_weights():
    """The head on bridged weights: the functional map and both feature
    sets within rtol 1e-4 (atol 1e-5 of the largest); width 32 > n_fmap,
    else the features' spectral coefficients have too low a rank and the
    map's systems are singular up to the regulariser. The JAX tree's
    params/feature_extractor/... keys load into the port and come back
    bit-equal."""
    verts, faces = icosphere(2)
    k, n_fmap, v_pad = 32, 20, 256
    sx = [_shape(verts, faces, k, v_pad, s) for s in (True, False)]
    sy = [_shape(verts * np.asarray([1.0, 0.8, 1.2]), faces, k, v_pad, s)
          for s in (True, False)]
    jmodel = JaxFMC(c_in=3, c_out=32, c_width=32, n_block=2, n_fmap=n_fmap)
    params = jmodel.init(jax.random.PRNGKey(0), sx[0], sy[0])
    flat = _flatten_params(jax.tree.map(np.asarray, params))
    assert all(key.startswith("params/feature_extractor/") for key in flat)
    rs = np.random.RandomState(3)
    for key in flat:
        if key.endswith("diffusion_time"):
            flat[key] = (rs.rand(*flat[key].shape) * 0.05).astype(np.float32)
    from diffusionnet_tpu.serving.export import _unflatten_params
    want = jmodel.apply(_unflatten_params(flat), sx[0], sy[0])

    model = FunctionalMapCorrespondence(c_in=3, c_out=32, c_width=32,
                                        n_block=2, n_fmap=n_fmap)
    model.load_state_dict(from_flat_jax_params(flat))
    back = to_flat_jax_params(model)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    with torch.no_grad():
        got = model(sx[1], sy[1])
    assert got[0].shape == (n_fmap, n_fmap)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
