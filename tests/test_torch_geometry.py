"""Port's host precompute against the JAX package: operators, cache keys,
the shared disk cache, and padding."""

import numpy as np
import pytest

import diffusionnet_tpu.geometry as jgeo
import diffusionnet_tpu.utils as jutils
import diffusionnet_tpu_torch.geometry as tgeo
import diffusionnet_tpu_torch.utils as tutils
from tests.meshgen import flat_grid, icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("frames", "mass", "evals", "evecs", "gradX_spec", "gradY_spec")


def _assert_ops_equal(a, b, atol):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=atol, err_msg=f)
    for f in ("L", "gradX", "gradY"):
        np.testing.assert_array_equal(getattr(a, f).idx, getattr(b, f).idx)
        np.testing.assert_allclose(getattr(a, f).val, getattr(b, f).val,
                                   rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("mesh", ["icosphere3", "flat_grid16"])
def test_compute_operators_matches_jax(mesh):
    """Same host pipeline, seeded ARPACK: equal to 1e-6."""
    verts, faces = icosphere(3) if mesh == "icosphere3" else flat_grid(16)
    j = jgeo.compute_operators(verts, faces, k_eig=16, eigensolver="host")
    t = tgeo.compute_operators(verts, faces, k_eig=16, eigensolver="host")
    _assert_ops_equal(t, j, atol=1e-6)


def test_hash_arrays_identical():
    rs = np.random.RandomState(3)
    arrs = (rs.randn(50, 3).astype(np.float32),
            rs.randint(0, 50, (30, 3)).astype(np.int64))
    assert tutils.hash_arrays(arrs) == jutils.hash_arrays(arrs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_operator_cache_shared(tmp_path, writer):
    """A cache entry written by one package is a hit for the other."""
    verts, faces = icosphere(2)
    first, second = (jgeo, tgeo) if writer == "jax" else (tgeo, jgeo)
    written = first.get_operators(verts, faces, k_eig=12,
                                  op_cache_dir=str(tmp_path),
                                  eigensolver="host")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1
    # a miss would recompute; truncation on load shows it was read
    read = second.get_operators(verts, faces, k_eig=8,
                                op_cache_dir=str(tmp_path),
                                eigensolver="host")
    assert sorted(p.name for p in tmp_path.iterdir()) == files
    assert read.evecs.shape == (verts.shape[0], 8)
    np.testing.assert_array_equal(read.evecs, written.evecs[:, :8])
    np.testing.assert_array_equal(read.gradX_spec, written.gradX_spec[:, :8])
    np.testing.assert_array_equal(read.mass, written.mass)


def test_pad_operators_matches_jax():
    verts, faces = flat_grid(12)
    t = tgeo.compute_operators(verts, faces, k_eig=10, eigensolver="host")
    j = jgeo.compute_operators(verts, faces, k_eig=10, eigensolver="host")
    tp = tgeo.pad_operators(t, 256, k_eig=12, d_max_l=12, d_max_grad=12)
    jp = jgeo.pad_operators(j, 256, k_eig=12, d_max_l=12, d_max_grad=12)
    assert tp.evecs.shape == (256, 12) and tp.L.idx.shape == (256, 12)
    _assert_ops_equal(tp, jp, atol=1e-6)
    assert not tp.mass[verts.shape[0]:].any()
