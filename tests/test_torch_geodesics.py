"""Geodesics in the port against the JAX package on the CPU: every method
of get_all_pairs_geodesic_distance (exact/ich, steiner, graph and the host
heat method to 1e-10 of the diameter; heat_device in f32 to 1e-4 of it), the
exact solver's Steiner patching and the record of which method ran, the
shared SHA1 geodesic cache, geodesic_label_errors, and the device heat
solver's blocks against the host heat method."""

import numpy as np
import pytest

import diffusionnet_tpu.geometry as jgeo
import diffusionnet_tpu_torch.geometry as tgeo
from diffusionnet_tpu import native as jnative
from diffusionnet_tpu_torch import native as tnative
from tests.meshgen import flat_grid, icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

MESHES = {"icosphere2": lambda: icosphere(2),
          "grid": lambda: flat_grid(12, jitter=0.2)}


@pytest.mark.parametrize("method", ["exact", "ich", "steiner", "graph",
                                    "heat"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_host_methods_match_jax(mesh, method):
    """The same native library and the same scipy factorizations: within
    1e-10 of the diameter; info names the method that ran."""
    v, f = MESHES[mesh]()
    info = {}
    t = tgeo.get_all_pairs_geodesic_distance(v, f, method=method, info=info)
    j = jgeo.get_all_pairs_geodesic_distance(v, f, method=method)
    assert t.shape == (v.shape[0],) * 2
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-10 * j.max())
    assert info["ran"] == ("exact" if method == "ich" else method)
    assert info["cached"] is False


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_heat_device_on_cpu_matches_jax(mesh):
    """The device heat method in f32 on the CPU against JAX's (f32, highest
    precision): within 1e-4 of the diameter."""
    v, f = MESHES[mesh]()
    t = tgeo.get_all_pairs_geodesic_distance(v, f, method="heat_device",
                                             device="cpu")
    j = jgeo.get_all_pairs_geodesic_distance(v, f, method="heat_device")
    assert np.abs(t - j).max() / j.max() < 1e-4


def test_device_heat_solver_blocks_match_host_heat():
    """tests/test_geometry.py's check on the port: icosphere(3), source
    blocks of 256 (< V), against the host solver at the same diffusion time,
    within 1e-3 of the diameter; and against analytic sphere distances."""
    v, f = icosphere(3)
    src = np.arange(v.shape[0])
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    h = np.linalg.norm(v[edges[:, 0]] - v[edges[:, 1]], axis=1).mean()
    diam = np.linalg.norm(v.max(axis=0) - v.min(axis=0))
    t_eff = max(h * h, (diam / 60.0) ** 2)
    d_host = tgeo.HeatMethodSolver(v, f, t_coef=t_eff / (h * h)).distance(src)
    d_dev = tgeo.DeviceHeatMethodSolver(v, f, source_block=256,
                                        device="cpu").distance(src)
    assert d_dev.dtype == np.float32 and d_dev.shape == d_host.shape
    assert np.abs(d_host - d_dev).max() / d_host.max() < 1e-3
    u = v / np.linalg.norm(v, axis=1, keepdims=True)
    ana = np.arccos(np.clip(u @ u.T, -1, 1))
    nz = ana > 0.2
    assert np.abs(d_dev - ana)[nz].max() / ana.max() < 0.03
    # the heat method on the host equals JAX's bit for bit
    np.testing.assert_array_equal(
        d_host, jgeo.HeatMethodSolver(v, f, t_coef=t_eff / (h * h))
        .distance(src))


def test_exact_patching_is_recorded_and_matches_jax():
    """A window budget too small for some sources: their rows are
    recomputed on the Steiner graph (k 8), as the JAX package does, and
    info lists them; without patching it raises."""
    v, f = icosphere(2)
    src = np.arange(v.shape[0])
    info = {}
    t = tnative.exact_geodesics_native(v, f, src, window_budget=400,
                                       patch_failures=True, info=info)
    j = jnative.exact_geodesics_native(v, f, src, window_budget=400,
                                       patch_failures=True)
    np.testing.assert_array_equal(t, j)
    assert 0 < len(info["patched_sources"]) <= len(src)
    with pytest.raises(RuntimeError, match="window budget"):
        tnative.exact_geodesics_native(v, f, src, window_budget=400)


def test_exact_on_a_nonmanifold_mesh_records_steiner():
    """The exact solver refuses a non-manifold mesh; the table then comes
    from the Steiner graph over the whole mesh (JAX's documented path), and
    info says so."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0], [0.5, -1, 0],
                  [0.5, 0, 1]], np.float64)
    f = np.array([[0, 1, 2], [1, 0, 3], [0, 1, 4]])
    info = {}
    t = tgeo.get_all_pairs_geodesic_distance(v, f, method="exact",
                                             info=info)
    j = jgeo.get_all_pairs_geodesic_distance(v, f, method="exact")
    np.testing.assert_array_equal(t, j)
    assert info["ran"] == "steiner" and "exact_error" in info


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_geodesic_cache_shared(tmp_path, writer):
    """An entry written by either package is a hit for the other (same
    SHA1 key, probing and fields); a hit returns the stored table."""
    v, f = icosphere(2)
    first, second = (jgeo, tgeo) if writer == "jax" else (tgeo, jgeo)
    written = first.get_all_pairs_geodesic_distance(
        v, f, geodesic_cache_dir=str(tmp_path), method="steiner")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1
    z = np.load(tmp_path / files[0])
    # overwrite the stored table: a hit returns it, a miss would not
    marked = written + 1.0
    np.savez(tmp_path / files[0], **{k: z[k] for k in z.files if k != "dist"},
             dist=marked)
    kw = {"info": {}} if second is tgeo else {}
    read = second.get_all_pairs_geodesic_distance(
        v, f, geodesic_cache_dir=str(tmp_path), method="steiner", **kw)
    np.testing.assert_array_equal(read, marked)
    assert sorted(p.name for p in tmp_path.iterdir()) == files
    if second is tgeo:
        assert kw["info"]["cached"] and kw["info"]["ran"] is None
    else:
        assert str(z["ran"]) == "steiner"


@pytest.mark.parametrize("normalization", ["diameter", "area"])
def test_geodesic_label_errors_match_jax(normalization):
    v, f = icosphere(2)
    rs = np.random.RandomState(0)
    pred, gt = rs.randint(0, v.shape[0], (2, 50))
    t = tgeo.geodesic_label_errors(v, f, pred, gt,
                                   normalization=normalization,
                                   method="graph")
    j = jgeo.geodesic_label_errors(v, f, pred, gt,
                                   normalization=normalization,
                                   method="graph")
    np.testing.assert_allclose(t, j, rtol=1e-12)
    with pytest.raises(ValueError, match="unknown geodesic method"):
        tgeo.get_all_pairs_geodesic_distance(v, f, method="mmp")
