"""Point clouds in the port against the JAX package on the CPU: the native
host library (sources, build, kNN, the cloud triangle soup, the CSR SpMM),
the host kNN and `find_knn(method="cpu_kd")`, cloud normals and the cloud
gradient, the point-cloud, robust and tufted Laplacians, the cloud branch
of `compute_operators` (host ARPACK and the device solver on the CPU), the
shared operator cache for clouds, and the refusals: a failed native build
raises and nothing falls back."""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusionnet_tpu.geometry as jgeo
import diffusionnet_tpu_torch.geometry as tgeo
from diffusionnet_tpu import native as jnative
from diffusionnet_tpu.geometry import point_cloud as jpc
from diffusionnet_tpu.ops.knn import find_knn as jax_find_knn
from diffusionnet_tpu_torch import native as tnative
from diffusionnet_tpu_torch.geometry import knn_host as tknn
from diffusionnet_tpu_torch.geometry import point_cloud as tpc
from diffusionnet_tpu_torch.native import build as tbuild
from diffusionnet_tpu_torch.ops.knn import find_knn
from tests.meshgen import flat_grid, icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")


def _cloud(sub=3, seed=0, jitter=0.01):
    v, _ = icosphere(sub)
    return v + jitter * np.random.RandomState(seed).randn(*v.shape)


def _grid_points():
    """A flat grid with its z set to 0: equal distances everywhere."""
    v, _ = flat_grid(8)
    return np.asarray(v, np.float64)


def _assert_sparse_close(a, b, rtol):
    a, b = a.tocsc(), b.tocsc()
    a.sum_duplicates()
    b.sum_duplicates()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=0,
                               atol=rtol * np.abs(b.data).max())


def test_native_sources_are_the_jax_packages():
    """The port's C++ is the JAX package's, byte for byte, so both
    libraries built with the same flags compute the same bits."""
    here = os.path.dirname(tbuild.__file__)
    there = os.path.dirname(jnative.build.__file__)
    for name in ("dnet_native.cpp", "ich_geodesics.cpp"):
        assert filecmp.cmp(os.path.join(here, name),
                           os.path.join(there, name), shallow=False), name
    so = tbuild.build()
    assert so.parent == tbuild.BUILD_DIR and so.name.startswith("libdnt_host_")
    assert not [n for n in os.listdir(here) if n.endswith(".so")]


@pytest.mark.parametrize("points", ["jittered", "grid"])
@pytest.mark.parametrize("k", [1, 8, 31])
def test_knn_native_bit_equal_to_jax_native(points, k):
    """The native KD-tree of both packages, ties included (the grid)."""
    p = _cloud(2) if points == "jittered" else _grid_points()
    q = p[::3] + 0.1
    for tgt, src in ((p, p), (p, q)):
        dt, it = tnative.knn_native(tgt, src, k)
        dj, ij = jnative.knn_native(tgt, src, k)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("omit_diagonal", [False, True])
def test_find_knn_host_matches_jax_and_ckdtree(omit_diagonal):
    """find_knn_host against JAX's (its native path, bit-equal, a duplicate
    point included) and, on jittered points (no ties), against the cKDTree
    oracle to 1e-12."""
    p = _cloud(2)
    p_dup = p.copy()
    p_dup[5] = p_dup[17]
    for pts in (p, p_dup):
        dt, it = tgeo.find_knn_host(pts, pts, 12, omit_diagonal=omit_diagonal)
        dj, ij = jgeo.find_knn_host(pts, pts, 12, omit_diagonal=omit_diagonal)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(it, ij)
    do, io = tknn.find_knn_ckdtree(p, p, 12, omit_diagonal=omit_diagonal)
    dt, it = tgeo.find_knn_host(p, p, 12, omit_diagonal=omit_diagonal)
    np.testing.assert_array_equal(it, io)
    np.testing.assert_allclose(dt, do, rtol=1e-12)
    with pytest.warns(UserWarning, match="exceeds"):
        d, _ = tgeo.find_knn_host(p[:5], p[:5], 9, omit_diagonal=True)
    assert d.shape == (5, 4)


@pytest.mark.parametrize("omit_diagonal", [False, True])
def test_find_knn_cpu_kd_matches_jax(omit_diagonal):
    """ops.find_knn(method='cpu_kd') (lifted refusal) against JAX's: f32
    distances and int64 indices bit-equal; largest is refused."""
    p = _cloud(2).astype(np.float32)
    q = p[:40] * 1.01
    for src, tgt in ((p, p), (q, p)) if not omit_diagonal else ((p, p),):
        d, i = find_knn(torch.from_numpy(src), torch.from_numpy(tgt), 7,
                        omit_diagonal=omit_diagonal, method="cpu_kd")
        dj, ij = jax_find_knn(jnp.asarray(src), jnp.asarray(tgt), 7,
                              omit_diagonal=omit_diagonal, method="cpu_kd")
        assert d.dtype == torch.float32 and i.dtype == torch.int64
        np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    with pytest.raises(ValueError, match="largest"):
        find_knn(torch.from_numpy(p), torch.from_numpy(p), 3, largest=True,
                 method="cpu_kd")


def test_cloud_triangles_sorted_unique_repeatable_and_jax_equal():
    """The threaded soup: rows sorted and unique, each triangle sorted,
    bit-equal over two calls and to the JAX package's."""
    p = _cloud(3)
    a = tnative.cloud_triangles_native(p, k=30)
    b = tnative.cloud_triangles_native(p, k=30)
    np.testing.assert_array_equal(a, b)
    assert a.shape[0] > 0 and (np.diff(a, axis=1) > 0).all()
    assert np.unique(a, axis=0).shape == a.shape
    keys = a[:, 0] * p.shape[0] ** 2 + a[:, 1] * p.shape[0] + a[:, 2]
    assert (np.diff(keys) > 0).all()
    np.testing.assert_array_equal(a, jnative.cloud_triangles_native(p, k=30))


def test_local_triangles_oracle_matches_jax():
    """The Python triangulation kept as the oracle: equal to JAX's."""
    p = _cloud(2)
    np.testing.assert_array_equal(tpc._local_triangles(p, 12),
                                  jpc._local_triangles(p, 12))


def test_csr_spmm_native_matches_scipy_and_jax():
    """The threaded CSR SpMM (bound, not wired into the polish) against
    scipy to 1e-12 and bit-equal to the JAX package's; a CSC input is
    converted, not read as CSR."""
    v, f = icosphere(3)
    A = tgeo.cotan_laplacian(v, f).tocsr()
    B = np.random.RandomState(1).randn(A.shape[0], 37)
    got = tnative.csr_spmm_native(A, B, n_threads=4)
    np.testing.assert_allclose(got, A @ B, rtol=0,
                               atol=1e-12 * np.abs(A @ B).max())
    np.testing.assert_array_equal(got, jnative.csr_spmm_native(A, B, 4))
    np.testing.assert_array_equal(tnative.csr_spmm_native(A.tocsc(), B, 4),
                                  got)


@pytest.mark.parametrize("intrinsic_delaunay", [False, True])
def test_point_cloud_laplacian_matches_jax(intrinsic_delaunay):
    """L and mass to 1e-12 relative (f64)."""
    p = _cloud(3)
    Lt, mt = tgeo.point_cloud_laplacian(
        p, intrinsic_delaunay=intrinsic_delaunay)
    Lj, mj = jgeo.point_cloud_laplacian(
        p, intrinsic_delaunay=intrinsic_delaunay)
    _assert_sparse_close(Lt, Lj, 1e-12)
    np.testing.assert_allclose(mt, mj, rtol=1e-12)


def _soups():
    """The soups of tests/test_tufted.py."""
    verts, faces = icosphere(2)
    yield "ico_soup", verts, np.concatenate([faces, faces[:7, ::-1]])
    v, f = flat_grid(n=24, jitter=0.2)
    v = np.asarray(v, np.float64).copy()
    v[:, 0] *= 6.0
    yield "skinny_grid", v, f
    yield "bowtie", np.array([[0, 0, 0], [1, 0, 0], [0.5, 1, 0],
                              [0.5, -1, 0], [0.5, 0, 1]], np.float64), \
        np.array([[0, 1, 2], [1, 0, 3], [0, 1, 4]])
    for seed in (0, 4, 7):
        rs = np.random.RandomState(seed)
        V, F = rs.randint(5, 40), rs.randint(2, 60)
        v = rs.randn(V, 3)
        if seed % 3 == 0:
            v[:, 2] *= 1e-3
        if seed % 4 == 0:
            v[rs.randint(V)] = v[rs.randint(V)]
        yield f"fuzz{seed}", v, rs.randint(0, V, size=(F, 3))


@pytest.mark.parametrize("name,verts,faces", list(_soups()),
                         ids=[s[0] for s in _soups()])
def test_robust_and_tufted_laplacians_match_jax(name, verts, faces):
    """mesh_laplacian_robust (plain and intrinsic Delaunay) and
    tufted_laplacian with and without flips: L and mass to 1e-12
    relative."""
    for fn_t, fn_j, kw in (
            (tgeo.mesh_laplacian_robust, jgeo.mesh_laplacian_robust, {}),
            (tgeo.mesh_laplacian_robust, jgeo.mesh_laplacian_robust,
             dict(intrinsic_delaunay=True)),
            (tgeo.tufted_laplacian, jgeo.tufted_laplacian, dict(flip=False)),
            (tgeo.tufted_laplacian, jgeo.tufted_laplacian, dict(flip=True))):
        Lt, mt = fn_t(verts, faces, **kw)
        Lj, mj = fn_j(verts, faces, **kw)
        _assert_sparse_close(Lt, Lj, 1e-12)
        np.testing.assert_allclose(mt, mj, rtol=1e-12, err_msg=str(kw))


def test_cloud_normals_and_gradient_match_jax():
    """vertex_normals_np and build_grad_point_cloud on a cloud (both lifted
    refusals) against JAX's: the same kNN, so 1e-12."""
    p = _cloud(3)
    nt = tgeo.vertex_normals_np(p, None)
    nj = jgeo.vertex_normals_np(p, None)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-12)
    frames = tgeo.build_tangent_frames_np(p, None)
    np.testing.assert_allclose(frames, jgeo.build_tangent_frames_np(p, None),
                               rtol=0, atol=1e-12)
    Gt = tgeo.build_grad_point_cloud(p, frames)
    Gj = jgeo.build_grad_point_cloud(p, frames)
    d = abs(Gt - Gj)
    assert d.max() <= 1e-12 * abs(Gj).max()


def _align_signs(E, ref):
    s = np.sign(np.sum(E * ref, axis=0))
    s[s == 0] = 1
    return E * s


def test_cloud_operators_host_match_jax():
    """compute_operators on a jittered icosphere(3) cloud with host ARPACK
    (seeded): frames, mass, L, gradients and spectral gradients to 1e-6 as
    tests/test_torch_geometry.py holds meshes, evecs after sign
    alignment; the stage timings name the triangulation."""
    p = _cloud(3)
    timings = {}
    t = tgeo.compute_operators(p, None, k_eig=16, eigensolver="host",
                               timings=timings)
    j = jgeo.compute_operators(p, None, k_eig=16, eigensolver="host")
    assert {"frames", "triangulation", "laplacian", "eigensolve",
            "build_grad"} <= set(timings)
    for f in ("frames", "mass", "evals"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=0,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(_align_signs(t.evecs, j.evecs), j.evecs,
                               rtol=0, atol=1e-6)
    s = np.sign(np.sum(t.evecs * j.evecs, axis=0))
    for f in ("gradX_spec", "gradY_spec"):
        np.testing.assert_allclose(getattr(t, f) * s, getattr(j, f), rtol=0,
                                   atol=1e-6, err_msg=f)
    for f in ("L", "gradX", "gradY"):
        np.testing.assert_array_equal(getattr(t, f).idx, getattr(j, f).idx)
        np.testing.assert_allclose(getattr(t, f).val, getattr(j, f).val,
                                   rtol=0, atol=1e-6, err_msg=f)


def test_cloud_operators_device_solver_on_cpu_against_arpack():
    """The device solver on the CPU for the cloud, against host ARPACK, as
    tests/test_torch_eigen_device.py holds meshes: evals within 1e-4 of
    the largest, heat diffusion of random signals within 1e-4."""
    p = _cloud(3)
    K = 16
    d = tgeo.compute_operators(p, None, k_eig=K, eigensolver="device",
                               device="cpu")
    h = tgeo.compute_operators(p, None, k_eig=K, eigensolver="host")
    scale = max(float(np.max(h.evals)), 1.0)
    np.testing.assert_allclose(d.evals, h.evals, atol=1e-4 * scale)
    ev_d, ev_h = (np.asarray(a, np.float64) for a in (d.evals, h.evals))
    E_d, E_h = (np.asarray(a, np.float64) for a in (d.evecs, h.evecs))
    mass = np.asarray(h.mass, np.float64)
    x = np.random.RandomState(0).randn(len(mass), 4)
    for tt in np.asarray([12.0, 24.0, 48.0]) / ev_h[K - 1]:
        dh = E_h @ (np.exp(-ev_h * tt)[:, None] * (E_h.T @ (mass[:, None] * x)))
        dd = E_d @ (np.exp(-ev_d * tt)[:, None] * (E_d.T @ (mass[:, None] * x)))
        assert np.abs(dd - dh).max() / np.abs(dh).max() <= 1e-4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cloud_operator_cache_shared(tmp_path, writer):
    """get_operators(faces=None): the same key and npz layout as the JAX
    package, so an entry written by one is a hit for the other."""
    p = _cloud(2).astype(np.float32)
    first, second = (jgeo, tgeo) if writer == "jax" else (tgeo, jgeo)
    written = first.get_operators(p, None, k_eig=12,
                                  op_cache_dir=str(tmp_path),
                                  eigensolver="host")
    files = sorted(x.name for x in tmp_path.iterdir())
    assert len(files) == 1
    read = second.get_operators(p, None, k_eig=8,
                                op_cache_dir=str(tmp_path),
                                eigensolver="host")
    assert sorted(x.name for x in tmp_path.iterdir()) == files
    np.testing.assert_array_equal(read.evecs, written.evecs[:, :8])
    np.testing.assert_array_equal(read.gradX.val, written.gradX.val)
    np.testing.assert_array_equal(read.mass, written.mass)


def test_dataset_precompute_of_a_cloud_with_normals():
    """SurfaceDataset with faces=None and given normals (the E5 cloud
    flow): the frames carry those normals, and the operators equal JAX's."""
    from diffusionnet_tpu.data import SurfaceDataset as JDS
    from diffusionnet_tpu_torch.data import SurfaceDataset as TDS
    v, f = icosphere(3)
    normals = tgeo.mesh_vertex_normals_np(v, f)
    out = []
    for DS in (TDS, JDS):
        ds = DS(labels_kind="vertex")
        ds.add(v, None, np.zeros(v.shape[0], np.int32))
        ds.precompute(k_eig=8, verbose=False, normals_list=[normals],
                      eigensolver="host")
        out.append(ds.ops_list[0])
    np.testing.assert_allclose(out[0].frames[:, 2], normals, atol=1e-6)
    np.testing.assert_allclose(out[0].frames, out[1].frames, atol=1e-6)
    np.testing.assert_allclose(out[0].gradX_spec, out[1].gradX_spec,
                               atol=1e-5)


def test_failed_native_build_raises_and_nothing_falls_back(tmp_path,
                                                           monkeypatch):
    """A compiler that fails raises with its output; with the library
    unbuildable, kNN, cloud normals, the cloud Laplacian and the cloud
    operators all raise (no scipy or Python triangulation behind them)."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'fake compiler refuses' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        tbuild.build(cxx=str(fake))
    with pytest.raises(RuntimeError, match="cannot run"):
        tbuild.build(cxx=str(tmp_path / "no-such-g++"))

    monkeypatch.setattr(tbuild, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))   # only the failing g++
    p = _cloud(2)
    for call in (lambda: tgeo.find_knn_host(p, p, 4),
                 lambda: tgeo.vertex_normals_np(p, None),
                 lambda: tgeo.point_cloud_laplacian(p),
                 lambda: tgeo.compute_operators(p, None, k_eig=4,
                                                eigensolver="host"),
                 lambda: find_knn(torch.from_numpy(p), torch.from_numpy(p),
                                  3, method="cpu_kd")):
        with pytest.raises(RuntimeError, match="build failed"):
            call()
