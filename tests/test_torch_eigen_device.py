"""The port's device eigensolver (geometry/eigen.py::eigensolve_device) on
the CPU against the JAX package's and against host ARPACK.

Routes: the sliced-ELL SpMM (B5's plain version here; the JAX package's
blocked-ELL panels on its side) and the ELL gather.
Tolerances: eigenvalues within 1e-6 of the largest, relative; M-weighted
principal angles on a cluster-closed cut within 1e-8 (both after the f64
polish, as tests/test_blocked_ell.py holds the JAX solver); one sweep fed
the same start block gives Ritz values within rtol 1e-5 (f32 sweeps whose
sums run in another order)."""

import warnings

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp
import diffusionnet_tpu.geometry as jgeo
from diffusionnet_tpu.geometry import eigen as jeig
from diffusionnet_tpu.ops import blocked_ell as jbe
from diffusionnet_tpu.ops.sparse import Ell as JaxEll
from diffusionnet_tpu_torch.data import SurfaceDataset
from diffusionnet_tpu_torch.geometry import eigen as teig
from diffusionnet_tpu_torch.geometry import operators as tops
from diffusionnet_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                      vertex_areas)
from diffusionnet_tpu_torch.ops import blocked_ell as tbe
from diffusionnet_tpu_torch.ops.sparse import ell_from_coo
from tests.meshgen import icosphere, torus

torch.set_float32_matmul_precision("highest")

K = 16
EPS = 1e-8


@pytest.fixture(scope="module")
def ico4():
    """icosphere(4), 2562 vertices: above the dense-eigh gate at k=16."""
    v, f = icosphere(4)
    L = cotan_laplacian(v, f)
    m = vertex_areas(v, f)
    coo = scipy.sparse.coo_matrix(L)
    ell = ell_from_coo(coo.row, coo.col, coo.data, L.shape[0])
    h, H = teig.eigensolve_host(L, m, K)
    return L, m, ell, h, H


def _principal_angle_err(A, B, m, kk=9):
    """max |s - 1| over the singular values of A^T M B on the first kk
    columns (sphere multiplets 1 + 3 + 5: a cut at a spectral gap)."""
    s = np.linalg.svd(np.asarray(A)[:, :kk].T @ (m[:, None] * B[:, :kk]),
                      compute_uv=False)
    return np.abs(s - 1).max()


def test_solver_setup_matches_jax(ico4):
    L, m, ell, _, _ = ico4
    mass = m.astype(np.float32)
    for n_valid in (None, 2500):
        got = teig._device_solver_setup(ell, mass, K, n_valid, EPS, None,
                                        None)
        want = jeig._device_solver_setup(ell, mass, K, n_valid, EPS, None,
                                         None)
        np.testing.assert_array_equal(got[0], want[0])       # mask
        np.testing.assert_array_equal(got[1], want[1])       # inv_sqrt_m
        np.testing.assert_allclose(got[2], want[2], rtol=1e-7)  # bound
        assert got[3:5] == want[3:5]                         # n_cols, over
        np.testing.assert_allclose(got[5], want[5], rtol=1e-7)  # lambda_cut


def _jax_blocked_route(b, imp, mkp, bound, degree):
    fmt = (jnp.asarray(b.blocks), jnp.asarray(b.offs), jnp.asarray(b.starts),
           jnp.asarray(b.ov_rows), jnp.asarray(b.ov_cols),
           jnp.asarray(b.ov_vals))
    ww, npx = int(b.w_window), int(b.n_pad_x)
    imp_j, mkp_j = jnp.asarray(imp), jnp.asarray(mkp)
    bj, ej = jnp.float32(bound), jnp.float32(EPS)
    return (lambda X, lo: jeig._dev_filter_gram_blocked(
                *fmt, ww, npx, imp_j, mkp_j, X, lo, bj, ej, degree),
            lambda Y, F: jeig._dev_rotate_apply_blocked(
                *fmt, ww, npx, imp_j, mkp_j, bj, ej, Y, F))


@pytest.mark.parametrize("route", ["blocked", "ell"])
def test_one_sweep_same_start_block_matches_jax(ico4, route):
    """_split_sweep of both packages from one numpy start block X0: Ritz
    values within rtol 1e-5; residual norms within 1e-3 of the largest
    (each is an f32 difference W S - U w of nearly equal terms)."""
    L, m, ell, _, _ = ico4
    mass = m.astype(np.float32)
    mask, ism, bound, n_cols, _, lam = teig._device_solver_setup(
        ell, mass, K, None, EPS, None, None)
    degree = 24
    V = L.shape[0]
    if route == "blocked":
        b = tbe.blocked_ell_from_sparse(L, device="cpu")
        jb = jbe.blocked_ell_from_sparse(L, device=False,
                                         tile_rows=b.tile_rows, perm=b.perm)
        n = b.n_pad
        assert n == jb.n_pad
        imp = np.zeros(n, np.float32)
        imp[:V] = ism[b.perm]
        mkp = np.zeros(n, bool)
        mkp[:V] = mask[b.perm]
        mv = teig._mv_blocked(b, torch.from_numpy(imp), torch.from_numpy(mkp),
                              bound, EPS)
        mk = torch.from_numpy(mkp)
        j_fg, j_ra = _jax_blocked_route(jb, imp, mkp, bound, degree)
    else:
        n = V
        mv = teig._mv_ell(torch.from_numpy(ell.idx), torch.from_numpy(ell.val),
                          torch.from_numpy(ism), torch.from_numpy(mask),
                          bound, EPS)
        mk = torch.from_numpy(mask)
        args = (jnp.asarray(ell.idx), jnp.asarray(ell.val), jnp.asarray(ism),
                jnp.asarray(mask))
        bj, ej = jnp.float32(bound), jnp.float32(EPS)
        j_fg = lambda X, lo: jeig._dev_filter_gram_ell(*args, X, lo, bj, ej,
                                                      degree)
        j_ra = lambda Y, F: jeig._dev_rotate_apply_ell(*args, bj, ej, Y, F)
    X0 = np.random.RandomState(5).randn(n, n_cols).astype(np.float32)
    U, w, res = teig._split_sweep(
        lambda X, lo: teig._dev_filter_gram(mv, mk, X, lo, bound, degree),
        lambda Y, F: teig._dev_rotate_apply(mv, Y, F),
        torch.from_numpy(X0), np.float32(lam))
    Uj, wj, resj = jeig._split_sweep(j_fg, j_ra, jnp.asarray(X0),
                                     jnp.float32(lam))
    assert U.shape == (n, n_cols) and U.dtype == torch.float32
    np.testing.assert_allclose(w, wj, rtol=1e-5)
    resj = np.asarray(resj, np.float64)
    assert np.abs(res - resj).max() <= 1e-3 * resj.max()


@pytest.fixture(scope="module")
def jax_solution(ico4):
    L, m, ell, _, _ = ico4
    return jeig.eigensolve_device(
        JaxEll(jnp.asarray(ell.idx), jnp.asarray(ell.val)),
        jnp.asarray(m, jnp.float32), K, banded="blocked",
        polish=(L, np.asarray(m, np.float64)))


@pytest.mark.parametrize("banded", ["blocked", False])
def test_whole_solve_matches_jax_and_arpack(ico4, jax_solution, banded):
    L, m, ell, h, H = ico4
    tbe.reset_launches()
    ev, E = teig.eigensolve_device(ell, m.astype(np.float32), K,
                                   banded=banded,
                                   polish=(L, np.asarray(m, np.float64)),
                                   device="cpu")
    assert tbe.LAUNCHES == {"blocked_ell": 0}
    assert teig.LAST_CONVERGE_INFO["name"] == (
        "eigensolve_device[blocked]" if banded else "eigensolve_device")
    ev_j, E_j = (np.asarray(a) for a in jax_solution)
    assert E.shape == (L.shape[0], K) and E.dtype == np.float64
    assert np.abs(ev - h).max() / h.max() < 1e-6
    assert np.abs(ev - ev_j).max() / ev_j.max() < 1e-6
    assert _principal_angle_err(E, H, m) < 1e-8
    assert _principal_angle_err(E, E_j, m) < 1e-8


def test_no_polish_returns_tensors_on_the_device(ico4):
    """Without the polish: f32 tensors on the requested device, evals
    within 1e-4 of the largest (the f32 noise floor of the sweeps)."""
    L, m, ell, h, _ = ico4
    ev, E = teig.eigensolve_device(ell, m.astype(np.float32), K,
                                   device="cpu")
    assert ev.dtype == E.dtype == torch.float32
    assert E.device.type == "cpu" and E.shape == (L.shape[0], K)
    assert np.abs(ev.numpy() - h).max() / h.max() < 1e-4


def test_tiny_dense_route_matches_jax():
    """icosphere(2), 162 vertices: the dense f64 eigh route."""
    v, f = icosphere(2)
    L = cotan_laplacian(v, f)
    m = vertex_areas(v, f)
    coo = scipy.sparse.coo_matrix(L)
    ell = ell_from_coo(coo.row, coo.col, coo.data, L.shape[0])
    pol = (L, np.asarray(m, np.float64))
    ev, E = teig.eigensolve_device(ell, m.astype(np.float32), K, polish=pol,
                                   device="cpu")
    ev_j, _ = jeig.eigensolve_device(
        JaxEll(jnp.asarray(ell.idx), jnp.asarray(ell.val)),
        jnp.asarray(m, jnp.float32), K, polish=pol)
    h, H = teig.eigensolve_host(L, m, K)
    np.testing.assert_allclose(ev, np.asarray(ev_j), rtol=0,
                               atol=1e-12 * h.max())
    assert np.abs(ev - h).max() / h.max() < 1e-6
    assert _principal_angle_err(E, H, m) < 1e-8


def test_compute_operators_device_matches_jax():
    """The entry point on the CPU against the JAX package's (its ELL route
    on the CPU): evals within 1e-4 of the largest, and the gauge-invariant
    heat-diffusion outputs within 1e-4 (tests/test_eigen_device.py's
    measure: raw eigenvectors of the sphere's multiplets are not unique)."""
    v, f = icosphere(3)
    t = tops.compute_operators(v, f, k_eig=K, eigensolver="device",
                               device="cpu")
    j = jgeo.compute_operators(v, f, k_eig=K, eigensolver="device")
    scale = max(float(np.max(j.evals)), 1.0)
    np.testing.assert_allclose(t.evals, j.evals, atol=1e-4 * scale)
    ev_t, ev_j = (np.asarray(a, np.float64) for a in (t.evals, j.evals))
    E_t, E_j = (np.asarray(a, np.float64) for a in (t.evecs, j.evecs))
    mass = np.asarray(j.mass, np.float64)
    x = np.random.RandomState(0).randn(len(mass), 4)
    for tt in np.asarray([12.0, 24.0, 48.0]) / max(ev_j[K - 1], 1e-12):
        dj = E_j @ (np.exp(-ev_j * tt)[:, None] * (E_j.T @ (mass[:, None] * x)))
        dt = E_t @ (np.exp(-ev_t * tt)[:, None] * (E_t.T @ (mass[:, None] * x)))
        assert np.abs(dt - dj).max() / np.abs(dj).max() <= 1e-4


def test_dataset_precompute_device_eigensolver(tmp_path):
    ds = SurfaceDataset(labels_kind="global")
    for v, f in (icosphere(3), torus(24, 12)):
        ds.add(v, f, 0)
    before = tops.EIGEN_FALLBACKS
    ds.precompute(k_eig=8, op_cache_dir=str(tmp_path), verbose=False,
                  eigensolver="device", device="cpu")
    assert tops.EIGEN_FALLBACKS == before
    for (v, f), ops in zip((icosphere(3), torus(24, 12)), ds.ops_list):
        h, _ = teig.eigensolve_host(cotan_laplacian(v, f),
                                    vertex_areas(v, f) + 1e-8 * np.mean(
                                        vertex_areas(v, f)), 8)
        assert ops.evecs.shape == (v.shape[0], 8)
        assert np.abs(ops.evals - h).max() <= 1e-4 * h.max()


# --- no hidden failure -------------------------------------------------------

def test_non_convergence_falls_back_to_arpack(monkeypatch):
    """The solver's own EigenSolveNotConverged: a warning, the host ladder's
    result, and the fallback counter rises by one."""
    v, f = icosphere(3)

    def no_converge(*a, **kw):
        raise teig.EigenSolveNotConverged("test: forced non-convergence")
    monkeypatch.setattr(teig, "_converge", no_converge)
    before = tops.EIGEN_FALLBACKS
    with pytest.warns(UserWarning, match="falling back"):
        ops = tops.compute_operators(v, f, k_eig=K, device="cpu")
    assert tops.EIGEN_FALLBACKS == before + 1
    host = tops.compute_operators(v, f, k_eig=K, eigensolver="host")
    np.testing.assert_array_equal(ops.evals, host.evals)


def test_max_sweeps_exhausted_raises_not_converged(ico4):
    L, m, ell, _, _ = ico4
    with pytest.raises(teig.EigenSolveNotConverged, match="not converged"):
        teig.eigensolve_device(ell, m.astype(np.float32), K, max_sweeps=1,
                               tol=1e-12, device="cpu")


def test_other_runtime_errors_propagate(monkeypatch):
    """A RuntimeError that is not the solver's own (here from the SpMM, as
    a failed build or launch would raise it) is not caught: no fallback."""
    v, f = icosphere(3)

    def broken(*a, **kw):
        raise RuntimeError("blocked_ell launch failed: test")
    monkeypatch.setattr(teig, "ell_matvec", broken)
    before = tops.EIGEN_FALLBACKS
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="launch failed: test"):
            tops.compute_operators(v, f, k_eig=K, device="cpu")
    assert tops.EIGEN_FALLBACKS == before


@pytest.mark.parametrize("banded", ["blocked", False])
def test_certification_failure_raises_not_converged(ico4, monkeypatch,
                                                    banded):
    """When the f64 certification rejects the basis, the solver's own
    exception leaves eigensolve_device on either route, as in the JAX
    package (compute_operators then falls back to ARPACK); the sweeps ran
    first and converged."""
    L, m, ell, _, _ = ico4
    calls = []

    def reject(*a, **kw):
        calls.append(np.asarray(a[2]).shape)
        raise teig.EigenSolveNotConverged("test: certification failed")
    monkeypatch.setattr(teig, "_rr_polish_host", reject)
    teig.LAST_CONVERGE_INFO.clear()
    with pytest.raises(teig.EigenSolveNotConverged, match="test"):
        teig.eigensolve_device(ell, m.astype(np.float32), K, banded=banded,
                               polish=(L, np.asarray(m, np.float64)),
                               device="cpu")
    assert calls == [(L.shape[0], K + 8)]
    assert teig.LAST_CONVERGE_INFO["name"] == (
        "eigensolve_device[blocked]" if banded else "eigensolve_device")


def test_certification_failure_falls_back_to_arpack(monkeypatch):
    """A certification failure inside compute_operators: a warning naming
    it, the host ladder's result, and the fallback counter rises by one."""
    v, f = icosphere(3)

    def reject(*a, **kw):
        raise teig.EigenSolveNotConverged("f64 certification failed: test")
    monkeypatch.setattr(teig, "_rr_polish_host", reject)
    before = tops.EIGEN_FALLBACKS
    with pytest.warns(UserWarning, match="certification failed: test"):
        ops = tops.compute_operators(v, f, k_eig=K, device="cpu")
    assert tops.EIGEN_FALLBACKS == before + 1
    host = tops.compute_operators(v, f, k_eig=K, eigensolver="host")
    np.testing.assert_array_equal(ops.evals, host.evals)


def test_blocked_required_raises_over_budget(ico4, monkeypatch):
    L, m, ell, _, _ = ico4
    monkeypatch.setattr(teig, "_format_budget", lambda *a: 1000)
    with pytest.raises(RuntimeError, match="blocked"):
        teig.eigensolve_device(ell, m.astype(np.float32), K,
                               banded="blocked", device="cpu")


@pytest.mark.parametrize("banded", [True, "dia"])
def test_unported_formats_raise(ico4, banded):
    L, m, ell, _, _ = ico4
    with pytest.raises(NotImplementedError, match="A.5"):
        teig.eigensolve_device(ell, m.astype(np.float32), K, banded=banded,
                               device="cpu")


def test_solver_restores_matmul_precision(ico4):
    L, m, ell, _, _ = ico4
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        teig.eigensolve_device(ell, m.astype(np.float32), K, device="cpu",
                               cheb_degree=8, max_sweeps=30)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("budget", [2e9, 0.0], ids=["gemm", "spmm"])
def test_polish_matches_jax(ico4, budget):
    """The f64 polish (scipy SpMMs) against the JAX package's on one random
    basis, certification off (a random basis would rightly fail it), with
    and without the certification's kept blocks; and the certification
    raises the solver's own exception on that basis."""
    L, m, _, _, _ = ico4
    Y = np.random.RandomState(3).randn(L.shape[0], K + 8)
    ev, Q = teig._rr_polish_host(L, m, Y, K, EPS, certify_tol=None,
                                 certify_budget=budget)
    ev_j, Q_j = jeig._rr_polish_host(L, m, Y, K, EPS, certify_tol=None)
    np.testing.assert_allclose(ev, ev_j, rtol=1e-10, atol=1e-12)
    assert _principal_angle_err(Q, Q_j, m, kk=4) < 1e-8
    with pytest.raises(teig.EigenSolveNotConverged, match="certification"):
        teig._rr_polish_host(L, m, Y, K, EPS, certify_budget=budget)
