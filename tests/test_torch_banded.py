"""The port's dense RCM band and DIA operator formats (ops/banded.py) and
the device eigensolver's routes on them (eigensolve_device(banded=True |
'dia')) on the CPU against the JAX package's and against host ARPACK.

The planners are the JAX package's numpy: their outputs bit-equal. The
matvecs: within 1e-5 of the largest |y| of JAX's and of scipy's f64
product (f32 sums in another order). The solves, polished: eigenvalues
within 1e-6 of the largest of ARPACK's and of JAX's same-format solve, and
M-weighted principal angles on a cluster-closed cut within 1e-8 (the
single-card tests' measure, tests/test_torch_eigen_device.py)."""

import functools

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp
from diffusionnet_tpu.geometry import eigen as jeig
from diffusionnet_tpu.ops import banded as jbd
from diffusionnet_tpu.ops.sparse import Ell as JaxEll
from diffusionnet_tpu_torch.geometry import eigen as teig
from diffusionnet_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                      vertex_areas)
from diffusionnet_tpu_torch.ops import banded as tbd
from diffusionnet_tpu_torch.ops.sparse import ell_from_coo
from tests.meshgen import icosphere, torus
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

K = 16
EPS = 1e-8


@functools.lru_cache(maxsize=None)
def _mesh(name):
    """(name, L, mass, ell) of icosphere(4) (unstructured, 2562 vertices)
    or torus(40, 30) (a regular grid, 1200 vertices)."""
    v, f = icosphere(4) if name == "ico4" else torus(40, 30)
    L = cotan_laplacian(v, f)
    coo = scipy.sparse.coo_matrix(L)
    ell = ell_from_coo(coo.row, coo.col, coo.data, L.shape[0])
    return name, L, vertex_areas(v, f), ell


@pytest.fixture(scope="module", params=["ico4", "torus"])
def mesh(request):
    return _mesh(request.param)


@pytest.mark.parametrize("tile_rows", [128, 512])
def test_band_plan_bit_equal_to_jax(mesh, tile_rows):
    _, L, _, _ = mesh
    got = tbd._band_plan(L, tile_rows, 2_500_000_000, None, np.float32)
    want = jbd._band_plan(L, tile_rows, 2_500_000_000, None, np.float32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # over budget: both refuse
    assert tbd._band_plan(L, tile_rows, 1000, None, np.float32) is None
    assert jbd._band_plan(L, tile_rows, 1000, None, np.float32) is None


def test_band_formats_bit_equal_to_jax(mesh):
    _, L, _, _ = mesh
    host = tbd.banded_from_sparse(L)
    dev = tbd.banded_from_sparse_device(L, device="cpu")
    want = jbd.banded_from_sparse(L)
    np.testing.assert_array_equal(host.band, want.band)
    np.testing.assert_array_equal(host.starts, want.starts)
    np.testing.assert_array_equal(host.perm, want.perm)
    assert host.n == want.n and host.width == want.width
    assert dev.band.device.type == "cpu"
    np.testing.assert_array_equal(dev.band.numpy(), want.band)
    np.testing.assert_array_equal(dev.starts.numpy(), want.starts)


def test_dia_format_bit_equal_to_jax(mesh):
    name, L, _, _ = mesh
    got, want = tbd.dia_from_sparse(L), jbd.dia_from_sparse(L)
    if name == "ico4":   # unstructured: more than 48 diagonals
        assert got is None and want is None
        return
    assert got[1] == want[1] and len(got[1]) <= 48
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("C", [1, 24])
def test_matvecs_match_jax_and_scipy(mesh, C):
    name, L, _, _ = mesh
    V = L.shape[0]
    x = np.random.RandomState(C).randn(V, C).astype(np.float32)
    b = tbd.banded_from_sparse(L)
    n_pad = b.band.shape[0] * b.band.shape[1]
    xp = np.zeros((n_pad, C), np.float32)
    xp[:V] = x[b.perm]
    got = tbd.banded_matvec(b, torch.from_numpy(xp)).numpy()
    jb = jbd.banded_from_sparse(L)
    want = np.asarray(jbd.banded_matvec(
        jb._replace(band=jnp.asarray(jb.band), starts=jnp.asarray(jb.starts)),
        jnp.asarray(xp)))
    exact = np.zeros((n_pad, C))
    exact[:V] = (L @ x.astype(np.float64))[b.perm]
    scale = np.abs(exact).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - exact).max() <= 1e-5 * scale
    dia = tbd.dia_from_sparse(L)
    if dia is None:
        return
    got = tbd.dia_matvec(torch.from_numpy(dia[0]), dia[1],
                         torch.from_numpy(x)).numpy()
    want = np.asarray(jbd.dia_matvec(jnp.asarray(dia[0]), dia[1],
                                     jnp.asarray(x)))
    exact = L @ x.astype(np.float64)
    scale = np.abs(exact).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - exact).max() <= 1e-5 * scale


def _principal_angle_err(A, B, m, kk=9):
    """max |s - 1| over the singular values of A^T M B on the first kk
    columns (a cut at a spectral gap of both meshes at k 16)."""
    s = np.linalg.svd(np.asarray(A)[:, :kk].T @ (m[:, None] * B[:, :kk]),
                      compute_uv=False)
    return np.abs(s - 1).max()


@pytest.mark.parametrize("name, banded", [("ico4", True), ("torus", True),
                                          ("torus", "dia")])
def test_solve_matches_jax_same_format_and_arpack(name, banded):
    """The DIA format takes structured meshes only (its refusal on
    icosphere(4): test_torch_eigen_device.py::test_unported_formats_raise)."""
    name, L, m, ell = _mesh(name)
    h, H = teig.eigensolve_host(L, m, K)
    pol = (L, np.asarray(m, np.float64))
    ev, E = teig.eigensolve_device(ell, m.astype(np.float32), K,
                                   banded=banded, polish=pol, device="cpu")
    assert teig.LAST_CONVERGE_INFO["name"] == (
        "eigensolve_device[banded]" if banded is True
        else "eigensolve_device[dia]")
    ev_j, E_j = (np.asarray(a) for a in jeig.eigensolve_device(
        JaxEll(jnp.asarray(ell.idx), jnp.asarray(ell.val)),
        jnp.asarray(m, jnp.float32), K, banded=banded, polish=pol))
    assert E.shape == (L.shape[0], K) and E.dtype == np.float64
    assert np.abs(ev - h).max() / h.max() < 1e-6
    assert np.abs(ev - ev_j).max() / ev_j.max() < 1e-6
    cut = 9 if name == "ico4" else 5
    assert _principal_angle_err(E, H, m, cut) < 1e-8
    assert _principal_angle_err(E, E_j, m, cut) < 1e-8


@pytest.mark.parametrize("banded", [True, "dia"])
def test_unpolished_solve_returns_tensors(banded):
    """Without the polish: f32 tensors on the device, evals within 1e-4 of
    the largest of ARPACK's, padded nothing (these formats keep V rows on
    the way out)."""
    _, L, m, ell = _mesh("torus")
    h, _ = teig.eigensolve_host(L, m, K)
    ev, E = teig.eigensolve_device(ell, m.astype(np.float32), K,
                                   banded=banded, device="cpu")
    assert ev.dtype == E.dtype == torch.float32
    assert E.shape == (L.shape[0], K) and E.device.type == "cpu"
    assert np.abs(ev.numpy() - h).max() / h.max() < 1e-4
