"""The port's vertex-sharded eigensolver
(geometry/eigen.py::eigensolve_device_sharded) on the CPU against the JAX
package's, host ARPACK and the port's single-process solver.

The port runs one world of 4 ranks (spawned processes over gloo,
`parallel.launch`; tests/torch_sharded_workers.py) once for the module; the
JAX side runs here on 4 of the 8 virtual CPU devices. The surface is
icosphere(4), 2562 vertices padded to 2564, so every shard of 641 rows
holds real vertices (at icosphere(3) one sweep's top Ritz values move by
1e-3 between JAX's own one-device and sharded sweeps). Tolerances: one sweep from a shared start block gives Ritz
values within rtol 1e-5 of JAX's (f32 sums in another order); the solve's
eigenvalues within 1e-4 of the largest of ARPACK's and JAX's, its vectors
M-orthonormal within 1e-4 with padded rows exactly 0; every rank's
eigenvalues bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from diffusionnet_tpu.geometry import eigen as jeig
from diffusionnet_tpu.ops.sparse import Ell as JaxEll
from diffusionnet_tpu_torch.geometry import eigen as teig
from diffusionnet_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                      vertex_areas)
from diffusionnet_tpu_torch.ops.sparse import ell_from_coo, ell_pad
from diffusionnet_tpu_torch.parallel import launch
from tests import torch_sharded_workers as W
from tests.meshgen import icosphere
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")

K = 16
EPS = 1e-8
V_PAD = 2564
DEGREE = 24
WORLD = 4


@pytest.fixture(scope="module")
def problem():
    v, f = icosphere(4)
    L = cotan_laplacian(v, f)
    m = vertex_areas(v, f)
    coo = L.tocoo()
    ell = ell_pad(ell_from_coo(coo.row, coo.col, coo.data, L.shape[0]),
                  V_PAD)
    mass = np.zeros(V_PAD, np.float32)
    mass[:len(m)] = m
    evh, _ = teig.eigensolve_host(L, m, K)
    return dict(L=L, m=m, V=len(m), ell=ell, mass=mass, evh=evh)


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    p = problem
    d = tmp_path_factory.mktemp("eigen_sharded")
    _, _, _, n_cols, _, _ = teig._device_solver_setup(
        p["ell"], p["mass"], K, None, EPS, None, None)
    X0 = np.random.RandomState(5).randn(V_PAD, n_cols).astype(np.float32)
    Lpad = scipy.sparse.block_diag(
        [p["L"], scipy.sparse.csr_matrix((V_PAD - p["V"],) * 2)]).tocsr()
    m64 = np.zeros(V_PAD)
    m64[:p["V"]] = p["m"]
    inputs = str(d / "inputs.npz")
    np.savez(inputs, idx=p["ell"].idx, val=p["ell"].val, mass=p["mass"],
             k=K, degree=DEGREE, X0=X0, mass64=m64, **{
                 "csr/data": Lpad.data, "csr/indices": Lpad.indices,
                 "csr/indptr": Lpad.indptr, "csr/n": V_PAD})
    out = launch(W.eigen_rank, WORLD, (inputs,), workdir=str(d / "ranks"))
    return dict(out=out, X0=X0, n_cols=n_cols)


@pytest.fixture(scope="module")
def jax_mesh(cpu_devices):
    return Mesh(np.asarray(cpu_devices[:WORLD]), ("vert",))


def _jax_ell(ell):
    return JaxEll(jnp.asarray(ell.idx), jnp.asarray(ell.val))


def test_one_sweep_same_start_block_matches_jax(problem, ranks, jax_mesh):
    """The sharded stages of both packages (all-gather SpMM, reduced Gram
    and Rayleigh-Ritz matrices) from one numpy start block: Ritz values
    within rtol 1e-5; residual norms within 1e-3 of the largest."""
    p, mesh = problem, jax_mesh
    mask, ism, bound, _, _, lam = teig._device_solver_setup(
        p["ell"], p["mass"], K, None, EPS, None, None)
    vs = NamedSharding(mesh, P("vert"))
    put = lambda a: jax.device_put(jnp.asarray(a), vs)  # noqa: E731
    args = (put(p["ell"].idx), put(p["ell"].val), put(ism), put(mask))
    bj, ej = jnp.float32(bound), jnp.float32(EPS)
    Uj, wj, resj = jeig._split_sweep(
        lambda X, lo: jeig._dev_filter_gram_sharded(
            *args, X, lo, bj, ej, DEGREE, mesh, "vert"),
        lambda Y, F: jeig._dev_rotate_apply_sharded(
            *args, bj, ej, Y, F, mesh, "vert"),
        put(ranks["X0"]), jnp.float32(lam),
        rotate_gram=lambda Y, F: jeig._dev_rotate_gram_sharded(
            Y, F, mesh, "vert"),
        rotate_residuals=lambda Y, W_, S, w: (
            jeig._dev_rotate_residuals_sharded(Y, W_, S, w, mesh, "vert")))
    r0 = ranks["out"][0]
    np.testing.assert_allclose(r0["sweep/w"], wj, rtol=1e-5)
    resj = np.asarray(resj, np.float64)
    assert np.abs(r0["sweep/res"] - resj).max() <= 1e-3 * resj.max()
    U = np.concatenate([r["sweep/U"] for r in ranks["out"]])
    assert U.shape == (V_PAD, ranks["n_cols"])
    for r in ranks["out"][1:]:
        np.testing.assert_array_equal(r["sweep/w"], r0["sweep/w"])


def _check_basis(evecs, p):
    V = p["V"]
    assert np.abs(evecs[V:]).max() == 0.0
    E = evecs[:V].astype(np.float64)
    G = E.T @ (p["m"][:, None] * E)
    np.testing.assert_allclose(G, np.eye(K), atol=1e-4)


def test_solve_matches_arpack_and_jax(problem, ranks, jax_mesh):
    p = problem
    r0 = ranks["out"][0]
    evh = p["evh"]
    np.testing.assert_allclose(r0["evals"], evh, atol=1e-4 * evh.max())
    jev, jevec = jeig.eigensolve_device_sharded(
        _jax_ell(p["ell"]), jnp.asarray(p["mass"]), K, mesh=jax_mesh)
    np.testing.assert_allclose(r0["evals"], np.asarray(jev),
                               atol=1e-4 * evh.max())
    evecs = np.concatenate([r["evecs"] for r in ranks["out"]])
    assert evecs.shape == (V_PAD, K) and evecs.dtype == np.float32
    _check_basis(evecs, p)


def test_every_rank_returns_the_same_evals_bits(ranks):
    r0 = ranks["out"][0]
    for r in ranks["out"][1:]:
        assert r["evals"].tobytes() == r0["evals"].tobytes()
        assert r["polish/evals"].tobytes() == r0["polish/evals"].tobytes()
        assert int(r["converge"]) == int(r0["converge"])


def test_sharded_matches_single_process_solve(problem, ranks):
    """The same start block (the whole (V, n) draw of seed 777, each rank
    keeping its rows) through the single-process ELL route: the same
    eigenvalues within 1e-5 of the largest, the same sweep count."""
    p = problem
    ev, evec = teig.eigensolve_device(p["ell"], p["mass"], K, banded=False,
                                      device="cpu")
    sweeps = teig.LAST_CONVERGE_INFO["sweeps"]
    r0 = ranks["out"][0]
    np.testing.assert_allclose(r0["evals"], ev.numpy(),
                               atol=1e-5 * p["evh"].max())
    assert int(r0["converge"]) == sweeps
    _check_basis(evec.numpy(), p)


def test_polished_solve_matches_arpack(problem, ranks):
    """With polish every rank gathers the iterate and returns the whole
    f64 pairs."""
    p = problem
    r0 = ranks["out"][0]
    assert r0["polish/evecs"].shape == (V_PAD, K)
    assert r0["polish/evecs"].dtype == np.float64
    np.testing.assert_allclose(r0["polish/evals"], p["evh"],
                               atol=1e-6 * p["evh"].max())
    _check_basis(r0["polish/evecs"], p)


def test_refusals_and_empty_band(ranks):
    for r in ranks["out"]:
        assert "divisible" in str(r["refuse/divisible"])
        # k_eig 0: empty evals and this rank's (641, 0) block
        assert r["k0/shapes"].tolist() == [0, V_PAD // WORLD, 0]
