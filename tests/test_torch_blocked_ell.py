"""The port's blocked-ELL format and B5's plain version against the JAX
package (diffusionnet_tpu/ops/blocked_ell.py), and the port's ELL gather.

The planner is the JAX package's numpy, so its arrays must be bit-equal for
the same group_rows, tile_rows, nb and perm. The plain matvec is held to
the JAX reference, to the Pallas kernel in interpret mode and to scipy in
float64: |y - y_f64| <= 5e-6 max |y_f64| (f32 sums of at most 1,024 panel
products per row, in another order), padded rows exactly 0."""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp
from diffusionnet_tpu.ops import blocked_ell as jbe
from diffusionnet_tpu_torch.geometry.laplacian import cotan_laplacian
from diffusionnet_tpu_torch.ops import blocked_ell as tbe
from diffusionnet_tpu_torch.ops.sparse import Ell, ell_from_coo, ell_matvec
from tests.meshgen import icosphere, torus

torch.set_float32_matmul_precision("highest")

TOL = 5e-6


def _laplacian(mesh):
    v, f = icosphere(4) if mesh == "ico" else torus(60, 50)
    return cotan_laplacian(v, f)


def _build_both(mesh, nb):
    L = _laplacian(mesh)
    kw = dict(group_rows=32, tile_rows=256, nb=nb, device=False)
    return L, tbe.blocked_ell_from_sparse(L, **kw), \
        jbe.blocked_ell_from_sparse(L, **kw)


@pytest.mark.parametrize("nb", [8, 2, 1])
@pytest.mark.parametrize("mesh", ["ico", "torus"])
def test_planner_bit_equal_to_jax(mesh, nb):
    """Every array of the JAX planner, bit for bit; nb 1 (both meshes) and
    nb 2 (the torus) force the COO overflow. nused counts each group's
    used panels, which are a prefix: every panel past it is zero, every
    panel inside it is not."""
    L, t, j = _build_both(mesh, nb)
    for name in ("blocks", "offs", "starts", "ov_rows", "ov_cols",
                 "ov_vals"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(t.perm, j.perm)
    assert (t.n, t.n_pad_x, t.w_window) == (j.n, j.n_pad_x, j.w_window)
    nonzero = (t.blocks != 0).flatten(3).any(-1)              # (T, GR, NB)
    slot = torch.arange(nb)
    assert torch.equal(nonzero, slot < t.nused[..., None])
    if nb == 1 or (mesh, nb) == ("torus", 2):
        assert int((t.ov_vals != 0).sum()) > 0, f"nb={nb} should overflow"


def test_planner_device_assembly_equals_host():
    """The torch scatter (here on the CPU device) gives the numpy panels."""
    L = _laplacian("torus")
    a = tbe.blocked_ell_from_sparse(L, nb=2, device=False)
    b = tbe.blocked_ell_from_sparse(L, nb=2, device="cpu")
    for name in ("blocks", "offs", "starts", "nused", "ov_rows", "ov_cols",
                 "ov_vals"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.tile_rows, a.group_rows) == (tbe.DEFAULT_TILE_ROWS,
                                           tbe.DEFAULT_GROUP_ROWS)


def test_planner_rejects_over_budget():
    assert tbe.blocked_ell_from_sparse(_laplacian("ico"), max_bytes=1000,
                                       device=False) is None


def _jax_fmt(b):
    return b._replace(
        blocks=jnp.asarray(b.blocks), offs=jnp.asarray(b.offs),
        starts=jnp.asarray(b.starts), ov_rows=jnp.asarray(b.ov_rows),
        ov_cols=jnp.asarray(b.ov_cols), ov_vals=jnp.asarray(b.ov_vals),
        perm=None)


@pytest.mark.parametrize("mesh,nb,C", [("ico", 8, 96), ("ico", 1, 160),
                                       ("torus", 8, 160), ("torus", 2, 96)])
def test_plain_matvec_matches_jax_and_scipy(mesh, nb, C):
    L, t, j = _build_both(mesh, nb)
    V = L.shape[0]
    x = np.zeros((t.n_pad, C), np.float32)
    x[:V] = np.random.RandomState(C + nb).randn(V, C)
    Lp = scipy.sparse.csr_matrix(L)[t.perm][:, t.perm]
    y_true = Lp @ x[:V].astype(np.float64)
    scale = np.abs(y_true).max()
    tbe.reset_launches()
    y = tbe.blocked_ell_matvec(t, torch.from_numpy(x)).numpy()
    assert tbe.LAUNCHES == {"blocked_ell": 0}   # CPU: the plain version
    assert y.shape == (t.n_pad, C)
    assert np.abs(y[:V] - y_true).max() <= TOL * scale
    assert np.abs(y[V:]).max() == 0.0
    d = _jax_fmt(j)
    y_ref = np.asarray(jbe.blocked_ell_matvec_ref(d, jnp.asarray(x)))
    assert np.abs(y[:V] - y_ref[:V]).max() <= TOL * scale
    y_pal = np.asarray(jbe.blocked_ell_matvec(d, jnp.asarray(x),
                                              interpret=True))
    assert np.abs(y[:V] - y_pal[:V]).max() <= TOL * scale


def test_matvec_refuses_other_devices():
    L, t, _ = _build_both("ico", 8)
    x = torch.zeros((t.n_pad, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbe.blocked_ell_matvec(t, x)


@pytest.mark.parametrize("batched", [False, True])
def test_ell_matvec_matches_scipy(batched):
    """The ELL gather (the eigensolver's fallback route) against scipy in
    float64, within 5e-6 of max |y|; batched ELLs of two operators."""
    mats = [_laplacian("ico"), 2.0 * _laplacian("ico")]
    rs = np.random.RandomState(1)
    x = rs.randn(len(mats), mats[0].shape[0], 160).astype(np.float32)
    ells = []
    for m in mats:
        coo = scipy.sparse.coo_matrix(m)
        ells.append(ell_from_coo(coo.row, coo.col, coo.data, m.shape[0]))
    want = np.stack([m @ xi.astype(np.float64) for m, xi in zip(mats, x)])
    if batched:
        ell = Ell(torch.from_numpy(np.stack([e.idx for e in ells])),
                  torch.from_numpy(np.stack([e.val for e in ells])))
        got = ell_matvec(ell, torch.from_numpy(x)).numpy()
    else:
        got = np.stack([ell_matvec(Ell(torch.from_numpy(e.idx),
                                       torch.from_numpy(e.val)),
                                   torch.from_numpy(xi)).numpy()
                        for e, xi in zip(ells, x)])
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
