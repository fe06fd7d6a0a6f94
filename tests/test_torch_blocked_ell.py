"""The port's sliced-ELL format and B5's plain version against the JAX
package (diffusionnet_tpu/ops/blocked_ell.py), and the port's ELL gather.

The format differs from the JAX planner's panels, but its permutation and
row padding must be the JAX planner's, and densified it must be the f32
permuted matrix bit for bit. The plain matvec is held to the JAX reference,
to the Pallas kernel in interpret mode and to scipy in float64:
|y - y_f64| <= 5e-6 max |y_f64| (f32 sums of a row's entries, in another
order than the JAX panels'), padded rows exactly 0."""

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
from tests.test_torch_cuda import _hub_matrix

torch.set_float32_matmul_precision("highest")

TOL = 5e-6


def _laplacian(mesh):
    v, f = icosphere(4) if mesh == "ico" else torus(60, 50)
    return cotan_laplacian(v, f)


def _slot_rows(b):
    """The row and the slot index j of every slot, from the offsets alone
    (a loop over slices)."""
    off = b.offsets.numpy().astype(np.int64)
    rows = np.empty(off[-1], np.int64)
    js = np.empty(off[-1], np.int64)
    for s in range(b.n_slices):
        q = np.arange(off[s + 1] - off[s])
        rows[off[s]:off[s + 1]] = 32 * s + q % 32
        js[off[s]:off[s + 1]] = q // 32
    return rows, js


def _permuted(L, perm):
    p = scipy.sparse.csr_matrix(scipy.sparse.csr_matrix(L)[perm][:, perm])
    p.sort_indices()
    return p


@pytest.mark.parametrize("tile_rows", [256, 512, 1024])
@pytest.mark.parametrize("mesh", ["ico", "torus"])
def test_format_perm_and_dense_equal_jax_and_matrix(mesh, tile_rows):
    """perm and n_pad are the JAX planner's; the slots densify to the f32
    permuted matrix bit for bit; each slice is as wide as its longest row,
    a row's columns ascend, its padding slots hold its own index and 0, and
    rows past V have no entries."""
    L = _laplacian(mesh)
    V = L.shape[0]
    t = tbe.blocked_ell_from_sparse(L, tile_rows=tile_rows, device="cpu")
    j = jbe.blocked_ell_from_sparse(L, tile_rows=tile_rows, device=False)
    np.testing.assert_array_equal(t.perm, j.perm)
    assert (t.n, t.n_pad, t.tile_rows) == (j.n, j.n_pad, tile_rows)
    assert t.cols.dtype == torch.int32 and t.vals.dtype == torch.float32
    assert t.offsets.dtype == torch.int32
    p = _permuted(L, t.perm)
    rows, js = _slot_rows(t)
    cols, vals = t.cols.numpy().astype(np.int64), t.vals.numpy()
    dense = np.zeros((t.n_pad, t.n_pad), np.float32)
    np.add.at(dense, (rows, cols), vals)
    want = np.zeros_like(dense)
    want[:V, :V] = p.astype(np.float32).toarray()
    np.testing.assert_array_equal(dense, want)
    deg = np.zeros(t.n_pad, np.int64)
    deg[:V] = np.diff(p.indptr)
    np.testing.assert_array_equal(t.widths().numpy(),
                                  deg.reshape(-1, 32).max(1))
    pad = js >= deg[rows]
    assert (cols[pad] == rows[pad]).all() and (vals[pad] == 0).all()
    assert (rows[~pad] < V).all()
    for r in range(0, V, 97):      # ascending columns within a row
        mine = cols[(rows == r) & ~pad]
        np.testing.assert_array_equal(mine, p.indices[p.indptr[r]:
                                                      p.indptr[r + 1]])


def test_device_assembly_equals_numpy():
    """The torch assembly (here on the CPU device) equals a numpy
    construction row by row."""
    L = _laplacian("torus")
    t = tbe.blocked_ell_from_sparse(L, device="cpu")
    p = _permuted(L, t.perm)
    deg = np.diff(p.indptr)
    width = np.zeros(t.n_slices, np.int64)
    for r in range(L.shape[0]):
        width[r // 32] = max(width[r // 32], deg[r])
    off = np.concatenate([[0], np.cumsum(32 * width)])
    cols = np.zeros(off[-1], np.int32)
    vals = np.zeros(off[-1], np.float32)
    for s in range(t.n_slices):
        for q in range(32 * width[s]):
            cols[off[s] + q] = 32 * s + q % 32
    for r in range(L.shape[0]):
        for k in range(deg[r]):
            e = off[r // 32] + 32 * k + r % 32
            cols[e] = p.indices[p.indptr[r] + k]
            vals[e] = p.data[p.indptr[r] + k]
    np.testing.assert_array_equal(t.cols.numpy(), cols)
    np.testing.assert_array_equal(t.vals.numpy(), vals)
    np.testing.assert_array_equal(t.offsets.numpy(), off.astype(np.int32))
    assert t.nbytes() == 8 * off[-1] + 4 * off.size


@pytest.mark.parametrize("C", [1, 97])
def test_plain_matvec_hub_row_and_empty_rows(C):
    """One row of degree > 500 (a slice that wide) and rows with no
    entries: the plain version against scipy in float64."""
    A = _hub_matrix()
    V = A.shape[0]
    b = tbe.blocked_ell_from_sparse(A, device="cpu")
    assert int(b.widths().max()) >= 500
    p = _permuted(A, b.perm)
    assert (np.diff(p.indptr) == 0).sum() >= 50
    x = np.zeros((b.n_pad, C), np.float32)
    x[:V] = np.random.RandomState(C).randn(V, C)
    y_true = p @ x[:V].astype(np.float64)
    y = tbe.blocked_ell_matvec(b, torch.from_numpy(x)).numpy()
    assert y.shape == (b.n_pad, C) and y.dtype == np.float32
    assert np.abs(y[:V] - y_true).max() <= TOL * np.abs(y_true).max()
    assert np.abs(y[V:]).max() == 0.0
    assert (y[:V][np.diff(p.indptr) == 0] == 0).all()


def test_planner_rejects_over_budget():
    assert tbe.blocked_ell_from_sparse(_laplacian("ico"), max_bytes=1000,
                                       device="cpu") is None


def _jax_fmt(b):
    return b._replace(
        blocks=jnp.asarray(b.blocks), offs=jnp.asarray(b.offs),
        starts=jnp.asarray(b.starts), ov_rows=jnp.asarray(b.ov_rows),
        ov_cols=jnp.asarray(b.ov_cols), ov_vals=jnp.asarray(b.ov_vals),
        perm=None)


@pytest.mark.parametrize("mesh,nb,C", [("ico", 8, 96), ("ico", 1, 160),
                                       ("torus", 8, 160), ("torus", 2, 96)])
def test_plain_matvec_matches_jax_and_scipy(mesh, nb, C):
    """The port's plain version against the JAX package's reference and
    Pallas kernel (interpret mode) on its panels with nb panels a group
    (nb 1 and 2 send entries through its COO overflow), and scipy."""
    L = _laplacian(mesh)
    t = tbe.blocked_ell_from_sparse(L, tile_rows=256, device="cpu")
    j = jbe.blocked_ell_from_sparse(L, group_rows=32, tile_rows=256, nb=nb,
                                    device=False)
    assert t.n_pad == j.n_pad
    np.testing.assert_array_equal(t.perm, j.perm)
    if nb < 8:
        assert int((np.asarray(j.ov_vals) != 0).sum()) > 0
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
    t = tbe.blocked_ell_from_sparse(_laplacian("ico"), device="cpu")
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
