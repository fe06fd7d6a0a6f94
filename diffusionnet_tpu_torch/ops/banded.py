"""The device eigensolver's structured operator formats, and the
bandwidth-reducing order that the sliced-ELL planner (ops/blocked_ell.py)
also uses. The counterpart of diffusionnet_tpu/ops/banded.py.

Two formats, both plain torch here as in the JAX package (plain XLA there,
no Pallas kernel):

  * the dense RCM band (`Banded`): under a reverse Cuthill-McKee order a
    mesh Laplacian is banded, and its product is a batch of per-row-tile
    dense (TR, W) x (W, C) products over contiguous windows of x (one
    `torch.bmm`). It stores TR x W values a tile, so its memory grows with
    the bandwidth, bounded by `max_band_bytes`;
  * DIA (`dia_from_sparse`): a grid-structured triangulation has a handful
    of distinct (col - row) offsets, and its product is a sum of statically
    shifted elementwise products over one zero-padded buffer: no gather,
    memory exactly D * V.

The planners are host numpy, the JAX package's, so perm, the window starts
and the DIA data are the same on both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Banded(NamedTuple):
    """A square (n, n) sparse matrix as per-row-tile dense bands, under a
    row/column permutation `perm` (apply as P A P^T):

    band:   (T, TR, W) float: tile t, local row r holds the dense window
            A[perm][t*TR + r, starts[t] : starts[t] + W]
    starts: (T,) int window starts (clamped so starts[t] + W <= n_pad)
    n:      logical dimension V (rows t*TR + r >= n are zero padding)
    perm:   (n,) int64 new-order -> old-index mapping (numpy, host-side)
    """
    band: torch.Tensor
    starts: torch.Tensor
    n: int
    perm: np.ndarray

    @property
    def width(self) -> int:
        return self.band.shape[-1]

    @property
    def tile_rows(self) -> int:
        return self.band.shape[-2]


def rcm_permutation(mat) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (symmetric): new -> old indices."""
    import scipy.sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(
        scipy.sparse.csr_matrix(mat), symmetric_mode=True), dtype=np.int64)


def _band_plan(mat, tile_rows: int, max_band_bytes: int,
               perm: np.ndarray | None, dtype):
    """Host-side band layout plan: permutation, per-tile window starts, and
    the flat scatter targets of every nonzero. Returns None when the
    reordered bandwidth would exceed max_band_bytes."""
    import scipy.sparse
    csr = scipy.sparse.csr_matrix(mat)
    V = csr.shape[0]
    if perm is None:
        perm = rcm_permutation(csr)
    p = scipy.sparse.csr_matrix(csr[perm][:, perm])

    T = -(-V // tile_rows)
    n_pad = T * tile_rows
    indptr, indices, data = p.indptr, p.indices, p.data

    # per-tile window: [min col, max col] over the tile's rows
    starts = np.zeros(T, np.int64)
    width = 0
    for t in range(T):
        r0, r1 = t * tile_rows, min((t + 1) * tile_rows, V)
        cols = indices[indptr[r0]:indptr[r1]]
        lo = int(cols.min()) if cols.size else 0
        hi = int(cols.max()) if cols.size else 0
        starts[t] = lo
        width = max(width, hi - lo + 1)
    W = -128 * (-width // 128)      # the JAX package's lane-aligned window
    if T * tile_rows * W * np.dtype(dtype).itemsize > max_band_bytes:
        return None
    # clamp so every window [start, start + W) lies inside the padded x
    starts = np.minimum(starts, max(n_pad - W, 0))

    rows = np.repeat(np.arange(V), np.diff(indptr))
    t_of = rows // tile_rows
    local_r = rows % tile_rows
    local_c = indices - starts[t_of]
    assert (local_c >= 0).all() and (local_c < W).all()
    flat = (t_of * tile_rows + local_r) * W + local_c
    return perm, starts, T, W, flat, data.astype(dtype)


def banded_from_sparse(mat, tile_rows: int = 512,
                       max_band_bytes: int = 2_500_000_000,
                       perm: np.ndarray | None = None,
                       dtype=np.float32) -> Banded | None:
    """The banded form of a scipy sparse matrix under an RCM permutation,
    assembled in host memory (the test oracle): a numpy band. Returns None
    when the reordered bandwidth would exceed max_band_bytes."""
    plan = _band_plan(mat, tile_rows, max_band_bytes, perm, dtype)
    if plan is None:
        return None
    perm, starts, T, W, flat, vals = plan
    band = np.zeros(T * tile_rows * W, dtype)
    band[flat] = vals
    return Banded(band=band.reshape(T, tile_rows, W),
                  starts=starts.astype(np.int32), n=mat.shape[0], perm=perm)


def banded_from_sparse_device(mat, tile_rows: int = 512,
                              max_band_bytes: int = 2_500_000_000,
                              perm: np.ndarray | None = None,
                              dtype=np.float32,
                              device="cuda") -> Banded | None:
    """banded_from_sparse with the band assembled on `device` by one
    nnz-sized scatter: the band holds about TR * W / degree times more
    zeros than the matrix, and only the nnz-sized targets and values cross
    to the device. Returns tensors on `device`, or None over budget."""
    plan = _band_plan(mat, tile_rows, max_band_bytes, perm, dtype)
    if plan is None:
        return None
    perm, starts, T, W, flat, vals = plan
    dev = torch.device(device)
    band = torch.zeros(T * tile_rows * W, dtype=torch.from_numpy(vals).dtype,
                       device=dev)
    band[torch.from_numpy(flat).to(dev)] = torch.from_numpy(vals).to(dev)
    return Banded(band=band.reshape(T, tile_rows, W),
                  starts=torch.from_numpy(starts.astype(np.int64)).to(dev),
                  n=mat.shape[0], perm=perm)


def banded_matvec(b: Banded, x: torch.Tensor) -> torch.Tensor:
    """y = (P A P^T) @ x for x already in the permuted order. x: (n_pad, C)
    with n_pad = T * TR (callers pad; padded rows must be zero). Returns
    (n_pad, C): one batched (TR, W) x (W, C) product over the T windows
    x[starts[t] : starts[t] + W]."""
    band = torch.as_tensor(b.band, device=x.device)
    starts = torch.as_tensor(b.starts, device=x.device).long()
    T, TR, W = band.shape
    rows = starts[:, None] + torch.arange(W, device=x.device)   # (T, W)
    xw = x[rows]                                                # (T, W, C)
    y = torch.bmm(band.to(x.dtype), xw)
    return y.reshape(T * TR, x.shape[-1])


def dia_from_sparse(mat, max_diags: int = 48, dtype=np.float32):
    """Row-wise DIA extraction: data[d, i] = A[i, i + offsets[d]].
    Returns (data (D, V) numpy, offsets tuple[int]) or None when the matrix
    has more than max_diags distinct diagonals (an unstructured mesh)."""
    coo = mat.tocoo()
    off = coo.col - coo.row
    offsets = np.unique(off)
    if offsets.size > max_diags:
        return None
    V = mat.shape[0]
    data = np.zeros((offsets.size, V), dtype)
    d_idx = np.searchsorted(offsets, off)
    np.add.at(data, (d_idx, coo.row), coo.data.astype(dtype))
    return data, tuple(int(o) for o in offsets)


def dia_matvec(data: torch.Tensor, offsets: tuple,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, row-wise DIA: y[i] = sum_d data[d, i] * x[i + offsets[d]],
    the terms added in the order of `offsets` (ascending), each a static
    slice of one zero-padded copy of x (V + 2P rows, P the largest |offset|).

    dia_from_sparse writes data[d, i] only for entries that exist, so a row
    whose i + offset falls outside [0, V) has data 0 there and the padding
    it reads is multiplied away. data (D, V); x (V, C)."""
    V = x.shape[0]
    data = data.to(x.dtype)
    P = max(abs(o) for o in offsets)
    if P == 0:
        return data[0][:, None] * x
    xp = torch.nn.functional.pad(x, (0, 0, P, P))
    y = None
    for d, off in enumerate(offsets):
        t = data[d][:, None] * xp[P + off:P + off + V]
        y = t if y is None else y + t
    return y
