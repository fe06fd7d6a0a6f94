"""Sliced-ELL SpMM: the device eigensolver's operator format for
unstructured meshes, and the wrapper of kernel B5 (csrc/blocked_ell.cu).

The counterpart of diffusionnet_tpu/ops/blocked_ell.py, which computes
y = (P A P^T) x with P an RCM permutation. The function is the same; the
format is not. The JAX package covers each row group's nonzeros with dense
128-column panels, the shape of the TPU's 128 x 128 matrix unit, and spills
what does not fit into a COO overflow. On this card that shape costs: a
triangle-mesh Laplacian has about 7 nonzeros a row against up to 1,024
panel slots, so a panel kernel streams and multiplies 60-70x the work the
nonzeros need, and the overflow's scatter-add needs f32 atomics, whose
order changes from run to run. Here the format is sliced ELL (SELL-32):

  * the rows, in the RCM order and padded to a multiple of tile_rows, are
    cut into slices of SLICE = 32 rows;
  * slice s has width w_s = the largest row length in it (the diagonal
    counts as an entry);
  * its entries are stored slot-major as a (w_s, 32) block: slot j of the
    slice's 32 rows is one coalesced 128-byte load of columns (int32,
    ascending within a row) and one of values (f32);
  * a row shorter than w_s is padded with its own index as column and 0 as
    value; rows at or past V have no entries;
  * offsets[s] is the prefix sum of 32 * w_s (offsets has n_slices + 1
    entries, so w_s = (offsets[s + 1] - offsets[s]) / 32).

There is no overflow: every entry is in its row's slots, and the kernel sums
each output in one thread, so the result is the same bit for bit on every
run. The permutation and the padding are the JAX planner's: `perm` equals
its perm for the same matrix, and n_pad = ceil(V / tile_rows) * tile_rows,
so the eigensolver's row order and iterate shapes are the same on both.
The format is assembled on the target device from nnz-sized arrays.

Dispatch: tensors on the CPU take the plain version
(`blocked_ell_matvec_reference`); tensors on a CUDA device launch the
kernel or raise. There is no fallback between the two.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..training.profiling import count, since
from .banded import rcm_permutation

SLICE = 32            # rows per slice
DEFAULT_TILE_ROWS = 512

# launches of kernel B5 since the last reset_launches(); the wrapper adds
# one where it launches the kernel, and nowhere else (under a lock: the
# precompute's worker threads launch it concurrently)
LAUNCHES = {"blocked_ell": 0}
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["blocked_ell"] = 0


class SlicedEll(NamedTuple):
    """A square sparse matrix in sliced ELL (see the module docstring),
    under a row/column permutation `perm` (apply as P A P^T):

    cols:    (n_slots,) int32; entry (j, r) of slice s, holding row
             32 s + r's j-th entry, is at offsets[s] + 32 j + r.
    vals:    (n_slots,) float32, the matching values.
    offsets: (n_pad / 32 + 1,) int32 slot offsets of the slices.
    n:       logical dimension V (rows >= n are zero padding).
    n_pad:   rows of x and y (a multiple of tile_rows).
    tile_rows: the row padding granularity.
    perm:    (n,) int64 new-order -> old-index mapping (numpy).
    """
    cols: torch.Tensor
    vals: torch.Tensor
    offsets: torch.Tensor
    n: int
    n_pad: int
    tile_rows: int
    perm: np.ndarray

    @property
    def n_slices(self) -> int:
        return self.n_pad // SLICE

    def widths(self) -> torch.Tensor:
        """(n_slices,) int64 slot count of every slice."""
        off = self.offsets.long()
        return (off[1:] - off[:-1]) // SLICE

    def nbytes(self) -> int:
        """Device bytes of the format's arrays."""
        return sum(t.numel() * t.element_size()
                   for t in (self.cols, self.vals, self.offsets))


def blocked_ell_from_sparse(mat, tile_rows: int | None = None,
                            max_bytes: int = 6_000_000_000,
                            perm: np.ndarray | None = None,
                            device="cuda") -> SlicedEll | None:
    """The sliced-ELL form of a scipy sparse square matrix under an RCM
    permutation (or `perm`). Returns None when its arrays exceed max_bytes,
    or their slot count the int32 range (callers then take the ELL gather).

    device: where the format is assembled, from the nnz-sized entries and
    their slot positions (one scatter each into the padding's columns and
    zeros)."""
    import scipy.sparse

    csr = scipy.sparse.csr_matrix(mat)
    V = csr.shape[0]
    if perm is None:
        perm = rcm_permutation(csr)
    p = scipy.sparse.csr_matrix(csr[perm][:, perm])
    p.sort_indices()

    TR = tile_rows if tile_rows is not None else DEFAULT_TILE_ROWS
    if TR < SLICE or TR % SLICE:
        raise ValueError(f"tile_rows={TR} must be a positive multiple of "
                         f"{SLICE}")
    n_pad = -(-V // TR) * TR
    n_slices = n_pad // SLICE
    deg = np.zeros(n_pad, np.int64)
    deg[:V] = np.diff(p.indptr)
    width = deg.reshape(n_slices, SLICE).max(axis=1)
    offsets = np.zeros(n_slices + 1, np.int64)
    np.cumsum(SLICE * width, out=offsets[1:])
    n_slots = int(offsets[-1])
    if (n_slots * 8 + offsets.size * 4 > max_bytes
            or n_slots > np.iinfo(np.int32).max):
        return None

    # slot of every entry: row r's k-th entry goes to slot k of its slice
    rows = np.repeat(np.arange(V, dtype=np.int64), deg[:V])
    k = np.arange(p.nnz, dtype=np.int64) - p.indptr[rows]
    dest = offsets[rows // SLICE] + SLICE * k + rows % SLICE
    cols_e = p.indices.astype(np.int32)
    vals_e = p.data.astype(np.float32)

    # every slot starts as padding: its own row's index, value 0. Slot q of
    # slice s belongs to row 32 s + q % 32 (offsets are multiples of 32).
    dev = torch.device(device)
    slice_of = torch.repeat_interleave(
        torch.arange(n_slices, device=dev),
        torch.from_numpy(SLICE * width).to(dev), output_size=n_slots)
    cols = (SLICE * slice_of
            + torch.arange(n_slots, device=dev) % SLICE).to(torch.int32)
    vals = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    dest_t = torch.from_numpy(dest).to(dev)
    cols[dest_t] = torch.from_numpy(cols_e).to(dev)
    vals[dest_t] = torch.from_numpy(vals_e).to(dev)
    return SlicedEll(cols=cols, vals=vals,
                     offsets=torch.from_numpy(offsets.astype(np.int32)).to(
                         dev),
                     n=V, n_pad=n_pad, tile_rows=TR, perm=perm)


def blocked_ell_matvec_reference(b: SlicedEll, x: torch.Tensor
                                 ) -> torch.Tensor:
    """Plain PyTorch version of B5: per slot j, the x rows of every slice
    wider than j gathered and multiplied by their values, added to y in
    ascending j (as ops/sparse.py::ell_matvec gathers, one slot at a time:
    the slices differ in width). x: (n_pad, C), in the permuted order,
    padded rows zero. Returns (n_pad, C)."""
    C = x.shape[-1]
    off, width = b.offsets.long(), b.widths()
    y = torch.zeros((b.n_slices, SLICE, C), dtype=x.dtype, device=x.device)
    lane = torch.arange(SLICE, device=x.device)
    cols = b.cols.long()
    for j in range(int(width.max())):
        s = torch.nonzero(width > j).squeeze(1)
        e = off[s, None] + SLICE * j + lane                  # (slices, 32)
        y[s] += b.vals[e][..., None] * x[cols[e]]
    return y.view(b.n_pad, C)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("blocked_ell_matvec: " + msg)


def _raise_on(lib, code: int) -> None:
    if code != 0:
        raise RuntimeError("blocked_ell launch failed: "
                           + lib.bell_error_string(code).decode())


def _blocked_ell_matvec_cuda(b: SlicedEll, x: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter_ns()
    _check(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
           "x must be a contiguous f32 (n, C) matrix")
    C = x.shape[1]
    _check(x.shape[0] == b.n_pad and C >= 1,
           f"x {tuple(x.shape)}: expected ({b.n_pad}, C >= 1)")
    arrays = (b.cols, b.vals, b.offsets)
    _check(all(t.device == x.device for t in arrays),
           "the format and x on different devices")
    _check(b.vals.dtype == torch.float32, "vals must be f32")
    _check(b.cols.dtype == torch.int32 and b.offsets.dtype == torch.int32,
           "cols and offsets must be int32")
    _check(all(t.is_contiguous() for t in arrays), "format not contiguous")
    _check(b.offsets.shape == (b.n_slices + 1,)
           and b.cols.shape == b.vals.shape and b.cols.ndim == 1,
           "format shapes")
    from .. import _build
    lib = _build.load()
    y = torch.empty((b.n_pad, C), dtype=x.dtype, device=x.device)
    vec = int(C % 4 == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bell_matvec_launch(
            b.cols.data_ptr(), b.vals.data_ptr(), b.offsets.data_ptr(),
            x.data_ptr(), y.data_ptr(), b.n_slices, C, vec, stream)
    _raise_on(lib, code)
    with _LAUNCHES_LOCK:
        LAUNCHES["blocked_ell"] += 1
    count("launch.blocked_ell", seconds=since(t0))
    return y


def blocked_ell_matvec(b: SlicedEll, x: torch.Tensor) -> torch.Tensor:
    """y = (P A P^T) x for x (n_pad, C) already in the permuted order
    (padded rows zero), f32. Returns (n_pad, C), padded rows exactly 0:
    kernel B5 for CUDA tensors (one launch), the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return blocked_ell_matvec_reference(b, x)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    return _blocked_ell_matvec_cuda(b, x)
