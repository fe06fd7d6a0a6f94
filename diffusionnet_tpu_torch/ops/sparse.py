"""Fixed-topology sparse operators in ELL format.

The counterpart of diffusionnet_tpu/ops/sparse.py. Each row is padded to a
static max degree D: `idx (V, D) int32`, `val (V, D) float`; padding entries
carry val == 0. The operator bundle keeps L, gradX and gradY in this layout
(numpy); `ell_matvec` applies one to torch tensors (the device eigensolver's
gather route and the model's ELL gradient path), and `ell_to_dense`
densifies one (the implicit_dense diffusion).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Ell(NamedTuple):
    """A square (n, n) sparse matrix in ELL (padded row-major) layout.

    idx: (..., n, D) int32 column indices per row (padding rows point at 0)
    val: (..., n, D) values (padding entries are exactly 0)
    """
    idx: np.ndarray
    val: np.ndarray

    @property
    def max_degree(self) -> int:
        return self.idx.shape[-1]


def ell_from_coo(rows, cols, vals, n_rows: int, dtype=np.float32) -> Ell:
    """COO triplets to ELL, summing duplicates; D is the largest row degree
    (at least 1)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)

    # Sum duplicate (row, col) entries first (COO semantics).
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows * n_rows + cols
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
    np.add.at(summed, inv, vals)
    u_rows = (uniq // n_rows).astype(np.int64)
    u_cols = (uniq % n_rows).astype(np.int64)

    counts = np.bincount(u_rows, minlength=n_rows)
    d_max = max(int(counts.max()) if counts.size else 0, 1)
    idx = np.zeros((n_rows, d_max), dtype=np.int32)
    val = np.zeros((n_rows, d_max), dtype=dtype)
    # position of each entry within its row
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(u_rows.shape[0]) - starts[u_rows]
    idx[u_rows, slot] = u_cols.astype(np.int32)
    val[u_rows, slot] = summed.astype(dtype)
    return Ell(idx=idx, val=val)


def _gather_rows(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x's rows at idx: (..., n, D, C)."""
    if idx.ndim == 2:
        return x[..., idx, :]
    lead = idx.shape[:-2]
    n, D = idx.shape[-2:]
    xb = x.reshape(-1, *x.shape[-2:])
    ib = idx.reshape(-1, n, D)
    b = torch.arange(ib.shape[0], device=x.device)[:, None, None]
    return xb[b, ib].reshape(*lead, n, D, x.shape[-1])


def _acc_dtype(val, x) -> torch.dtype:
    return torch.promote_types(torch.promote_types(val.dtype, x.dtype),
                               torch.float32)


def _ell_forward(idx, val, x):
    acc = _acc_dtype(val, x)
    y = torch.einsum("...nd,...ndc->...nc", val.to(acc),
                     _gather_rows(idx, x).to(acc))
    return y.to(x.dtype)


class _EllMatvec(torch.autograd.Function):
    """y = A x with a backward that sums each column's entries in a fixed
    order. The gather's own backward accumulates by index (index_put_),
    which adds atomically on the CPU's threads, so a step's bits varied
    from run to run and a resumed `fit` of the ELL route did not repeat the
    uninterrupted one. dx here is the embedding lookup's backward: a
    sort-based sum of each row's entries in a fixed order, on the CPU and
    on a card. dval (where asked for) is a gather and a sum over C."""

    @staticmethod
    def forward(ctx, idx, val, x):
        ctx.save_for_backward(idx, val, x)
        return _ell_forward(idx, val, x)

    @staticmethod
    def backward(ctx, dy):
        idx, val, x = ctx.saved_tensors
        acc = _acc_dtype(val, x)
        dy = dy.to(acc)
        dx = dval = None
        n, D = idx.shape[-2:]
        C = x.shape[-1]
        if ctx.needs_input_grad[2]:
            if idx.ndim == 2:
                # one operator for every leading index of x: the leading
                # dims ride along as channels
                lead = x.shape[:-2]
                g = dy.reshape(-1, n, C).permute(1, 0, 2).reshape(n, -1)
                rows = (val.to(acc)[..., None] * g[:, None]).reshape(n * D, -1)
                dx = torch.ops.aten.embedding_dense_backward(
                    rows, idx.reshape(-1), n, -1, False)
                dx = dx.view(n, -1, C).permute(1, 0, 2).reshape(*lead, n, C)
            else:
                nb = idx.numel() // (n * D)
                keys = (idx.reshape(nb, n * D) + n * torch.arange(
                    nb, device=idx.device)[:, None]).reshape(-1)
                rows = (val.to(acc)[..., None] * dy[..., None, :]).reshape(
                    -1, C)
                dx = torch.ops.aten.embedding_dense_backward(
                    rows, keys, nb * n, -1, False).view(x.shape)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dval = torch.einsum("...nc,...ndc->...nd", dy,
                                _gather_rows(idx, x).to(acc))
            dval = dval.reshape(-1, *val.shape).sum(0).to(val.dtype)
        return None, dval, dx


def ell_matvec(ell: Ell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in ELL (torch tensors): a row gather and a
    contraction over the degree. ell.idx/val: (n, D), or (..., n, D)
    matching x's leading dims; x: (..., n, C) -> (..., n, C).

    Accumulates in f32 (f64 for f64 operands) and returns x's dtype, as
    the JAX package's `ell_matvec` does. Plain torch: the JAX package has
    no kernel here either (plain XLA). Differentiable in x and val, with a
    backward that repeats its bits (`_EllMatvec`)."""
    return _EllMatvec.apply(ell.idx.long(), ell.val, x)


def ell_to_dense(ell: Ell, n: int | None = None) -> torch.Tensor:
    """Densify: (..., rows, D) ELL -> (..., rows, n) torch tensor (n defaults
    to rows). Batch dims are kept. Entries that share a (row, column) are
    added, as the JAX package's `.at[].add` does; padding adds its zeros."""
    idx = torch.as_tensor(ell.idx).long()
    val = torch.as_tensor(ell.val)
    rows = idx.shape[-2]
    n = n if n is not None else rows
    lead = idx.shape[:-2]
    flat = torch.arange(rows, device=idx.device)[:, None] * n + idx
    dense = val.new_zeros((*lead, rows * n))
    dense.scatter_add_(-1, flat.reshape(*lead, -1), val.reshape(*lead, -1))
    return dense.reshape(*lead, rows, n)


def ell_pad(ell: Ell, n_rows: int, d_max: int | None = None) -> Ell:
    """Pad an Ell to a larger static (n_rows, d_max)."""
    idx, val = np.asarray(ell.idx), np.asarray(ell.val)
    n0, d0 = idx.shape
    d_max = d_max if d_max is not None else d0
    out_idx = np.zeros((n_rows, d_max), dtype=idx.dtype)
    out_val = np.zeros((n_rows, d_max), dtype=val.dtype)
    out_idx[:n0, :d0] = idx
    out_val[:n0, :d0] = val
    return Ell(idx=out_idx, val=out_val)
