"""Blocked-ELL SpMM: the device eigensolver's operator format for
unstructured meshes, and the wrapper of kernel B5 (csrc/blocked_ell.cu).

The counterpart of diffusionnet_tpu/ops/blocked_ell.py. Under an RCM
permutation, rows are cut into groups of G; each group's nonzero columns are
covered by at most NB dense panels of 128 columns (8-aligned starts), and
entries of groups that need more panels spill into a small COO overflow.
The matvec is then a batch of dense (G x 128) x (128 x C) products.

The host planner (`_window_plan`, `blocked_ell_from_sparse`) is the JAX
package's numpy, so for the same group_rows, tile_rows, nb and perm it
gives the same arrays; the dense panels are assembled by one nnz-sized
scatter on the target device. Beside the JAX arrays the port keeps `nused`,
each group's count of used panels (the planner opens them in order, so
they are the first nused): the kernel skips the all-zero rest.

Choices re-derived for this card. The TPU kernel stages each row tile's
whole x window (W x 128) in VMEM, so the JAX planner sizes the tile from a
16 MB VMEM budget (`_VMEM_BUDGET`, `_kernel_vmem_bytes`) and tries 1024-row
tiles first, with 64-row groups. The CUDA kernel stages no window: each
panel's 128 x rows are read straight from device memory into shared memory.
So the tile only sets the granularity of the window starts, and the port's
defaults are fixed: 512-row tiles and 32-row groups (smaller groups need
fewer panels, so fewer entries overflow; the kernel's work per row is the
same).

Dispatch: tensors on the CPU take the plain version
(`blocked_ell_matvec_reference`); tensors on a CUDA device launch the
kernel or raise. There is no fallback between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .banded import rcm_permutation

PANEL = 128           # panel width: columns per panel
DEFAULT_TILE_ROWS = 512
DEFAULT_GROUP_ROWS = 32

# launches of kernel B5 since the last reset_launches(); the wrapper adds
# one where it launches the kernel, and nowhere else
LAUNCHES = {"blocked_ell": 0}


def reset_launches() -> None:
    LAUNCHES["blocked_ell"] = 0


class BlockedEll(NamedTuple):
    """A square sparse matrix as per-row-group dense 128-column panels,
    under a row/column permutation `perm` (apply as P A P^T):

    blocks: (T, GROUPS, NB, G, 128) float32: tile t, group g, panel b
            holds
            dense A[perm][t*TR + g*G + r, starts[t] + offs[t,g,b] + c].
    offs:   (T, GROUPS, NB) int32 panel starts relative to the tile's
            window start; 8-aligned; offs + 128 <= W.
    starts: (T,) int32 per-tile window starts (8-aligned).
    nused:  (T, GROUPS) int32 used panels per group (the first nused).
    ov_rows/ov_cols/ov_vals: (R,) COO spill of groups needing more than NB
            panels (R >= 1; padded with one zero-valued entry at 0).
    n:      logical dimension V (rows >= n are zero padding).
    n_pad_x: rows of x the windows may reach (= T*TR + W).
    w_window: window width W (multiple of 128).
    perm:   (n,) int64 new-order -> old-index mapping (numpy), or None.
    """
    blocks: torch.Tensor
    offs: torch.Tensor
    starts: torch.Tensor
    nused: torch.Tensor
    ov_rows: torch.Tensor
    ov_cols: torch.Tensor
    ov_vals: torch.Tensor
    n: int
    n_pad_x: int
    w_window: int
    perm: np.ndarray | None

    @property
    def tile_rows(self) -> int:
        return self.blocks.shape[1] * self.blocks.shape[3]

    @property
    def group_rows(self) -> int:
        return self.blocks.shape[3]

    @property
    def n_pad(self) -> int:
        return self.blocks.shape[0] * self.tile_rows

    def nbytes(self) -> int:
        """Device bytes of the format's arrays."""
        return sum(t.numel() * t.element_size() for t in
                   (self.blocks, self.offs, self.starts, self.nused,
                    self.ov_rows, self.ov_cols, self.ov_vals))


def _window_plan(csr, TR: int):
    """Per-TR-row-tile window starts (8-aligned) and the width W (multiple
    of 128, one extra panel of slack so every chosen panel fits:
    off + 128 <= W). The JAX planner's numpy, unchanged."""
    V = csr.shape[0]
    nnz = csr.nnz
    T = -(-V // TR)
    indices = csr.indices
    rows = np.repeat(np.arange(V, dtype=np.int64), np.diff(csr.indptr))
    starts = np.zeros(T, np.int64)
    width = 1
    if nnz:
        tile_of = rows // TR
        seg = np.searchsorted(tile_of, np.arange(T))
        nonempty = np.zeros(T, bool)
        nonempty[tile_of] = True
        red = np.minimum(seg, nnz - 1)
        lo = np.where(nonempty, np.minimum.reduceat(indices, red), 0)
        hi = np.where(nonempty, np.maximum.reduceat(indices, red), 0)
        starts = (lo // 8 * 8).astype(np.int64)
        width = int(np.maximum(hi - starts + 1, 1).max())
    W = -PANEL * (-width // PANEL) + PANEL
    return starts, W, rows


def blocked_ell_from_sparse(mat, group_rows: int | None = None,
                            tile_rows: int | None = None,
                            nb: int = 8,
                            max_bytes: int = 6_000_000_000,
                            perm: np.ndarray | None = None,
                            device="cuda") -> BlockedEll | None:
    """The blocked-ELL form of a scipy sparse square matrix under an RCM
    permutation (or `perm`). Returns None when the panels,
    n_pad * nb * 128 * 4 bytes, exceed max_bytes (callers then take the
    ELL gather).

    device: where the panels are assembled, by one nnz-sized scatter into
    zeros (the panels hold ~NB*128/degree times more zeros than the matrix
    has entries; shipping them from the host would dominate). False
    assembles them in numpy and returns CPU tensors (the JAX planner's
    device=False)."""
    import scipy.sparse

    csr = scipy.sparse.csr_matrix(mat)
    V = csr.shape[0]
    if perm is None:
        perm = rcm_permutation(csr)
    p = scipy.sparse.csr_matrix(csr[perm][:, perm])
    p.sort_indices()

    TR = tile_rows if tile_rows is not None else DEFAULT_TILE_ROWS
    G = group_rows if group_rows is not None else DEFAULT_GROUP_ROWS
    if TR % G:
        raise ValueError(f"tile_rows={TR} must be a multiple of "
                         f"group_rows={G}")
    T = -(-V // TR)
    n_pad = T * TR
    GROUPS = TR // G
    if n_pad * nb * PANEL * 4 > max_bytes:
        return None

    indices, data = p.indices, p.data
    nnz = p.nnz
    starts, W, rows = _window_plan(p, TR)
    n_pad_x = n_pad + W  # windows may read past n_pad; rows there are zero

    # Per-group panel selection, as <= nb passes of segmented minima over
    # (group, col)-sorted entries: each pass opens one 8-aligned 128-wide
    # panel per group at its lowest still-uncovered column (greedy interval
    # cover); entries left after nb passes spill to the COO overflow. The
    # pass index is the panel slot, so a group's used slots are a prefix.
    nG = -(-V // G)
    grp = rows // G
    order = np.lexsort((indices, grp))
    g_s, c_s = grp[order], indices[order].astype(np.int64)
    panel_of = np.full(nnz, -1, np.int64)     # pass index (= panel slot)
    panel_start = np.zeros(nnz, np.int64)     # chosen panel's absolute col
    offs_abs = np.zeros((nG, nb), np.int64)
    active = np.ones(nnz, bool)
    for p_i in range(nb):
        idx_a = np.nonzero(active)[0]
        if idx_a.size == 0:
            break
        ga, ca = g_s[idx_a], c_s[idx_a]
        ug, ui = np.unique(ga, return_index=True)
        pstart = ca[ui] // 8 * 8              # min active col per group
        offs_abs[ug, p_i] = pstart
        per_entry = pstart[np.searchsorted(ug, ga)]
        covered = ca < per_entry + PANEL
        hit = idx_a[covered]
        panel_of[hit] = p_i
        panel_start[hit] = per_entry[covered]
        active[hit] = False

    # offsets relative to the owning tile's window start (both 8-aligned);
    # unused slots keep offs_abs 0, so rel may go negative there: they
    # multiply zero panels, so they are clamped into the window
    tile_of_group = (np.arange(nG) * G) // TR
    rel = offs_abs - starts[tile_of_group][:, None]
    used = np.zeros((nG, nb), bool)
    used[g_s[panel_of >= 0], panel_of[panel_of >= 0]] = True
    assert ((rel[used] >= 0) & (rel[used] + PANEL <= W)).all(), (W,)
    rel = np.clip(rel, 0, W - PANEL)
    offs = np.zeros((T, GROUPS, nb), np.int64)
    offs.reshape(-1, nb)[:nG] = rel
    nused = np.zeros((T, GROUPS), np.int64)
    nused.reshape(-1)[:nG] = used.sum(axis=1)

    # flat scatter targets into blocks (T, GROUPS, NB, G, 128)
    cov = panel_of >= 0
    rows_s = rows[order]
    t_s = rows_s // TR
    g_loc = (rows_s % TR) // G
    r_loc = rows_s % G
    flat_keep = (((((t_s[cov] * GROUPS) + g_loc[cov]) * nb + panel_of[cov])
                  * G + r_loc[cov]) * PANEL + (c_s[cov] - panel_start[cov]))
    vals_keep = data[order][cov].astype(np.float32)

    if bool((~cov).any()):
        ov_rows = rows_s[~cov].astype(np.int32)
        ov_cols = c_s[~cov].astype(np.int32)
        ov_vals = data[order][~cov].astype(np.float32)
    else:  # placeholder: one zero-valued entry
        ov_rows = np.zeros(1, np.int32)
        ov_cols = np.zeros(1, np.int32)
        ov_vals = np.zeros(1, np.float32)

    shape = (T, GROUPS, nb, G, PANEL)
    if device is False:
        blocks = np.zeros(int(np.prod(shape)), np.float32)
        blocks[flat_keep] = vals_keep
        blocks = torch.from_numpy(blocks.reshape(shape))
        dev = torch.device("cpu")
    else:
        dev = torch.device(device)
        blocks = torch.zeros(int(np.prod(shape)), dtype=torch.float32,
                             device=dev)
        blocks[torch.from_numpy(flat_keep).to(dev)] = \
            torch.from_numpy(vals_keep).to(dev)
        blocks = blocks.view(shape)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    return BlockedEll(blocks=blocks, offs=i32(offs), starts=i32(starts),
                      nused=i32(nused), ov_rows=i32(ov_rows),
                      ov_cols=i32(ov_cols),
                      ov_vals=torch.from_numpy(ov_vals).to(dev),
                      n=V, n_pad_x=int(n_pad_x), w_window=int(W), perm=perm)


def _add_overflow(b: BlockedEll, x: torch.Tensor, y: torch.Tensor) -> None:
    """y[ov_rows] += ov_vals * x[ov_cols], in place (the COO spill, added
    outside the kernel as the JAX package adds it outside its Pallas call;
    the placeholder entry adds 0)."""
    y.index_add_(0, b.ov_rows.long(),
                 b.ov_vals[:, None] * x[b.ov_cols.long()])


def blocked_ell_matvec_reference(b: BlockedEll, x: torch.Tensor
                                 ) -> torch.Tensor:
    """Plain PyTorch version of B5 (the JAX package's
    `blocked_ell_matvec_ref`): per panel slot, the x rows of every group's
    panel gathered and multiplied in one batched product, plus the COO
    overflow. x: (n_pad, C) float32, in the permuted order, padded rows
    zero. Returns (n_pad, C)."""
    T, GROUPS, NB, G, _ = b.blocks.shape
    n_pad = T * GROUPS * G
    C = x.shape[-1]
    xp = torch.zeros((max(b.n_pad_x, x.shape[0]), C), dtype=x.dtype,
                     device=x.device)
    xp[:x.shape[0]] = x
    nG = T * GROUPS
    base = (b.starts.long().repeat_interleave(GROUPS)[:, None]
            + b.offs.long().view(nG, NB))                       # (nG, NB)
    rows = torch.arange(PANEL, device=x.device)
    panels = b.blocks.view(nG, NB, G, PANEL)
    y = torch.zeros((nG, G, C), dtype=x.dtype, device=x.device)
    for s in range(NB):
        xb = xp[base[:, s, None] + rows]                        # (nG,128,C)
        y += torch.bmm(panels[:, s], xb)
    y = y.view(n_pad, C)
    _add_overflow(b, x, y)
    return y


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("blocked_ell_matvec: " + msg)


def _raise_on(lib, code: int) -> None:
    if code != 0:
        raise RuntimeError("blocked_ell launch failed: "
                           + lib.bell_error_string(code).decode())


def _blocked_ell_matvec_cuda(b: BlockedEll, x: torch.Tensor) -> torch.Tensor:
    T, GROUPS, NB, G, _ = b.blocks.shape
    n_groups = T * GROUPS
    _check(G in (32, 64), f"group_rows={G}: the kernel takes 32 or 64")
    _check(x.dtype == torch.float32 and x.ndim == 2 and x.is_contiguous(),
           "x must be a contiguous f32 (n, C) matrix")
    C = x.shape[1]
    _check(x.shape[0] >= 1 and C >= 1, f"empty x {tuple(x.shape)}")
    arrays = (b.blocks, b.offs, b.starts, b.nused, b.ov_rows, b.ov_cols,
              b.ov_vals)
    _check(all(t.device == x.device for t in arrays),
           "the format and x on different devices")
    _check(b.blocks.dtype == torch.float32
           and b.ov_vals.dtype == torch.float32,
           "blocks and ov_vals must be f32")
    _check(all(t.dtype == torch.int32 for t in
               (b.offs, b.starts, b.nused, b.ov_rows, b.ov_cols)),
           "offs, starts, nused, ov_rows, ov_cols must be int32")
    _check(all(t.is_contiguous() for t in arrays), "format not contiguous")
    _check(tuple(b.offs.shape) == (T, GROUPS, NB)
           and tuple(b.starts.shape) == (T,)
           and tuple(b.nused.shape) == (T, GROUPS), "format shapes")
    from .. import _build
    lib = _build.load()
    y = torch.empty((n_groups * G, C), dtype=x.dtype, device=x.device)
    vec = int(C % 4 == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bell_matvec_launch(
            b.blocks.data_ptr(), b.offs.data_ptr(), b.starts.data_ptr(),
            b.nused.data_ptr(), x.data_ptr(), y.data_ptr(), n_groups, GROUPS,
            G, NB, x.shape[0], C, vec, stream)
    _raise_on(lib, code)
    LAUNCHES["blocked_ell"] += 1
    _add_overflow(b, x, y)
    return y


def blocked_ell_matvec(b: BlockedEll, x: torch.Tensor) -> torch.Tensor:
    """y = (P A P^T) x for x (n_pad, C) already in the permuted order
    (padded rows zero), f32. Returns (n_pad, C):
    kernel B5 for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return blocked_ell_matvec_reference(b, x)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    return _blocked_ell_matvec_cuda(b, x)
