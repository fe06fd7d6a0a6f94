"""Generalized eigensolvers for L phi = lambda M phi (M diagonal lumped mass).

The counterpart of diffusionnet_tpu/geometry/eigen.py. Three paths:

  * `eigensolve_host`: scipy ARPACK shift-invert with the reference's ladder
    (geometry.py:336-361), seeded per attempt so a run is deterministic.
  * `eigensolve_device`: the single-card device solver, the default of
    `compute_operators`. Because M is diagonal the problem reduces to a
    standard symmetric one on C = M^-1/2 L M^-1/2, solved by
    Chebyshev-filtered subspace iteration (Zhou and Saad's scaled filter)
    with SVQB orthonormalization, a residual-converged outer loop, and a
    float64 Rayleigh-Ritz polish and certification on the host:

      repeat until the k wanted residuals converge:
        Y  <- p_m(C) X       scaled Chebyshev filter on [lo, bound]
        Y  <- SVQB(Y) x2     Gram-eigh whitening
        RR: T = Y^T C Y; eigh; rotate; residuals ||C u - w u||
        lo <- top Ritz value

    One outer iteration is four device stages with host (n, n) float64
    factorizations between them (`_split_sweep`): only (n, n) matrices
    cross to the host, the (V, n) blocks stay on the device. The SpMM is
    kernel B5 on the sliced-ELL format (ops/blocked_ell.py: the JAX
    package's RCM order and row padding, about 8 bytes a nonzero) on a
    CUDA device, or the ELL gather (ops/sparse.py::ell_matvec) when the
    format exceeds the memory budget; on the CPU the ELL gather is the
    default, as in the JAX package. The dense RCM band and DIA formats
    (ops/banded.py) are routes on request (banded=True, 'dia'). A
    basis that does not converge, or that the f64 certification rejects,
    raises EigenSolveNotConverged, and compute_operators falls back to
    host ARPACK, as in the JAX package.
  * `eigensolve_device_sharded`: the same solver on every rank of a
    `vert` mesh axis, each rank holding its rows of every (V, n) block.

Left out of the port, with the reason:
  * `cheb_segment` (the filter as short device programs): a workaround for
    a per-program watchdog of the TPU runtime. Here the Chebyshev
    recurrence is a Python loop of kernel launches, so no program is long;
  * `_ensure_compilation_cache`: JAX's compiled-program cache; PyTorch runs
    eagerly and the kernels are built once by _build.py;
  * the threaded native host SpMM of the polish: the polish uses scipy,
    the JAX package's own no-compiler fallback.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import scipy.sparse
import scipy.sparse.linalg as sla
import torch

from ..ops.sparse import Ell, ell_matvec


class EigenSolveNotConverged(RuntimeError):
    """The device solver did not reach its tolerance (stagnation above the
    f32 noise floor, the sweep budget spent, or a failed f64
    certification). `compute_operators` falls back to the host ARPACK
    ladder on this exception only; a build, launch or device error is
    another RuntimeError and propagates."""


def eigensolve_host(L: scipy.sparse.spmatrix, massvec: np.ndarray, k_eig: int,
                    eps: float = 1e-8):
    """Reference-parity host path (ARPACK shift-invert with the retry ladder)."""
    if k_eig == 0:
        return np.zeros((0,)), np.zeros((L.shape[0], 0))

    L_eigsh = (L + scipy.sparse.identity(L.shape[0]) * eps).tocsc()
    Mmat = scipy.sparse.diags(np.asarray(massvec, dtype=np.float64))
    failcount = 0
    while True:
        try:
            # deterministic ARPACK start, seeded per ATTEMPT: a retry still
            # escapes a start-vector-driven convergence failure while the
            # run stays reproducible (and equal to the JAX package's)
            v0 = np.random.RandomState(777 + failcount).randn(L.shape[0])
            evals, evecs = sla.eigsh(L_eigsh, k=k_eig, M=Mmat, sigma=eps,
                                     v0=v0)
            evals = np.clip(evals, a_min=0.0, a_max=float("inf"))
            return evals, evecs
        except Exception as e:  # same ladder as reference geometry.py:345-361
            print(e)
            if failcount > 3:
                raise ValueError("failed to compute eigendecomp")
            failcount += 1
            print(f"--- decomp failed; adding eps ===> count: {failcount}")
            L_eigsh = L_eigsh + scipy.sparse.identity(L.shape[0]) * (eps * 10 ** failcount)


class _FullF32Matmul:
    """f32 products at full precision whatever the caller set, restored
    when the last user leaves. The wanted band's relative gaps are ~1e-5 of
    lambda_max(C): TF32 (about 3 decimal digits) would corrupt the Gram and
    Rayleigh-Ritz matrices on the card while the CPU tests pass.

    The settings are process-wide and get_all_operators solves in several
    threads, so the users are counted under a lock: the first one in saves
    the caller's settings, the last one out restores them, and no solve
    runs at the caller's precision while another has left."""

    def __init__(self):
        self._lock = threading.Lock()
        self._users = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._users == 0:
                self._saved = (torch.get_float32_matmul_precision(),
                               torch.backends.cuda.matmul.allow_tf32)
                torch.set_float32_matmul_precision("highest")
                torch.backends.cuda.matmul.allow_tf32 = False
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    prec, tf32 = self._saved
                    torch.set_float32_matmul_precision(prec)
                    torch.backends.cuda.matmul.allow_tf32 = tf32


_full_f32_matmul = _FullF32Matmul()


def _cheb_filter(matvec, X: torch.Tensor, lo, hi, m: int) -> torch.Tensor:
    """Y = rho_m(C) X with rho_m(x) = T_m((x - c)/e) / T_m((0 - c)/e),
    c = (hi + lo)/2, e = (hi - lo)/2: the Zhou-Saad scaled Chebyshev filter
    (normalized at x = 0, so |rho_m| <= 1 on [0, hi]: no overflow, while
    the wanted band [0, lo) grows relative to [lo, hi] like
    e^{2m sqrt((lo-x)/(hi-lo))}). The scalars are float32, as the JAX
    package's traced scalars are; the recurrence is a loop of launches."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    e = (hi - lo) / f32(2.0)
    c = (hi + lo) / f32(2.0)
    l0 = -c / e                      # ell(0), < -1
    sigma = f32(1.0) / l0
    Zm1 = X
    Zm0 = matvec(X).sub_(X, alpha=float(c)).mul_(float(sigma / e))
    for _ in range(1, m):
        sigma_new = f32(1.0) / (f32(2.0) * l0 - sigma)
        Zn = (matvec(Zm0).sub_(Zm0, alpha=float(c))
              .mul_(float(f32(2.0) * sigma_new / e))
              .sub_(Zm1, alpha=float(sigma * sigma_new)))
        Zm1, Zm0, sigma = Zm0, Zn, sigma_new
    return Zm0


def _whiten_factor(G, tau: float = 1e-12) -> np.ndarray:
    """Host half of SVQB orthonormalization (Stathopoulos-Wu): from the Gram
    matrix G = Y^T Y, the (n, n) factor F such that Y F has orthonormal
    columns: diagonal scaling, eigh whitening, rank-revealing clip. The
    eigh of a ~100 KB matrix runs on the host in float64."""
    import scipy.linalg
    G = np.asarray(G, np.float64)
    G = 0.5 * (G + G.T)
    d = 1.0 / np.sqrt(np.clip(np.diag(G), 1e-30, None))
    w, S = scipy.linalg.eigh(G * d[:, None] * d[None, :])
    w = np.clip(w, tau * max(w.max(), 1e-300), None)
    return (d[:, None] * S) / np.sqrt(w)[None, :]


def _host_eigh_ascending(T):
    """Host f64 eigh of the (n, n) Rayleigh-Ritz matrix."""
    import scipy.linalg
    T = np.asarray(T, np.float64)
    w, S = scipy.linalg.eigh(0.5 * (T + T.T))
    return w, S


def _device_solver_setup(L_ell: Ell, massvec, k_eig: int, n_valid, eps: float,
                         lambda_cut, oversample):
    """Validity mask, M^-1/2 row scaling, spectral-radius bound and filter
    window estimate, in host numpy (trivial O(nnz) reductions)."""
    idx = np.asarray(L_ell.idx)
    val = np.asarray(L_ell.val)
    massvec_np = np.asarray(massvec)
    V = idx.shape[0]
    mask = massvec_np > 0
    if n_valid is not None:
        # caller-declared valid-row count: rows at or beyond n_valid are
        # padding even if their mass is nonzero
        mask = mask & (np.arange(V) < n_valid)
    inv_sqrt_m = np.where(
        mask, 1.0 / np.sqrt(np.where(mask, massvec_np, 1.0)), 0.0
    ).astype(np.float32)

    # spectral radius bound of C (Gershgorin over the normalized entries,
    # plus the eps * M^-1 regularization term of the matvec: a tiny-mass
    # vertex with a near-zero Laplacian row otherwise pushes lambda_max(C)
    # outside the Chebyshev interval)
    scaled = np.abs(val) * inv_sqrt_m[:, None] * inv_sqrt_m[idx]
    bound = (float(scaled.sum(axis=1).max())
             + eps * float(inv_sqrt_m.max()) ** 2
             + eps)

    if oversample is None:
        oversample = max(8, k_eig // 4)
    # the subspace cannot exceed the number of valid rows (tiny meshes)
    n_valid_rows = int(mask.sum())
    if k_eig > n_valid_rows:
        raise RuntimeError(f"k_eig={k_eig} exceeds the {n_valid_rows} valid "
                           "vertices")
    n_cols = min(k_eig + oversample, n_valid_rows)
    oversample = n_cols - k_eig

    # Weyl's law cutoff estimate: lambda_j ~= 4 pi j / Area for a 2-manifold
    # (the outer loop replaces it with the top Ritz value after one sweep)
    if lambda_cut is None:
        area = float(massvec_np.sum())
        lambda_cut = max(4.0 * np.pi * (n_cols + 1) / max(area, 1e-30), eps)
    lambda_cut = min(lambda_cut, 0.5 * bound)
    return mask, inv_sqrt_m, bound, n_cols, oversample, lambda_cut


def _ell_to_scipy(ell: Ell):
    """Host CSR from an ELL bundle (explicit padding zeros pruned)."""
    idx = np.asarray(ell.idx)
    val = np.asarray(ell.val)
    V, D = idx.shape
    rows = np.repeat(np.arange(V), D)
    m = scipy.sparse.coo_matrix(
        (val.ravel(), (rows, idx.ravel())), shape=(V, V)).tocsr()
    m.eliminate_zeros()
    return m


def _dense_eigh_tiny(L_ell: Ell, massvec, mask, k_eig: int, eps: float,
                     polish, device=None):
    """Dense generalized eigh for tiny problems (valid rows ~ subspace
    size), where the band-pass filter cannot separate the wanted band: a
    direct f64 eigh of (L + eps I, M) on the valid rows, exact, with the
    host ladder's semantics (reference geometry.py:340-352). With polish:
    float64 numpy; else float32 tensors on `device`."""
    import scipy.linalg
    idx = np.where(np.asarray(mask))[0]
    if polish is not None:
        L_sp, mass = polish
    else:
        L_sp, mass = _ell_to_scipy(L_ell), np.asarray(massvec)
    A = np.asarray(L_sp.todense(), dtype=np.float64)[np.ix_(idx, idx)]
    A[np.diag_indices_from(A)] += eps
    m = np.asarray(mass, np.float64)[idx]
    w, U = scipy.linalg.eigh(A, np.diag(m))
    # subtract the eps regularization like every sibling path, so the zero
    # mode comes back as exactly 0
    w = np.clip(w[:k_eig] - eps, 0.0, None)
    evecs = np.zeros((np.asarray(L_ell.idx).shape[0], k_eig), np.float64)
    evecs[idx] = U[:, :k_eig]
    if polish is not None:
        return w, evecs
    return (torch.as_tensor(w, dtype=torch.float32, device=device),
            torch.as_tensor(evecs, dtype=torch.float32, device=device))


def _rr_polish_host(L: scipy.sparse.spmatrix, massvec, Y, k_eig: int,
                    eps: float, certify_tol: float | None = 1e-3,
                    timings: dict | None = None,
                    certify_budget: float = 2e9):
    """Float64 Rayleigh-Ritz polish of a device-converged basis Y (V, n).

    The f32 sweeps converge the subspace to the f32 matvec noise floor; this
    polish (a) works in f64, (b) augments the basis with the selective f64
    residual block Z = CQ - Q(Q^T CQ) (one block-Krylov step, correcting
    the f32 subspace error to second order), (c) solves one generalized RR,
    and (d) certifies the pairs by their f64 residual, raising
    EigenSolveNotConverged above certify_tol. The SpMMs are scipy's (the
    JAX package's no-compiler fallback). Returns (evals (k,), evecs (V, k))
    float64, evecs M-orthonormal.

    certify_budget: bytes of (V, n) f64 blocks that the certification may
    keep alive to reuse C[Y, Z] instead of one more SpMM. They are CY, CZ
    and the copy of CY that Z starts from: up to three blocks, and the
    guard counts all three (the JAX package's guard counts one)."""
    import scipy.linalg

    def _mark(stage, t0):
        if timings is not None:
            timings[stage] = timings.get(stage, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    _t = time.perf_counter()
    V = Y.shape[0]
    m = np.asarray(massvec, np.float64)
    r = np.zeros(V)
    pos = m > 0
    r[pos] = 1.0 / np.sqrt(m[pos])
    Lcsr = L.tocsr()

    # fold the M^-1/2 scaling and the eps shift into the operator once:
    # C = r L r + eps r^2 I, so each matvec is one SpMM
    rows = np.repeat(np.arange(V), np.diff(Lcsr.indptr))
    C_sp = scipy.sparse.csr_matrix(
        (Lcsr.data * r[rows] * r[Lcsr.indices], Lcsr.indices, Lcsr.indptr),
        shape=Lcsr.shape)
    C_sp = (C_sp + scipy.sparse.diags(eps * r * r)).tocsr()

    def matvec(B):
        t0 = time.perf_counter()
        out = C_sp @ B
        _mark("polish_spmm", t0)
        return out

    _t = _mark("polish_setup", _t)

    # no QR: the generalized eigh(T, G) takes a non-orthonormal basis (Y
    # arrives SVQB'd, so G ~ I). Tall (V, n) products go through
    # np.matmul(..., out=), which BLAS runs far faster than `A @ B` with a
    # fresh tall result.
    Y = np.asarray(Y, np.float64)
    _t = _mark("polish_cast", _t)
    CY = matvec(Y)
    T0 = Y.T @ CY
    G0 = Y.T @ Y
    gemm_certify = (certify_tol is not None
                    and 3 * Y.shape[0] * Y.shape[1] * 8 < certify_budget)
    CZ = None
    # residual block Z = CY - Y G0^-1 T0, column-normalized; only columns
    # whose residual sits above the f32 noise floor join
    Z = CY.copy() if gemm_certify else CY
    Z -= np.matmul(Y, scipy.linalg.solve(G0, T0, assume_a="pos"),
                   out=np.empty_like(CY))
    zn = np.linalg.norm(Z, axis=0)
    cnorm = max(float(np.abs(C_sp).sum(axis=1).max()), 1e-300)
    f32_floor = float(np.finfo(np.float32).eps) * cnorm
    keep = zn > max(4.0 * f32_floor, 1e-13 * max(zn.max(), 1e-300))
    if keep.all():
        Z /= zn
    elif keep.any():
        Z = Z[:, keep] / zn[keep]
    else:
        Z = None
    if Z is not None:
        CZ = matvec(Z)
        # blockwise T/G for B = [Y, Z] (C symmetric: Z^T C Y = (Y^T C Z)^T)
        YtZ, YtCZ = Y.T @ Z, Y.T @ CZ
        T = np.block([[T0, YtCZ], [YtCZ.T, Z.T @ CZ]])
        G = np.block([[G0, YtZ], [YtZ.T, Z.T @ Z]])
    else:
        T, G = T0, G0
    if not gemm_certify:
        CY = CZ = None  # free the (V, n) blocks before the dense work
    T = 0.5 * (T + T.T)
    G = 0.5 * (G + G.T)
    _t = _mark("polish_gram", _t)
    try:
        w, S = scipy.linalg.eigh(T, G)
    except scipy.linalg.LinAlgError:
        # near-dependent augmentation columns: regularize and retry
        G = G + 1e-10 * np.eye(G.shape[0])
        w, S = scipy.linalg.eigh(T, G)
    _t = _mark("polish_eigh", _t)
    evals = np.clip(w[:k_eig] - eps, 0.0, None)
    # B @ S without materializing B = [Y, Z]
    n = Y.shape[1]
    BS = np.matmul(Y, np.ascontiguousarray(S[:n, :k_eig]),
                   out=np.empty((Y.shape[0], k_eig)))
    if Z is not None:
        BS += np.matmul(Z, np.ascontiguousarray(S[n:, :k_eig]),
                        out=np.empty_like(BS))
    _t = _mark("polish_recombine", _t)

    if certify_tol is not None:
        # f64 certification of the final pairs: the f32 outer loop's
        # noise-floor acceptance can accept an unconverged basis on
        # ill-scaled operators; the true residual ||C u - w u|| catches it
        if gemm_certify:
            # C (Y S1 + Z S2) = CY S1 + CZ S2 from the kept blocks
            CBS = np.matmul(CY, np.ascontiguousarray(S[:n, :k_eig]),
                            out=np.empty_like(BS))
            if Z is not None:
                CBS += np.matmul(CZ, np.ascontiguousarray(S[n:, :k_eig]),
                                 out=np.empty_like(BS))
            res = CBS - BS * w[None, :k_eig]
        else:
            res = matvec(BS) - BS * w[None, :k_eig]
        # denominator floor: the f64 noise of one matvec, ~u64 * ||C||
        f64_floor = 2.22e-16 * max(float(w[-1]), 1.0)
        rel = float(np.linalg.norm(res, axis=0).max()
                    / max(float(w[k_eig - 1]), eps, f64_floor))
        if rel > certify_tol:
            raise EigenSolveNotConverged(
                f"f64 certification failed after polish: max relative "
                f"residual {rel:.3e} > {certify_tol:g}: the f32 sweeps "
                "converged to a wrong subspace (ill-scaled operator?)")
    evecs = r[:, None] * BS
    _mark("polish_certify", _t)
    return evals, evecs


# --- the four device stages -------------------------------------------------
#   1. filter + Gram:      Y = p_m(C) X;  G = Y^T Y
#   2. [host F1 = whiten(G)]  rotate + Gram:  Y <- Y F1;  G2 = Y^T Y
#   3. [host F2 = whiten(G2)] rotate + apply: Y <- Y F2;  W = C Y;  T = Y^T W
#   4. [host w, S = eigh(T)]  rotate + residuals: U = Y S;  R = W S - U w
# The products are torch.matmul at full f32 (see _full_f32_matmul). Each
# stage takes `reduce`, applied to every (n, n) matrix and to the residuals'
# squared column sums: the identity on one card (whose residual norms are
# vector_norm's), the fixed-order sum over the `vert` shards in the sharded
# solver (each rank then holds its rows of every (V, n) block, and every
# rank sees the same reduced bits).


def _identity(t):
    return t


def _scaled_matvec(apply_op, inv_sqrt_m: torch.Tensor, mask: torch.Tensor,
                   bound: float, eps: float, col_chunk: int | None = None,
                   gather=None):
    """x -> C x = r (A (r x)) + eps r^2 x with r = M^-1/2; padded rows act
    as bound * I, so the band-pass filter damps leakage onto padding
    instead of amplifying it into a fake zero mode. apply_op: the SpMM.
    col_chunk: apply in column blocks of this width (bounds the ELL
    gather's (V, D, chunk) temporary). gather: for a shard's rows, the
    whole surface's r x from every shard's (the operator's columns are
    global; L is symmetric and applied as r L r, so scaling before the
    gather lets both sides use local data)."""
    r = inv_sqrt_m[:, None]
    e2 = (float(np.float32(eps)) * inv_sqrt_m * inv_sqrt_m)[:, None]
    keep = mask[:, None]
    bound_r = float(np.float32(bound))

    def block(x):
        rx = r * x
        y = apply_op(rx if gather is None else gather(rx))
        y = r * y + e2 * x
        return torch.where(keep, y, bound_r * x)

    def mv(x):
        n = x.shape[1]
        if col_chunk is None or n <= col_chunk:
            return block(x)
        return torch.cat([block(x[:, i:i + col_chunk])
                          for i in range(0, n, col_chunk)], dim=1)
    return mv


def _mv_ell(L_idx, L_val, inv_sqrt_m, mask, bound, eps, col_chunk=None,
            gather=None):
    """C x on the ELL gather (ops/sparse.py::ell_matvec); with `gather`,
    on a shard's rows of the operator (global column indices)."""
    ell = Ell(L_idx, L_val)
    return _scaled_matvec(lambda x: ell_matvec(ell, x), inv_sqrt_m, mask,
                          bound, eps, col_chunk, gather)


def _mv_blocked(b, inv_sqrt_m, mask, bound, eps):
    """C x on the sliced-ELL SpMM (kernel B5 on a CUDA device), in the
    RCM-permuted, tile-padded row order."""
    from ..ops.blocked_ell import blocked_ell_matvec
    return _scaled_matvec(lambda x: blocked_ell_matvec(b, x), inv_sqrt_m,
                          mask, bound, eps)


def _mv_banded(band, inv_sqrt_m, mask, bound, eps, col_chunk=None):
    """C x on the dense RCM band (ops/banded.py::banded_matvec), in the
    RCM-permuted, tile-padded row order."""
    from ..ops.banded import banded_matvec
    return _scaled_matvec(lambda x: banded_matvec(band, x), inv_sqrt_m,
                          mask, bound, eps, col_chunk)


def _mv_dia(data, offsets: tuple, inv_sqrt_m, mask, bound, eps,
            col_chunk=None):
    """C x on the DIA format (ops/banded.py::dia_matvec), in the original
    row order."""
    from ..ops.banded import dia_matvec
    return _scaled_matvec(lambda x: dia_matvec(data, offsets, x),
                          inv_sqrt_m, mask, bound, eps, col_chunk)


def _dev_filter_gram(mv, mask, X, lo, bound, cheb_degree: int,
                     reduce=_identity):
    """Stage 1: Y = p_m(C) X on the valid rows, G = Y^T Y."""
    X = torch.where(mask[:, None], X, torch.zeros((), dtype=X.dtype,
                                                  device=X.device))
    Y = _cheb_filter(mv, X, lo, bound, cheb_degree)
    return Y, reduce(Y.T @ Y)


def _dev_rotate_gram(Y, F, reduce=_identity):
    """Stage 2: apply the first whitening factor, re-Gram (the second SVQB
    pass fixes the f32 roundoff of the big rotation product)."""
    Y = Y @ F
    return Y, reduce(Y.T @ Y)


def _dev_rotate_apply(mv, Y, F, reduce=_identity):
    """Stage 3: apply the second whitening factor, W = C Y, T = Y^T W."""
    Y = Y @ F
    W = mv(Y)
    return Y, W, reduce(Y.T @ W)


def _dev_rotate_residuals(Y, W, S, w, reduce=_identity):
    """Stage 4: rotate into the Ritz basis, per-column residual 2-norms."""
    U = Y @ S
    R = W @ S - U * w[None, :]
    if reduce is _identity:
        return U, torch.linalg.vector_norm(R, dim=0)
    return U, torch.sqrt(reduce((R * R).sum(dim=0)))


def _split_sweep(filter_gram, rotate_apply, X, lo, reduce=_identity):
    """One outer iteration through the four stages. filter_gram(X, lo) and
    rotate_apply(Y, F) close over the operator (and `reduce`). Returns
    (Ritz vectors U (on the device), Ritz values w ascending (np.float64),
    residual 2-norms (np.float64))."""
    def dev(a):
        return torch.as_tensor(a, dtype=X.dtype, device=X.device)

    def host(t):
        return t.detach().cpu().numpy()

    Y, G = filter_gram(X, lo)
    Y, G2 = _dev_rotate_gram(Y, dev(_whiten_factor(host(G))), reduce)
    Y, W, T = rotate_apply(Y, dev(_whiten_factor(host(G2))))
    w, S = _host_eigh_ascending(host(T))
    U, res = _dev_rotate_residuals(Y, W, dev(S), dev(w), reduce)
    return U, w, host(res).astype(np.float64)


def _sweep_fn(mv, mask, bound, cheb_degree, reduce=_identity):
    """sweep(X, lo): one outer iteration on the matvec mv."""
    return lambda X, lo: _split_sweep(
        lambda Xs, los: _dev_filter_gram(mv, mask, Xs, los, bound,
                                         cheb_degree, reduce),
        lambda Ys, Fs: _dev_rotate_apply(mv, Ys, Fs, reduce), X, lo, reduce)


# Diagnostic record of the most recent _converge call in this process:
# {"name", "exit" ("tol" | "floor"), "sweeps", "worst", "tol_scale",
#  "floor_limit"}, written on every successful convergence, so a run can
# tell a tolerance exit from a noise-floor acceptance.
LAST_CONVERGE_INFO: dict = {}


def _converge(sweep_fn, X, lo0: float, k_eig: int, eps: float, tol: float,
              max_sweeps: int, bound: float, verbose: bool, name: str):
    """Outer loop: sweep until the worst wanted residual clears tol*scale,
    or accept the f32 noise floor by the stagnation rule (iterate until the
    residual stops shrinking; one post-stagnation sweep matters for the
    f64 polish). Returns (X, w). Raises EigenSolveNotConverged on
    stagnation far above the floor or when max_sweeps run out; a
    non-finite residual is a fault, not slow convergence, and raises a
    plain RuntimeError."""
    def _record(exit_kind, it, worst, scale):
        LAST_CONVERGE_INFO.clear()
        LAST_CONVERGE_INFO.update(
            name=name, exit=exit_kind, sweeps=it + 1, worst=worst,
            tol_scale=tol * scale,
            floor_limit=max(1e-5 * bound, 10 * tol * scale))

    lo = np.float32(lo0)
    prev_worst = np.inf
    w = None
    worst = np.inf
    for it in range(max_sweeps):
        X, w, res = sweep_fn(X, lo)
        scale = float(max(float(w[k_eig - 1]), eps))
        worst = float(np.max(res[:k_eig]))
        if verbose:
            print(f"  {name} sweep {it}: worst wanted residual {worst:.3e} "
                  f"(tol*scale {tol * scale:.3e})", flush=True)
        if not np.isfinite(worst):
            raise RuntimeError(f"{name}: non-finite residual at sweep {it}")
        if worst <= tol * scale:
            _record("tol", it, worst, scale)
            break
        if worst > 0.9 * prev_worst:
            # < 1.11x reduction: a plateau. Accept it when it lands within
            # an order of the tolerance or at the large-problem f32 floor
            # (~100 units of rounding of one matvec)
            if worst <= max(1e-5 * bound, 10 * tol * scale):
                _record("floor", it, worst, scale)
                break
            raise EigenSolveNotConverged(
                f"{name}: residual stagnated at {worst:.3e} (sweep {it}), "
                "far above the rounding floor")
        prev_worst = worst
        # adapt the filter window: damp everything above the basis's top
        lo = np.float32(np.clip(w[-1], 0.0, 0.5 * bound))
    else:
        raise EigenSolveNotConverged(
            f"{name}: wanted band not converged after {max_sweeps} sweeps "
            f"(worst residual {worst:.3e})")
    return X, w


def _format_budget(V: int, n_cols: int, device: torch.device) -> int:
    """Bytes the sliced-ELL format may take (8 bytes a slot, about 1.4
    slots a nonzero on a Delaunay mesh: some 8 MB at 100k vertices). On a
    CUDA device: 80% of the free memory less twelve (V, n_cols) f32 blocks
    (the recurrence's three and the matvec's temporaries). Elsewhere the
    JAX package's figure for a 16 GB chip."""
    block = V * n_cols * 4
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(0, int(0.8 * free) - 12 * block)
    return min(6_500_000_000, max(2_500_000_000, 11_000_000_000 - 3 * block))


def _cheb_degree(cheb_degree, bound: float, lambda_cut: float) -> int:
    """The filter degree: the Chebyshev convergence exponent
    sqrt(bound / lambda_cut), capped at the JAX package's 320 so both
    packages run the same schedule, rounded up to a multiple of 32."""
    if cheb_degree is not None:
        return cheb_degree
    cheb_degree = int(np.clip(8.0 * np.sqrt(bound / lambda_cut) + 10,
                              50, 320))
    return -32 * (-cheb_degree // 32)


def _ell_col_chunk(rows: int, degree: int, n_cols: int) -> int | None:
    """Column block that bounds the ELL gather's (rows, D, chunk)
    temporary to ~1.5 GB."""
    gather_bytes = rows * degree * 4
    if gather_bytes * n_cols > 1.5e9:
        return max(16, int(1.5e9 / gather_bytes) // 16 * 16)
    return None


def _check_cheb_degree(cheb_degree) -> None:
    if cheb_degree is not None and cheb_degree < 2:
        raise ValueError(f"cheb_degree must be >= 2, got {cheb_degree} "
                         "(the recurrence always consumes degrees 0..1)")


def _to_rows(a: np.ndarray, perm: np.ndarray, n_rows: int) -> np.ndarray:
    """A (V,) vector in a format's permuted, tile-padded row order."""
    out = np.zeros(n_rows, a.dtype)
    out[:len(perm)] = a[perm]
    return out


def _operator_format(banded, L_ell, polish, inv_sqrt_m, mask, bound, eps,
                     n_cols, dev):
    """The SpMM format of eigensolve_device's `banded`: (name, perm or None,
    rows of the iterate, the matvec C x on those rows), or None for the
    ELL gather. Raises where a required format does not fit."""
    from ..ops.banded import (banded_from_sparse_device, dia_from_sparse,
                              rcm_permutation)
    from ..ops.blocked_ell import blocked_ell_from_sparse
    if not (banded in (True, "dia", "blocked")
            or (banded is None and dev.type == "cuda")):
        return None
    V = len(mask)
    L_host = polish[0] if polish is not None else _ell_to_scipy(L_ell)
    fits = L_host.shape[0] == V
    if banded == "dia":
        # structured meshes (few distinct col - row offsets): statically
        # shifted elementwise products, no gather, memory D * V
        dia = dia_from_sparse(L_host) if fits else None
        if dia is None:
            raise RuntimeError("banded='dia' but the operator is not "
                               "diagonal-structured (or the ELL was padded)")
        return ("eigensolve_device[dia]", None, V, _mv_dia(
            torch.from_numpy(dia[0]).to(dev), dia[1],
            torch.from_numpy(inv_sqrt_m).to(dev),
            torch.from_numpy(mask).to(dev), bound, eps,
            64 if V * n_cols * 4 > 1.0e9 else None))
    budget = _format_budget(V, n_cols, dev)
    if banded is True:
        rep = banded_from_sparse_device(
            L_host, max_band_bytes=budget, perm=rcm_permutation(L_host),
            device=dev) if fits else None
        if rep is None:
            raise RuntimeError("banded=True but the RCM-reordered bandwidth "
                               "exceeds the band-size budget")
        T_, TR, Wd = rep.band.shape
        n_rows = T_ * TR
        col_chunk = None
        if T_ * Wd * 4 * n_cols > 1.5e9:   # the (T, W, chunk) window gather
            col_chunk = max(16, int(1.5e9 / (T_ * Wd * 4)) // 16 * 16)
        mv = _mv_banded(rep, torch.from_numpy(
            _to_rows(inv_sqrt_m, rep.perm, n_rows)).to(dev),
            torch.from_numpy(_to_rows(mask, rep.perm, n_rows)).to(dev),
            bound, eps, col_chunk)
        return "eigensolve_device[banded]", rep.perm, n_rows, mv
    rep = blocked_ell_from_sparse(
        L_host, max_bytes=budget, perm=rcm_permutation(L_host),
        device=dev) if fits else None
    if rep is None:
        if banded == "blocked":
            raise RuntimeError("banded='blocked' but the sliced-ELL format "
                               "exceeds the memory budget")
        return None
    mv = _mv_blocked(rep, torch.from_numpy(
        _to_rows(inv_sqrt_m, rep.perm, rep.n_pad)).to(dev),
        torch.from_numpy(_to_rows(mask, rep.perm, rep.n_pad)).to(dev),
        bound, eps)
    return "eigensolve_device[blocked]", rep.perm, rep.n_pad, mv


def eigensolve_device(L_ell: Ell, massvec, k_eig: int,
                      n_valid: int | None = None,
                      eps: float = 1e-8, tol: float = 2e-4,
                      max_sweeps: int = 30,
                      lambda_cut: float | None = None,
                      cheb_degree: int | None = None,
                      oversample: int | None = None,
                      seed: int = 777,
                      polish=None,
                      banded: bool | str | None = None,
                      verbose: bool = False,
                      timings: dict | None = None,
                      device="cuda"):
    """The k smallest generalized eigenpairs of L phi = lambda M phi by
    residual-converged Chebyshev-filtered subspace iteration on `device`
    (see the module docstring).

    L_ell: symmetric PSD weak Laplacian in ELL layout, numpy (padded rows
    all-zero). massvec: (V,) numpy, positive on valid rows, 0 on padding.
    Without polish returns float32 tensors on `device` (evals (k,), evecs
    (V, k), padded rows zero); with polish=(L_scipy, massvec_f64) the f64
    host Rayleigh-Ritz polish runs on the converged basis and float64 numpy
    arrays come back.

    tol: relative residual target (relative to the top wanted Ritz value);
    a stagnating residual is accepted at the f32 noise floor (_converge).
    cheb_degree: filter degree per sweep (default from sqrt(bound /
    lambda_cut), rounded up to a multiple of 32). seed: the start block
    X0 ~ N(0, 1) comes from a torch.Generator seeded with it (not the JAX
    package's bits). banded: operator format. None: on a CUDA device the
    sliced-ELL SpMM (kernel B5), or the ELL gather when the format exceeds
    the memory budget; on the CPU the ELL gather. 'blocked' requires the
    sliced format (its plain version on the CPU), True the dense RCM band
    and 'dia' the DIA format (ops/banded.py, plain torch); each raises if
    the operator does not fit it. False forces the ELL gather. timings:
    optional dict of wall seconds per stage (eigen_band_build,
    eigen_sweeps, eigen_polish, polish_*).

    Raises EigenSolveNotConverged if the band does not converge in
    max_sweeps, or, with polish, if the f64 certification rejects the
    basis (compute_operators then falls back to the host ladder)."""
    def _mark(stage, t0):
        if timings is not None:
            timings[stage] = timings.get(stage, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    if banded not in (None, False, True, "blocked", "dia"):
        raise ValueError(f"banded={banded!r}: expected None, False, True, "
                         "'blocked' or 'dia'")
    _check_cheb_degree(cheb_degree)
    dev = torch.device(device)
    V = np.asarray(L_ell.idx).shape[0]
    if k_eig == 0:
        return (torch.zeros((0,), device=dev),
                torch.zeros((V, 0), device=dev))

    mask, inv_sqrt_m, bound, n_cols, oversample, lambda_cut = \
        _device_solver_setup(L_ell, massvec, k_eig, n_valid, eps,
                             lambda_cut, oversample)

    # small problems: when the subspace spans more than ~1/10 of the
    # spectrum the filter cannot separate the wanted band; a direct f64
    # eigh is exact there (gate as in the JAX package)
    n_valid_rows = int(mask.sum())
    if n_valid_rows <= min(12 * n_cols, 4096):
        return _dense_eigh_tiny(L_ell, massvec, mask, k_eig, eps, polish,
                                dev)
    cheb_degree = _cheb_degree(cheb_degree, bound, lambda_cut)

    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    fmt = _operator_format(banded, L_ell, polish, inv_sqrt_m, mask, bound,
                           eps, n_cols, dev)
    if fmt is not None or dev.type == "cuda":
        _mark("eigen_band_build", t0)
    if fmt is None:
        # ELL gather: wide operators, banded=False, and the CPU default
        idx = np.asarray(L_ell.idx)
        fmt = ("eigensolve_device", None, V, _mv_ell(
            torch.from_numpy(idx).to(dev),
            torch.from_numpy(np.asarray(L_ell.val, np.float32)).to(dev),
            torch.from_numpy(inv_sqrt_m).to(dev),
            torch.from_numpy(mask).to(dev), bound, eps,
            _ell_col_chunk(V, idx.shape[1], n_cols)))
    name, perm, n_rows, mv = fmt
    mask_rows = mask if perm is None else _to_rows(mask, perm, n_rows)
    mask_t = torch.from_numpy(mask_rows).to(dev)

    with _full_f32_matmul():
        X0 = torch.randn((n_rows, n_cols), generator=gen, device=dev)
        t0 = time.perf_counter()
        X, w = _converge(_sweep_fn(mv, mask_t, bound, cheb_degree), X0,
                         lambda_cut, k_eig, eps, tol, max_sweeps, bound,
                         verbose, name)
    # back to the original vertex order
    if perm is None:
        X_orig = X.cpu().numpy()
    else:
        X_orig = np.zeros((V, n_cols), np.float32)
        X_orig[perm] = X[:V].cpu().numpy()
    t0 = _mark("eigen_sweeps", t0)
    if polish is not None:
        L_sp, mass_f64 = polish
        out = _rr_polish_host(L_sp, mass_f64, X_orig, k_eig, eps,
                              timings=timings)
        _mark("eigen_polish", t0)
        return out
    evals = torch.as_tensor(np.clip(w[:k_eig] - eps, 0.0, None),
                            dtype=torch.float32, device=dev)
    evecs = torch.as_tensor(inv_sqrt_m[:, None] * X_orig[:, :k_eig],
                            dtype=torch.float32, device=dev)
    return evals, evecs


# ---------------------------------------------------------------------------
# The vertex-sharded solver (several cards): every (V, n) block row-sharded
# over the `vert` axis of a DeviceMesh, one rank a shard. The SpMM gathers
# the iterate (the operator's column indices are global); the Gram, Rayleigh-
# Ritz and residual sums are reduced over the shards in a fixed order; all
# O(V) work stays on the rank's card.
# ---------------------------------------------------------------------------

def eigensolve_device_sharded(L_ell: Ell, massvec, k_eig: int, mesh,
                              axis: str = "vert",
                              n_valid: int | None = None,
                              eps: float = 1e-8, tol: float = 2e-4,
                              max_sweeps: int = 30,
                              lambda_cut: float | None = None,
                              cheb_degree: int | None = None,
                              oversample: int | None = None,
                              seed: int = 777,
                              polish=None,
                              verbose: bool = False,
                              device=None):
    """eigensolve_device with every (V, n) block row-sharded over the
    `axis` axis of `mesh` (a `parallel.make_mesh` DeviceMesh), run on every
    rank of it: the route for surfaces whose blocks do not fit one card.
    The same algorithm and convergence loop as the ELL route of
    eigensolve_device; what crosses the shards is one all-gather of the
    (V, n) iterate per filter matvec and fixed-order sums of the (n, n)
    matrices and the residuals, so every rank makes the same host
    decisions. The start block is the single-card solver's (the whole
    (V, n) block from a torch.Generator seeded with `seed`, each rank
    keeping its rows), and there is no tiny dense route.

    L_ell, massvec: the whole padded surface (numpy), the same on every
    rank; V must be divisible by the shard count. device: this rank's card
    (default cuda:LOCAL_RANK). Returns (evals (k,), evecs (V / shards, k),
    this rank's rows) f32 on `device`; with polish=(L_scipy, massvec_f64)
    the iterate is gathered and every rank runs the f64 host polish and
    returns the whole (evals, evecs) float64 numpy arrays."""
    from ..ops.collectives import ordered_sum
    from ..parallel.distributed import rank_device
    from ..parallel.mesh import _AllGather

    n_shards = mesh.size(mesh.mesh_dim_names.index(axis))
    V = np.asarray(L_ell.idx).shape[0]
    if V % n_shards != 0:
        raise ValueError(f"V={V} not divisible by {n_shards} '{axis}' shards"
                         " — pad the operator rows (ell_pad) first")
    _check_cheb_degree(cheb_degree)
    dev = rank_device(device)
    if k_eig == 0:
        return (torch.zeros((0,), device=dev),
                torch.zeros((V // n_shards, 0), device=dev))

    mask, inv_sqrt_m, bound, n_cols, oversample, lambda_cut = \
        _device_solver_setup(L_ell, massvec, k_eig, n_valid, eps,
                             lambda_cut, oversample)
    cheb_degree = _cheb_degree(cheb_degree, bound, lambda_cut)

    group = mesh.get_group(axis)
    step = V // n_shards
    rows = slice(mesh.get_local_rank(axis) * step,
                 (mesh.get_local_rank(axis) + 1) * step)

    def local(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a)[rows] if dtype is None
            else np.asarray(a, dtype)[rows])).to(dev)
    idx = np.asarray(L_ell.idx)
    inv_t, mask_t = local(inv_sqrt_m), local(mask)
    mv = _mv_ell(local(idx), local(L_ell.val, np.float32), inv_t, mask_t,
                 bound, eps, _ell_col_chunk(step, idx.shape[1], n_cols),
                 gather=lambda t: _AllGather.apply(t, 0, group))
    # a sum over one shard is the identity (and keeps the single-card
    # route's residual norms)
    reduce = _identity if n_shards == 1 else (
        lambda t: ordered_sum(t, group))

    gen = torch.Generator(device=dev).manual_seed(seed)
    with _full_f32_matmul():
        X0 = torch.randn((V, n_cols), generator=gen, device=dev)[rows]
        X, w = _converge(_sweep_fn(mv, mask_t, bound, cheb_degree, reduce),
                         X0.contiguous(), lambda_cut, k_eig, eps, tol,
                         max_sweeps, bound, verbose,
                         "eigensolve_device_sharded")
    if polish is not None:
        L_sp, mass_f64 = polish
        X_all = _AllGather.apply(X, 0, group).cpu().numpy()
        return _rr_polish_host(L_sp, mass_f64, X_all, k_eig, eps)
    evals = torch.as_tensor(np.clip(w[:k_eig] - eps, 0.0, None),
                            dtype=torch.float32, device=dev)
    evecs = inv_t[:, None] * X[:, :k_eig]
    return evals, evecs
