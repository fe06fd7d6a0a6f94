"""All-pairs geodesic distances on the card: the heat method as dense
linear algebra. The counterpart of diffusionnet_tpu/geometry/heat_device.py.

The host paths (geodesics.py) compute the all-pairs tables the correspondence
evals consume (reference geometry.py:784-896) either exactly (native ICH,
~minutes per mesh) or approximately (scipy-factorized heat method). This
module is the third point on that curve: the heat method (Crane, Weischedel
& Wardetzky, "Geodesics in Heat", TOG 2013) batched over ALL sources at once
on the device.

Design notes (the JAX package's, kept):
  * Only the SPARSE pieces travel to the device (COO of the cotan Laplacian,
    ~7V entries, plus per-face geometry); the dense (V, V) systems are
    scattered there.
  * The Poisson operator is made SPD by PINNING one vertex per connected
    component (vertex 0 on a connected mesh; its row/col replaced by the
    identity's), not by the host path's 1e-8 diagonal shift: the shift
    leaves the condition number at ~lambda_max/shift (~1e8 at 10k
    vertices), beyond f32; pinning gives ~lambda_max/lambda_2 (~1e4),
    comfortably inside it. Both are exact up to the method's own error.
    Symmetric Jacobi scaling normalizes the diagonals before factorization.
  * After the one Cholesky, EXPLICIT inverses are formed in column blocks
    (of the source block), so the solves' temporaries stay bounded; every
    per-block distance solve is then a dense matmul, and the heat step's
    delta-function RHS makes `u` a column GATHER.
  * Each block of inverse columns takes one step of iterative refinement,
    its residual computed against the f64 system (a sparse product): on an
    H100 the f32 Cholesky solves of the pinned Laplacian left 2.5e-3
    relative error in its inverse at 6,890 vertices (against 6.5e-7 for
    the heat operator's), which the step brings to the f32 rounding of the
    stored inverse. This is the port's addition to the JAX design.
  * Every product runs in full f32 (eigen.py's _full_f32_matmul guard): a
    TF32 pass would destroy the factor of an operator with condition ~1e4.

This module holds no kernel of its own: the factorization, the triangular
solves and the products are torch's (cuSOLVER and cuBLAS on the card).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph as csgraph
import torch

from .eigen import _full_f32_matmul
from .laplacian import cotan_laplacian, heat_face_geometry, vertex_areas


def _pinned_system(L, diag_add, pins):
    """The f64 system L + diag(diag_add) with the rows and columns of the
    vertices in `pins` replaced by the identity's (scipy CSR)."""
    keep = scipy.sparse.diags((~pins).astype(np.float64))
    A = keep @ (L + scipy.sparse.diags(diag_add)) @ keep
    return (A + scipy.sparse.diags(pins.astype(np.float64))).tocsr()


def _build_chol(A, device):
    """Scatter the system A (scipy, unique entries) densely on the device
    in f32, Jacobi-scale, and Cholesky-factorize. Returns (C, s, ok) with
    A^-1 = s * C^-T C^-1 * s."""
    coo = A.tocoo()
    V = A.shape[0]
    M = torch.zeros((V, V), dtype=torch.float32, device=device)
    M[torch.from_numpy(coo.row).to(device),
      torch.from_numpy(coo.col).to(device)] = torch.from_numpy(
          coo.data.astype(np.float32)).to(device)
    s = torch.rsqrt(torch.diagonal(M))
    M.mul_(s[:, None]).mul_(s[None, :])
    C, err = torch.linalg.cholesky_ex(M)
    del M
    ok = bool(err.item() == 0) and bool(torch.isfinite(C).all())
    return C, s, ok


def _solve(C, s, B):
    """A^-1 B from the scaled Cholesky factor (C, s)."""
    return torch.cholesky_solve(B * s[:, None], C).mul_(s[:, None])


def _heat_block_solve(Hinv, Linv0, faces, rot_edges, cots, edge_vecs, srcs):
    """One block of the heat method: srcs (S,) -> (S, V) distances."""
    S = srcs.shape[0]
    # heat step: u = (M + tL)^{-1} delta_src, a gather of inverse columns
    u = Hinv[:, srcs]                                      # (V, S)
    uf = u[faces]                                          # (F, 3, S)
    X = torch.einsum("fcd,fcs->fds", rot_edges, uf)        # (F, 3, S)
    del u, uf
    # max-scaled normalization: far-field |X| sits below sqrt(f32_min),
    # where |X|^2 underflows to 0 in a naive norm while X / tiny_eps
    # amplifies the underflow noise by 1e10+; dividing by the per-(face,
    # source) max first keeps every square in range, so the gradient
    # directions stay valid down to |X| ~ f32_min
    m = X.abs().amax(dim=1, keepdim=True)                   # (F, 1, S)
    m_safe = m + 1e-10 * m.amax(dim=0, keepdim=True) + 1e-38
    Z = X / m_safe
    del X, m, m_safe
    Xn = -Z / (torch.linalg.vector_norm(Z, dim=1, keepdim=True) + 1e-20)
    del Z

    # integrated divergence, scattered over the face corners
    V = Hinv.shape[0]
    div = torch.zeros((V, S), dtype=torch.float32, device=Hinv.device)
    for corner in range(3):
        j = (corner + 1) % 3
        k = (corner + 2) % 3
        e_ij = edge_vecs[:, k]
        e_ik = -edge_vecs[:, j]
        dot_ij = torch.einsum("fd,fds->fs", e_ij, Xn)
        dot_ik = torch.einsum("fd,fds->fs", e_ik, Xn)
        contrib = 0.5 * (cots[:, k][:, None] * dot_ij
                         + cots[:, j][:, None] * dot_ik)
        div.index_add_(0, faces[:, corner], contrib)

    # Poisson solve: one matmul against the pinned inverse (phi[pin] = 0)
    phi = Linv0 @ div                                      # (V, S)
    phi = phi - phi[srcs, torch.arange(S, device=phi.device)][None, :]
    return phi.abs_().T


class DeviceHeatMethodSolver:
    """Heat-method geodesics with device-resident dense inverses.

    HeatMethodSolver's API (`distance(sources) -> (S, V) float32` numpy),
    with the solves, gradients and divergence on `device` ("cuda" unless the
    caller asks for "cpu"). Two dense (V, V) f32 inverses stay on the
    device: 3.3 GB at 20k vertices.
    """

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 t_coef: float = 1.0, source_block: int = 2048,
                 device="cuda"):
        verts = np.asarray(verts, dtype=np.float64)
        faces = np.asarray(faces, dtype=np.int64)
        V = verts.shape[0]
        self._V = V
        self._block = min(int(source_block), V)
        self.device = torch.device(device)

        L = cotan_laplacian(verts, faces)
        L.sum_duplicates()
        L = L.tocoo()
        mass = vertex_areas(verts, faces)
        rot_edges, cots, edge_vecs, h = heat_face_geometry(verts, faces)

        # f32 far-field floor on the diffusion time: the one-step screened
        # Poisson Green's function decays like e^(-d/sqrt(t)); once it
        # underflows f32 entirely (~1e-38) the normalized gradients are
        # noise. With the max-scaled normalization the directions stay
        # valid down to that line, so sqrt(t) >= diam/60 (decay e^-60)
        # suffices.
        diam = np.linalg.norm(verts.max(axis=0) - verts.min(axis=0))
        t = max(t_coef * h * h, (diam / 60.0) ** 2)

        # pin ONE vertex per connected component: pinning only vertex 0
        # would leave every other component's block exactly singular
        _, labels = csgraph.connected_components(
            scipy.sparse.csr_matrix(
                (np.abs(L.data), (L.row, L.col)), shape=(V, V)),
            directed=False)
        pins = np.zeros(V, dtype=bool)
        pins[np.unique(labels, return_index=True)[1]] = True

        dev, f32 = self.device, torch.float32

        def on(a, dtype=f32):
            return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

        L = L.tocsr()
        with _full_f32_matmul():
            Hinv = self._invert(_pinned_system(t * L, mass,
                                               np.zeros(V, bool)))
            Linv0 = self._invert(_pinned_system(L, np.zeros(V), pins))
        # the pinned inverse is blockdiag over {pins: 1, rest: L_red^-1};
        # zero the pinned 1s so `Linv0 @ div` gives phi[pin] = 0 exactly
        pin_idx = on(np.flatnonzero(pins), torch.int64)
        Linv0[pin_idx, pin_idx] = 0.0
        self._ops = (Hinv, Linv0, on(faces, torch.int64), on(rot_edges),
                     on(cots), on(edge_vecs))

    def _invert(self, A):
        """Explicit A^-1 (f32) of the scipy system A, built in column blocks
        of the source block, each refined once against A in f64."""
        V, dev = A.shape[0], self.device
        C, s, ok = _build_chol(A, dev)
        if not ok:
            raise RuntimeError(
                "f32 factorization of the heat/Poisson operator failed "
                "(mesh too ill-conditioned for the device path); use "
                "HeatMethodSolver")
        coo = A.tocoo()
        with torch.sparse.check_sparse_tensor_invariants():
            A64 = torch.sparse_coo_tensor(
                torch.from_numpy(np.stack([coo.row, coo.col]).astype(
                    np.int64)),
                torch.from_numpy(coo.data), size=A.shape).coalesce().to(dev)
        Ainv = torch.empty((V, V), dtype=torch.float32, device=dev)
        for c0 in range(0, V, self._block):
            n = min(self._block, V - c0)
            eye = torch.zeros((V, n), dtype=torch.float64, device=dev)
            eye[torch.arange(c0, c0 + n, device=dev),
                torch.arange(n, device=dev)] = 1.0
            X = _solve(C, s, eye.float())
            X += _solve(C, s, (eye - A64 @ X.double()).float())
            Ainv[:, c0:c0 + n] = X
        return Ainv

    def distance(self, sources: np.ndarray) -> np.ndarray:
        """Geodesic distance from each source vertex: (S, V) float32."""
        sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
        S = sources.shape[0]
        out = np.empty((S, self._V), dtype=np.float32)
        with _full_f32_matmul():
            for s0 in range(0, S, self._block):
                chunk = torch.from_numpy(sources[s0:s0 + self._block]).to(
                    self.device)
                d = _heat_block_solve(*self._ops, chunk)
                out[s0:s0 + chunk.shape[0]] = d.cpu().numpy()
        return out


def all_pairs_heat_device(verts: np.ndarray, faces: np.ndarray,
                          t_coef: float = 1.0, source_block: int = 2048,
                          device="cuda") -> np.ndarray:
    """The full (V, V) heat-method distance table computed on `device`."""
    solver = DeviceHeatMethodSolver(verts, faces, t_coef=t_coef,
                                    source_block=source_block, device=device)
    return solver.distance(np.arange(np.asarray(verts).shape[0]))
