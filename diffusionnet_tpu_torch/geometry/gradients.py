"""Tangent-plane gradient operator — vectorized numpy assembly.

`build_grad` of diffusionnet_tpu/geometry/gradients.py, copied. The per-vertex
least-squares stencil

    coefs = (T_i^T T_i + eps I_2)^{-1} T_i^T  @  [-1 | I]

reduces, per outgoing edge e = (i -> j) with tangent vector t_e, to

    c_e      = A_i^{-1} t_e            (entry at (i, j), complex c_e.x + i c_e.y)
    c_self_i = -sum_e c_e              (entry at (i, i))

with A_i = sum_e t_e t_e^T + eps I (2x2, inverted analytically). Same stencil,
eps_reg = 1e-5, unit edge weights as reference geometry.py:233-256.
`build_grad_point_cloud` is the same stencil over a cloud's 30-NN edges.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


def build_grad(n_verts: int, edges: np.ndarray, edge_tangent_vectors: np.ndarray,
               eps_reg: float = 1e-5) -> scipy.sparse.csc_matrix:
    """(V,V) complex sparse gradient operator.

    edges: (2, E) int (tail, tip); self-edges are ignored (reference
    geometry.py:226-227). edge_tangent_vectors: (E, 2) float.
    """
    edges = np.asarray(edges)
    t = np.asarray(edge_tangent_vectors, dtype=np.float64)
    tail, tip = edges[0], edges[1]
    keep = tail != tip
    tail, tip, t = tail[keep], tip[keep], t[keep]

    N = n_verts
    # Per-vertex 2x2 normal matrix A_i = sum_e t_e t_e^T + eps I
    A = np.zeros((N, 2, 2), dtype=np.float64)
    outer = t[:, :, None] * t[:, None, :]  # (E,2,2)
    np.add.at(A, tail, outer)
    A[:, 0, 0] += eps_reg
    A[:, 1, 1] += eps_reg

    # Analytic 2x2 inverse (A is SPD + eps, det > 0)
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    Ainv = np.empty_like(A)
    Ainv[:, 0, 0] = A[:, 1, 1]
    Ainv[:, 1, 1] = A[:, 0, 0]
    Ainv[:, 0, 1] = -A[:, 0, 1]
    Ainv[:, 1, 0] = -A[:, 1, 0]
    Ainv /= det[:, None, None]

    # Per-edge coefficient c_e = A_{tail}^{-1} t_e
    c = np.einsum("eij,ej->ei", Ainv[tail], t)  # (E,2)
    coef = c[:, 0] + 1j * c[:, 1]

    # Self coefficient: -sum of outgoing edge coefficients
    self_coef = np.zeros(N, dtype=np.complex128)
    np.add.at(self_coef, tail, -coef)

    rows = np.concatenate([tail, np.arange(N)])
    cols = np.concatenate([tip, np.arange(N)])
    vals = np.concatenate([coef, self_coef])
    return scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsc()


def build_grad_point_cloud(verts: np.ndarray, frames: np.ndarray,
                           n_neighbors_cloud: int = 30,
                           neigh_inds: np.ndarray | None = None):
    """Gradient operator of a point cloud over its kNN edge set (reference
    geometry.py:179-194), vectorized end to end."""
    from .host_frames import edge_tangent_vectors_np
    from .knn_host import find_knn_host

    if neigh_inds is None:
        _, neigh_inds = find_knn_host(verts, verts, n_neighbors_cloud,
                                      omit_diagonal=True)
    V = verts.shape[0]
    edge_inds_from = np.repeat(np.arange(V), neigh_inds.shape[1])
    edges = np.stack((edge_inds_from, neigh_inds.flatten()))
    edge_tangent_vecs = edge_tangent_vectors_np(verts, frames, edges)
    return build_grad(V, edges, edge_tangent_vecs)
