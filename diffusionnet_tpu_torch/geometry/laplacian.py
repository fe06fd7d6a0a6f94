"""Cotangent Laplacian and lumped (barycentric) vertex areas — vectorized numpy.

A copy of diffusionnet_tpu/geometry/laplacian.py (the JAX package cannot be
imported without loading jax).

Replaces the reference's external C++ dependency potpourri3d
(`pp3d.cotan_laplacian(denom_eps=1e-10)` / `pp3d.vertex_areas`, reference
geometry.py:322-323) with an in-repo, fully vectorized float64 assembly.

Convention: weak (integrated) cotan Laplacian, positive semi-definite:
    L_ij = -0.5 (cot a_ij + cot b_ij)   for edge (i,j) with opposite angles a, b
    L_ii = -sum_{j != i} L_ij
Degenerate triangles are guarded by denom_eps on the |cross| denominator of each
cotangent, mirroring potpourri3d's denom_eps semantics.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


def face_areas_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    coords = verts[faces]
    vec_A = coords[:, 1, :] - coords[:, 0, :]
    vec_B = coords[:, 2, :] - coords[:, 0, :]
    return 0.5 * np.linalg.norm(np.cross(vec_A, vec_B), axis=-1)


def vertex_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Barycentric lumped mass: each face donates one third of its area to each
    corner (the reference's `pp3d.vertex_areas`)."""
    areas = face_areas_np(verts, faces) / 3.0
    mass = np.zeros(verts.shape[0], dtype=verts.dtype)
    for i in range(3):
        np.add.at(mass, faces[:, i], areas)
    return mass


def heat_face_geometry(verts: np.ndarray, faces: np.ndarray):
    """Per-face quantities shared by the heat-method solvers (host and
    device): (rot_edges (F,3,3), cots (F,3), edge_vecs (F,3,3),
    mean_edge_len). rot_edges[f, c] is the opposite edge of corner c rotated
    90 degrees about the face normal and pre-scaled by 1/(2A), so
    grad u = sum_c u_c * rot_edges[c] (Crane et al., "Geodesics in Heat")."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    coords = verts[faces]
    e0 = coords[:, 2] - coords[:, 1]   # edge opposite corner 0
    e1 = coords[:, 0] - coords[:, 2]
    e2 = coords[:, 1] - coords[:, 0]
    n = np.cross(e2, -e1)
    areas = 0.5 * np.linalg.norm(n, axis=1)
    n_unit = n / (2.0 * areas[:, None] + 1e-300)
    rot_edges = np.stack([np.cross(n_unit, e0),
                          np.cross(n_unit, e1),
                          np.cross(n_unit, e2)],
                         axis=1) / (2.0 * areas[:, None, None] + 1e-300)

    def cot(u, v):
        cr = np.linalg.norm(np.cross(u, v), axis=1)
        return np.sum(u * v, axis=1) / (cr + 1e-300)

    cots = np.stack([cot(-e1, e2), cot(-e2, e0), cot(-e0, e1)], axis=1)
    edge_vecs = np.stack([e0, e1, e2], axis=1)
    h = np.mean([np.linalg.norm(e0, axis=1), np.linalg.norm(e1, axis=1),
                 np.linalg.norm(e2, axis=1)])
    return rot_edges, cots, edge_vecs, h


def cotan_laplacian(verts: np.ndarray, faces: np.ndarray,
                    denom_eps: float = 1e-10) -> scipy.sparse.csc_matrix:
    """Weak cotan Laplacian as a (V,V) CSC matrix, float64.

    Fully vectorized: one pass over faces computing the three corner cotangents,
    then a single COO assembly (vs the reference's external C++ call).
    """
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    V = verts.shape[0]
    coords = verts[faces]  # (F,3,3)

    rows_list, cols_list, vals_list = [], [], []
    for corner in range(3):
        i = faces[:, corner]
        j = faces[:, (corner + 1) % 3]
        k = faces[:, (corner + 2) % 3]
        # cotangent of the angle at corner `corner`, which is opposite edge (j,k)
        u = coords[:, (corner + 1) % 3] - coords[:, corner]
        v = coords[:, (corner + 2) % 3] - coords[:, corner]
        cross_norm = np.linalg.norm(np.cross(u, v), axis=-1)
        cot = np.sum(u * v, axis=-1) / (cross_norm + denom_eps)
        w = 0.5 * cot
        # off-diagonals -w at (j,k) and (k,j); diagonals +w at (j,j) and (k,k)
        rows_list += [j, k, j, k]
        cols_list += [k, j, j, k]
        vals_list += [-w, -w, w, w]

    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = np.concatenate(vals_list)
    L = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(V, V)).tocsc()
    if np.isnan(L.data).any():
        raise RuntimeError("NaN Laplace matrix")
    return L
