"""Point-cloud and robust mesh Laplacians: the counterpart of
diffusionnet_tpu/geometry/point_cloud.py, the in-repo replacement for the
robust-laplacian package (reference geometry.py:17,317
`robust_laplacian.point_cloud_laplacian`).

Algorithm (Sharp & Crane, "A Laplacian for Nonmanifold Triangle Meshes", SGP
2020, point-cloud variant):
  1. For each point, project its k-NN neighborhood to the tangent plane and
     build a local 2-D Delaunay triangulation; keep the triangles incident to
     the point (native/, threaded C++).
  2. Union + dedupe all local triangles into one (generally nonmanifold) soup.
  3. Build the cotan Laplacian from *intrinsic edge lengths* with global
     intrinsic mollification (add a small delta to all lengths so every
     triangle satisfies the triangle inequality with slack), which guarantees
     finite, stable cotans.
  4. Lumped barycentric mass from the soup areas.

Returns (L csc, mass vector), both float64. Where the JAX package falls back
to the Python triangulation when the native call fails, this raises;
`_local_triangles` is kept as the test oracle.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
from scipy.spatial import Delaunay, cKDTree

from ..native import cloud_triangles_native


def _local_triangles(verts: np.ndarray, n_neighbors: int = 30) -> np.ndarray:
    """Union of per-point tangent-plane Delaunay triangles incident to each point.
    Returns (T,3) int64 canonicalized unique triangles. The Python version of
    the native triangulation: a test oracle, called by no other module."""
    V = verts.shape[0]
    k = min(n_neighbors, V - 1)
    tree = cKDTree(verts)
    _, neigh = tree.query(verts, k=k + 1)  # includes self (usually first)

    tris = set()
    for i in range(V):
        ids = neigh[i]
        # ensure self is first
        if ids[0] != i:
            ids = np.concatenate(([i], ids[ids != i]))[:k + 1]
        pts = verts[ids] - verts[i]
        # tangent plane via SVD of the centered neighborhood
        _, _, vh = np.linalg.svd(pts - pts.mean(axis=0, keepdims=True),
                                 full_matrices=False)
        basis = vh[:2]  # (2,3)
        uv = pts @ basis.T  # (k+1, 2)
        try:
            dt = Delaunay(uv)
        except Exception:
            continue
        simplices = dt.simplices  # local indices
        # keep triangles incident to the center (local index 0)
        incident = (simplices == 0).any(axis=1)
        for tri in simplices[incident]:
            g = tuple(sorted(int(ids[t]) for t in tri))
            tris.add(g)
    if not tris:
        raise RuntimeError("point-cloud triangulation produced no triangles")
    return np.array(sorted(tris), dtype=np.int64)


def _intrinsic_mollify(lengths: np.ndarray, rel_factor: float = 1e-6) -> np.ndarray:
    """Global intrinsic mollification: add the smallest uniform delta such that
    every triangle satisfies l_a + l_b >= l_c + eps (Sharp & Crane §3.3)."""
    eps = rel_factor * lengths.mean()
    a, b, c = lengths[:, 0], lengths[:, 1], lengths[:, 2]
    needed = np.maximum.reduce([
        c + eps - a - b, a + eps - b - c, b + eps - c - a,
        np.zeros_like(a),
    ])
    delta = needed.max()
    return lengths + delta + eps


def _cotan_from_lengths(lengths: np.ndarray):
    """Per-corner cotangents and areas from side lengths (l0 opposite corner 0...)."""
    a, b, c = lengths[:, 0], lengths[:, 1], lengths[:, 2]
    s = 0.5 * (a + b + c)
    # Kahan-stable Heron
    area2 = np.maximum(s * (s - a) * (s - b) * (s - c), 1e-300)
    area = np.sqrt(area2)
    cot = np.empty_like(lengths)
    cot[:, 0] = (b * b + c * c - a * a) / (4.0 * area)
    cot[:, 1] = (c * c + a * a - b * b) / (4.0 * area)
    cot[:, 2] = (a * a + b * b - c * c) / (4.0 * area)
    return cot, area


def mesh_laplacian_robust(verts: np.ndarray, faces: np.ndarray,
                          mollify_factor: float = 1e-6,
                          intrinsic_delaunay: bool = False):
    """Robust (L, mass) for an arbitrary triangle SOUP — nonmanifold edges,
    inconsistent orientation, degenerate slivers all allowed.

    The Sharp-Crane tufted-cover construction on a soup yields exactly twice
    the per-face cotan sums and twice the barycentric mass (every face appears
    twice in the cover), so the generalized eigenproblem L phi = lambda M phi
    and all diffusion operators are IDENTICAL to assembling per-face cotans
    from intrinsically mollified edge lengths — which is what this does.
    Counterpart of the reference's commented-out robust mesh path
    (geometry.py:320-321) and robust_laplacian.mesh_laplacian.

    intrinsic_delaunay=True additionally runs intrinsic Delaunay edge flips
    on the literal tufted cover (tufted.py) — the robust-laplacian package's
    full recipe, restoring nonnegative edge weights on pathological inputs."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    if intrinsic_delaunay:
        from .tufted import tufted_laplacian
        return tufted_laplacian(verts, faces, mollify_factor=mollify_factor)
    # drop degenerate faces (repeated vertices contribute nothing)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return _soup_laplacian(verts, faces[ok], mollify_factor)


def _soup_laplacian(verts: np.ndarray, faces: np.ndarray,
                    mollify_factor: float):
    V = verts.shape[0]
    p = verts[faces]  # (T,3,3)
    l = np.stack([
        np.linalg.norm(p[:, 1] - p[:, 2], axis=-1),
        np.linalg.norm(p[:, 2] - p[:, 0], axis=-1),
        np.linalg.norm(p[:, 0] - p[:, 1], axis=-1),
    ], axis=-1)
    l = _intrinsic_mollify(l, rel_factor=mollify_factor)
    cot, area = _cotan_from_lengths(l)

    rows_l, cols_l, vals_l = [], [], []
    for corner in range(3):
        j = faces[:, (corner + 1) % 3]
        k = faces[:, (corner + 2) % 3]
        w = 0.5 * cot[:, corner]
        rows_l += [j, k, j, k]
        cols_l += [k, j, j, k]
        vals_l += [-w, -w, w, w]
    L = scipy.sparse.coo_matrix(
        (np.concatenate(vals_l),
         (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(V, V)).tocsc()

    mass = np.zeros(V, dtype=np.float64)
    for corner in range(3):
        np.add.at(mass, faces[:, corner], area / 3.0)
    # guard against isolated points that received no triangles
    mass[mass == 0.0] = (mass[mass > 0.0].mean() * 1e-8
                         if (mass > 0).any() else 1.0)
    return L, mass


def cloud_soup(verts: np.ndarray, n_neighbors: int = 30) -> np.ndarray:
    """The cloud's triangle soup (native, threaded): (T, 3) int64 sorted
    unique triangles. Raises if there is none."""
    faces = cloud_triangles_native(verts, k=n_neighbors)
    if faces.shape[0] == 0:
        raise RuntimeError("point-cloud triangulation produced no triangles")
    return faces


def point_cloud_laplacian(verts: np.ndarray, n_neighbors: int = 30,
                          mollify_factor: float = 1e-6,
                          intrinsic_delaunay: bool = False):
    """(L, mass) for a point cloud; both float64, L a (V,V) CSC PSD matrix.

    The triangulation runs in threaded native C++ (the per-point SVD +
    Delaunay loop is the hot precompute path at cloud scale); a failed
    native build or call raises.

    intrinsic_delaunay=True runs intrinsic Delaunay flips on the tufted
    cover of the local-Delaunay soup (tufted.py) — the robust-laplacian
    package's full point-cloud recipe."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = cloud_soup(verts, n_neighbors)
    if intrinsic_delaunay:
        from .tufted import tufted_laplacian
        return tufted_laplacian(verts, faces, mollify_factor=mollify_factor)
    return _soup_laplacian(verts, faces, mollify_factor)
