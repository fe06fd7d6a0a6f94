"""Host-side (numpy, float64) vertex normals / tangent frames / edge tangents.

A copy of diffusionnet_tpu/geometry/host_frames.py, so the port computes the
same frames without importing the JAX package. These run in the precompute
pipeline, which follows the reference's numerics (float64 on host, reference
geometry.py:310,429) including the deterministic seed-777 degenerate-normal
recovery (geometry.py:128-141).

Attribution: the algorithm (constants, seed-777 ladder, failure conditions) is
a deliberate numerics-parity reimplementation of nmwsharp/diffusion-net
geometry.py:92-177, MIT License (c) 2020-2021 Nicholas Sharp and coauthors —
see the repository LICENSE file.
"""

from __future__ import annotations

import numpy as np


def mesh_face_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    coords = verts[faces]
    vec_A = coords[:, 1, :] - coords[:, 0, :]
    vec_B = coords[:, 2, :] - coords[:, 0, :]
    raw = np.cross(vec_A, vec_B)
    return raw / (np.linalg.norm(raw, axis=-1, keepdims=True) + 1e-6)


def mesh_vertex_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit-face-normal accumulation (reference geometry.py:101-111)."""
    face_n = mesh_face_normals_np(verts, faces)
    vertex_normals = np.zeros(verts.shape)
    for i in range(3):
        np.add.at(vertex_normals, faces[:, i], face_n)
    # 0/0 -> NaN is the DESIGNED signal for the recovery ladder in
    # vertex_normals_np (unreferenced/degenerate vertices); silence the
    # RuntimeWarning, the NaNs are handled downstream
    with np.errstate(invalid="ignore"):
        return (vertex_normals
                / np.linalg.norm(vertex_normals, axis=-1, keepdims=True))


def neighborhood_normal_np(points: np.ndarray) -> np.ndarray:
    """(N,K,3) centered neighborhoods -> (N,3) SVD plane-fit normals
    (reference geometry.py:92-99)."""
    (_, _, vh) = np.linalg.svd(points, full_matrices=False)
    normal = vh[:, 2, :]
    return normal / np.linalg.norm(normal, axis=-1, keepdims=True)


def vertex_normals_np(verts: np.ndarray, faces: np.ndarray,
                      n_neighbors_cloud: int = 30) -> np.ndarray:
    """Vertex normals with the reference's NaN-recovery ladder
    (geometry.py:114-148): wiggle with seed 777 then random unit normals."""
    if faces is None or faces.size == 0:  # point cloud
        raise NotImplementedError(
            "point-cloud normals need the host kNN, which the port brings "
            "with ROADMAP item A.5 (precompute)")
    else:
        normals = mesh_vertex_normals_np(verts, faces)

        bad_normals_mask = np.isnan(normals).any(axis=1, keepdims=True)
        if bad_normals_mask.any():
            bbox = np.amax(verts, axis=0) - np.amin(verts, axis=0)
            scale = np.linalg.norm(bbox) * 1e-4
            wiggle = (np.random.RandomState(seed=777).rand(*verts.shape) - 0.5) * scale
            wiggle_verts = verts + bad_normals_mask * wiggle
            normals = mesh_vertex_normals_np(wiggle_verts, faces)

        bad_normals_mask = np.isnan(normals).any(axis=1)
        if bad_normals_mask.any():
            rand = (np.random.RandomState(seed=777).rand(*verts.shape) - 0.5)
            normals[bad_normals_mask, :] = rand[bad_normals_mask, :]
            normals = normals / np.linalg.norm(normals, axis=-1)[:, None]

    if np.any(np.isnan(normals)):
        raise ValueError("NaN normals :(")
    return normals


def build_tangent_frames_np(verts: np.ndarray, faces: np.ndarray,
                            normals: np.ndarray | None = None) -> np.ndarray:
    """Per-vertex (basisX, basisY, normal) stacked (V,3,3)
    (reference geometry.py:151-177, 0.9 candidate threshold at :167-168)."""
    V = verts.shape[0]
    vert_normals = vertex_normals_np(verts, faces) if normals is None else normals

    cand1 = np.broadcast_to(np.array([1.0, 0.0, 0.0]), (V, 3))
    cand2 = np.broadcast_to(np.array([0.0, 1.0, 0.0]), (V, 3))

    dots = np.abs(np.sum(vert_normals * cand1, axis=-1))
    basisX = np.where((dots < 0.9)[:, None], cand1, cand2)
    basisX = basisX - vert_normals * np.sum(basisX * vert_normals, axis=-1)[:, None]
    basisX = basisX / (np.linalg.norm(basisX, axis=-1, keepdims=True) + 1e-6)
    basisY = np.cross(vert_normals, basisX)
    frames = np.stack((basisX, basisY, vert_normals), axis=-2)

    if np.any(np.isnan(frames)):
        raise ValueError("NaN coordinate frame! Must be very degenerate")
    return frames


def edge_tangent_vectors_np(verts: np.ndarray, frames: np.ndarray,
                            edges: np.ndarray) -> np.ndarray:
    """(2,E) edges -> (E,2) tangent-plane components at the tail vertex
    (reference geometry.py:197-206)."""
    edge_vecs = verts[edges[1, :], :] - verts[edges[0, :], :]
    basisX = frames[edges[0, :], 0, :]
    basisY = frames[edges[0, :], 1, :]
    compX = np.sum(edge_vecs * basisX, axis=-1)
    compY = np.sum(edge_vecs * basisY, axis=-1)
    return np.stack((compX, compY), axis=-1)
