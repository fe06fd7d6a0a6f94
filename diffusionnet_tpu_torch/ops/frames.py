"""Vertex normals, tangent frames and edge tangent vectors on torch
tensors: the counterpart of diffusionnet_tpu/ops/frames.py (reference
geometry.py:92-206).

As in the JAX package, a vertex whose accumulated normal vanishes
(unreferenced, or a zero-area umbrella) gets a pseudo-random unit normal
drawn from a fixed seed, 777, with no data-dependent control flow; the
draws are torch's, not the JAX package's bits. `face_mask` zeroes padded
faces, as in the JAX functions.
"""

from __future__ import annotations

import torch

from .vector import (cross, dot, face_normals, norm, normalize,
                     project_to_tangent)


def mesh_vertex_normals(verts, faces, face_mask=None):
    """Vertex normals from the unit normals of the incident faces, summed
    with equal weights (reference geometry.py:101-111); face_mask zeroes
    padded faces."""
    face_n = face_normals(verts, faces)
    if face_mask is not None:
        face_n = face_n * face_mask[:, None]
    faces = faces.long()
    vertex_normals = torch.zeros_like(verts)
    for i in range(3):
        vertex_normals = vertex_normals.index_add(0, faces[:, i], face_n)
    return vertex_normals / (norm(vertex_normals) + 1e-20)[:, None]


def _fallback_normals(verts):
    """Pseudo-random unit normals from seed 777, for degenerate vertices."""
    g = torch.Generator(device=verts.device).manual_seed(777)
    r = torch.rand(verts.shape, generator=g, device=verts.device,
                   dtype=verts.dtype) - 0.5
    return r / (norm(r) + 1e-20)[:, None]


def vertex_normals(verts, faces=None, n_neighbors_cloud: int = 30,
                   face_mask=None, neigh_inds=None):
    """Vertex normals of a mesh (faces given: face normals accumulated, the
    degenerate fallback) or a point cloud (faces None or empty: plane fits
    over n_neighbors_cloud neighbourhoods, reference geometry.py:114-122;
    neigh_inds (V, k) may be given)."""
    if faces is None or faces.numel() == 0:
        from .knn import find_knn
        if neigh_inds is None:
            _, neigh_inds = find_knn(verts, verts, n_neighbors_cloud,
                                     omit_diagonal=True)
        neigh_points = verts[neigh_inds, :] - verts[:, None, :]
        return neighborhood_normal(neigh_points)
    normals = mesh_vertex_normals(verts, faces, face_mask=face_mask)
    bad = ((norm(normals) < 0.5)[:, None]
           | torch.isnan(normals).any(dim=-1, keepdim=True))
    normals = torch.where(bad, _fallback_normals(verts), normals)
    return normals / (norm(normals) + 1e-20)[:, None]


def neighborhood_normal(points):
    """(N, K, 3) centered neighbourhoods -> (N, 3) plane-fit normals by SVD
    (reference geometry.py:92-99); the sign is the SVD's."""
    _, _, vh = torch.linalg.svd(points, full_matrices=False)
    normal = vh[:, 2, :]
    return normal / (torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
                     + 1e-20)


def build_tangent_frames(verts, faces=None, normals=None, face_mask=None,
                         neigh_inds=None):
    """Per-vertex orthonormal frames (basisX, basisY, normal), (V, 3, 3);
    the candidate axis is chosen with the 0.9 threshold of reference
    geometry.py:164-172."""
    V = verts.shape[0]
    vert_normals = (normals if normals is not None
                    else vertex_normals(verts, faces, face_mask=face_mask,
                                        neigh_inds=neigh_inds))
    cand1 = verts.new_tensor([1.0, 0.0, 0.0]).expand(V, 3)
    cand2 = verts.new_tensor([0.0, 1.0, 0.0]).expand(V, 3)
    basisX = torch.where((dot(vert_normals, cand1).abs() < 0.9)[:, None],
                         cand1, cand2)
    basisX = normalize(project_to_tangent(basisX, vert_normals))
    basisY = cross(vert_normals, basisX)
    return torch.stack((basisX, basisY, vert_normals), dim=-2)


def edge_tangent_vectors(verts, frames, edges):
    """Edge vectors in the 2-D tangent basis at the tail vertex; edges
    (2, E) -> (E, 2) (reference geometry.py:197-206)."""
    edges = edges.long()
    edge_vecs = verts[edges[1, :], :] - verts[edges[0, :], :]
    basisX = frames[edges[0, :], 0, :]
    basisY = frames[edges[0, :], 1, :]
    return torch.stack((dot(edge_vecs, basisX), dot(edge_vecs, basisY)),
                       dim=-1)
