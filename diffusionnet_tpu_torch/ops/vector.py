"""Elementary vector and face math on torch tensors: the counterpart of
diffusionnet_tpu/ops/vector.py (reference geometry.py:24-90), with the same
shape checks."""

from __future__ import annotations

import torch


def norm(x):
    """Norm of an array of vectors along the last dim: (..., d) -> (...)."""
    return torch.linalg.vector_norm(x, dim=-1)


def norm2(x):
    """Squared norm along the last dim."""
    return dot(x, x)


def normalize(x, divide_eps: float = 1e-6, highdim: bool = False):
    """Unit-normalize along the last dim with an eps guard (the checks of
    reference geometry.py:42-47)."""
    if x.ndim == 1:
        raise ValueError(
            f"called normalize() on single vector of dim {x.shape}; are you "
            "sure?")
    if not highdim and x.shape[-1] > 4:
        raise ValueError(
            f"called normalize() with large last dimension {x.shape}; are you "
            "sure?")
    return x / (norm(x) + divide_eps)[..., None]


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def face_coords(verts, faces):
    """(V, 3), (F, 3) -> (F, 3, 3) coordinates of each face's corners."""
    return verts[faces.long()]


def project_to_tangent(vecs, unit_normals):
    """Remove the normal component of vecs; normals assumed unit (reference
    geometry.py:67-69)."""
    return vecs - unit_normals * dot(vecs, unit_normals)[..., None]


def face_area(verts, faces):
    """(F,) areas via cross products (reference geometry.py:72-78)."""
    coords = face_coords(verts, faces)
    vec_A = coords[:, 1, :] - coords[:, 0, :]
    vec_B = coords[:, 2, :] - coords[:, 0, :]
    return 0.5 * norm(cross(vec_A, vec_B))


def face_normals(verts, faces, normalized: bool = True):
    """(F, 3) face normals (reference geometry.py:80-90)."""
    coords = face_coords(verts, faces)
    vec_A = coords[:, 1, :] - coords[:, 0, :]
    vec_B = coords[:, 2, :] - coords[:, 0, :]
    raw_normal = cross(vec_A, vec_B)
    if normalized:
        return normalize(raw_normal)
    return raw_normal
