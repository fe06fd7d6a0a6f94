"""Position normalization on torch tensors: the counterpart of
diffusionnet_tpu/ops/transforms.py (reference geometry.py:635-665)."""

from __future__ import annotations

import torch

from .vector import cross, norm


def normalize_positions(pos, faces=None, method: str = "mean",
                        scale_method: str = "max_rad"):
    """Center and unit-scale positions.

    method: 'mean' (centroid) or 'bbox' (box center). scale_method:
    'max_rad' (divide by the largest radius) or 'area' (by the square root
    of the total face area; needs faces). 'mean' and 'max_rad' broadcast
    over leading batch dims."""
    if method == "mean":
        pos = pos - pos.mean(dim=-2, keepdim=True)
    elif method == "bbox":
        center = (pos.amax(dim=-2) + pos.amin(dim=-2)) / 2.0
        pos = pos - center[..., None, :]
    else:
        raise ValueError("unrecognized method")

    if scale_method == "max_rad":
        scale = norm(pos).amax(dim=-1, keepdim=True)[..., None]
        pos = pos / scale
    elif scale_method == "area":
        if faces is None:
            raise ValueError("must pass faces for area normalization")
        coords = pos[faces.long()]
        vec_A = coords[:, 1, :] - coords[:, 0, :]
        vec_B = coords[:, 2, :] - coords[:, 0, :]
        total_area = (norm(cross(vec_A, vec_B)) * 0.5).sum()
        pos = pos * (1.0 / torch.sqrt(total_area))
    else:
        raise ValueError("unrecognized scale method")
    return pos
