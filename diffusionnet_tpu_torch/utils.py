"""Utilities: cache hashing, filesystem, bucket padding, rotation
augmentation, the smoothed log loss and host position normalization.

The counterpart of diffusionnet_tpu/utils.py. `hash_arrays` gives the same
SHA1 keys as the JAX package, so both packages share one operator cache.
Random rotations take a torch.Generator where the JAX package takes a key;
their math is a function of the uniforms drawn (`rotation_from_uniforms`),
so the same uniforms give the JAX package's matrices.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch


def hash_arrays(arrs) -> str:
    """Running SHA1 over the raw bytes of a list of numpy arrays
    (reference utils.py:71-76), the operator cache's key."""
    running_hash = hashlib.sha1()
    for arr in arrs:
        arr = np.ascontiguousarray(np.asarray(arr))
        running_hash.update(arr.view(np.uint8))
    return running_hash.hexdigest()


def ensure_dir_exists(d: str) -> None:
    os.makedirs(d, exist_ok=True)


DEFAULT_BUCKETS = (256, 1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144)


def round_up_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_size(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n, else n rounded up to a multiple of 8192."""
    for b in buckets:
        if n <= b:
            return b
    return round_up_to_multiple(n, 8192)


def pad_to(arr: np.ndarray, n: int, axis: int = 0, value=0):
    """Pad `arr` along `axis` up to length n with a constant."""
    arr = np.asarray(arr)
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        raise ValueError(f"cannot pad axis of size {cur} down to {n}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n - cur)
    return np.pad(arr, widths, mode="constant", constant_values=value)


def to_np(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array
    (reference utils.py:12-16 ``toNP``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Rotation augmentation
# ---------------------------------------------------------------------------

def rotation_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) uniforms in [0, 1) -> (..., 3, 3) rotations, uniform on
    SO(3) (the Householder construction of reference utils.py:78-114, in
    the JAX package's order of operations)."""
    theta = u[..., 0] * 2.0 * math.pi    # rotation about the pole (Z)
    phi = u[..., 1] * 2.0 * math.pi      # direction of pole deflection
    z = u[..., 2] * 2.0                  # magnitude of pole deflection
    r = torch.sqrt(z)
    V = torch.stack([torch.sin(phi) * r, torch.cos(phi) * r,
                     torch.sqrt(2.0 - z)], dim=-1)
    st, ct = torch.sin(theta), torch.cos(theta)
    zero, one = torch.zeros_like(st), torch.ones_like(st)
    R = torch.stack([torch.stack([ct, st, zero], -1),
                     torch.stack([-st, ct, zero], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    return (V[..., :, None] * V[..., None, :] - eye) @ R


def rotation_y_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """(...) uniforms in [0, 1) -> (..., 3, 3) rotations about the Y axis by
    2 pi u (reference utils.py:35-45)."""
    angle = u * (2.0 * math.pi)
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, zero, s], -1),
                        torch.stack([zero, one, zero], -1),
                        torch.stack([-s, zero, c], -1)], -2)


def random_rotation_matrix(generator: torch.Generator,
                           dtype=torch.float32) -> torch.Tensor:
    """A uniform random rotation in SO(3), from three uniforms drawn from
    `generator` (on its device)."""
    u = torch.rand(3, generator=generator, device=generator.device)
    return rotation_from_uniforms(u).to(dtype)


def random_rotate_points(pts: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
    """Right-multiply points by a uniform random rotation (reference
    utils.py:30-33)."""
    R = random_rotation_matrix(generator, pts.dtype).to(pts.device)
    return pts @ R


def random_rotate_points_y(pts: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """Random rotation about the Y axis only (reference utils.py:35-45)."""
    u = torch.rand((), generator=generator, device=generator.device)
    return pts @ rotation_y_from_uniform(u).to(pts.device, pts.dtype)


# ---------------------------------------------------------------------------
# Losses and host preprocessing
# ---------------------------------------------------------------------------

def label_smoothing_log_loss(pred: torch.Tensor, labels: torch.Tensor,
                             smoothing: float = 0.0) -> torch.Tensor:
    """Smoothed negative log-likelihood on log-probabilities pred
    (..., n_class) with integer labels (...) (reference utils.py:18-24):
    the mean over the leading dims."""
    n_class = pred.shape[-1]
    one_hot = torch.nn.functional.one_hot(labels.long(), n_class).to(
        pred.dtype)
    one_hot = (one_hot * (1.0 - smoothing)
               + (1.0 - one_hot) * smoothing / (n_class - 1))
    return -(one_hot * pred).sum(-1).mean()


def normalize_positions_np(pos: np.ndarray, faces=None, method: str = "mean",
                           scale_method: str = "max_rad") -> np.ndarray:
    """Center and unit-scale positions on the host, float64 (reference
    geometry.py:635-665). method: 'mean' or 'bbox'; scale_method: 'max_rad'
    (per batch element for (B, V, 3)) or 'area' (needs faces)."""
    pos = np.asarray(pos, dtype=np.float64)
    if method == "mean":
        pos = pos - pos.mean(axis=-2, keepdims=True)
    elif method == "bbox":
        center = (pos.max(axis=-2) + pos.min(axis=-2)) / 2.0
        pos = pos - center[..., None, :]
    else:
        raise ValueError("unrecognized method")

    if scale_method == "max_rad":
        scale = np.linalg.norm(pos, axis=-1).max(axis=-1, keepdims=True)
        pos = pos / scale[..., None]
    elif scale_method == "area":
        if faces is None:
            raise ValueError("must pass faces for area normalization")
        coords = pos[faces]
        fa = 0.5 * np.linalg.norm(
            np.cross(coords[:, 1] - coords[:, 0], coords[:, 2] - coords[:, 0]),
            axis=-1)
        pos = pos / np.sqrt(fa.sum())
    else:
        raise ValueError("unrecognized scale method")
    return pos
