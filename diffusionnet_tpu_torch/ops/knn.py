"""k nearest neighbours and farthest-point sampling on the device: the
counterpart of diffusionnet_tpu/ops/knn.py (reference
geometry.py:669-751).

The brute-force kNN runs over chunks of the source points, so the
(chunk, M) distance block bounds the working set whatever N is; the
farthest-point loop keeps its state on the device (no host sync a step).
"""

from __future__ import annotations

import numpy as np
import torch

from .transforms import normalize_positions
from .vector import norm2


def find_knn(points_source, points_target, k: int, largest: bool = False,
             omit_diagonal: bool = False, method: str = "brute",
             chunk_size: int = 2048):
    """The k nearest (largest: farthest) target points of each source point.

    Returns (dists, inds), (N, k) each, sorted by increasing distance
    (decreasing with largest). omit_diagonal requires the source and the
    target to be the same set (reference geometry.py:671-672). method:
    'brute' on the tensors' device (chunked), or 'cpu_kd', the native host
    KD-tree (geometry/knn_host.py; the reference's sklearn path,
    geometry.py:695-721): float32 distances and int64 indices, returned
    on the source's device."""
    if omit_diagonal and points_source.shape[0] != points_target.shape[0]:
        raise ValueError("omit_diagonal can only be used when source and "
                         "target are same shape")
    if method == "cpu_kd":
        if largest:
            raise ValueError("can't do largest with cpu_kd")
        from ..geometry.knn_host import find_knn_host
        d, i = find_knn_host(points_source.detach().cpu().numpy(),
                             points_target.detach().cpu().numpy(), k,
                             omit_diagonal=omit_diagonal)
        dev = points_source.device
        return (torch.from_numpy(d.astype(np.float32)).to(dev),
                torch.from_numpy(i).to(dev))
    if method != "brute":
        raise ValueError("unrecognized method")

    N = points_source.shape[0]
    chunk = max(1, min(chunk_size, N))
    tgt_sq = (points_target * points_target).sum(-1)
    dists, inds = [], []
    for start in range(0, N, chunk):
        pts = points_source[start:start + chunk]
        d2 = ((pts * pts).sum(-1)[:, None] - 2.0 * pts @ points_target.T
              + tgt_sq[None, :]).clamp(min=0.0)
        if omit_diagonal:
            # the self-match gets the worst value for the direction chosen
            rows = torch.arange(pts.shape[0], device=pts.device)
            d2[rows, rows + start] = -torch.inf if largest else torch.inf
        vals, idx = torch.topk(d2, k, dim=-1, largest=largest, sorted=True)
        dists.append(torch.sqrt(vals))
        inds.append(idx)
    return torch.cat(dists), torch.cat(inds)


def farthest_point_sampling(points, n_sample: int):
    """Greedy farthest-point sampling from the centermost point (reference
    geometry.py:736-749); returns an (N,) bool mask with n_sample True
    entries."""
    N = points.shape[0]
    if n_sample > N:
        raise ValueError("not enough points to sample")
    pts = normalize_positions(points)
    i = torch.argmin(norm2(pts))
    chosen = torch.zeros(N, dtype=torch.bool, device=points.device)
    chosen[i] = True
    min_dists = torch.full((N,), torch.inf, dtype=points.dtype,
                           device=points.device)
    for _ in range(n_sample - 1):
        min_dists = torch.minimum(norm2(pts[i][None, :] - pts), min_dists)
        # never pick a chosen point again: with duplicate points min_dists
        # can be 0 everywhere
        i = torch.argmax(torch.where(chosen, -1.0, min_dists))
        chosen[i] = True
    return chosen
