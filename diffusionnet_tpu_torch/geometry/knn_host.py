"""Host kNN for the precompute: the counterpart of
diffusionnet_tpu/geometry/knn_host.py (reference find_knn(method='cpu_kd'),
geometry.py:695-721, with its duplicate-point guard in omit_diagonal).

It runs on the native KD-tree (native/). Where the JAX package falls back
to scipy when the native call fails, this raises. `find_knn_ckdtree` is the
same query on scipy's cKDTree, kept as a test oracle only.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..native import knn_native


def _clamp_k(points_source, points_target, k, omit_diagonal):
    if omit_diagonal and points_source.shape[0] != points_target.shape[0]:
        raise ValueError("omit_diagonal requires same source/target shape")
    # clamp to the target count: a KD-tree fills missing neighbours with an
    # out-of-range index, which would leak into the gathers downstream
    V = points_target.shape[0]
    k_max = V - 1 if omit_diagonal else V
    if k > k_max:
        warnings.warn(
            f"find_knn_host: k={k} exceeds the {k_max} available target "
            f"points; returning (N, {k_max}) arrays instead of (N, {k})",
            stacklevel=3)
        k = k_max
    if k < 1:
        raise ValueError(f"need at least {'2' if omit_diagonal else '1'} "
                         f"target points, got {V}")
    return k + 1 if omit_diagonal else k


def _omit_self(dists, neighbors):
    """Drop the self element; where duplicates keep self out of the list,
    drop the farthest instead (reference geometry.py:709-716)."""
    mask = neighbors != np.arange(neighbors.shape[0])[:, None]
    mask[np.sum(mask, axis=1) == mask.shape[1], -1] = False
    n, k = neighbors.shape
    return (dists[mask].reshape(n, k - 1), neighbors[mask].reshape(n, k - 1))


def find_knn_host(points_source: np.ndarray, points_target: np.ndarray,
                  k: int, omit_diagonal: bool = False):
    """(dists, inds), each (N, k), sorted by increasing distance."""
    points_source = np.asarray(points_source, dtype=np.float64)
    points_target = np.asarray(points_target, dtype=np.float64)
    k_search = _clamp_k(points_source, points_target, k, omit_diagonal)
    dists, neighbors = knn_native(points_target, points_source, k_search)
    if omit_diagonal:
        dists, neighbors = _omit_self(dists, neighbors)
    return dists, neighbors


def find_knn_ckdtree(points_source: np.ndarray, points_target: np.ndarray,
                     k: int, omit_diagonal: bool = False):
    """find_knn_host on scipy's cKDTree (the JAX package's fallback): a test
    oracle, called by no other module. Ties between equal distances may be
    ordered differently from the native tree."""
    from scipy.spatial import cKDTree
    points_source = np.asarray(points_source, dtype=np.float64)
    points_target = np.asarray(points_target, dtype=np.float64)
    k_search = _clamp_k(points_source, points_target, k, omit_diagonal)
    dists, neighbors = cKDTree(points_target).query(points_source,
                                                    k=k_search)
    if k_search == 1:
        dists, neighbors = dists[:, None], neighbors[:, None]
    if omit_diagonal:
        dists, neighbors = _omit_self(dists, neighbors)
    return dists, neighbors
