"""Host utilities: cache hashing, filesystem, bucket padding.

The numpy parts of diffusionnet_tpu/utils.py. `hash_arrays` gives the same
SHA1 keys as the JAX package, so both packages share one operator cache.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


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
