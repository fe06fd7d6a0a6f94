"""Host-parallel operator precompute. The counterpart of
diffusionnet_tpu/geometry/parallel_precompute.py.

Precompute is independent across shapes and the disk cache tolerates
concurrent writers (a duplicate writer at worst leaves an extra bucket
file, reference geometry.py:444-446), so the misses fan out over a process
pool; cache hits load in-process (they are I/O-bound and fast).
"""

from __future__ import annotations

import os
from multiprocessing import get_context

import numpy as np

from .operators import Operators, get_operators


def _worker(args):
    verts, faces, k_eig, op_cache_dir, normals, eigensolver = args
    # a numpy bundle (NamedTuples of arrays) pickles back to the parent
    return get_operators(verts, faces, k_eig=k_eig, op_cache_dir=op_cache_dir,
                         normals=normals, eigensolver=eigensolver)


def get_all_operators_parallel(verts_list, faces_list, k_eig: int,
                               op_cache_dir: str | None = None,
                               normals=None,
                               n_workers: int | None = None,
                               eigensolver: str = "host") -> list[Operators]:
    """get_all_operators over a spawn pool of n_workers processes (default
    os.cpu_count()); the results keep input order. Cache hits load here,
    only the misses go to the workers.

    eigensolver defaults to 'host' (ARPACK; unlike get_operators'
    'device'): the pool is for CPU-parallel solves across shapes, and
    worker processes must not open the card the parent holds. Pass
    eigensolver='device' only with n_workers=1 (in-process, on the card)."""
    n = len(verts_list)
    n_workers = n_workers if n_workers is not None else (os.cpu_count() or 1)
    results: list = [None] * n
    miss = []
    for i in range(n):
        if op_cache_dir is not None:
            results[i] = get_operators(
                verts_list[i], faces_list[i], k_eig=k_eig,
                op_cache_dir=op_cache_dir,
                normals=None if normals is None else normals[i],
                cache_only=True)
        if results[i] is None:
            miss.append(i)

    jobs = [(np.asarray(verts_list[i]), np.asarray(faces_list[i]), k_eig,
             op_cache_dir, None if normals is None else normals[i],
             eigensolver)
            for i in miss]
    if n_workers <= 1 or len(miss) <= 1:
        computed = [_worker(j) for j in jobs]
    else:
        # spawn: fork is unsafe in a process with threads or a CUDA context
        with get_context("spawn").Pool(min(n_workers, len(miss))) as pool:
            computed = pool.map(_worker, jobs)
    for i, ops in zip(miss, computed):
        results[i] = ops
    return results


def precompute_shard_for_host(verts_list, faces_list, k_eig: int,
                              op_cache_dir: str,
                              process_index: int | None = None,
                              process_count: int | None = None,
                              normals=None,
                              n_workers: int | None = None) -> list[int]:
    """Multi-host precompute: this process computes its round-robin share
    of the dataset (indices process_index, process_index + process_count,
    ...) into the SHARED op_cache_dir; after every process is done (a
    barrier), each loads the whole dataset at cache-hit speed.

    process_index/count: the torch.distributed rank and world size when it
    is initialized (and the arguments are None), else the arguments (one
    process by default). Returns the indices this process computed."""
    if process_index is None or process_count is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            process_index, process_count = (dist.get_rank(),
                                            dist.get_world_size())
        else:
            process_index, process_count = 0, 1
    mine = list(range(process_index, len(verts_list), process_count))
    if not mine:
        return mine
    get_all_operators_parallel(
        [verts_list[i] for i in mine], [faces_list[i] for i in mine],
        k_eig=k_eig, op_cache_dir=op_cache_dir,
        normals=None if normals is None else [normals[i] for i in mine],
        n_workers=n_workers)
    return mine
