"""SurfaceDataset and static-shape padded batching.

The counterpart of diffusionnet_tpu/data/dataset.py (host side). Every batch
is padded to a vertex bucket with masked filler, so a dataset of many mesh
sizes gives a few batch shapes, and the kernels see fixed shapes.

Padding invariants:
  * padded vertices have mass == 0 -> exact no-ops in every mass-weighted
    reduction;
  * padded ELL entries have val == 0;
  * padding labels are -1 -> excluded from losses and metrics;
  * filler samples (to square off a partial final batch) copy a real
    sample's geometry but carry labels == -1 everywhere, and face_mask False.

Batches are numpy; `PaddedBatch.to(device)` is the one boundary where they
become torch tensors. (The JAX package's prefetch_to_device and
DeviceDataset come with ROADMAP item A.7.)
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from .. import utils
from ..geometry.operators import (DEFAULT_EIGENSOLVER, Operators,
                                  get_operators, map_operators,
                                  pad_operators, truncate_k)

LABEL_KINDS = ("global", "vertex", "face")


class PaddedBatch(NamedTuple):
    """One statically-shaped batch; every field leads with the batch dim B."""
    verts: np.ndarray      # (B, Vp, 3) float32
    ops: Operators         # stacked/padded operator bundle
    labels: np.ndarray     # (B,) | (B, Vp) | (B, Fp) int32; -1 = ignore
    faces: np.ndarray      # (B, Fp, 3) int32; -1 rows = padding
    face_mask: np.ndarray  # (B, Fp) bool; True on real faces of real samples

    def to(self, device) -> "PaddedBatch":
        """The same batch with every array a torch tensor on `device`."""
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return PaddedBatch(verts=t(self.verts), ops=self.ops.to(device),
                           labels=t(self.labels), faces=t(self.faces),
                           face_mask=t(self.face_mask))


class SurfaceDataset:
    """A list of surfaces (meshes), labels, and -- after `precompute()` --
    their spectral operator bundles.

    labels_kind: 'global' (one int per shape), 'vertex' (V ints), or 'face'
    (F ints)."""

    def __init__(self, labels_kind: str = "global"):
        if labels_kind not in LABEL_KINDS:
            raise ValueError(f"labels_kind must be one of {LABEL_KINDS}, "
                             f"got '{labels_kind}'")
        self.labels_kind = labels_kind
        self.verts_list: list[np.ndarray] = []
        self.faces_list: list[np.ndarray] = []
        self.labels_list: list[np.ndarray] = []
        self.ops_list: list[Operators] = []

    def __len__(self) -> int:
        return len(self.verts_list)

    def add(self, verts, faces, labels) -> None:
        """Add one surface. faces: (F,3) int. labels: an int ('global'), (V,)
        ints ('vertex'), or (F,) ints ('face')."""
        verts = np.asarray(verts, dtype=np.float32)
        if verts.ndim != 2 or verts.shape[1] != 3:
            raise ValueError(f"verts must be (V, 3), got {verts.shape}")
        if faces is None or np.asarray(faces).size == 0:
            faces = np.zeros((0, 3), dtype=np.int64)
        else:
            faces = np.asarray(faces, dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int32)
        if self.labels_kind == "global":
            if labels.ndim != 0:
                raise ValueError("'global' labels must be scalars")
        elif self.labels_kind == "vertex":
            if labels.shape != (verts.shape[0],):
                raise ValueError(f"'vertex' labels must be (V,)={verts.shape[0]}, "
                                 f"got {labels.shape}")
        else:  # face
            if labels.shape != (faces.shape[0],):
                raise ValueError(f"'face' labels must be (F,)={faces.shape[0]}, "
                                 f"got {labels.shape}")
        self.verts_list.append(verts)
        self.faces_list.append(faces)
        self.labels_list.append(labels)

    def precompute(self, k_eig: int, op_cache_dir: str | None = None,
                   verbose: bool = True,
                   eigensolver: str = DEFAULT_EIGENSOLVER,
                   device="cuda") -> None:
        """Compute (or load from the disk cache) the Operators bundle of
        every surface. eigensolver: 'device' (default; the solve runs on
        `device`) or 'host' (ARPACK), as get_operators."""
        n = len(self)
        ops = []
        for i in range(n):
            if verbose:
                print(f"precompute {i} / {n}")
            ops.append(get_operators(self.verts_list[i], self.faces_list[i],
                                     k_eig, op_cache_dir,
                                     eigensolver=eigensolver, device=device))
        self.ops_list = ops


def _group_by_bucket(ds: SurfaceDataset, buckets) -> dict[int, list[int]]:
    """vertex bucket -> sample indices; buckets=None puts the whole dataset
    in one bucket sized for its largest shape."""
    if buckets is None:
        v_pad = utils.bucket_size(max(v.shape[0] for v in ds.verts_list))
        return {v_pad: list(range(len(ds)))}
    groups: dict[int, list[int]] = {}
    for i, v in enumerate(ds.verts_list):
        groups.setdefault(utils.bucket_size(v.shape[0], buckets), []).append(i)
    return dict(sorted(groups.items()))


def _stack_group(ds: SurfaceDataset, idx: Sequence[int], v_pad: int,
                 f_pad: int, k_eig: int, d_l: int, d_g: int) -> PaddedBatch:
    """One PaddedBatch of the given samples."""
    verts = np.stack([utils.pad_to(ds.verts_list[i], v_pad) for i in idx])
    faces = np.stack([utils.pad_to(ds.faces_list[i].astype(np.int32), f_pad,
                                   value=-1) for i in idx])
    face_mask = np.zeros((len(idx), f_pad), dtype=bool)
    for b, i in enumerate(idx):
        face_mask[b, :ds.faces_list[i].shape[0]] = True
    if ds.labels_kind == "global":
        labels = np.asarray([ds.labels_list[i] for i in idx], np.int32)
    else:
        pad_len = v_pad if ds.labels_kind == "vertex" else f_pad
        labels = np.stack([utils.pad_to(ds.labels_list[i], pad_len, value=-1)
                           for i in idx]).astype(np.int32)
    ops = map_operators(
        lambda *xs: np.stack(xs, axis=0),
        *[pad_operators(truncate_k(ds.ops_list[i], k_eig), v_pad, k_eig, d_l,
                        d_g) for i in idx])
    return PaddedBatch(verts=verts, ops=ops, labels=labels, faces=faces,
                       face_mask=face_mask)


def _stacked_groups(ds: SurfaceDataset, buckets):
    """One padded, stacked batch of all rows per vertex-bucket group, built
    once per (dataset, bucket config) and cached on the dataset; batches are
    then row gathers. The cache key holds the ops_list object and its
    elements (identity-compared), so precompute() or replacing an element
    invalidates it."""
    key = (ds.ops_list, tuple(ds.ops_list), len(ds),
           tuple(buckets) if buckets is not None else None)
    cached = getattr(ds, "_stacked_cache", None)
    if (cached is not None and cached[0][0] is key[0]
            and len(cached[0][1]) == len(key[1])
            and all(a is b for a, b in zip(cached[0][1], key[1]))
            and cached[0][2:] == key[2:]):
        return cached[1]

    k_eig = min(o.evals.shape[0] for o in ds.ops_list)
    groups = []
    for v_pad, idx in _group_by_bucket(ds, buckets).items():
        group_ops = [ds.ops_list[i] for i in idx]
        # group-wide static shapes, rounded
        d_l = utils.round_up_to_multiple(
            max(o.L.max_degree for o in group_ops), 4)
        d_g = utils.round_up_to_multiple(
            max(max(o.gradX.max_degree, o.gradY.max_degree)
                for o in group_ops), 4)
        max_f = max(ds.faces_list[i].shape[0] for i in idx)
        f_pad = utils.round_up_to_multiple(max_f, 128) if max_f else 4
        stacked = _stack_group(ds, idx, v_pad, f_pad, k_eig, d_l, d_g)
        groups.append((np.asarray(idx), stacked))
    ds._stacked_cache = (key, groups)
    return groups


def _take(stacked: PaddedBatch, rows) -> PaddedBatch:
    return PaddedBatch(
        verts=stacked.verts[rows],
        ops=map_operators(lambda a: a[rows], stacked.ops),
        labels=stacked.labels[rows], faces=stacked.faces[rows],
        face_mask=stacked.face_mask[rows])


def _batch_rows(stacked: PaddedBatch, order, start: int, batch_size: int
                ) -> PaddedBatch:
    """One batch from stacked group rows; filler rows repeat the chunk's
    first sample with labels -1 and face_mask False."""
    chunk = order[start:start + batch_size]
    n_fill = batch_size - len(chunk)
    rows = np.concatenate([chunk, np.full(n_fill, chunk[0], chunk.dtype)])
    batch = _take(stacked, rows)
    if n_fill:
        labels = batch.labels.copy()
        labels[len(chunk):] = -1
        face_mask = batch.face_mask.copy()
        face_mask[len(chunk):] = False
        batch = batch._replace(labels=labels, face_mask=face_mask)
    return batch


def make_padded_batches(ds: SurfaceDataset, batch_size: int,
                        shuffle: bool = False, seed: int = 0,
                        buckets=None) -> Iterator[PaddedBatch]:
    """Yield statically-shaped PaddedBatches (numpy).

    Samples are grouped by vertex bucket (buckets=None: one bucket sized for
    the dataset's largest shape); each group's pad shapes -- v_pad, f_pad,
    ELL degrees -- are group-wide. A partial final batch is squared off with
    filler samples whose labels are -1 everywhere. With shuffle, each
    group's order is a numpy RandomState(seed) permutation, as in the JAX
    package, so both packages give the same batches."""
    if not ds.ops_list:
        raise RuntimeError("call SurfaceDataset.precompute() before batching")
    if len(ds.ops_list) != len(ds):
        raise RuntimeError("ops_list is stale: precompute() after every add()")

    rng = np.random.RandomState(seed) if shuffle else None
    for idx, stacked in _stacked_groups(ds, buckets):
        n = len(idx)
        order = rng.permutation(n) if rng is not None else np.arange(n)
        for start in range(0, n, batch_size):
            yield _batch_rows(stacked, order, start, batch_size)
