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

Batches are numpy; `PaddedBatch.to(device)` is the boundary where they
become torch tensors. Two input pipelines feed a training loop:
`prefetch_to_device` (host stacking and the copy to the card on a
background thread) and `DeviceDataset` (the stacked dataset on the card
once, batches gathered there).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from .. import utils
from ..training.profiling import span, wait
from ..geometry.operators import (DEFAULT_EIGENSOLVER, Operators,
                                  get_all_operators, map_operators,
                                  pad_operators, truncate_k)

LABEL_KINDS = ("global", "vertex", "face")


class PaddedBatch(NamedTuple):
    """One statically-shaped batch; every field leads with the batch dim B."""
    verts: np.ndarray      # (B, Vp, 3) float32
    ops: Operators         # stacked/padded operator bundle
    labels: np.ndarray     # (B,) | (B, Vp) | (B, Fp) int32; -1 = ignore
    faces: np.ndarray      # (B, Fp, 3) int32; -1 rows = padding
    face_mask: np.ndarray  # (B, Fp) bool; True on real faces of real samples

    def map(self, fn: Callable) -> "PaddedBatch":
        """fn applied to every array of the batch (the idx and val of each
        Ell included; None stays None)."""
        return PaddedBatch(verts=fn(self.verts),
                           ops=map_operators(fn, self.ops),
                           labels=fn(self.labels), faces=fn(self.faces),
                           face_mask=fn(self.face_mask))

    def to(self, device) -> "PaddedBatch":
        """The same batch with every array a torch tensor on `device`."""
        return self.map(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))


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
                   normals_list: Sequence | None = None,
                   verbose: bool = True,
                   eigensolver: str = DEFAULT_EIGENSOLVER,
                   device="cuda", timings: dict | None = None) -> None:
        """Compute (or load from the disk cache) the Operators bundle of
        every surface through get_all_operators (its worker policy).
        normals_list: optional per-sample (V, 3) normals that replace the
        computed ones in the tangent frames (the sampling_invariance cloud
        flow, reference dataset.py:107-115,146). eigensolver: 'device'
        (default; the solve runs on `device`) or 'host' (ARPACK). timings:
        optional dict of wall seconds per precompute stage (empty when
        every shape came from the cache)."""
        n = len(self)
        if normals_list is not None and len(normals_list) != n:
            raise ValueError(f"normals_list has {len(normals_list)} entries "
                             f"for {n} samples")
        self.ops_list = get_all_operators(
            self.verts_list, self.faces_list, k_eig,
            op_cache_dir=op_cache_dir, normals=normals_list,
            eigensolver=eigensolver, verbose=verbose, device=device,
            timings=timings)


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


def _epoch_chunks(groups, batch_size: int, shuffle: bool, seed: int):
    """(stacked group, the group's order, start) of each batch of an epoch:
    each group's order is a numpy RandomState(seed) permutation with
    shuffle (as in the JAX package); `_rows` makes the batch's rows."""
    rng = np.random.RandomState(seed) if shuffle else None
    for idx, stacked in groups:
        n = len(idx)
        order = rng.permutation(n) if rng is not None else np.arange(n)
        for start in range(0, n, batch_size):
            yield stacked, order, start


def _rows(order, start: int, batch_size: int) -> tuple:
    """(rows, n_real) of the batch at `start` of an epoch's order: a partial
    final batch repeats the chunk's first row after its n_real real ones."""
    chunk = order[start:start + batch_size]
    n_fill = batch_size - len(chunk)
    return (np.concatenate([chunk, np.full(n_fill, chunk[0], chunk.dtype)]),
            len(chunk))


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

    for stacked, order, start in _epoch_chunks(_stacked_groups(ds, buckets),
                                               batch_size, shuffle, seed):
        rows, n_real = _rows(order, start, batch_size)
        batch = stacked.map(lambda a: a[rows])
        if n_real < batch_size:
            # filler rows: labels -1, face_mask False
            labels = batch.labels.copy()
            labels[n_real:] = -1
            face_mask = batch.face_mask.copy()
            face_mask[n_real:] = False
            batch = batch._replace(labels=labels, face_mask=face_mask)
        yield batch


def _copy_to_card(batch: PaddedBatch, device, stream) -> tuple:
    """The batch copied to the card from pinned host memory on `stream`, and
    the event recorded after the copies. The pinned arrays may go at once:
    the caching host allocator keeps a pinned block from reuse until the
    copy's stream has passed it."""
    with torch.cuda.stream(stream):
        dev = batch.map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                        .pin_memory().to(device, non_blocking=True))
        event = torch.cuda.Event()
        event.record(stream)
    return dev, event


def prefetch_to_device(batches, size: int = 2, device="cuda"):
    """PaddedBatches (numpy) -> the same batches as torch tensors on
    `device`, produced ahead of consumption.

    A background thread runs the producer (the host stacking of
    make_padded_batches) and the copies, so both overlap the consumer's
    device work; at most `size` batches wait in the queue. On a CUDA device
    each batch is copied from pinned memory on a side stream, and the
    consumer's stream is made to wait on the copy's event before it reads
    the batch, with every tensor marked as used on it for the caching
    allocator. A producer error is raised in the consumer; a consumer that
    abandons the generator (an exception, an early stop) releases the
    thread, which then drops its batches. The consumer's wait for each
    batch is the span dnt.batch (`training.profiling`), and so is its wait
    for the end of the producer's batches."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    errors: list[BaseException] = []
    abandoned = threading.Event()
    side = (torch.cuda.Stream(device) if device.type == "cuda" else None)

    def put(item) -> bool:
        """A bounded put that notices abandonment (the thread must not stay
        blocked holding batches on the device); False once abandoned."""
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if side is not None:
                    item = _copy_to_card(b, device, side)
                else:
                    item = (b.to(device), None)
                if not put(item):
                    return
        except BaseException as e:  # raised again on the consumer's side
            errors.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            with span("dnt.batch"):
                item = q.get()
                if item is not sentinel:
                    batch, event = item
                    if event is not None:
                        stream = torch.cuda.current_stream(device)
                        stream.wait_event(event)

                        def used_here(t):
                            t.record_stream(stream)
                            return t
                        batch = batch.map(used_here)
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield batch
    finally:
        # closed or abandoned: release the producer, drop what it queued
        abandoned.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


class DeviceDataset:
    """The whole padded, stacked dataset on `device` once (one stacked batch
    per vertex bucket, as make_padded_batches groups it); a batch is an
    index_select of its rows on the device, so an epoch moves no operator
    bytes from the host. The dataset must fit on the card beside the model
    and the optimizer state."""

    def __init__(self, ds: SurfaceDataset, buckets=None, device="cuda"):
        if not ds.ops_list or len(ds.ops_list) != len(ds):
            raise RuntimeError("precompute() the dataset before uploading")
        self.labels_kind = ds.labels_kind
        self.device = torch.device(device)
        self.groups = [(idx, stacked.to(self.device))
                       for idx, stacked in _stacked_groups(ds, buckets)]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0
                ) -> Iterator[PaddedBatch]:
        """PaddedBatches of tensors gathered on the device, in the order and
        with the filler of make_padded_batches (the same seed gives the
        same permutation): a partial final batch repeats the chunk's first
        row with labels -1 and face_mask False, so its leaves equal those of
        make_padded_batches. The making of each (its rows, their copy to
        the device, the gather) is the span dnt.batch
        (`training.profiling`)."""
        for stacked, order, start in _epoch_chunks(self.groups, batch_size,
                                                   shuffle, seed):
            with span("dnt.batch"):
                rows, n_real = _rows(order, start, batch_size)
                with wait("dnt.wait.batch_rows", self.device):
                    r = torch.from_numpy(rows).to(self.device)
                batch = stacked.map(lambda a: a.index_select(0, r))
                if n_real < batch_size:
                    fill = (torch.arange(batch_size, device=self.device)
                            >= n_real)
                    lbl = fill.reshape((-1,) + (1,) * (batch.labels.ndim - 1))
                    batch = batch._replace(
                        labels=batch.labels.masked_fill(lbl, -1),
                        face_mask=batch.face_mask.masked_fill(fill[:, None],
                                                              False))
            yield batch
