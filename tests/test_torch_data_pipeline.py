"""The port's input pipelines and dataset precompute on the CPU, mirroring
tests/test_data.py: DeviceDataset batches bit-equal to make_padded_batches
(and so to the JAX package's), shuffles that cover every sample,
prefetch_to_device's order, values, errors and release, the threaded
get_all_operators, and precompute's normals_list against the JAX
package's operators."""

import threading
import time

import numpy as np
import pytest
import torch

import diffusionnet_tpu.data.dataset as jds_mod
import diffusionnet_tpu.geometry as jgeo
import diffusionnet_tpu_torch.geometry as tgeo
from diffusionnet_tpu_torch.data import (DeviceDataset, SurfaceDataset,
                                         make_padded_batches,
                                         prefetch_to_device)
from tests.meshgen import icosphere, torus
from tests.test_torch_geometry import _assert_ops_equal
from tests.test_torch_train import _assert_bundle_equal, _to_jax_ops


def _batch_equal(a, b):
    """Every array of two PaddedBatches (tensors or numpy) bit-equal."""
    arrays = []
    a.map(lambda x: arrays.append(x) or x)
    n = len(arrays)
    b.map(lambda x: arrays.append(x) or x)
    assert len(arrays) == 2 * n
    for x, y in zip(arrays[:n], arrays[n:]):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _dataset(kind, n, sizes=(1,)):
    ds = SurfaceDataset(labels_kind=kind)
    for i in range(n):
        v, f = (icosphere(sizes[i % len(sizes)]) if i % 3 else
                torus(8, 6))
        v = v * (1 + 0.01 * i)
        lab = {"global": i, "vertex": (v[:, 0] > 0).astype(np.int32) + i % 2,
               "face": np.arange(f.shape[0]) % 3}[kind]
        ds.add(v, f, lab)
    ds.precompute(k_eig=4, verbose=False, eigensolver="host")
    return ds


@pytest.fixture(scope="module")
def datasets():
    return {kind: _dataset(kind, 7, sizes=(1, 2))
            for kind in ("global", "vertex", "face")}


@pytest.mark.parametrize("kind", ["global", "vertex", "face"])
@pytest.mark.parametrize("shuffle,buckets", [(False, None), (True, None),
                                             (True, (64, 256, 1024))])
def test_device_dataset_matches_host_batches(datasets, kind, shuffle,
                                             buckets):
    """DeviceDataset's gathers equal make_padded_batches leaf for leaf, bit
    for bit (grouping, padding, filler rows), which equal the JAX
    package's make_padded_batches."""
    ds = datasets[kind]
    host = list(make_padded_batches(ds, 3, shuffle=shuffle, seed=4,
                                    buckets=buckets))
    dev = list(DeviceDataset(ds, buckets=buckets, device="cpu").batches(
        3, shuffle=shuffle, seed=4))
    assert len(host) == len(dev) >= 3
    for h, d in zip(host, dev):
        assert isinstance(d.verts, torch.Tensor)
        _batch_equal(h, d)
    assert any((h.labels == -1).all(axis=tuple(range(1, h.labels.ndim)))
               .any() for h in host)
    jds = jds_mod.SurfaceDataset(labels_kind=kind)
    for v, f, lab in zip(ds.verts_list, ds.faces_list, ds.labels_list):
        jds.add(v, f, lab)
    jds.ops_list = [_to_jax_ops(o) for o in ds.ops_list]
    want = list(jds_mod.make_padded_batches(jds, 3, shuffle=shuffle, seed=4,
                                            buckets=buckets))
    for h, w in zip(host, want):
        for f in ("verts", "labels", "faces", "face_mask"):
            np.testing.assert_array_equal(getattr(h, f), getattr(w, f))
        _assert_bundle_equal(h.ops, w.ops)


def test_device_dataset_shuffle_covers_all_samples(datasets):
    seen = []
    for b in DeviceDataset(datasets["global"], device="cpu").batches(
            3, shuffle=True, seed=3):
        seen += [int(x) for x in b.labels if x >= 0]
    assert sorted(seen) == list(range(7))


def test_prefetch_preserves_order_and_values(datasets):
    ds = datasets["face"]
    plain = list(make_padded_batches(ds, 2, shuffle=True, seed=1))
    pre = list(prefetch_to_device(make_padded_batches(ds, 2, shuffle=True,
                                                      seed=1), device="cpu"))
    assert len(plain) == len(pre)
    for a, b in zip(plain, pre):
        assert isinstance(b.verts, torch.Tensor)
        _batch_equal(a, b)


def test_prefetch_raises_the_producers_error(datasets):
    def batches():
        yield from make_padded_batches(datasets["global"], 2)
        raise KeyError("producer failed")
    got = []
    with pytest.raises(KeyError, match="producer failed"):
        for b in prefetch_to_device(batches(), device="cpu"):
            got.append(b)
    assert len(got) == 4


def test_prefetch_abandoned_releases_its_thread(datasets):
    """A consumer that stops after one batch of many: closing the generator
    returns within the 10 s guard, and the producer thread ends."""
    before = set(threading.enumerate())

    def endless():
        b = next(make_padded_batches(datasets["global"], 2))
        while True:
            yield b
    gen = prefetch_to_device(endless(), size=1, device="cpu")
    next(gen)
    t0 = time.monotonic()
    gen.close()
    started = [t for t in threading.enumerate() if t not in before]
    for t in started:
        t.join(timeout=10)
    assert time.monotonic() - t0 < 10
    assert not any(t.is_alive() for t in started)


def test_get_all_operators_threaded_matches_sequential(tmp_path):
    """Two threads of the device eigensolver (on the CPU) give the
    sequential loop's operators, in order."""
    meshes = [icosphere(2), torus(10, 8), icosphere(1)]
    vlist = [v * (1 + 0.1 * i) for i, (v, _) in enumerate(meshes)]
    flist = [f for _, f in meshes]
    seq = tgeo.get_all_operators(vlist, flist, k_eig=6, eigensolver="device",
                                 n_workers=1, verbose=False, device="cpu")
    par = tgeo.get_all_operators(vlist, flist, k_eig=6, eigensolver="device",
                                 n_workers=2, verbose=False, device="cpu",
                                 op_cache_dir=str(tmp_path))
    assert len(par) == 3
    for a, b in zip(seq, par):
        _assert_ops_equal(a, b, atol=0)


def test_full_f32_matmul_holds_across_threads():
    """The eigensolver's precision guard under two overlapping solves (as
    get_all_operators' threads run them): the one that leaves first does
    not hand the caller's TF32 to the one still inside, and the caller's
    settings come back once both have left."""
    from diffusionnet_tpu_torch.geometry.eigen import _full_f32_matmul
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32)
    inside, a_left = threading.Barrier(2), threading.Event()
    seen = {}

    def state():
        return (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32)

    def solve(name):
        with _full_f32_matmul():
            inside.wait(timeout=10)
            seen[name, "in"] = state()
            if name == "a":
                return
            assert a_left.wait(timeout=10)
            seen[name, "after a left"] = state()

    def first():
        solve("a")
        a_left.set()
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        threads = [threading.Thread(target=first),
                   threading.Thread(target=solve, args=("b",))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        after = state()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    assert len(seen) == 3
    assert all(v == ("highest", False) for v in seen.values()), seen
    assert after == ("high", True)


def test_precompute_normals_list_matches_jax():
    """precompute(normals_list=) builds the frames from the given normals:
    equal to the JAX package's operators on the same normals (atol 1e-6, as
    the operator tests), and different from the computed ones. The meshes
    are jittered, so no eigenvalue cluster is cut at k 8."""
    rs = np.random.RandomState(0)
    (v1, f1), (v2, f2) = icosphere(2), torus(10, 8)
    v1, v2 = (v * (1 + 0.05 * rs.randn(*v.shape)) for v in (v1, v2))
    normals = []
    for v in (v1, v2):
        n = rs.randn(*v.shape)
        normals.append(n / np.linalg.norm(n, axis=1, keepdims=True))
    ds = SurfaceDataset(labels_kind="global")
    ds.add(v1, f1, 0)
    ds.add(v2, f2, 1)
    ds.precompute(k_eig=8, normals_list=normals, verbose=False,
                  eigensolver="host")
    for o, v, f, n in zip(ds.ops_list, ds.verts_list, ds.faces_list,
                          normals):
        want = jgeo.compute_operators(v, f, k_eig=8, normals=n,
                                      eigensolver="host")
        _assert_ops_equal(o, want, atol=1e-6)
        np.testing.assert_allclose(o.frames[:, 2], n, atol=1e-6)
    plain = tgeo.compute_operators(v1, f1, k_eig=8, eigensolver="host")
    assert not np.allclose(plain.frames, ds.ops_list[0].frames, atol=1e-3)
    with pytest.raises(ValueError, match="normals_list"):
        ds.precompute(k_eig=8, normals_list=normals[:1], verbose=False,
                      eigensolver="host")
