"""Build and bind the port's native host library (C++, ctypes).

The counterpart of diffusionnet_tpu/native/build.py: the same two sources
(copied here: dnet_native.cpp, ich_geodesics.cpp), the same compiler flags
(`-O3 -march=native`, retried without `-march=native`), so both libraries
compute the same bits. The library is built with g++ at first use into
build/host_native/ at the repository root, under a name that carries a hash
of the sources and the flags; nothing is written beside the sources. A
failed build raises with the compiler's output, and no caller falls back to
another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "dnet_native.cpp", _HERE / "ich_geodesics.cpp")
BUILD_DIR = _HERE.parent.parent / "build" / "host_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _digest(flags) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(cxx: str, flags, so: Path) -> str | None:
    """Compile to a per-process name and rename (atomic): a racing process
    never loads a half-written library. Returns None, or the compiler's
    output on failure."""
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *flags, *map(str, SOURCES), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        return f"cannot run {cxx}: {e}"
    try:
        if res.returncode != 0:
            return " ".join(cmd) + "\n" + res.stdout + res.stderr
        os.replace(tmp, so)
        return None
    finally:
        tmp.unlink(missing_ok=True)


def build(cxx: str | None = None) -> Path:
    """Compile the library unless one for the current sources and flags
    exists; returns its path. Tries JAX's flags, then the same without
    -march=native (a toolchain may refuse it), as the JAX package does."""
    cxx = cxx or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native host "
                           "library is built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for flags in (CXX_FLAGS,
                  tuple(f for f in CXX_FLAGS if f != "-march=native")):
        so = BUILD_DIR / f"libdnt_host_{_digest(flags)}.so"
        if so.exists():
            return so
        err = _compile(cxx, flags, so)
        if err is None:
            return so
        errors.append(err)
    raise RuntimeError("native host library build failed:\n"
                       + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its C interface."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        d, i64, i32 = (ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_int32))
        f32 = ctypes.POINTER(ctypes.c_float)
        I64, I32 = ctypes.c_int64, ctypes.c_int32
        lib.dnet_knn.argtypes = [d, I64, d, I64, I32, d, i64]
        lib.dnet_knn.restype = None
        lib.dnet_dijkstra_geodesics.argtypes = [d, I64, i64, I64, i64, I64,
                                                f32]
        lib.dnet_dijkstra_geodesics.restype = None
        lib.dnet_steiner_geodesics.argtypes = [d, I64, i64, I64, i64, I64,
                                               I32, f32]
        lib.dnet_steiner_geodesics.restype = None
        lib.dnet_cloud_triangles.argtypes = [d, I64, I32, i64, I64]
        lib.dnet_cloud_triangles.restype = I64
        lib.dnet_csr_spmm_f64.argtypes = [i64, i64, d, d, I64, I64, d, I32]
        lib.dnet_csr_spmm_f64.restype = None
        lib.dnet_ich_geodesics.argtypes = [d, I64, i64, I64, i64, I64, I64,
                                           f32, i32]
        lib.dnet_ich_geodesics.restype = I32
        _lib = lib
        return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_index(idx: np.ndarray, n_verts: int, what: str = "faces"):
    """The C++ code indexes raw buffers: an out-of-range index from a
    corrupted file or cache must raise here, not corrupt memory."""
    if idx.size and (idx.min() < 0 or idx.max() >= n_verts):
        raise ValueError(f"{what} index out of range [0, {n_verts}): "
                         f"got {idx.min()}..{idx.max()}")


def _mesh_args(verts, faces, sources):
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    sources = np.ascontiguousarray(sources, dtype=np.int64)
    _check_index(faces, verts.shape[0])
    _check_index(sources, verts.shape[0], "sources")
    return verts, faces, sources


def csr_spmm_native(A, B: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """out = A @ B for a scipy CSR (V, V) A and a dense (V, C) float64 B,
    threaded over row blocks (n_threads 0: the hardware's count)."""
    lib = get_lib()
    if A.shape[0] != A.shape[1] or A.shape[1] != B.shape[0]:
        raise ValueError(f"shape mismatch: A {A.shape} @ B {B.shape}")
    if A.format != "csr":  # a CSC read as CSR would compute A.T @ B
        A = A.tocsr()
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    B = np.ascontiguousarray(B, dtype=np.float64)
    out = np.empty((A.shape[0], B.shape[1]), dtype=np.float64)
    lib.dnet_csr_spmm_f64(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        _ptr(data, ctypes.c_double), _ptr(B, ctypes.c_double),
        A.shape[0], B.shape[1], _ptr(out, ctypes.c_double), n_threads)
    return out


def knn_native(points_target: np.ndarray, points_source: np.ndarray, k: int):
    """KD-tree kNN: (dists (N, k) float64, inds (N, k) int64), sorted by
    increasing distance."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lib = get_lib()
    tgt = np.ascontiguousarray(points_target, dtype=np.float64)
    src = np.ascontiguousarray(points_source, dtype=np.float64)
    n_t, n_s = tgt.shape[0], src.shape[0]
    k = min(k, n_t)
    dists = np.empty((n_s, k), dtype=np.float64)
    inds = np.empty((n_s, k), dtype=np.int64)
    lib.dnet_knn(_ptr(tgt, ctypes.c_double), n_t, _ptr(src, ctypes.c_double),
                 n_s, k, _ptr(dists, ctypes.c_double),
                 _ptr(inds, ctypes.c_int64))
    return dists, inds


def cloud_triangles_native(verts: np.ndarray, k: int = 30) -> np.ndarray:
    """The point-cloud triangle soup: the union of each point's
    tangent-plane Delaunay triangles incident to it (threaded). Returns
    (T, 3) int64 triangles, each sorted, the rows sorted and unique."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lib = get_lib()
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    V = verts.shape[0]
    max_tris = max(64, 24 * V)
    for _ in range(3):
        out = np.empty((max_tris, 3), dtype=np.int64)
        n = lib.dnet_cloud_triangles(_ptr(verts, ctypes.c_double), V, int(k),
                                     _ptr(out, ctypes.c_int64), max_tris)
        if n >= 0:
            return out[:n].copy()
        max_tris *= 4
    raise RuntimeError("cloud triangulation overflow")


def dijkstra_geodesics_native(verts, faces, sources) -> np.ndarray:
    """Graph (edge-path) geodesic distances: (S, V) float32."""
    lib = get_lib()
    verts, faces, sources = _mesh_args(verts, faces, sources)
    out = np.empty((sources.shape[0], verts.shape[0]), dtype=np.float32)
    lib.dnet_dijkstra_geodesics(
        _ptr(verts, ctypes.c_double), verts.shape[0],
        _ptr(faces, ctypes.c_int64), faces.shape[0],
        _ptr(sources, ctypes.c_int64), sources.shape[0],
        _ptr(out, ctypes.c_float))
    return out


def steiner_geodesics_native(verts, faces, sources,
                             k_steiner: int = 4) -> np.ndarray:
    """Geodesics on a Steiner-refined graph: (S, V) float32, an upper bound
    whose error to the polyhedral geodesic is O(1/k_steiner)."""
    lib = get_lib()
    verts, faces, sources = _mesh_args(verts, faces, sources)
    out = np.empty((sources.shape[0], verts.shape[0]), dtype=np.float32)
    lib.dnet_steiner_geodesics(
        _ptr(verts, ctypes.c_double), verts.shape[0],
        _ptr(faces, ctypes.c_int64), faces.shape[0],
        _ptr(sources, ctypes.c_int64), sources.shape[0],
        k_steiner, _ptr(out, ctypes.c_float))
    return out


def exact_geodesics_native(verts, faces, sources,
                           window_budget: int | None = None,
                           patch_failures: bool = False,
                           info: dict | None = None) -> np.ndarray:
    """Exact polyhedral geodesics (ICH continuous Dijkstra): (S, V) float32.

    With patch_failures=True the sources whose window budget overflowed are
    recomputed (those rows only) on the Steiner graph at k_steiner=8, the
    JAX package's documented patch; `info["patched_sources"]` then lists
    them. Raises RuntimeError on a non-manifold or non-oriented mesh, and on
    a budget overflow without patch_failures."""
    lib = get_lib()
    verts, faces, sources = _mesh_args(verts, faces, sources)
    if window_budget is None:
        window_budget = max(200 * faces.shape[0], 2_000_000)
    out = np.empty((sources.shape[0], verts.shape[0]), dtype=np.float32)
    ok = np.empty(sources.shape[0], dtype=np.int32)
    rc = lib.dnet_ich_geodesics(
        _ptr(verts, ctypes.c_double), verts.shape[0],
        _ptr(faces, ctypes.c_int64), faces.shape[0],
        _ptr(sources, ctypes.c_int64), sources.shape[0],
        window_budget, _ptr(out, ctypes.c_float), _ptr(ok, ctypes.c_int32))
    bad = np.flatnonzero(ok == 0) if rc == 0 else np.zeros(0, np.int64)
    if info is not None:
        info["patched_sources"] = sources[bad]
    if rc == 1:
        return out
    if rc < 0:
        raise RuntimeError("exact geodesics failed (non-manifold or "
                           "non-oriented mesh)")
    if not patch_failures:
        raise RuntimeError("exact geodesics failed (window budget exceeded "
                           f"for {bad.size}/{len(ok)} sources)")
    out[bad] = steiner_geodesics_native(verts, faces, sources[bad],
                                        k_steiner=8)
    return out
