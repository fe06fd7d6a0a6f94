"""Build and load the port's CUDA kernels.

The counterpart of diffusionnet_tpu/native/build.py. `nvcc` compiles each
csrc/*.cu for sm_90a, all sources at once (one nvcc process each), then links
them into one shared library with a plain C interface, which is loaded with
ctypes. The build runs at first use, from the sources in this package only,
into build/torch_kernels/ at the repository root; the library's name carries
a hash of the sources, the shared header and the flags, so an edited source
is rebuilt. A missing nvcc or a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "megablock_fwd.cu",
           _PKG / "csrc" / "megablock_bwd.cu",
           _PKG / "csrc" / "blocked_ell.cu",
           _PKG / "csrc" / "spectral_fused.cu")
HEADERS = (_PKG / "csrc" / "megablock_common.cuh",
           _PKG / "csrc" / "splitv.cuh", _PKG / "csrc" / "wgmma.cuh")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use")
    return nvcc


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(nvcc: str | None = None) -> Path:
    """Compile the kernels unless a library for the current sources exists.
    Returns its path; the compiler's output (ptxas register and shared-memory
    report) is kept beside it as a .log file."""
    so = BUILD_DIR / f"libdnt_kernels_{_digest()}.so"
    if so.exists():
        return so
    nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to per-process names and rename (atomic): a racing process
    # never loads a half-written library
    tag = f"{_digest()}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in SOURCES]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(SOURCES, objs)]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    logs = []
    try:
        try:
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
        except OSError as e:
            raise RuntimeError(f"cannot run {nvcc}: {e}") from e
        for c, proc in zip(cmds, procs):
            out = proc.communicate()[0]
            logs.append(" ".join(c) + "\n" + out)
            if proc.returncode != 0:
                for q in procs:
                    q.wait()
                raise RuntimeError("CUDA kernel build failed:\n" + logs[-1])
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("CUDA kernel link failed:\n" + " ".join(link)
                               + "\n" + res.stdout + res.stderr)
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its C interface."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        pp, pi, ll = ctypes.POINTER(p), ctypes.POINTER(i), ctypes.c_longlong
        lib.mb_fwd_launch.argtypes = (
            [p] * 7 + [pp, pp, pi, i, p, pp, pp, ll, p] + [i] * 12 + [p])
        lib.mb_fwd_launch.restype = i
        lib.mb_fwd_xhat_launch.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.mb_fwd_xhat_launch.restype = i
        lib.mb_xhat_reduce_launch.argtypes = [p, p, i, i, i, i, p]
        lib.mb_xhat_reduce_launch.restype = i
        lib.mb_smem_optin.argtypes = []
        lib.mb_smem_optin.restype = i
        lib.mb_bwd_rows_launch.argtypes = (
            [p] * 9 + [pp, pp, pp, pi, i, p, p, p, i, pi, pi, i, i, i, p, p,
                       i, pi] + [i] * 10 + [p])
        lib.mb_bwd_rows_launch.restype = i
        lib.mb_bwd_grads_launch.argtypes = [
            p, i, p, p, p, i, ctypes.POINTER(ll), i, p, ll, i, ll, p, i, ll,
            i, i, i, i, i, i, p]
        lib.mb_bwd_grads_launch.restype = i
        lib.mb_grad_reduce_launch.argtypes = [p, p, i, i, ll, ll, i, p]
        lib.mb_grad_reduce_launch.restype = i
        lib.mb_error_string.argtypes = [i]
        lib.mb_error_string.restype = ctypes.c_char_p
        lib.bell_matvec_launch.argtypes = [p] * 5 + [i] * 3 + [p]
        lib.bell_matvec_launch.restype = i
        lib.bell_error_string.argtypes = [i]
        lib.bell_error_string.restype = ctypes.c_char_p
        lib.sf_project_launch.argtypes = [p] * 6 + [i, p, p] + [i] * 9 + [p]
        lib.sf_project_launch.restype = i
        lib.sf_apply_launch.argtypes = [p] * 8 + [i] * 7 + [p]
        lib.sf_apply_launch.restype = i
        _lib = lib
        return lib
