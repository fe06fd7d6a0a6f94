"""Build and load the port's CUDA kernels.

The counterpart of diffusionnet_tpu/native/build.py. `nvcc` compiles
csrc/*.cu for sm_90a into one shared library with a plain C interface, which
is loaded with ctypes. The build runs at first use, from the sources in this
package only, into build/torch_kernels/ at the repository root; the library's
name carries a hash of the sources and flags, so an edited source is rebuilt.
A missing nvcc or a failed build raises with the compiler's output.
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
SOURCES = (_PKG / "csrc" / "megablock_fwd.cu",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for src in SOURCES:
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
    # compile to a per-process name and rename (atomic): a racing process
    # never loads a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {nvcc}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("CUDA kernel build failed:\n" + " ".join(cmd)
                           + "\n" + res.stdout + res.stderr)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its C interface."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mb_fwd_launch.argtypes = (
            [p] * 7 + [i, ctypes.POINTER(p), ctypes.POINTER(i),
                       ctypes.POINTER(p), ctypes.POINTER(i), i, p, p, p]
            + [i] * 8 + [p])
        lib.mb_fwd_launch.restype = i
        lib.mb_xhat_reduce_launch.argtypes = [p, p, i, i, i, i, p]
        lib.mb_xhat_reduce_launch.restype = i
        lib.mb_error_string.argtypes = [i]
        lib.mb_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
