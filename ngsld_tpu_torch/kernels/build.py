"""Build the CUDA kernels of csrc/ into a shared library, at first use.

nvcc compiles the repository's .cu sources (and nothing else) into one
shared library with a plain C interface, loaded with ctypes. The output
goes to ngsld_tpu_torch/.build/, keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Without nvcc, or on a failed compile, build_library raises RuntimeError
(carrying nvcc's stderr): there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")
# IEEE division and NaN/inf semantics are part of the output contract:
# no --use_fast_math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"ngsld_kernels_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile (if needed) and return the library path."""
    so = library_path()
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "ngsld_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on "
            "PATH); the CUDA kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"ngsld_tpu_torch: nvcc failed ({res.returncode}): "
            f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def get_library() -> ctypes.CDLL:
    """Build if needed, load once, declare the entry points."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for name in ("ngsld_pair_em_f32", "ngsld_pair_em_f64"):
                fn = getattr(lib, name)
                fn.restype = i32
                fn.argtypes = [vp, vp, vp, i64, i32, i32, vp, vp, vp, vp]
            _LIB = lib
        return _LIB
