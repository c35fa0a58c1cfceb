"""Build the CUDA kernels of csrc/ into shared libraries, at first use.

nvcc compiles each of the repository's .cu sources (with the .cuh headers
beside them, and nothing else) into its own shared library with a plain C
interface, loaded with ctypes.
All missing libraries build at once, one nvcc process per source, started
together. The outputs go to ngsld_tpu_torch/.build/, keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads at once. Without nvcc, or on a failed compile, build_libraries
raises RuntimeError (carrying nvcc's stderr): there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils.logging import PROCESS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")
# IEEE division and NaN/inf semantics are part of the output contract:
# no --use_fast_math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict = {}

_vp, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# source name -> {entry point: argtypes}; every entry point returns the
# cudaError of its launch as an int (the *_smem entry points: bytes)
ENTRY_POINTS = {
    "pair_em": {
        **{name: [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp, _vp,
                  _vp, _vp]
           for name in ("ngsld_pair_em_f32", "ngsld_pair_em_f64")},
        # the option path: iter_cap, f0, eps between ignore_miss and next
        **{name: [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _i32, _vp, _vp,
                  _vp, _vp, _vp, _vp, _vp]
           for name in ("ngsld_pair_em_opts_f32", "ngsld_pair_em_opts_f64")}},
    "pair_em_rows": {
        **{name: [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp, _vp, _vp, _vp]
           for name in ("ngsld_pair_em_rows_f32", "ngsld_pair_em_rows_f64")},
        # the capped instance: iter_cap after ignore_miss
        **{name: [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp, _vp,
                  _vp]
           for name in ("ngsld_pair_em_rows_cap_f32",
                        "ngsld_pair_em_rows_cap_f64")},
        "ngsld_smem_limits": [_vp]},
    "pair_em_ichunk": {
        **{name: [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp, _vp, _vp, _vp]
           for name in ("ngsld_pair_em_ichunk_f32",
                        "ngsld_pair_em_ichunk_f64")},
        **{name: [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp, _vp,
                  _vp]
           for name in ("ngsld_pair_em_ichunk_cap_f32",
                        "ngsld_pair_em_ichunk_cap_f64",
                        "ngsld_pair_em_cluster_f32",
                        "ngsld_pair_em_cluster_f64")},
        **{name: [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _i32, _vp, _vp,
                  _vp, _vp]
           for name in ("ngsld_pair_em_cluster_cap_f32",
                        "ngsld_pair_em_cluster_cap_f64")},
        "ngsld_pair_em_cluster_occupancy": [_i32] * 5 + [_vp]},
    "strip_em": {
        "ngsld_strip_em": [_vp] * 12 + [_i32, _i64, _i64] + [_i32] * 7
        + [_vp] * 7,
        "ngsld_strip_em_smem": [_i32, _i32]},
    "strip_em_stream": {
        "ngsld_strip_em_stream": [_vp] * 12 + [_i32, _i64, _i64] + [_i32] * 8
        + [_vp] * 5,
        "ngsld_strip_em_stream_smem": [_i32]},
    "gl_narrow": {
        "ngsld_gl_narrow_f32": [_vp, _vp, _i64, _i32, _vp, _vp],
        "ngsld_gl_check_f64": [_vp, _i64, _i32, _vp, _vp]},
}


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


def sources() -> dict:
    """{name: path} of every kernel source in csrc/."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))}


def library_path(name: str) -> str:
    """Where the library for the source's current text (with the headers
    of csrc/, which any source may include) and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [sources()[name],
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"ngsld_{name}_{h.hexdigest()[:16]}.so")


def build_libraries() -> dict:
    """Compile every library that is missing, all at once, and return
    {name: library path}."""
    paths = {name: library_path(name) for name in sources()}
    missing = [n for n, so in paths.items() if not os.path.exists(so)]
    PROCESS.count("kernel_libs_built", len(missing))
    if not missing:
        return paths
    with PROCESS.span("init: kernel build"):
        _compile(paths, missing)
    return paths


def _compile(paths: dict, missing: list) -> None:
    """One nvcc process a missing library, started together."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "ngsld_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on "
            "PATH); the CUDA kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in missing:
        tmp = f"{paths[name]}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, sources()[name]]
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, tmp, cmd, proc in procs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{stderr}")
        else:
            os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("ngsld_tpu_torch: " + "\n".join(errors))


def get_library(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu: build if needed, load once, declare
    its entry points."""
    with _LOCK:
        if name not in _LIBS:
            path = build_libraries()[name]
            with PROCESS.span(f"init: kernel lib {name}"):
                lib = ctypes.CDLL(path)
            for fn_name, argtypes in ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = _i32
                fn.argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS[name]


# (per block, per block after opting in) of an H100, bytes: what the kernel
# routing assumes for CPU tensors, so that a CPU run takes the rungs a card
# run would; a CUDA device is asked
NOMINAL_SMEM = (49152, 232448)


def smem_limits(device) -> tuple[int, int]:
    """Shared memory a block may use on `device`, bytes: (without opting
    in, with cudaFuncAttributeMaxDynamicSharedMemorySize). A CUDA device is
    asked through csrc/pair_em_rows.cu; for the CPU the H100's figures
    stand in."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return NOMINAL_SMEM
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = get_library("pair_em_rows").ngsld_smem_limits(
            ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"ngsld_smem_limits failed: cudaError {err}")
    return int(out[0]), int(out[1])
