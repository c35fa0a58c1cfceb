"""PyTorch engine driver: the default single-device run.

Device: CUDA when available (the pair EM then runs in the hand-written
kernel), else the CPU with the kernels' plain PyTorch twins;
NGSLD_PLATFORM=cpu pins the CPU. Precision mirrors
ngsld_tpu.engine._resolve_precision with CUDA in the TPU's place: auto is
f32 on CUDA and f64 on the CPU.

This slice runs the gathered-pair sweep on one device. Options that need
a part not ported yet raise StrictError naming it: --shard/--shard_ind
resolving to more than one device, --ring, --profile (a JAX profiler
trace) and NGSLD_BLOCK_STRIP=1 (the strip sweep).
"""

from __future__ import annotations

import os
import sys

import torch

from ngsld_tpu.config import Params
from ngsld_tpu.strict import StrictError
from ngsld_tpu.utils.logging import RunLog, echo_config

from .engine_block import _run_torch_body


def _resolve_device() -> torch.device:
    if os.environ.get("NGSLD_PLATFORM") == "cpu" or \
            not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _resolve_precision(precision: str, device: torch.device) -> str:
    if precision != "auto":
        return precision
    return "f32" if device.type == "cuda" else "f64"


def _refuse_unported(pars: Params, device: torch.device) -> None:
    n_avail = torch.cuda.device_count() if device.type == "cuda" else 1
    # --shard 0 means "all devices" (ngsld_tpu.engine.run_jax)
    shard = pars.shard or n_avail // pars.shard_ind
    if shard != 1 or pars.shard_ind != 1:
        raise StrictError(
            "shard", f"--shard {pars.shard} x --shard_ind {pars.shard_ind} "
            f"resolves to {max(shard, 1) * pars.shard_ind} devices; the torch "
            "engine runs on one device (multi-device sweeps are not ported)")
    pars.shard = 1
    if pars.ring:
        raise StrictError("ring", "--ring: the ring sweep is not ported to "
                          "the torch engine")
    if pars.profile:
        raise StrictError("profile", "--profile writes a JAX profiler trace; "
                          "not available in the torch engine")
    if os.environ.get("NGSLD_BLOCK_STRIP") == "1":
        raise StrictError("strip", "NGSLD_BLOCK_STRIP=1: the strip sweep is "
                          "not ported to the torch engine")


def run_torch(pars: Params, out_fh=None) -> None:
    device = _resolve_device()
    prec = _resolve_precision(pars.precision, device)
    _refuse_unported(pars, device)
    if device.type == "cuda":
        # Pearson r2 is element-wise (no matmul), but no f32 product of
        # this engine may ever run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log = RunLog(pars.verbose)
    if pars.verbose >= 1:
        echo_config(pars, f"(torch, {device}, {prec})")

    close = False
    if out_fh is None:
        if pars.out is not None:
            out_fh = open(pars.out, "wb")
            close = True
        else:
            out_fh = getattr(sys.stdout, "buffer", sys.stdout)
    try:
        _run_torch_body(pars, out_fh, log, prec, device)
    finally:
        if close:
            out_fh.close()
