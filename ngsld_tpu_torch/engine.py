"""PyTorch engine entry point: the default single-device run.

Device: the CUDA card (the EM then runs in the hand-written kernels),
unless the caller asks for the CPU with NGSLD_PLATFORM=cpu (the kernels'
plain PyTorch versions). Without a CUDA device and without that request
the run is refused with a StrictError: the engine never picks the CPU by
itself. Precision mirrors ngsld_tpu/engine.py::_resolve_precision with
CUDA in the TPU's place: auto is f32 on CUDA and f64 on the CPU.

The sweep runs on one device, as gathered pair blocks or as dense strip
tiles (engine_block picks; NGSLD_BLOCK_STRIP=1/0 forces), or with --ring
as the site-sharded ring sweep on one device (engine_ring; a band that
fits inside one ring step's partner sub-block runs the block engine
instead, with a log line saying so). Options that need a part not ported
yet raise StrictError naming it: --shard/--shard_ind resolving to more
than one device (the multi-device ring among them) and --profile (a JAX
profiler trace).
"""

from __future__ import annotations

import os
import sys

import torch

from .config import Params
from .engine_block import _run_torch_body
from .engine_ring import RingNarrowBand, _run_torch_ring
from .strict import StrictError
from .utils.logging import RunLog, echo_config


def _resolve_device() -> torch.device:
    if os.environ.get("NGSLD_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise StrictError(
            "device", "no CUDA device is available; the torch engine runs "
            "on the card unless NGSLD_PLATFORM=cpu asks for the CPU")
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
        what = ("the multi-device ring is" if pars.ring
                else "multi-device sweeps are")
        raise StrictError(
            "ring" if pars.ring else "shard",
            f"--shard {pars.shard} x --shard_ind {pars.shard_ind} "
            f"resolves to {max(shard, 1) * pars.shard_ind} devices; the torch "
            f"engine runs on one device ({what} not ported)")
    pars.shard = 1
    if pars.profile:
        raise StrictError("profile", "--profile writes a JAX profiler trace; "
                          "not available in the torch engine")


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
        if pars.ring:
            try:
                _run_torch_ring(pars, out_fh, log, prec, device)
            except RingNarrowBand as e:
                # raised before any IO/output: the band fits inside one
                # ring step's sub-block, so the rectangle sweep would be
                # mostly dead cells; the block engine has the same output
                # contract
                log.log(1, f"==> --ring auto-route: {e}; using the block "
                           "engine (NGSLD_RING_AUTOROUTE=0 or --ring_sub N "
                           "to force the ring)")
                _run_torch_body(pars, out_fh, log, prec, device)
        else:
            _run_torch_body(pars, out_fh, log, prec, device)
    finally:
        if close:
            out_fh.close()
