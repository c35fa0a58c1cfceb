"""PyTorch engine entry point.

Device: the CUDA card (the EM then runs in the hand-written kernels),
unless the caller asks for the CPU with NGSLD_PLATFORM=cpu (the kernels'
plain PyTorch versions). Without a CUDA device and without that request
the run is refused with a StrictError: the engine never picks the CPU by
itself. Precision mirrors ngsld_tpu/engine.py::_resolve_precision with
CUDA in the TPU's place: auto is f32 on CUDA and f64 on the CPU.

The sweep runs as gathered pair blocks or as dense strip tiles
(engine_block picks; NGSLD_BLOCK_STRIP=1/0 forces), or with --ring as the
site-sharded ring sweep (engine_ring; a band that fits inside one ring
step's partner sub-block runs the block engine instead, with a log line
saying so).

--shard N / --shard_ind M (ngsld_tpu/engine.py:80-98) run on N x M
devices, one process (rank) each, over torch.distributed
(parallel/mesh.py). The block engine splits each block's pairs or each
chunk's tiles over the N 'pairs' rows; rank 0 alone loads the input,
writes the rows and the checkpoint. The ring (--ring) splits the table
into N site blocks, one a row, whose partner sub-blocks ride the ring
between the rows; each rank loads its own block. In both the cohort
splits over the M ranks of a row. The devices are the node's cards, the
launched world under a launcher (torchrun), and on the CPU
(NGSLD_PLATFORM=cpu) any count of processes. --shard 0 takes the devices
--shard_ind leaves (on the CPU, one row). Without a launcher this process
becomes rank 0 and starts the other ranks itself. The output is the
one-device run's TSV, rows in the same order; a ring whose ranks span
several nodes (torchrun --nnodes, LOCAL_WORLD_SIZE < WORLD_SIZE) writes
one OUT.partNNNNN a site block instead, which tools.merge joins.

--profile DIR records the run with torch.profiler (CPU activity, plus
CUDA activity on the card, and every thread's RunLog spans where torch
can profile all threads; no shapes, no stacks) from the resolved device
to the end of the run, also one that raises, and writes it into DIR as
one Chrome trace a rank under tensorboard_trace_handler's naming
(<host>_<pid>.<time_ns>.pt.trace.json), which TensorBoard and Perfetto
open. The JAX package writes an XPlane trace there instead; the flag
keeps its meaning, a profiler trace of the run in DIR, not its format.
"""

from __future__ import annotations

import os
import sys

import torch

from .config import Params
from .engine_block import _run_torch_body
from .engine_ring import RingNarrowBand, _run_torch_ring
from .kernels import launch_counts
from .parallel import mesh
from .strict import StrictError
from .utils.logging import RunLog, echo_config


def _resolve_device(env=None) -> torch.device:
    if os.environ.get("NGSLD_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise StrictError(
            "device", "no CUDA device is available; the torch engine runs "
            "on the card unless NGSLD_PLATFORM=cpu asks for the CPU")
    if env is not None:
        return mesh.rank_device(False, env["local_rank"])
    return torch.device("cuda", torch.cuda.current_device())


def _resolve_precision(precision: str, device: torch.device) -> str:
    if precision != "auto":
        return precision
    return "f32" if device.type == "cuda" else "f64"


def _resolve_shards(pars: Params, device: torch.device, env=None) -> int:
    """Resolve --shard 0 once (the decomposition and so the checkpoint
    fingerprint must not depend on the machine a run resumes on) and
    return the world size, --shard x --shard_ind. The devices: the
    launched world, the node's cards, or on the CPU any count."""
    if env is not None:
        n_avail = env["world"]
    elif device.type == "cuda":
        n_avail = torch.cuda.device_count()
    else:
        n_avail = None
    m = pars.shard_ind
    if not pars.shard:
        # the devices LEFT OVER after the individual axis takes its share
        pars.shard = 1 if n_avail is None else n_avail // m
        if not pars.shard:
            raise StrictError("shard", f"--shard_ind {m} > {n_avail} devices")
    if n_avail is not None and pars.shard * m > n_avail:
        raise StrictError("shard", f"--shard {pars.shard} x --shard_ind "
                          f"{m} > {n_avail} devices")
    if env is not None and pars.shard * m != env["world"]:
        raise StrictError("shard", f"--shard {pars.shard} x --shard_ind {m} "
                          f"!= the launched world of {env['world']} ranks")
    return pars.shard * m


def _start_profile(trace_dir: str, device: torch.device):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    # every thread's spans (RunLog's record_function ranges: the loaders',
    # the ingest's, the emit's), where this torch can; else the main
    # thread's alone
    extra = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        extra["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(trace_dir),
                   **extra)
    prof.start()
    return prof


def _run_rank(pars: Params, out_fh, prec: str, device: torch.device,
              m=None) -> None:
    """One rank's run (the whole run on one device): log, --profile, the
    output (rank 0 only), the sweep and the timings (RunLog.summary, with
    the run's kernel launches by name)."""
    rank = 0 if m is None else m.rank
    log = RunLog(pars.verbose, rank=rank)
    launches = launch_counts()
    if pars.verbose >= 1 and rank == 0:
        echo_config(pars, f"(torch, {device}, {prec})")
    if m is not None:
        log.log(1, f"==> {m.world} ranks ({m.shard} "
                   f"{'sites' if pars.ring else 'pairs'} x {m.shard_ind} "
                   f"'ind'), device collectives over {m.backend}"
                   + (f"; {m.world} ranks share "
                      f"{torch.cuda.device_count()} card(s)"
                      if m.shared else ""))
    if pars.ring and pars.shard == 1 and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        log.log(1, "==> WARNING: --ring with --shard 1 runs a degenerate "
                   f"1-device ring ({torch.cuda.device_count()} devices "
                   "available); pass --shard 0 for all devices")

    # one trace a rank for the whole run, the auto-routed ring's block run
    # too; stop() writes it, also when the run raises
    prof = _start_profile(pars.profile, device) if pars.profile else None
    close = False
    try:
        # the output: rank 0's; on a ring across nodes each site block's
        # first rank writes its own part (no directory is known to be
        # shared), part 00000 with the header
        parts = pars.ring and m is not None and m.nodes
        if out_fh is None and (rank == 0 or parts and m.ii == 0):
            if pars.out is not None:
                path = pars.out
                if parts:
                    path = f"{pars.out}.part{m.pi:05d}"
                    log.log(1, f"==> ring across nodes: each site block's "
                               f"first rank writes {pars.out}.partNNNNN "
                               f"(merge: python -m ngsld_tpu_torch.tools."
                               f"merge {pars.out})")
                out_fh = open(path, "wb")
                close = True
            else:
                out_fh = getattr(sys.stdout, "buffer", sys.stdout)
        if pars.ring:
            try:
                _run_torch_ring(pars, out_fh, log, prec, device, m)
            except RingNarrowBand as e:
                # raised before any IO/output: the band fits inside one
                # ring step's sub-block, so the rectangle sweep would be
                # mostly dead cells; the block engine has the same output
                # contract
                log.log(1, f"==> --ring auto-route: {e}; using the block "
                           "engine (NGSLD_RING_AUTOROUTE=0 or --ring_sub N "
                           "to force the ring)")
                _run_torch_body(pars, out_fh, log, prec, device, m)
        else:
            _run_torch_body(pars, out_fh, log, prec, device, m)
        for k, n in launch_counts().items():
            if n > launches[k]:
                log.count(f"launch:{k}", n - launches[k])
        log.summary()
    finally:
        if close:
            out_fh.close()
        if prof is not None:
            prof.stop()


def run_torch(pars: Params, out_fh=None) -> None:
    env = mesh.launched()
    device = _resolve_device(env)
    prec = _resolve_precision(pars.precision, device)
    world = _resolve_shards(pars, device, env)
    if device.type == "cuda":
        # Pearson r2 is element-wise (no matmul), but no f32 product of
        # this engine may ever run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if world == 1:
        _run_rank(pars, out_fh, prec, device)
    elif env is not None:
        # a launcher started every rank: join its group
        m = mesh.connect(env["rank"], world, pars.shard, pars.shard_ind,
                         device, env["local_world"])
        try:
            _run_rank(pars, out_fh if m.rank == 0 else None, prec, device, m)
        finally:
            mesh.teardown()
    else:
        if device.type == "cuda":
            device = mesh.rank_device(False, 0)
        with mesh.start_ranks(pars, prec, device) as m:
            _run_rank(pars, out_fh, prec, device, m)
