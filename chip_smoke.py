#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ngsld_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --strip-only   # a short look at the two strip
                                         # kernels: phases 1, 2, 3c and the
                                         # strip cells of 3 and 3b; prints
                                         # neither the kernels line nor ok
    python3 chip_smoke.py --gather-only  # the same for the gather kernels:
                                         # phases 1, 2, 3d and the gather
                                         # cells of 3 and 3b
    python3 chip_smoke.py --ring-only    # the ring alone: phases 1, 2, 7,
                                         # 10
    python3 chip_smoke.py --shard-only   # several ranks: phases 1, 2, 5,
                                         # 5b, 6, 9
    python3 chip_smoke.py --kernels-only # the kernels and their options:
                                         # phases 1, 2, 3, 11
    python3 chip_smoke.py --overlap-only # the overlap ingest: phases 1,
                                         # 2, 12
    python3 chip_smoke.py --dryrun-only  # the graft entry points: phases
                                         # 1, 2, 13

Phases, each printing its result and seconds on its own line:
  1. environment: card name and power limit (nvidia-smi), torch/CUDA/nvcc
     versions, whether the native host library loaded
  2. build: the six CUDA kernels from csrc/, one nvcc per source, timed
  3. kernel vs plain on the card, each kernel against its plain PyTorch
     version: pair_em_gather at the gather path's 524,288-pair block x 100
     individuals (f32 and f64, --ignore_miss_data off and on, x = 0 pairs
     included), at I = 37 and I = 1,200; strip_em at the strip path's
     256-tile chunk x 100 individuals (all-pairs tiles of a 4,096-site
     table, diagonal tiles with dead halves and full tiles,
     --ignore_miss_data off and on; the same launch at three repack
     intervals) and 16 tiles at I = 37 and I = 200; f to f's rounding,
     nIter and n_used exact; kernel and plain times, each kernel's bound
     on this card, and the strip kernel's lane efficiency read from its
     own nIter
  3b. the large-cohort kernels against their plain versions: pair_em_rows,
     pair_em_ichunk (its cluster body, and its streamed body forced) and
     the streamed strip_em at I = 37 and 1,200 (chunks with a partial last
     one, dead cells, x = 0 pairs, --ignore_miss_data off and on), then at
     the large-cohort cells, a 512-individual simulated panel tiled to the
     cohort size: pair_em_rows at 2,048 pairs x 4,000, pair_em_ichunk at
     2,048 pairs x 20,000 (the cluster body), the streamed strip_em on the
     36 all-pairs tiles of 1,024 sites x 20,000 (against the plain version
     on 2 tiles there, on 8 at I = 1,200 and on all 36 at I = 200, where it
     is also held against the resident kernel on all 36), each at three
     chunk sizes. Beside each gather kernel's time, the other kernels'
     times at the same cell (at 20,000: the streamed body, the kernel the
     cluster body replaced)
  3c. the strip kernels' design: the instructions of each kernel's EM
     inner loop by class and its registers (cuobjdump of the built
     libraries); inputs that aim at the repack through both kernels
     (warps with one live cell, a single live cell, iteration caps 0, 1, 3
     and around the repack interval, x = 0 cells, --ignore_miss_data);
     both kernels on the same 64 tiles at cohort sizes up to and past the
     resident kernel's shared-memory limit, where the wrapper must refuse
     it
  3d. the gather kernels' design: the SASS (instructions of the EM inner
     loop by class, registers) of the lane-group kernel, the rows kernel,
     the cluster body and the streamed body; pair_em_gather at the gather
     cell for G = 4, 8, 16, 32 lanes a pair, with the lane-use model of
     each layout read from the kernel's own n_iter; pair_em_rows for every
     block width (64-512 threads) at 2,048 x 4,000 and at 524,288 pairs of
     800-4,000 individuals (f32) and 300 and 2,048 (f64), with its blocks
     an SM; the slowest pair of the 2,048 x 4,000 cell launched alone (one
     pair's iteration latency), the cell's nIter histogram and that pair's
     share of the cell's time; the cluster body at 2,048 x 20,000 for
     several cluster sizes and block widths, and at I = 256 for the cost of
     a cluster iteration; two launches held bit-equal; edge cases through
     the three kernels against their plain versions (one pair, part-filled
     blocks, I = 1, 37, 100, both sides of every change of the group size
     and of the rows kernel's width, the gather rung's design limit and its
     refusal one past it, the rows kernel at I = 1, 37 and 100, the rows
     rung's first cohorts on the default block (f32 and f64) and its
     ceilings, with the refusal one past each, cluster sizes 1, 2, 8
     and one past the cluster's capacity through the streamed body, x = 0
     pairs, --ignore_miss_data, f64 tables); the ladder's crossovers,
     gather against rows at 16,384 and 524,288 pairs and rows against the
     cluster body (at its rule's C and at C = 1 and 2) at 16,384, f32 and
     f64; the
     lane groups against rows at 8,192-524,288 random pairs and on the
     band planner's blocks of 16,384-65,536 pairs, on both sides of their
     switch
  4. the slice vs the strict oracle: the port's CLI on the card against
     --engine strict, 24 x 2,000 fixture, four flag variants, each
     through the gather sweep (one block below the lane groups' least
     pair count: one launch, of the kernel the ladder picks) and through
     the strip sweep; the same four on a 128-SNP band, whose block the
     ladder gives to the lane groups (launches equal to the planned
     blocks, a row sample against strict recomputes); the gz-text
     run through the streamed text loader byte-equal to the run through
     strict.read_geno; plus a 12 x 384 all-pairs fixture with flat and
     compact strip emission, byte-equal
  5. real size: 25,000 sites x 100 individuals, --max_kb_dist 100
     --extend_out, through the port's CLI; the auto rule must take the
     strip sweep: row count against the host plan, strip launches against
     the chunk count, a row sample against strict recomputes; wall, stage
     split and pairs/s. Then the same fixture cut to 10,000 sites through
     the gather sweep (launches against the block count, sample against
     strict) and through the strip sweep, the two outputs held together
  5b. the large cohort through the CLI: a binary GL file (doubles,
     --log_scale) of 2,048 sites x 20,000 individuals, through the
     streamed loader; once dense (--max_snp_dist 128: the strip sweep with
     the streamed kernel) and once sampled (--rnd_sample 0.1: the gather
     sweep on the ichunk rung), then 2,048 x 4,000 sampled (the rows
     rung), then 8,192 sites x 1,000 individuals, a 2,048-SNP band sampled
     at 0.05 (733,628 pairs: the rows rung on one full --chunk_pairs block
     of 524,288 and part of a second); each run's kernel shown by its
     launch count (equal to the planned blocks on the gather sweep), a row
     sample against strict recomputes, the stage split with the upload's
     share; then pair_em_rows alone on the last run's first planned block,
     timed, against its bound and, on every 32nd pair, against its plain
     version
  6. device idle share: the phase 5 strip run under torch.profiler; busy
     time is the union of the trace's device intervals
  7. the ring sweep (--ring) on the card, one device: first both strip
     kernels against their plain versions on ring steps (the partner
     tables one sub-block's, the band bounds shifted to it: lo negative,
     hi below 0 and past the sub-block); R1, phase 5's 25k x 100 fixture,
     all pairs sampled at 1%, through the ring under torch.profiler
     (strip_em.cu once a ring step) and through the block engine (the
     gather sweep): the pair set byte-equal, values under the f32
     contract, a row sample against strict recomputes; wall, stage split,
     per-step peak device memory, idle share; R2, phase 5b's dense 2,048 x
     20,000 run through the ring (strip_em_stream.cu once a step, the
     pair set equal to phase 5b's) and the ring loader's host peak; R3,
     the same file sampled in f64 (the gather stepper on the ichunk rung)
     and phase 4's four variants through the ring in f32 (strip stepper)
     and f64 (gather stepper), each launch of the rung the ladder picks
     for its piece, against strict; R4, resume by sub-ring from a
     checkpoint whose later sub-ring was deleted (byte-equal), and the
     narrow-band auto-route (byte-equal to the block run)
  8. the host-side remainder: --profile DIR on phase 5's 10,000 x 100
     gather leg (pair_em.cu), the same 10,000 sites through the strip
     sweep (strip_em.cu) and
     phase 4's fixture through --ring (strip_em.cu once a step), each run
     four times in turns (without, with, with, without the flag): rows
     byte-equal, the same launches, each trace one Chrome trace holding
     one device event of the kernel per launch; walls, trace bytes; the
     gather leg also as two new processes of the CLI, without and with
     the flag (the process's first profiler). Then the port's tools on the
     gather leg's TSV, each timed: on its first fifth of rows prune (r2,
     --max_kb_dist 10, --min_weight 0.5; no kept pair within 10 kb at or
     above 0.5), fit_decay --n_ind 100 (a finite fit) and
     ld_blocks.extract_region over 50 kb (against a scan of the rows);
     merge of the whole TSV cut into five shards (byte-equal). Last, extras/: the HMM's forward, backward,
     posterior and viterbi at 100 x 5,000 x 2 on the card in f64 against
     the CPU in f64 (tolerances printed; paths equal), and findmax_torch
     on the card
  9. the block engine on two ranks that share the card (device
     collectives over gloo), each a new process started through launcher
     variables as torchrun starts them: 9a --shard 2 on phase 5's 10,000 x
     100 gather cell (pair_em.cu once a block on each rank's half, rows
     against phase 5's file: the same pairs, byte-equal where both halves
     took the block's rung), 9b --shard 2 on the 25k x 100 strip cell
     (strip_em.cu once a chunk on each rank's tiles, rows against phase
     6's file and a sample against strict), 9c --shard_ind 2 in f32 on
     phase 5b's 2,048 x 4,000 file, sampled (the gather step for
     --shard_ind), and dense on its first 1,024 sites (its strip step),
     against --shard_ind 1 runs (the pair set equal, values under the f32
     contract; no kernel launched); 9d the two --shard_ind steps at world
     size 1 over NCCL on the card, the gather step against compute_block
     (pair_em.cu) and the strip step on 64 all-pairs tiles against
     strip_em.cu (the reference's contract); 9a again over NCCL when the
     box has two cards. Each rank's launches, rungs and all-reduces, and the
     walls (the path on one shared card, not scaling)
  10. the ring across two ranks that share the card (the device
     collectives and the ring's exchange over gloo), started as phase 9
     starts them: 10a phase 7's R1 (25k x 100, all pairs at 1%) with
     --ring --shard 2 (strip_em.cu once a step on each rank) against
     phase 7's one-device file (the pair set byte-equal, rows byte-equal
     or under the f32 contract); 10b phase 5b's 2,048 x 4,000 file
     sampled at 0.1 with --ring --shard 2 --ring_sub 2 in f64 (the gather
     stepper: pair_em_rows.cu once a piece on each rank) and 10c the same
     in f32 with --ring --shard_ind 2 (no kernel), each against the
     one-device ring on the same flags; whether gloo's point-to-point
     operations take CUDA tensors (the reason the exchange stages through
     host memory); 10d 10a over NCCL when the box has two cards. Each
     rank's steps, pieces, launches, exchanges (count, seconds, bytes),
     all-reduces, host mask, sampling plan and merge seconds, and walls
  11. the kernel options, none of them on the CLI's path: 11a on phase 3's
     gather cell (524,288 pairs x 100, f32 and f64 tables,
     --ignore_miss_data off and on), pair_em.cu capped at 16 with the eps
     export, then its survivors resumed warm from its f64 state, against
     the one-phase launch bit for bit; pair_em_phased against
     pair_em_gather bit for bit; the capped launch's f and eps against the
     plain version; the one-phase, phase 1, pull-and-sort, phase 2 and
     phased times and the pair-iterations each executed; 11b on phase 3's
     strip cell (256 tiles x 100) strip_em.cu with and without want_eps at
     caps 100 and 30 (f, r2p, nIter, n_used bit-equal), the eps semantics
     on every live cell, eps against the plain version on 8 tiles, both
     times; 11c strip_em_twophase (cap1 30) against strip_em_compact on
     the cell's live cells: rows that stopped in phase A bit-equal,
     survivors within 5e-5 and nIter within 1 on more than 95%, both
     walls and the survivors; 11d at phase 3b's large-cohort cells (2,048
     random pairs of the tiled panel) pair_em_rows.cu at 4,000 (f32 and
     f64 tables) and pair_em_ichunk.cu's cluster body and streamed body
     (forced) at 20,000, each at cap 16 and at the default cap against
     its plain version (nIter and n_used exact, capped pairs at the cap),
     two launches bit-equal, the capped time beside its bound and the
     default launch's; the capped instances' registers
  12. the overlap ingest (GL upload and preprocess slab by slab under the
     gather sweep), each leg run with it and with NGSLD_OVERLAP_UPLOAD=0,
     rows to a file (a seekable output engages it): 12a the JAX package's
     1M-site sampled leg (1,000,000 sites x 100 from a binary file, ten
     copies of one 100,000-site simulation, --max_snp_dist 64
     --rnd_sample 0.05), the counter in the first run only, the TSVs
     byte-equal, the ladder's launches alone, a row sample against
     strict, both walls and stage splits, the ingest wait and the time to
     the first dispatch; 12b a dense 4,096 x 100 binary leg through the
     strip sweep (its tables after join_all), byte-equal; 12c a NaN three
     values before EOF in slabs of 100 sites: rc != 0, "NaN found", the
     output file empty; 12d the preprocess slab by slab against the whole
     table (slabs of 1 to 1,000 sites) at 100 and 20,000 individuals,
     byte-equal, and phase 5b's sampled 2,048 x 20,000 file in slabs of
     409 sites (the last of 3) with and without the overlap, byte-equal;
     in every leg one gl_narrow launch a slab, with and without the
     overlap; 12e the binary loader's kernel (gl_narrow.cu) on one slab of
     the cohort cells' input, 1,051 x 10,640 x 3 doubles, narrowed to f32
     and checked in f64, against its plain version (bit-equal, flags),
     its time beside its bound and the plain version's
  13. the graft entry points of the port (ngsld_tpu_torch/graft_entry.py,
     the counterparts of __graft_entry__.py) on the card: 13a entry()'s
     step on its 256 x 32 example block, its EM one launch of pair_em.cu,
     against pair_em_gather_ref on the card (nIter and n_used exact, f
     within 1e-6) and against the same step on the CPU in f64 (the
     reference's contract: hap freqs 3e-5, n_used exact, nIter within 1
     on more than 95%, r2p 2e-5); 13b dryrun_multichip(2) and 13c
     dryrun_multichip(4), the ranks spawned by the call and sharing the
     card over gloo, every check of the JAX dry run on every rank (the
     ('pairs', 'ind') sweep step, the all-steps ring sweep, the gather
     stepper's step, advance and compaction, the strip stepper on
     strip_em.cu, the ('sites', 'ind') stepper, the strip chunk over the
     ranks on strip_em.cu and over ('pairs', 'ind')); the wall and each
     rank's launches

Then one JSON line of per-kernel results and, last, the `ok` line. Any
failure exits non-zero without those lines; so does a machine without a
CUDA device. JAX and the JAX package ngsld_tpu are blocked from import
for the whole run: the port imports neither.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types

sys.modules["jax"] = None         # any `import jax` below raises ImportError
sys.modules["ngsld_tpu"] = None   # and so does any import of the JAX package

import numpy as np  # noqa: E402

MAIN_P, MAIN_I = 524_288, 100     # the default --chunk_pairs block, I = 100
STRIP_S, STRIP_TILES = 4_096, 256  # the strip chunk: 256 tiles of 128 x 128
REAL_S, REAL_I = 25_000, 100     # README's 25k row: ~4.5M pairs at kb100
GATHER_S = 10_000                # the same fixture cut, for the gather path
PANEL_I = 512                    # simulated panel, tiled to a large cohort
BIG_I, ROWS_I, BIG_P = 20_000, 4_000, 2_048   # the large-cohort gather cells
BIG_STRIP_S = 1_024              # streamed strip cell: 36 all-pairs tiles
BIG_S = 2_048                    # large-cohort CLI runs: sites
DENSE_IND_S = 1_024              # 9c's dense --shard_ind leg: its first sites
# the rows rung through the CLI on full default blocks: the panel tiled to
# FULL_I individuals, FULL_S sites, a band and sampling rate that fill one
# --chunk_pairs block and part of a second
FULL_I, FULL_S, FULL_BAND, FULL_RATE = 1_000, 8_192, 2_048, 0.05
# phase 4's wide band: its one block of the 24 x 2,000 fixture (about
# 248,000 pairs, 124,000 sampled) reaches the lane groups
SLICE_BAND = 128
ROWS_FULL_STRIDE = 32            # pairs of that block held against plain
IND_STRIP_TILES = 64             # 9d: the strip step's tiles over NCCL
ENGINE_TAG = "(torch, cuda"        # the engine's device in its config echo
F32_TOL, F64_TOL = 1e-6, 1e-12   # kernel vs plain: f's output rounding
R2P_TOL = 2e-5                   # strip kernel's in-kernel Pearson r2
# H100 SXM peaks for the bounds: device memory 3.35 TB/s; double precision
# outside the tensor cores 34 TFLOP/s (NVIDIA's H100 data sheet)
PEAK_BYTES_S, PEAK_F64_FLOPS = 3.35e12, 34e12
# flops of one (pair, individual, iteration) of the EM as every kernel
# writes it: Q 12, D 12, s 7, the division 1, the four products and sums 8
FLOPS_PER_EVAL = 40


def _phase(results, name, fn):
    """Run one phase; print PASS/FAIL and its seconds; record failure."""
    t0 = time.perf_counter()
    try:
        out = fn()
        ok = True
    except Exception:
        traceback.print_exc()
        out, ok = None, False
    dt = time.perf_counter() - t0
    print(f"[phase] {name}: {'PASS' if ok else 'FAIL'} ({dt:.3f} s)",
          flush=True)
    results.append(ok)
    return out


def _run(cmd):
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (r.stdout or r.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# ---------------------------------------------------------------- phase 1

def phase_env():
    import torch
    from ngsld_tpu_torch.native import get_lib
    from ngsld_tpu_torch.kernels.build import find_nvcc
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi)
    nvcc = find_nvcc()
    nv = _run([nvcc, "--version"]).splitlines()[-1] if nvcc else "not found"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}, nvcc {nv}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    native = get_lib() is not None
    print(f"native host library loaded: {native}"
          + ("" if native else " (pure-Python host formatter: walls below "
             "measure it, not the native path)"))
    return smi


# ---------------------------------------------------------------- phase 2

def phase_build():
    from ngsld_tpu_torch.kernels.build import build_libraries, get_library
    t0 = time.perf_counter()
    paths = build_libraries()
    for name in paths:
        get_library(name)
    print(f"built {sorted(os.path.relpath(p) for p in paths.values())} in "
          f"{time.perf_counter() - t0:.3f} s")
    if sorted(paths) != ["gl_narrow", "pair_em", "pair_em_ichunk",
                         "pair_em_rows", "strip_em", "strip_em_stream"]:
        raise AssertionError(f"unexpected kernel sources: {sorted(paths)}")


# ---------------------------------------------------------------- phase 3

def _sim_tables(n_ind, n_sites, seed):
    """Normal-space GLs, E[G] and MAF (mean E[G] / 2) of a simulated
    cohort with 2% all-missing sites, float64."""
    from ngsld_tpu_torch.utils.simulate import simulate
    sim = simulate(n_ind=n_ind, n_sites=n_sites, seed=seed,
                   all_missing_site_rate=0.02)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    eg = gl[..., 1] + 2 * gl[..., 2]
    return gl, eg, eg.mean(axis=1) / 2


def _table(n_ind, n_sites, n_pairs, seed, dtype, device):
    """Site table + banded pairs, built as tests/test_pallas_em.py:9-17
    builds its inputs (simulate, normalise, MAF = mean E[G] / 2)."""
    import torch
    gl, eg, maf = _sim_tables(n_ind, n_sites, seed)
    rng = np.random.default_rng(seed)
    s1 = np.sort(rng.integers(0, n_sites - 1, n_pairs))
    s2 = np.minimum(s1 + rng.integers(1, 256, n_pairs), n_sites - 1)
    gn_d = torch.from_numpy(gl).to(device=device, dtype=dtype).contiguous()
    maf_d = torch.from_numpy(maf).to(device=device, dtype=dtype)
    sidx = torch.from_numpy(np.stack([s1, s2]).astype(np.int32)).to(device)
    return gn_d, sidx, maf_d


def _check(kern, plain, tol, label, quiet=False):
    """Kernel vs plain twin. Both run the EM in f64 (the twin upcasts), so
    they agree to the rounding of f's dtype: f within `tol` (NaN where
    both are NaN), n_used and nIter exact on every pair, and x = 0 pairs
    frozen at nIter 0 with NaN f in both. Prints one line unless quiet."""
    fk, itk, nuk = (t.cpu().numpy() for t in kern)
    fp, itp, nup = (t.cpu().numpy() for t in plain)
    if not np.array_equal(nuk, nup):
        raise AssertionError(f"{label}: n_used differs on "
                             f"{int((nuk != nup).sum())} pairs")
    if not np.array_equal(itk, itp):
        raise AssertionError(f"{label}: nIter differs on "
                             f"{int((itk != itp).sum())} of {len(itp)} pairs")
    nan_k, nan_p = np.isnan(fk), np.isnan(fp)
    if not np.array_equal(nan_k, nan_p):
        raise AssertionError(f"{label}: NaN positions differ on "
                             f"{int((nan_k != nan_p).sum())} values")
    err = float(np.max(np.abs(np.where(nan_k, 0, fk) - np.where(nan_p, 0,
                                                                    fp))))
    if not err <= tol:
        raise AssertionError(f"{label}: max |f_kernel - f_plain| {err} > {tol}")
    x0 = nup == 0
    if x0.any():
        for name, f, it in (("kernel", fk, itk), ("plain", fp, itp)):
            if not (np.isnan(f[x0]).all() and (it[x0] == 0).all()):
                raise AssertionError(f"{label}: x = 0 pairs not frozen at "
                                     f"nIter 0 with NaN f ({name})")
    if not quiet:
        bits = "equal" if np.array_equal(np.where(nan_k, 0, fk),
                                         np.where(nan_p, 0, fp)) else "differ"
        print(f"  {label}: max|df| {err:.3e} (tol {tol:g}), f bits {bits}, "
              f"nIter and n_used exact, x=0 pairs {int(x0.sum())}")
    return err, int(x0.sum())


def _time(fn, reps=3, warm=True):
    """Best of `reps` after a warm-up: CUDA events around the call, then a
    pulled scalar that depends on the outputs (proves the work ran).
    warm=False: no warm-up call (the plain versions, which take seconds)."""
    import torch
    out = fn() if warm else None
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = fn()
        e1.record()
        chk = res[0].nan_to_num().sum() + res[1].sum()
        float(chk.item())
        best = min(best, e0.elapsed_time(e1))
    return best, (out if warm else res)


def _needed_evals(n_iter, n_ind, cap=100):
    """(pair, individual, iteration) updates this data needs: a pair that
    stopped at 0-based iteration n ran n + 1 updates, an unconverged one
    `cap`. Dead strip cells must be masked out by the caller."""
    it = n_iter.cpu().numpy().astype(np.int64)
    return int(np.minimum(it + 1, cap).sum()) * n_ind


def _bound(n_bytes, flops):
    """The least time the card could take, ms, and which side sets it."""
    t_b, t_f = n_bytes / PEAK_BYTES_S, flops / PEAK_F64_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _strip_case(n_ind, n_sites, n_tiles, seed, device, i_align=8):
    """strip_em's arguments for the first n_tiles all-pairs tiles of a
    simulated table (2% all-missing sites), built as the engine builds
    them: padded to whole tiles, pad sites not ok."""
    import torch
    from ngsld_tpu_torch.kernels.strip_em import strip_tables
    from ngsld_tpu_torch.plan.strips import TA, strip_plan
    gl, eg, maf = _sim_tables(n_ind, n_sites, seed)
    return _strip_args(gl, eg, maf, n_tiles, device, i_align)


def _strip_args(gl, eg, maf, n_tiles, device, i_align=8, ok_a=None,
                ok_b=None):
    """strip_em's arguments, the live mask and the dead cells' f0 for the
    first n_tiles all-pairs tiles of the tables gl (S, I, 3), eg, maf.
    ok_a / ok_b (S,) 0/1: sites usable as anchor / as partner (all, when
    None); the tile list is the plan's for all sites usable."""
    import torch
    from ngsld_tpu_torch.kernels.strip_em import strip_tables
    from ngsld_tpu_torch.plan.strips import TA, strip_plan
    n_sites, n_ind = gl.shape[:2]
    S, Sp = n_sites, -(-n_sites // TA) * TA
    hi = np.zeros(Sp, np.int64)
    hi[:S] = S
    ok = np.zeros(Sp, np.float32)
    ok[:S] = 1.0
    ta, tb, _, _ = strip_plan(hi, ok, S)
    ta, tb = ta[:n_tiles], tb[:n_tiles]
    if len(ta) != n_tiles:
        raise AssertionError(f"plan has {len(ta)} tiles, wanted {n_tiles}")
    f32 = np.float32
    gn = torch.from_numpy(np.pad(gl.astype(f32), ((0, Sp - S), (0, 0), (0, 0)),
                                 constant_values=1.0 / 3.0)).to(device)
    egd = torch.from_numpy(np.pad(eg.astype(f32),
                                  ((0, Sp - S), (0, 0)))).to(device)
    tabs = strip_tables(gn, egd, n_ind, i_align=i_align)
    del gn, egd
    m = torch.from_numpy(np.pad(maf.astype(f32), (0, Sp - S),
                                constant_values=0.5)).to(device)
    lo = torch.arange(1, Sp + 1, dtype=torch.int32, device=device)
    hi_d = torch.from_numpy(hi.astype(np.int32)).to(device)
    oka, okb = ok.copy(), ok.copy()
    if ok_a is not None:
        oka[:S] = ok_a
    if ok_b is not None:
        okb[:S] = ok_b
    args = (*tabs, m, m, lo, hi_d, torch.from_numpy(oka).to(device),
            torch.from_numpy(okb).to(device),
            torch.from_numpy(ta).to(device), torch.from_numpy(tb).to(device))
    # live mask on the host, (n, TA, TB), for the dead-cell check
    A = ta.astype(np.int64)[:, None, None] * TA + np.arange(TA)[None, :, None]
    B = tb.astype(np.int64)[:, None, None] * TA + np.arange(TA)[None, None, :]
    live = (B > A) & (B < hi[A]) & (oka[A] > 0) & (okb[B] > 0)
    # the f0 init of the dead cells, as the kernel computes it: in double
    # from the f32 MAFs, rounded to f32
    mp = np.pad(maf.astype(f32), (0, Sp - S),
                constant_values=0.5).astype(np.float64)
    dead = ~live
    ma = mp[np.broadcast_to(A, live.shape)[dead]]
    mb = mp[np.broadcast_to(B, live.shape)[dead]]
    f0_dead = np.stack([(1 - ma) * (1 - mb), (1 - ma) * mb, ma * (1 - mb),
                        ma * mb], axis=1).astype(f32)
    return args, live, f0_dead


def _check_strip(kern, plain, live, f0_dead, label, iter_cap=100,
                 quiet=False):
    """Strip kernel vs plain version, every cell: n_used and nIter exact,
    f within F32_TOL with NaN positions equal, r2p within R2P_TOL with NaN
    positions equal; dead cells at the f0 init with nIter == iter_cap.
    Prints one line unless quiet; returns max |df|."""
    fk, rk, itk, nuk = (t.cpu().numpy() for t in kern)
    fp, rp, itp, nup = (t.cpu().numpy() for t in plain)
    if not np.array_equal(nuk, nup):
        raise AssertionError(f"{label}: n_used differs on "
                             f"{int((nuk != nup).sum())} cells")
    n_diff = int((itk != itp).sum())
    if n_diff:
        raise AssertionError(f"{label}: nIter differs on {n_diff} of "
                             f"{itp.size} cells")
    for name, k, p, tol in (("f", fk, fp, F32_TOL), ("r2p", rk, rp, R2P_TOL)):
        nan_k, nan_p = np.isnan(k), np.isnan(p)
        if not np.array_equal(nan_k, nan_p):
            raise AssertionError(f"{label}: {name} NaN positions differ on "
                                 f"{int((nan_k != nan_p).sum())} values")
        with np.errstate(invalid="ignore"):
            err = float(np.max(np.abs(np.where(nan_k, 0, k)
                                      - np.where(nan_p, 0, p))))
        if not err <= tol:
            raise AssertionError(f"{label}: max |{name}_kernel - "
                                 f"{name}_plain| {err} > {tol}")
        if name == "f":
            f_err = err
        else:
            r_err = err
    if not (itk[~live] == iter_cap).all():
        raise AssertionError(f"{label}: a dead cell iterated")
    for name, f in (("kernel", fk), ("plain", fp)):
        if not np.array_equal(np.moveaxis(f, 1, -1)[~live], f0_dead):
            raise AssertionError(f"{label}: dead cells not at f0 ({name})")
    x0 = live & (nup == 0)
    if iter_cap > 0 and x0.any() and not (
            np.isnan(np.moveaxis(fk, 1, -1)[x0]).all()
            and (itk[x0] == 0).all()):
        raise AssertionError(f"{label}: n_used = 0 cells not frozen at "
                             "nIter 0 with NaN f")
    if not quiet:
        print(f"  {label}: max|df| {f_err:.3e} (tol {F32_TOL:g}), max|dr2p| "
              f"{r_err:.3e} (tol {R2P_TOL:g}), nIter and n_used exact on "
              f"{itk.size} cells ({int(live.sum())} live, {int(x0.sum())} "
              "with n_used 0)")
    return f_err


def phase_kernel(card, gather=True, strip=True):
    report = {}
    if gather:
        _gather_cells(card, report)
    if strip:
        _strip_cells(card, report)
    return report


def _gather_cells(card, report):
    import torch
    from ngsld_tpu_torch.kernels.pair_em import (pair_em_gather,
                                                 pair_em_gather_ref)
    dev = torch.device("cuda", 0)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        gn, sidx, maf = _table(MAIN_I, 20_000, MAIN_P, 5, dtype, dev)
        for ign in (False, True):
            label = f"pair_em {tag} P={MAIN_P} I={MAIN_I} ignore_miss={ign}"
            if not ign:
                ms_k, kern = _time(lambda: pair_em_gather(gn, sidx, maf, ign))
                ms_p, plain = _time(
                    lambda: pair_em_gather_ref(gn, sidx, maf, ign), 1, False)
            else:
                kern = pair_em_gather(gn, sidx, maf, ign)
                plain = pair_em_gather_ref(gn, sidx, maf, ign)
            err, n_x0 = _check(kern, plain, tol, label)
            if ign and n_x0 == 0:
                raise AssertionError(f"{label}: no x = 0 pairs in the case")
            if not ign:
                evals = int(kern[1].to(torch.int64).sum()) * MAIN_I
                # bound: the table, the index and the MAFs read once, the
                # three outputs written once; the EM's double-precision
                # flops for the updates this data needs
                esz = gn.element_size()
                n_bytes = (gn.numel() + maf.numel()) * esz + sidx.numel() * 4 \
                    + MAIN_P * (4 * esz + 8)
                need = _needed_evals(kern[1], MAIN_I)
                b_ms, b_by = _bound(n_bytes, need * FLOPS_PER_EVAL)
                report[tag] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err,
                                   evals_per_s=evals / (ms_k / 1e3),
                                   bound_ms=b_ms, bound_by=b_by)
                print(f"  {label}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms"
                      f", counted evals/s {evals / (ms_k / 1e3):.4e}; bound "
                      f"{b_ms:.3f} ms by {b_by} ({n_bytes} bytes, {need} "
                      f"needed evals x {FLOPS_PER_EVAL} flops) [{card}]")
        del gn, sidx, maf
    for n_ind, n_pairs in ((37, 65_536), (1_200, 16_384)):
        gn, sidx, maf = _table(n_ind, 4_000, n_pairs, n_ind, torch.float32,
                               dev)
        for ign in (False, True):
            _check(pair_em_gather(gn, sidx, maf, ign),
                   pair_em_gather_ref(gn, sidx, maf, ign), F32_TOL,
                   f"pair_em f32 P={n_pairs} I={n_ind} ignore_miss={ign}")
    del gn, sidx, maf
    torch.cuda.synchronize()


def _lane_line(label, n_iter, live_d, n_ind, rows, round_iters):
    """Print the lane efficiency of one strip launch, from its n_iter: of
    the one-thread-a-cell layout the kernels had, and of a block of
    rows x 32 threads that repacks every round_iters iterations."""
    from ngsld_tpu_torch.utils.devtrace import lane_efficiency
    old = lane_efficiency(n_iter, live_d, n_ind)
    eff = lane_efficiency(n_iter, live_d, n_ind, rows=rows,
                          round_iters=round_iters)
    print(f"  {label}: lane efficiency (needed / executed updates, from the "
          f"kernel's n_iter): one thread a cell, warp of 32 partners "
          f"{old['warp']:.4f}, 8 x 32 block {old['block']:.4f}; {rows} x 32 "
          f"block repacked every {round_iters} iteration(s) "
          f"{eff['repacked']:.4f}; {eff['needed']} needed evals")


def _strip_cells(card, report):
    import torch
    from ngsld_tpu_torch.kernels import strip_em as smod
    from ngsld_tpu_torch.kernels.strip_em import strip_em, strip_em_ref
    dev = torch.device("cuda", 0)
    # ---- strip_em at the strip path's chunk: 256 tiles x I = 100
    args, live, f0_dead = _strip_case(MAIN_I, STRIP_S, STRIP_TILES, 5, dev)
    n_diag = int((args[10] == args[11]).sum())
    for ign in (False, True):
        label = (f"strip_em tiles={STRIP_TILES} ({n_diag} diagonal) "
                 f"I={MAIN_I} ignore_miss={ign}")
        kw = dict(n_ind=MAIN_I, ignore_miss=ign)
        if not ign:
            ms_k, kern = _time(lambda: strip_em(*args, **kw))
            ms_p, plain = _time(lambda: strip_em_ref(*args, **kw), 1, False)
        else:
            kern, plain = strip_em(*args, **kw), strip_em_ref(*args, **kw)
        err = _check_strip(kern, plain, live, f0_dead, label)
        if not ign:
            live_d = torch.from_numpy(live).to(dev)
            nit_live = kern[2][live_d]
            evals = int(nit_live.to(torch.int64).sum()) * MAIN_I
            need = _needed_evals(nit_live, MAIN_I)
            ga, gb, ea, eb = args[:4]
            Ip, n = ga.shape[2], STRIP_TILES
            rows_a = len(torch.unique(args[10])) * 128
            rows_b = len(torch.unique(args[11])) * 128
            cells = n * 128 * 128
            # bound: the table slices of the distinct anchor and partner
            # tiles read once (3 GL planes + E[G], f32) with their per-site
            # vectors, the tile list, and the four outputs written once;
            # flops: the EM updates live cells need, plus the r2p dot of
            # every cell (2 Ip)
            n_bytes = (rows_a + rows_b) * Ip * 16 + rows_a * 16 \
                + rows_b * 8 + n * 8 + cells * (16 + 12)
            b_ms, b_by = _bound(n_bytes, need * FLOPS_PER_EVAL
                                + cells * 2 * Ip)
            report["strip"] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err,
                                   evals_per_s=evals / (ms_k / 1e3),
                                   bound_ms=b_ms, bound_by=b_by)
            print(f"  {label}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, "
                  f"counted evals/s over live cells "
                  f"{evals / (ms_k / 1e3):.4e}; bound {b_ms:.3f} ms by "
                  f"{b_by} ({n_bytes} bytes, {need} needed evals x "
                  f"{FLOPS_PER_EVAL} flops) [{card}]")
            _lane_line(label, kern[2], live_d, MAIN_I, 8, smod.ROUND_ITERS)
            # the repack interval: the same launch at three values
            k_ms = {}
            for k in (1, 2, 4):
                with _attr(smod, "ROUND_ITERS", k):
                    k_ms[k], out = _time(lambda: strip_em(*args, **kw))
                _hold_between(out, kern, f"{label}: ROUND_ITERS = {k}")
            print(f"  {label}: ms by iterations between repacks "
                  + json.dumps(k_ms) + f" (ROUND_ITERS = {smod.ROUND_ITERS})"
                  f" [{card}]")
    del args
    for n_ind in (37, 200):
        args, live, f0_dead = _strip_case(n_ind, 2_048, 16, n_ind, dev)
        for ign in (False, True):
            kw = dict(n_ind=n_ind, ignore_miss=ign)
            n0 = smod.LAUNCHES
            kern = strip_em(*args, **kw)
            if smod.LAUNCHES != n0 + 1:
                raise AssertionError("strip_em did not take the resident "
                                     "kernel")
            _check_strip(kern, strip_em_ref(*args, **kw),
                         live, f0_dead, f"strip_em tiles=16 I={n_ind} "
                         f"ignore_miss={ign}")
        del args
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 3b

def _tiled_panel(n_sites, n_ind, seed, device):
    """The reference bench's large-cohort fixture: a PANEL_I-individual
    simulated panel tiled along the individual axis to n_ind (the EM
    normalises per-individual sums, so trajectories follow the panel's
    while the kernels walk the whole cohort). Tiled on the device:
    (gn (S, n_ind, 3) f32, eg (S, n_ind) f32, maf (S,) f32)."""
    import torch
    gl, _, _ = _sim_tables(PANEL_I, n_sites, seed)
    reps = -(-n_ind // PANEL_I)
    gn = torch.from_numpy(gl.astype(np.float32)).to(device) \
        .repeat(1, reps, 1)[:, :n_ind].contiguous()
    eg = gn[..., 1] + 2 * gn[..., 2]
    maf = (eg.double().mean(dim=1) / 2).float()
    return gn, eg, maf


def _random_pairs(n_pairs, seed, n_sites=4_096):
    """(2, n_pairs) int32 random pairs of n_sites sites, on the card."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.integers(0, n_sites, n_pairs),
                                      rng.integers(0, n_sites, n_pairs)])
                            .astype(np.int32)).to("cuda")


def _gather_bound(gn, sidx, maf, n_iter, cap=100):
    """Bytes once (table, index, MAFs in; three outputs out) and the f64
    flops of the updates this data needs under the iteration cap."""
    esz, P = gn.element_size(), sidx.shape[1]
    n_bytes = (gn.numel() + maf.numel()) * esz + sidx.numel() * 4 \
        + P * (4 * esz + 8)
    need = _needed_evals(n_iter, gn.shape[1], cap)
    return (*_bound(n_bytes, need * FLOPS_PER_EVAL), n_bytes, need)


def _strip_bound(args, n_iter_live, n_ind):
    """As phase 3 counts the resident kernel's: the table slices of the
    distinct anchor and partner tiles read once with their per-site
    vectors and the tile list, four outputs written once; the EM updates
    live cells need plus the r2p dot of every cell."""
    import torch
    Ip, n = args[0].shape[2], len(args[10])
    rows_a = len(torch.unique(args[10])) * 128
    rows_b = len(torch.unique(args[11])) * 128
    cells = n * 128 * 128
    n_bytes = (rows_a + rows_b) * Ip * 16 + rows_a * 16 + rows_b * 8 \
        + n * 8 + cells * (16 + 12)
    need = _needed_evals(n_iter_live, n_ind)
    return (*_bound(n_bytes, need * FLOPS_PER_EVAL + cells * 2 * Ip),
            n_bytes, need)


@contextlib.contextmanager
def _attr(obj, name, value):
    """Set an attribute for the length of a block (a measurement aid)."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def _resident_strip_forced():
    """Send strip_em to the resident kernel whatever the cohort size, to
    time it beside the streamed one (a measurement aid, not a run mode)."""
    from ngsld_tpu_torch.kernels import strip_em as smod
    return _attr(smod, "strip_streamed", lambda *a, **k: False)


def phase_kernel_large(card, gather=True, strip=True):
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    from ngsld_tpu_torch.kernels import strip_em as smod
    from ngsld_tpu_torch.kernels.build import smem_limits
    dev = torch.device("cuda", 0)
    report = {}
    print(f"  shared memory a block may use: {smem_limits(dev)} bytes (default,"
          f" opt-in); ladder at {MAIN_P} pairs: I = 100 -> "
          f"{pmod.pick_gather_kernel(100, 4, dev, MAIN_P)}, {ROWS_I} -> "
          f"{pmod.pick_gather_kernel(ROWS_I, 4, dev, MAIN_P)}, {BIG_I} -> "
          f"{pmod.pick_gather_kernel(BIG_I, 4, dev, MAIN_P)}; strip streamed at "
          f"I = 100: {smod.strip_streamed(100, dev)}, at {BIG_I}: "
          f"{smod.strip_streamed(BIG_I, dev)}")
    if gather:
        _gather_cells_large(card, report)
    if strip:
        _strip_cells_large(card, report)
    torch.cuda.synchronize()
    return report


def _gather_cells_large(card, report):
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    # ---- small odd sizes: warp and chunk boundaries, a partial last chunk
    # (the streamed body of pair_em_ichunk, forced), the cluster body
    for n_ind, n_pairs, chunks in ((37, 65_536, (16, pmod.I_CHUNK)),
                                   (1_200, 16_384, (500, pmod.I_CHUNK))):
        gn, sidx, maf = _table(n_ind, 4_000, n_pairs, n_ind, torch.float32,
                               dev)
        for ign in (False, True):
            tag = f"f32 P={n_pairs} I={n_ind} ignore_miss={ign}"
            _, n_x0 = _check(pmod.pair_em_rows(gn, sidx, maf, ign),
                             pmod.pair_em_rows_ref(gn, sidx, maf, ign),
                             F32_TOL, f"pair_em_rows {tag}")
            for ic in chunks:
                if n_ind % ic == 0:
                    raise AssertionError("the last chunk must be partial")
                _check(_ichunk_streamed(gn, sidx, maf, ign, i_chunk=ic),
                       pmod.pair_em_ichunk_ref(gn, sidx, maf, ign,
                                               i_chunk=ic),
                       F32_TOL, f"pair_em_ichunk streamed i_chunk={ic} {tag}")
            _check(_ichunk_cluster(gn, sidx, maf, ign),
                   pmod.pair_em_ichunk_ref(gn, sidx, maf, ign), F32_TOL,
                   f"pair_em_ichunk cluster C="
                   f"{pmod.ichunk_cluster(n_ind, 4, dev)} {tag}")
            if ign and n_x0 == 0:
                raise AssertionError(f"{tag}: no x = 0 pairs in the case")
        if n_ind == 37:   # double tables
            g64, m64 = gn.double(), maf.double()
            _check(pmod.pair_em_rows(g64, sidx, m64, True),
                   pmod.pair_em_rows_ref(g64, sidx, m64, True), F64_TOL,
                   f"pair_em_rows f64 P={n_pairs} I={n_ind}")
            _check(_ichunk_streamed(g64, sidx, m64, True, i_chunk=16),
                   pmod.pair_em_ichunk_ref(g64, sidx, m64, True, i_chunk=16),
                   F64_TOL, f"pair_em_ichunk streamed f64 P={n_pairs} "
                   f"I={n_ind}")
            _check(_ichunk_cluster(g64, sidx, m64, True),
                   pmod.pair_em_ichunk_ref(g64, sidx, m64, True), F64_TOL,
                   f"pair_em_ichunk cluster f64 P={n_pairs} I={n_ind}")
            del g64, m64
    del gn, sidx, maf
    _gather_cells_big(card, report)


def _ichunk_streamed(*args, **kw):
    """pair_em_ichunk's streamed body at any cohort size (pair_em_ichunk
    takes it past the cluster's capacity only), shown by the body's own
    launch counter."""
    from ngsld_tpu_torch.kernels import pair_em as pmod
    n0, s0 = pmod.LAUNCHES_ICHUNK, pmod.LAUNCHES_ICHUNK_STREAM
    out = pmod._pair_em_ichunk_stream(*args, **kw)
    if (pmod.LAUNCHES_ICHUNK, pmod.LAUNCHES_ICHUNK_STREAM) != (n0 + 1, s0 + 1):
        raise AssertionError("pair_em_ichunk did not take its streamed body")
    return out


def _ichunk_cluster(*args, **kw):
    """pair_em_ichunk through its cluster body, shown by the counters."""
    from ngsld_tpu_torch.kernels import pair_em as pmod
    n0, s0 = pmod.LAUNCHES_ICHUNK, pmod.LAUNCHES_ICHUNK_STREAM
    out = pmod.pair_em_ichunk(*args, **kw)
    if (pmod.LAUNCHES_ICHUNK, pmod.LAUNCHES_ICHUNK_STREAM) != (n0 + 1, s0):
        raise AssertionError("pair_em_ichunk did not take its cluster body")
    return out


def _strip_cells_large(card, report):
    import torch
    from ngsld_tpu_torch.kernels import strip_em as smod
    dev = torch.device("cuda", 0)
    for n_ind, ic in ((37, 16), (1_200, smod.IC_STREAM)):
        with _env(NGSLD_STRIP_STREAM="1", NGSLD_STRIP_IC=str(ic)):
            args, live, f0_dead = _strip_case(n_ind, 2_048, 16, n_ind, dev,
                                              i_align=ic)
            for ign in (False, True):
                kw = dict(n_ind=n_ind, ignore_miss=ign)
                n0 = smod.LAUNCHES_STREAM
                kern = smod.strip_em(*args, **kw)
                if smod.LAUNCHES_STREAM != n0 + 1:
                    raise AssertionError("strip_em did not take the streamed "
                                         "kernel")
                _check_strip(kern, smod.strip_em_stream_ref(*args, **kw),
                             live, f0_dead, f"strip_em streamed IC={ic} "
                             f"tiles=16 I={n_ind} ignore_miss={ign}")
        del args
    _strip_cell_big(card, report)


def _gather_cells_big(card, report):
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    # ---- the large-cohort gather cells: a tiled panel, 2,048 random pairs
    sidx = _random_pairs(BIG_P, 5)
    for name, n_ind in (("rows", ROWS_I), ("ichunk", BIG_I)):
        gn, _, maf = _tiled_panel(4_096, n_ind, 3, dev)
        rung = pmod.pick_gather_kernel(n_ind, 4, dev, BIG_P)
        if rung != name:
            raise AssertionError(f"ladder gives {rung} at I = {n_ind}")
        kern_fn = (pmod.pair_em_rows if name == "rows" else _ichunk_cluster)
        plain_fn = (pmod.pair_em_rows_ref if name == "rows"
                    else pmod.pair_em_ichunk_ref)
        label = f"pair_em_{name} f32 P={BIG_P} I={n_ind} (tiled panel)"
        if name == "ichunk":
            label += f", cluster C={pmod.ichunk_cluster(n_ind, 4, dev)}"
        ms_k, kern = _time(lambda: kern_fn(gn, sidx, maf, False))
        ms_p, plain = _time(lambda: plain_fn(gn, sidx, maf, False), 1, False)
        err, _ = _check(kern, plain, F32_TOL, label)
        _check(kern_fn(gn, sidx, maf, True), plain_fn(gn, sidx, maf, True),
               F32_TOL, label + " ignore_miss=True")
        if name == "rows":
            others = {
                "pair_em_gather": _time(
                    lambda: pmod.pair_em_gather(gn, sidx, maf, False)),
                "pair_em_ichunk": _time(
                    lambda: _ichunk_cluster(gn, sidx, maf, False))}
        else:
            # the kernel the cluster body replaced, at the same cell
            others = {"pair_em_ichunk streamed": _time(
                lambda: _ichunk_streamed(gn, sidx, maf, False))}
        for o_name, (_, o_out) in others.items():
            _check(o_out, kern, F32_TOL, f"{o_name} vs pair_em_{name}, same "
                   "cell")
        b_ms, b_by, n_bytes, need = _gather_bound(gn, sidx, maf, kern[1])
        mean_it = float(kern[1].float().mean()) + 1
        report[name] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err,
                            bound_ms=b_ms, bound_by=b_by)
        if name == "ichunk":
            report[name]["before_ms"] = others["pair_em_ichunk streamed"][0]
        print(f"  {label}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, "
              + ", ".join(f"{k} {v[0]:.3f} ms" for k, v in others.items())
              + f" at the same cell; mean nIter {mean_it:.2f}, counted "
              f"evals/s {need / (ms_k / 1e3):.4e}; bound {b_ms:.3f} ms by "
              f"{b_by} ({n_bytes} bytes, {need} needed evals x "
              f"{FLOPS_PER_EVAL} flops) [{card}]")
        del gn, maf, kern, plain, others
    del sidx


def _strip_cell_big(card, report):
    import torch
    from ngsld_tpu_torch.kernels import strip_em as smod
    dev = torch.device("cuda", 0)
    # ---- the streamed strip cell: 1,024 sites x 20,000, all pairs; the
    # same tiles at 200 individuals, where the resident kernel still runs,
    # and at 1,200
    ic = smod.strip_i_align(BIG_I, dev)
    if not smod.strip_streamed(BIG_I, dev) or ic != smod.IC_STREAM:
        raise AssertionError("I = 20,000 must take the streamed strip kernel")
    n_tiles = (BIG_STRIP_S // 128) * (BIG_STRIP_S // 128 + 1) // 2
    ic_tried = (16, 32, 64)
    for n_ind, ref_tiles, ref_chunk in ((200, n_tiles, None), (1_200, 8, None),
                                        (BIG_I, 2, 1_000)):
        gn, eg, maf = _tiled_panel(BIG_STRIP_S, n_ind, 7, dev)
        # padded to the largest chunk tried: every smaller one divides it
        args, live, f0_dead = _strip_args(
            gn.cpu().numpy(), eg.cpu().numpy(), maf.cpu().numpy(), n_tiles,
            dev, i_align=max(ic_tried))
        del gn, eg
        kw = dict(n_ind=n_ind)
        label = (f"strip_em streamed IC={ic} tiles={n_tiles} I={n_ind} "
                 "(tiled panel)")
        with _env(NGSLD_STRIP_STREAM="1"):   # the smaller cohorts too
            n0 = smod.LAUNCHES_STREAM
            ms_k, kern = _time(lambda: smod.strip_em(*args, **kw), 2)
            if smod.LAUNCHES_STREAM != n0 + 3:
                raise AssertionError("strip_em did not take the streamed "
                                     "kernel")
            # the plain version on the first ref_tiles tiles (a diagonal
            # one first); at I = 20,000 its sums in chunks of ref_chunk
            # individuals to keep it to seconds
            sub = (*args[:10], args[10][:ref_tiles], args[11][:ref_tiles])
            ms_p, plain = _time(lambda: smod.strip_em_stream_ref(
                *sub, i_chunk=ref_chunk, **kw), 1, False)
            # the chunk: the same launch at three sizes (a lane adds its
            # share of the cohort's individuals in the same order whatever
            # the chunk)
            ic_ms = {}
            for c in ic_tried:
                with _env(NGSLD_STRIP_IC=str(c)):
                    ic_ms[c], out = _time(lambda: smod.strip_em(*args, **kw),
                                          2)
                _hold_between(out, kern, f"{label}: IC = {c}")
        err = _check_strip([t[:ref_tiles] for t in kern], plain,
                           live[:ref_tiles], f0_dead[:int(
                               (~live[:ref_tiles]).sum())],
                           label + f", plain on {ref_tiles} tiles")
        live_d = torch.from_numpy(live).to(dev)
        b_ms, b_by, n_bytes, need = _strip_bound(args, kern[2][live_d], n_ind)
        if smod.strip_streamed(n_ind, dev):
            beside = ("the resident kernel does not take this cohort "
                      f"({smod.strip_smem(n_ind)} bytes of shared memory)")
        else:
            n0 = smod.LAUNCHES
            ms_r, res = _time(lambda: smod.strip_em(*args, **kw), 2)
            if smod.LAUNCHES != n0 + 3:
                raise AssertionError("the resident kernel did not run")
            how = _hold_between(kern, res, f"{label}: streamed vs resident")
            beside = (f"resident kernel {ms_r:.3f} ms at the same cell "
                      f"(on all {n_tiles} tiles: {how})")
        print(f"  {label}: streamed kernel {ms_k:.3f} ms, {beside}, plain "
              f"{ms_p:.3f} ms for {ref_tiles} tiles; ms by chunk "
              + json.dumps(ic_ms) + f"; {int(live.sum())} live pairs, "
              f"counted evals/s {need / (ms_k / 1e3):.4e}; bound "
              f"{b_ms:.3f} ms by {b_by} ({n_bytes} bytes, {need} needed "
              f"evals x {FLOPS_PER_EVAL} flops) [{card}]")
        _lane_line(label, kern[2], live_d, n_ind, 16,
                   smod.ROUND_ITERS_STREAM)
        if n_ind == BIG_I:
            with _env(NGSLD_STRIP_STREAM="1"):
                _, seen = _clocks_during(lambda: _time(
                    lambda: smod.strip_em(*args, **kw), 3, False))
            print(f"  {label}: SM clock and power draw under three more "
                  f"launches: {seen}")
            report["stream"] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err,
                                    bound_ms=b_ms, bound_by=b_by,
                                    plain_tiles=ref_tiles)
        del args, kern, plain, live_d


def _clocks_during(fn):
    """Run fn() while a thread reads the card's SM clock and power draw
    every 0.2 s; returns (fn's result, the readings)."""
    import threading
    stop, seen = threading.Event(), []

    def sample():
        while not stop.is_set():
            seen.append(_run(["nvidia-smi", "--query-gpu=clocks.sm,"
                              "power.draw", "--format=csv,noheader"]))
            stop.wait(0.2)

    th = threading.Thread(target=sample)
    th.start()
    try:
        return fn(), seen
    finally:
        stop.set()
        th.join()


def _same(a, b):
    """Two strip_em outputs bit for bit (NaN equal to NaN)."""
    import torch
    return all(torch.equal(x.nan_to_num(), y.nan_to_num())
               and torch.equal(x.isnan(), y.isnan()) for x, y in zip(a, b))


def _hold_between(a, b, label):
    """Two launches of the strip kernels on the same inputs (another
    kernel, chunk or repack interval): r2p, nIter and n_used bit for bit, f
    within F32_TOL (a cell that has a group of lanes adds its individuals
    in the group's order, which follows the sub-tile's other cells). Says
    which it was."""
    import torch
    if _same(a, b):
        return "bit-equal"
    if not _same(a[1:], b[1:]):
        raise AssertionError(f"{label}: r2p, nIter or n_used differ")
    if not torch.equal(a[0].isnan(), b[0].isnan()):
        raise AssertionError(f"{label}: NaN positions of f differ")
    err = float((a[0].nan_to_num() - b[0].nan_to_num()).abs().max())
    if not err <= F32_TOL:
        raise AssertionError(f"{label}: max |df| {err} > {F32_TOL}")
    return (f"nIter, n_used, r2p bit-equal, max |df| {err:.3e} (tol "
            f"{F32_TOL:g}; summation order differs by design)")


# --------------------------------------------------------------- phase 3c

# (source, the EM kernel's name in it, a part of its mangled name): the
# instances built without --ignore_miss_data (and, for strip_em.cu,
# without the eps export), the ones every timed cell runs
STRIP_KERNELS = (("strip_em", "strip_em_kernel", "ILb0ELb0E"),
                 ("strip_em_stream", "strip_em_stream_kernel", "ILb0E"))


def _sass_lines(kernels=None):
    """One line a kernel: registers a thread and the instructions of its EM
    inner loop by class, per unrolled trip and per term. kernels: (source,
    kernel name, further parts of the mangled name) triples, the strip
    kernels by default."""
    from ngsld_tpu_torch.kernels.build import build_libraries
    from ngsld_tpu_torch.utils.devtrace import (cuobjdump, kernel_registers,
                                                sass_inner_loop)
    paths = build_libraries()
    out = {}
    for src, kernel, *more in kernels or STRIP_KERNELS:
        parts = [kernel, *more]
        loop = sass_inner_loop(cuobjdump(paths[src], "-sass"), parts)
        if loop is None or loop["fp64"] < 24:
            raise AssertionError(f"{src}: no EM inner loop found in the SASS "
                                 f"of {kernel}: {loop}")
        regs = kernel_registers(cuobjdump(paths[src], "-res-usage"), parts)
        t = loop["terms"]
        per_term = {k: round(v / t, 2) for k, v in loop.items()
                    if isinstance(v, int) and k != "terms"}
        print(f"  SASS {src}.cu {loop['function']}: {regs} registers a "
              f"thread; inner loop {loop['loop']} of {t} term(s): "
              + json.dumps({k: v for k, v in loop.items()
                            if k not in ("function", "loop")})
              + "; per term: " + json.dumps(per_term))
        out[kernel + "".join(more)] = dict(regs=regs, per_term=per_term)
    return out


def _repack_cases(card):
    """Inputs that aim at the repack, through both kernels, each against
    the plain version with nIter and n_used exact: warps with one live
    cell each, a single live cell, every cell stopping at a cap at and
    around a round boundary (ROUND_ITERS +- 1) and at cap 0, with x = 0
    cells and --ignore_miss_data."""
    import torch
    from ngsld_tpu_torch.kernels import strip_em as smod
    dev = torch.device("cuda", 0)
    n_ind, S, n_tiles, ic = 37, 2_048, 16, 16
    gl, eg, maf = _sim_tables(n_ind, S, 41)
    site = np.arange(S)
    one_a, one_b = (site == 100), (site == 777)
    K = smod.ROUND_ITERS
    caps = sorted({0, 1, 3, max(K - 1, 0), K, K + 1})
    masks = (("every 32nd partner live", None, site % 32 == 5, (100,)),
             ("one live cell", one_a, one_b, (100,)),
             ("all cells", None, None, caps))
    n_cases, worst = 0, 0.0
    for name, ok_a, ok_b, cap_list in masks:
        args, live, f0_dead = _strip_args(
            gl, eg, maf, n_tiles, dev, i_align=ic,
            ok_a=None if ok_a is None else ok_a.astype(np.float32),
            ok_b=None if ok_b is None else ok_b.astype(np.float32))
        if name == "one live cell" and int(live.sum()) != 1:
            raise AssertionError(f"{int(live.sum())} live cells, wanted 1")
        if name.startswith("every 32nd") and not (
                live.reshape(n_tiles, 128, 4, 32).sum(axis=-1) <= 1).all():
            raise AssertionError("a warp holds more than one live cell")
        for cap in cap_list:
            for ign in (False, True):
                kw = dict(n_ind=n_ind, iter_cap=cap, ignore_miss=ign)
                plain = smod.strip_em_ref(*args, **kw)
                outs = {}
                for kernel, env in (("resident", {}), ("streamed", dict(
                        NGSLD_STRIP_STREAM="1", NGSLD_STRIP_IC=str(ic)))):
                    with _env(**env):
                        outs[kernel] = smod.strip_em(*args, **kw)
                    worst = max(worst, _check_strip(
                        outs[kernel], plain, live, f0_dead,
                        f"repack case '{name}' iter_cap={cap} "
                        f"ignore_miss={ign} {kernel}", iter_cap=cap,
                        quiet=True))
                    n_cases += 1
                _hold_between(outs["resident"], outs["streamed"],
                              f"{name}, cap {cap}: streamed vs resident")
        del args
    print(f"  {n_cases} repack cases (16 tiles x {n_ind}, both kernels, "
          f"--ignore_miss_data off and on: {[m[0] for m in masks]}, caps "
          f"{caps} around ROUND_ITERS = {K}) agree with the plain version: "
          f"nIter and n_used exact, max|df| {worst:.3e} (tol {F32_TOL:g}); "
          "streamed held against resident")


def _crossover(card):
    """Both kernels on the same 64 tiles at cohort sizes around the
    resident kernel's limit, and the refusal past it."""
    import torch
    from ngsld_tpu_torch.kernels import strip_em as smod
    from ngsld_tpu_torch.kernels.build import smem_limits
    dev = torch.device("cuda", 0)
    limit = smem_limits(dev)[1]
    rows = {}
    for n_ind in (50, 100, 150, 200, 230, 250, 484, 1_200):
        args, _, _ = _strip_case(n_ind, 2_048, 64, n_ind, dev,
                                 i_align=smod.IC_STREAM)
        kw = dict(n_ind=n_ind)
        with _env(NGSLD_STRIP_STREAM="1"):
            ms_s, out_s = _time(lambda: smod.strip_em(*args, **kw))
        if smod.strip_smem(n_ind) <= limit:
            if smod.strip_streamed(n_ind, dev):
                raise AssertionError(f"I = {n_ind} fits and is streamed")
            ms_r, out_r = _time(lambda: smod.strip_em(*args, **kw))
            _hold_between(out_s, out_r, f"I = {n_ind}: streamed vs resident")
            rows[n_ind] = dict(resident_ms=round(ms_r, 3),
                               streamed_ms=round(ms_s, 3))
        else:
            # past the limit the wrapper refuses the resident kernel, with
            # both numbers
            try:
                with _resident_strip_forced():
                    smod.strip_em(*args, **kw)
            except ValueError as e:
                if str(smod.strip_smem(n_ind)) not in str(e) \
                        or str(limit) not in str(e):
                    raise AssertionError(f"refusal without the numbers: {e}")
            else:
                raise AssertionError(f"resident kernel not refused at I = "
                                     f"{n_ind}")
            if not smod.strip_streamed(n_ind, dev):
                raise AssertionError(f"I = {n_ind} does not fit and is not "
                                     "streamed")
            rows[n_ind] = dict(resident_ms=None, streamed_ms=round(ms_s, 3))
        del args
    print("  crossover, 64 tiles of 2,048 sites, ms (resident None: refused, "
          f"its block needs more than {limit} bytes): " + json.dumps(rows)
          + f" [{card}]")


def phase_strip_design(card):
    _sass_lines()
    _repack_cases(card)
    _crossover(card)

# --------------------------------------------------------------- phase 3d

# (source, kernel, a part of its mangled name): the f32-table instances
# built without --ignore_miss_data and without the options (pair_em.cu)
# or the cap (the others), the ones the timed cells run
GATHER_KERNELS_SASS = (("pair_em", "pair_em_kernel", "IfLb0ELb0E"),
                       ("pair_em_rows", "pair_em_rows_kernel", "IfLb0ELb0E"),
                       ("pair_em_ichunk", "pair_em_cluster_kernel",
                        "IfLb0ELb0E"),
                       ("pair_em_ichunk", "pair_em_ichunk_kernel",
                        "IfLb0ELb0E"))
GROUPS = (4, 8, 16, 32)          # lane groups timed at the gather cell
# pair_em_rows' widths, timed at (pairs, cohort, table itemsize)
ROWS_WIDTHS = (64, 128, 256, 512)
# (the rule was settled on these and on 524,288 x 6,000 and x 9,642 in
# f32; those two cells are no longer run, to keep the whole run near
# 800 s)
ROWS_SWEEP = ((BIG_P, ROWS_I, 4), (MAIN_P, 800, 4), (MAIN_P, 1_200, 4),
              (MAIN_P, 4_000, 4), (MAIN_P, 300, 8), (MAIN_P, 2_048, 8))
# crossovers: gather against rows, and rows against the cluster body
X_GATHER_ROWS = (100, 400, 500, 550, 600, 800, 1_000, 1_200, 2_048, 4_000)
# f64 tables: the lane groups' slots fit to 2,421 individuals
X_GATHER_ROWS_F64 = (100, 200, 250, 300, 400, 800, 2_048)
X_ROWS_ICHUNK = (4_000, 5_000, 6_000, 8_000, 9_642, 12_000)
X_ROWS_ICHUNK_F64 = (2_048, 3_000, 4_000, 4_821, 6_000)
# the lane groups / rows switch by pair count, at cohorts on both sides
X_PAIRS = (8_192, 16_384, 32_768, 65_536, MAIN_P)
X_PAIRS_I = ((100, 4), (400, 4), (500, 4), (200, 8), (250, 8))
# the same switch on the planner's banded blocks (--max_snp_dist, the band
# of phase 5b's runs)
X_BANDED, X_BAND = (16_384, 32_768, 65_536), 128
# pairs of the crossover cells: a sampled large-cohort block and the
# gather sweep's default block (--chunk_pairs); rows against the cluster
# body at the first only (the rows / ichunk switch is by cohort alone; it
# was measured at both counts, and the second is no longer run, for time)
X_P = (16_384, MAIN_P)


def _gather_groups_resident(n_ind, group, regs):
    """Lane groups of pair_em_gather the card holds at once (f32 tables):
    blocks an SM from its shared memory, its registers and the 32-block
    limit, times the SMs, times the groups a block."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    smem = pmod.gather_smem(n_ind, group)
    sm_bytes = pmod.smem_limits(dev)[1] + 1024
    per_sm = min(32, sm_bytes // (smem + 1024),
                 65_536 // (max(regs or 1, 1) * pmod.GATHER_THREADS))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return per_sm * sms * (pmod.GATHER_THREADS // group), per_sm


def _group_sweep(card, sass):
    """pair_em_gather at the gather cell for G = 4, 8, 16, 32 lanes a pair:
    times, resident warps, the lane-use model of each layout from the
    kernel's own n_iter, each run held against the rule's launch."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    from ngsld_tpu_torch.utils.devtrace import gather_lane_use
    dev = torch.device("cuda", 0)
    gn, sidx, maf = _table(MAIN_I, 20_000, MAIN_P, 5, torch.float32, dev)
    rule = pmod.gather_group(MAIN_I, 4, dev)
    base = pmod.pair_em_gather(gn, sidx, maf, False)
    if not _same(base, pmod.pair_em_gather(gn, sidx, maf, False)):
        raise AssertionError("pair_em_gather: two launches on the same "
                             "inputs differ")
    n_iter = base[1].cpu().numpy()
    regs = sass["pair_em_kernelIfLb0ELb0E"]["regs"]
    rows = {}
    for g in GROUPS:
        with _attr(pmod, "gather_group", lambda *a, g=g, **k: g):
            ms, out = _time(lambda: pmod.pair_em_gather(gn, sidx, maf,
                                                        False))
        err, _ = _check(out, base, F32_TOL, f"G = {g}", quiet=True)
        n_groups, per_sm = _gather_groups_resident(MAIN_I, g, regs)
        use = gather_lane_use(n_iter, MAIN_I, g, n_groups)["queue"]
        rows[f"G={g}"] = dict(ms=round(ms, 3), warps_sm=per_sm * 2,
                              lane_use=round(use, 4),
                              bits="equal" if _same(out, base)
                              else f"max|df| {err:.3e}")
    old = gather_lane_use(n_iter, MAIN_I, 32, 1)["warp"]
    print(f"  pair_em_gather f32 P={MAIN_P} I={MAIN_I}: by lane group (ms; "
          "resident warps an SM; modelled lane use of the queue from the "
          "kernel's n_iter; against the rule's launch, nIter and n_used "
          f"exact): " + json.dumps(rows) + f"; the rule takes G={rule}; two "
          "launches bit-equal; the warp-per-pair layout's lane use (4-warp "
          f"blocks) {old:.4f} [{card}]")
    del gn, sidx, maf, base


def _cluster_sweep(card):
    """pair_em_ichunk's cluster body at 2,048 x 20,000 for several cluster
    sizes and block widths, each held against the rule's launch; two
    launches bit-equal; at I = 256, where the arithmetic is trivial, the
    cost of a cluster's update."""
    import ctypes

    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    from ngsld_tpu_torch.kernels.build import get_library
    dev = torch.device("cuda", 0)
    sidx = _random_pairs(BIG_P, 5)
    lib = get_library("pair_em_ichunk")

    def active(n_ind, c, t):
        out = (ctypes.c_int * 1)()
        lib.ngsld_pair_em_cluster_occupancy(0, n_ind, c, t, 0,
                                            ctypes.addressof(out))
        return int(out[0])

    for n_ind, sizes, widths in ((BIG_I, (3, 4, 5, 6, 8), (128, 256, 512)),
                                 (256, (1, 2, 4, 8), (64,))):
        gn, _, maf = _tiled_panel(4_096, n_ind, 3, dev)
        c_rule = pmod.ichunk_cluster(n_ind, 4, dev)
        rule = (c_rule, pmod.cluster_threads(n_ind, c_rule))
        base = _ichunk_cluster(gn, sidx, maf, False)
        if not _same(base, _ichunk_cluster(gn, sidx, maf,
                                                         False)):
            raise AssertionError(f"pair_em_ichunk I={n_ind}: two launches "
                                 "differ")
        updates = int(np.minimum(base[1].cpu().numpy() + 1, 100).sum())
        rows = {}
        for c in sizes:
            for t in widths:
                with _attr(pmod, "ichunk_cluster", lambda *a, c=c, **k: c), \
                        _attr(pmod, "cluster_threads",
                              lambda *a, t=t, **k: t):
                    ms, out = _time(lambda: _ichunk_cluster(gn, sidx, maf,
                                                            False))
                err, _ = _check(out, base, F32_TOL, f"C={c}", quiet=True)
                n_act = active(n_ind, c, t)
                rows[f"C={c}, {t} threads"] = dict(
                    ms=round(ms, 3), clusters_resident=n_act,
                    us_per_cluster_update=round(ms * 1e3 * n_act / updates,
                                                3),
                    smem_block=pmod.cluster_smem(n_ind, c),
                    bits="equal" if _same(out, base)
                    else f"max|df| {err:.3e}")
        print(f"  pair_em_ichunk cluster body, P={BIG_P} I={n_ind} (tiled "
              f"panel, {updates} pair updates): " + json.dumps(rows)
              + f"; the rule takes C={rule[0]}, {rule[1]} threads; two "
              f"launches bit-equal [{card}]")
        del gn, maf, base
    del sidx


def _rows_resident(n_ind, esz, dev, threads, regs):
    """pair_em_rows blocks an SM holds at a width: the package's count (by
    shared memory and threads), then by the SM's 65,536 registers."""
    from ngsld_tpu_torch.kernels import pair_em as pmod
    return min(pmod.rows_pairs_sm(n_ind, esz, dev, threads),
               65536 // (regs * threads))


def _rows_forced(threads):
    """pair_em_rows at a given block width (a measurement aid)."""
    from ngsld_tpu_torch.kernels import pair_em as pmod
    return _attr(pmod, "rows_threads", lambda *a, **k: threads)


def _rows_sweep(card, sass):
    """pair_em_rows at each cell of ROWS_SWEEP for every block width: times,
    blocks an SM, each run held against the rule's launch; two launches of
    the rule bit-equal. The 2,048-pair cell is phase 3b's (pairs of seed
    5), the 524,288-pair cells the crossovers' (seed 11)."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    regs = sass["pair_em_rows_kernelIfLb0ELb0E"]["regs"]
    out = {}
    for n_pairs, n_ind, esz in ROWS_SWEEP:
        sidx = _random_pairs(n_pairs, 5 if n_pairs == BIG_P else 11)
        gn, _, maf = _tiled_panel(4_096, n_ind, 3 if n_pairs == BIG_P
                                  else 13, dev)
        dtype = torch.float32 if esz == 4 else torch.float64
        gn, maf = gn.to(dtype), maf.to(dtype)
        tol = F32_TOL if esz == 4 else F64_TOL
        base = pmod.pair_em_rows(gn, sidx, maf, False)
        if not _same(base, pmod.pair_em_rows(gn, sidx, maf, False)):
            raise AssertionError(f"pair_em_rows I={n_ind}: two launches "
                                 "differ")
        row = {}
        for t in ROWS_WIDTHS:
            with _rows_forced(t):
                ms, o = _time(lambda: pmod.pair_em_rows(gn, sidx, maf,
                                                        False))
            err, _ = _check(o, base, tol, f"T={t}", quiet=True)
            row[f"T={t}"] = dict(
                ms=round(ms, 3),
                blocks_sm=_rows_resident(n_ind, esz, dev, t, regs),
                bits="equal" if _same(o, base) else f"max|df| {err:.3e}")
        b_ms = _gather_bound(gn, sidx, maf, base[1])[0]
        key = f"{esz * 8}-bit P={n_pairs} I={n_ind}"
        out[key] = dict(row, rule=pmod.rows_threads(n_ind, esz),
                        bound_ms=round(b_ms, 3))
        del gn, maf, sidx, base
    print("  pair_em_rows by block width (ms; blocks an SM from shared "
          "memory, threads and registers; against the rule's launch, nIter "
          "and n_used exact): " + json.dumps(out) + f"; {regs} registers a "
          f"thread; two launches bit-equal [{card}]")
    return out


def _rows_tail(card):
    """The 2,048 x 4,000 cell of phase 3b: its nIter histogram, its
    slowest pair launched alone (one pair's iteration latency on an SM of
    its own) and that pair's share of the cell's time, beside a greedy
    model of the blocks' schedule in index order."""
    import heapq

    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    sidx = _random_pairs(BIG_P, 5)
    gn, _, maf = _tiled_panel(4_096, ROWS_I, 3, dev)
    ms_cell, cell = _time(lambda: pmod.pair_em_rows(gn, sidx, maf, False))
    it = cell[1].cpu().numpy().astype(np.int64)
    updates = np.minimum(it + 1, 100)
    slow = int(np.argmax(updates))
    one = sidx[:, slow:slow + 1].contiguous()
    ms_one, alone = _time(lambda: pmod.pair_em_rows(gn, one, maf, False))
    if not _same(alone, tuple(t[slow:slow + 1] for t in cell)):
        raise AssertionError("the slowest pair alone differs from its run in "
                             "the cell")
    # blocks start in index order on the first free slot
    slots = pmod.rows_pairs_sm(ROWS_I, 4, dev) * \
        torch.cuda.get_device_properties(dev).multi_processor_count
    ends = [0] * slots
    for u in updates:
        heapq.heappush(ends, heapq.heappop(ends) + int(u))
    makespan = max(ends)
    hist = np.bincount(updates)
    print(f"  pair_em_rows f32 P={BIG_P} I={ROWS_I}: cell {ms_cell:.3f} ms; "
          f"updates a pair (nIter + 1): mean {updates.mean():.3f}, median "
          f"{np.median(updates):.1f}, p99 {np.percentile(updates, 99):.1f}, "
          f"max {updates.max()} (pair index {slow}); histogram "
          + json.dumps({int(k): int(v) for k, v in enumerate(hist) if v})
          + f"; the slowest pair alone {ms_one:.3f} ms = "
          f"{ms_one * 1e3 / updates[slow]:.3f} us an iteration, "
          f"{ms_one / ms_cell:.4f} of the cell; greedy model of {slots} "
          f"slots: makespan {makespan} iteration-slots against "
          f"{updates.sum() / slots:.1f} packed [{card}]")
    del gn, maf, sidx, cell
    return dict(cell_ms=ms_cell, alone_ms=ms_one, slow_updates=int(
        updates[slow]))


def _gather_case(n_ind, n_pairs, seed, dtype, device):
    """A tiled-panel site table (2% all-missing sites, so x = 0 pairs under
    --ignore_miss_data) of 256 sites and n_pairs random pairs."""
    import torch
    gn, _, maf = _tiled_panel(256, n_ind, seed, device)
    rng = np.random.default_rng(seed)
    sidx = torch.from_numpy(np.stack([rng.integers(0, 256, n_pairs),
                                      rng.integers(0, 256, n_pairs)])
                            .astype(np.int32)).to(device)
    return gn.to(dtype), sidx, maf.to(dtype)


def _edge_cases(card):
    """Both redesigned kernels against their plain versions where their
    layouts have edges: one pair; pair counts that leave a block's groups
    part-filled; I = 1, 37, 100; I on both sides of every change of the
    group size and at the gather rung's design limit (one past it is
    refused with both numbers); cluster sizes 1, 2 and 8 and one past the
    cluster's capacity (the streamed body, by its counter); x = 0 pairs;
    --ignore_miss_data off and on; f64 tables. The rows kernel at I = 1,
    37 and 100 (the cohorts it takes on small blocks), its first cohorts on
    the default block, both sides of every change of its width and its
    ceilings (one past each refused with both numbers)."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    # where the rule changes G (f32 tables, then f64), and the design limit
    steps = {}
    for esz in (4, 8):
        prev = pmod.gather_group(1, esz, dev)
        for n in range(2, 6_000):
            g = pmod.gather_group(n, esz, dev)
            if g != prev:
                steps.setdefault(esz, []).append((n - 1, n, prev, g))
                prev = g
            if g is None:
                break
    limit = steps[4][-1][0]    # the last cohort a block of slots holds
    cases = [("gather", 1, 1_001), ("gather", 37, 1), ("gather", 37, 1_001),
             ("gather", 100, 4_099)]
    for lo, hi, _, g in steps[4][:-1]:
        cases += [("gather", lo, 2_048), ("gather", hi, 2_048)]
    cases += [("gather", limit, 512)]
    sizes = {}   # the first cohort of each cluster size
    for n in range(1, 80_000, 7):
        sizes.setdefault(pmod.ichunk_cluster(n, 4, dev), n)
    if not {1, 2, 8, None} <= set(sizes):
        raise AssertionError(f"cluster sizes reached: {sorted(sizes, key=str)}")
    cap = sizes[None]
    while pmod.ichunk_cluster(cap - 1, 4, dev) is None:
        cap -= 1
    cases += [("cluster", 37, 1), ("cluster", 100, 257),
              ("cluster", sizes[2], 257), ("cluster", sizes[8], 129),
              ("cluster", cap - 1, 64), ("stream", cap, 64)]
    # the rows rung: its first cohorts (f32, f64), both sides of every
    # change of its width, its ceilings (one past each refused below)
    rows_first = {esz: pmod.GATHER_MAX_IND[esz] + 1 for esz in (4, 8)}
    rows_cap = {esz: pmod.rows_max_ind(esz, dev) for esz in (4, 8)}
    widths = [(n - 1, n) for n in range(2, rows_cap[4] + 1)
              if pmod.rows_threads(n) != pmod.rows_threads(n - 1)]
    cases += [("rows", 1, 1), ("rows", 37, 1_001), ("rows", 100, 4_099),
              ("rows", rows_first[4], 1), ("rows", rows_first[4], 2_048),
              ("rows", rows_first[8], 2_048)]
    cases += [("rows", n, 257) for pair in widths for n in pair]
    cases += [("rows", rows_cap[8], 64), ("rows", rows_cap[4], 64)]
    n_cases, worst, seen = 0, {4: 0.0, 8: 0.0}, []
    for kind, n_ind, n_pairs in cases:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            esz = 4 if dtype == torch.float32 else 8
            if kind == "gather" and pmod.gather_group(n_ind, esz, dev) is None:
                continue
            if kind == "rows" and n_ind > rows_cap[esz]:
                continue
            if dtype == torch.float64 and n_ind > 40_000:
                continue      # the f64 cluster's capacity is half
            gn, sidx, maf = _gather_case(n_ind, n_pairs, n_ind % 97, dtype,
                                         dev)
            for ign in (False, True):
                if kind == "gather":
                    kern = pmod.pair_em_gather(gn, sidx, maf, ign)
                    plain = pmod.pair_em_gather_ref(gn, sidx, maf, ign)
                elif kind == "rows":
                    kern = pmod.pair_em_rows(gn, sidx, maf, ign)
                    plain = pmod.pair_em_rows_ref(gn, sidx, maf, ign)
                    if not _same(kern, pmod.pair_em_rows(gn, sidx, maf, ign)):
                        raise AssertionError(f"rows I={n_ind}: two launches "
                                             "differ")
                elif kind == "cluster":
                    kern = _ichunk_cluster(gn, sidx, maf, ign)
                    plain = pmod.pair_em_ichunk_ref(gn, sidx, maf, ign)
                else:
                    n0 = pmod.LAUNCHES_ICHUNK_STREAM
                    kern = pmod.pair_em_ichunk(gn, sidx, maf, ign)
                    if pmod.LAUNCHES_ICHUNK_STREAM != n0 + 1:
                        raise AssertionError(f"I = {n_ind}: not streamed")
                    plain = pmod.pair_em_ichunk_ref(gn, sidx, maf, ign)
                err, n_x0 = _check(kern, plain, tol, f"{kind} I={n_ind} "
                                   f"P={n_pairs} {dtype} ign={ign}",
                                   quiet=True)
                worst[esz] = max(worst[esz], err)
                n_cases += 1
            what = (f"G={pmod.gather_group(n_ind, esz, dev)}"
                    if kind == "gather" else
                    f"T={pmod.rows_threads(n_ind, esz)}" if kind == "rows"
                    else f"C={pmod.ichunk_cluster(n_ind, esz, dev)}")
            seen.append(f"{kind} I={n_ind} P={n_pairs} {esz * 8}-bit {what}"
                        f" x0={n_x0}")
            del gn, sidx, maf, kern, plain
    # one past the gather rung's design limit: refused with both numbers
    gn, sidx, maf = _gather_case(limit + 1, 4, 1, torch.float32, dev)
    try:
        pmod.pair_em_gather(gn, sidx, maf, False)
    except ValueError as e:
        need = pmod.gather_smem(limit + 1, 32, 4)
        if str(need) not in str(e) or str(pmod.smem_limits(dev)[1]) \
                not in str(e):
            raise AssertionError(f"refusal without the numbers: {e}")
    else:
        raise AssertionError(f"pair_em_gather took I = {limit + 1}")
    # one past the rows rung's ceilings: refused with both numbers
    for esz, dtype in ((4, torch.float32), (8, torch.float64)):
        n_ind = rows_cap[esz] + 1
        gn, sidx, maf = _gather_case(n_ind, 4, 1, dtype, dev)
        n0 = pmod.LAUNCHES_ROWS
        try:
            pmod.pair_em_rows(gn, sidx, maf, False)
        except ValueError as e:
            need = pmod.rows_block_smem(n_ind, esz,
                                        pmod.rows_threads(n_ind, esz, dev))
            if str(need) not in str(e) or str(pmod.smem_limits(dev)[1]) \
                    not in str(e) or pmod.LAUNCHES_ROWS != n0:
                raise AssertionError(f"refusal without the numbers: {e}")
        else:
            raise AssertionError(f"pair_em_rows took I = {n_ind}")
        if pmod.pick_gather_kernel(n_ind, esz, dev, MAIN_P) != "ichunk":
            raise AssertionError(f"the ladder does not take ichunk at "
                                 f"I = {n_ind}")
    del gn, sidx, maf
    print(f"  {n_cases} edge cases agree with the plain versions (nIter and "
          f"n_used exact, max|df| f32 {worst[4]:.3e}, f64 {worst[8]:.3e}): "
          + "; ".join(seen))
    print(f"  group size steps (last cohort, first cohort, G before, G "
          f"after): f32 {steps[4]}, f64 {steps[8]}; the gather rung's "
          f"design limit {limit} (I = {limit + 1} refused with both "
          f"numbers); cluster sizes first reached at "
          f"{json.dumps({str(k): v for k, v in sizes.items()})}, "
          f"capacity {cap - 1} individuals in f32; rows width steps (last "
          f"cohort, first cohort) {widths}, rows ceilings {rows_cap[4]} "
          f"(f32) and {rows_cap[8]} (f64), one past each refused with both "
          "numbers and sent to ichunk by the ladder")


def _banded_pairs(n_pairs, band, n_sites=4_096):
    """(2, n_pairs) int32 on the card: the first block the band planner
    (plan.band.iter_pair_blocks) emits over n_sites sites of one contig at
    --max_snp_dist band, every site kept."""
    import types

    import torch
    from ngsld_tpu_torch.plan.band import iter_pair_blocks
    pars = types.SimpleNamespace(n_sites=n_sites, max_kb_dist=0,
                                 max_snp_dist=band, min_maf=0.0,
                                 rnd_sample=1.0, seed=0)
    blk = next(iter_pair_blocks(pars, np.full(n_sites, 0.5),
                                np.ones(n_sites), block_pairs=n_pairs))
    if len(blk.s1) != n_pairs:
        raise AssertionError(f"banded block of {len(blk.s1)} pairs, asked "
                             f"{n_pairs}")
    return torch.from_numpy(np.stack([blk.s1, blk.s2]).astype(np.int32)) \
        .to("cuda")


def _pairs_sweep(card):
    """pair_em_gather against pair_em_rows at the cohorts X_PAIRS_I for
    each pair count of X_PAIRS (random pairs of a tiled panel, the
    crossovers' seeds) and of X_BANDED (the planner's banded blocks), each
    pair of runs held together."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    out = {}
    blocks = [(f"P={p}", p, functools.partial(_random_pairs, p, 11))
              for p in X_PAIRS]
    blocks += [(f"P={p} banded", p, functools.partial(_banded_pairs, p,
                                                       X_BAND))
               for p in X_BANDED]
    for n_ind, esz in X_PAIRS_I:
        dtype = torch.float32 if esz == 4 else torch.float64
        gn, _, maf = _tiled_panel(4_096, n_ind, 13, dev)
        gn, maf = gn.to(dtype), maf.to(dtype)
        for label, n_pairs, make in blocks:
            sidx = make()
            ms_g, g = _time(lambda: pmod.pair_em_gather(gn, sidx, maf, False))
            ms_r, r = _time(lambda: pmod.pair_em_rows(gn, sidx, maf, False))
            _check(g, r, F32_TOL if esz == 4 else F64_TOL,
                   f"I={n_ind} {label}", quiet=True)
            out[f"{esz * 8}-bit I={n_ind} {label}"] = dict(
                gather=round(ms_g, 3), rows=round(ms_r, 3),
                pick=pmod.pick_gather_kernel(n_ind, esz, dev, n_pairs))
            del sidx, g, r
        del gn, maf
    print("  lane groups against rows by pair count (random pairs, and the "
          f"planner's blocks at band {X_BAND}), ms, and the ladder's pick: "
          + json.dumps(out) + f" [{card}]")
    return out


def _ichunk_at(blocks, *args, **kw):
    """pair_em_ichunk's cluster body at `blocks` blocks a cluster (a
    measurement aid)."""
    from ngsld_tpu_torch.kernels import pair_em as pmod
    with _attr(pmod, "ichunk_cluster", lambda *a, **k: blocks):
        return _ichunk_cluster(*args, **kw)


def _crossovers(card):
    """The gather ladder's crossovers on the same pairs of a tiled panel:
    pair_em_gather against pair_em_rows (f32 and f64 tables), then
    pair_em_rows against pair_em_ichunk (its cluster body; the rows kernel
    is refused past its limit), each pair of runs held together; at two
    pair counts."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    out = {}
    for n_pairs in X_P:
        sidx = _random_pairs(n_pairs, 11)
        big = n_pairs == MAIN_P
        lists = {4: (X_GATHER_ROWS, () if big else X_ROWS_ICHUNK),
                 8: (X_GATHER_ROWS_F64, () if big else X_ROWS_ICHUNK_F64)}
        cells = [(n, dtype) for dtype, (xg, xi) in
                 ((torch.float32, lists[4]), (torch.float64, lists[8]))
                 for n in sorted(set(xg) | set(xi))]
        for n_ind, dtype in cells:
            gn, _, maf = _tiled_panel(4_096, n_ind, 13, dev)
            gn, maf = gn.to(dtype), maf.to(dtype)
            esz = gn.element_size()
            tol = F32_TOL if esz == 4 else F64_TOL
            row, runs = {}, {}
            fns = {"rows": pmod.pair_em_rows}
            if n_ind in lists[esz][0]:
                fns["gather"] = pmod.pair_em_gather
            if n_ind in lists[esz][1]:
                # the cluster body at the rule's C, and at C = 1 and 2
                # where one block an SM holds their slices
                c_rule = pmod.ichunk_cluster(n_ind, esz, dev)
                room = pmod._sm_bytes(dev) - pmod._CLUSTER_RESERVED
                for c in sorted({1, 2, c_rule}):
                    if c == c_rule or pmod.cluster_smem(n_ind, c,
                                                        esz) <= room:
                        fns[f"ichunk C={c}"] = functools.partial(
                            _ichunk_at, c)
            for name, fn in fns.items():
                try:
                    ms, runs[name] = _time(lambda: fn(gn, sidx, maf, False))
                    row[name] = round(ms, 3)
                except ValueError as e:
                    if name != "rows" or "shared memory" not in str(e):
                        raise
                    row[name] = None
            first = next(iter(runs.values()))
            for name, o in runs.items():
                _check(o, first, tol, f"I = {n_ind} {name}", quiet=True)
            row["pick"] = pmod.pick_gather_kernel(n_ind, esz, dev,
                                                  n_pairs)
            out[f"{esz * 8}-bit P={n_pairs} I={n_ind}"] = row
            del gn, maf, runs, first
        del sidx
    print("  crossovers, random pairs of 4,096 sites (tiled panel), ms (None: "
          "refused) and the ladder's pick: " + json.dumps(out) + f" [{card}]")
    return out


def phase_gather_design(card):
    sass = _sass_lines(GATHER_KERNELS_SASS)
    _group_sweep(card, sass)
    _rows_sweep(card, sass)
    _rows_tail(card)
    _cluster_sweep(card)
    _edge_cases(card)
    _crossovers(card)
    _pairs_sweep(card)


# ---------------------------------------------------------------- phase 4

def _cli(argv):
    """The port's CLI in-process; returns (rc, captured stderr)."""
    from ngsld_tpu_torch.cli import main
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


@contextlib.contextmanager
def _env(**kv):
    """Set environment variables for the length of a block (None unsets)."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _read_lines(path):
    with open(path) as fh:
        return fh.read().splitlines()


def phase_slice(tmp):
    from ngsld_tpu_torch.kernels import pair_em as pmod
    from ngsld_tpu_torch.kernels import strip_em as smod

    def counts():     # the gather sweep's three kernels, the strip kernels
        return dict(pair_em=pmod.LAUNCHES, pair_em_rows=pmod.LAUNCHES_ROWS,
                    pair_em_ichunk=pmod.LAUNCHES_ICHUNK,
                    strip=smod.LAUNCHES + smod.LAUNCHES_STREAM)
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    from ngsld_tpu_torch.utils.simulate import simulate, write_all
    sim = simulate(n_ind=24, n_sites=2000, seed=7)
    files = write_all(sim, os.path.join(tmp, "slice"))
    common = ["--n_ind", "24", "--n_sites", "2000", "--pos", files["pos"],
              "--max_kb_dist", "10", "--min_maf", "0.05", "--extend_out"]
    beagle = ["--geno", files["beagle"], "--probs"]
    variants = {
        "default": beagle,
        "ignore_miss_data": beagle + ["--ignore_miss_data"],
        "rnd_sample": beagle + ["--rnd_sample", "0.5", "--seed", "12345"],
        "binary": ["--geno", files["glf"], "--log_scale"],
    }
    for name, inp in variants.items():
        s_out = os.path.join(tmp, f"strict_{name}.ld")
        t0 = time.perf_counter()
        rc, err = _cli(inp + common + ["--engine", "strict", "--out", s_out])
        t_strict = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: strict rc {rc}\n{err}")
        s_lines = _read_lines(s_out)
        # each variant through the gather sweep (NGSLD_BLOCK_STRIP=0) and
        # through the strip sweep (=1); --precision auto is f32 on the card
        for sweep, flag in (("gather", "0"), ("strip", "1")):
            r_out = os.path.join(tmp, f"port_{name}_{sweep}.ld")
            c0 = counts()
            t0 = time.perf_counter()
            with _env(NGSLD_BLOCK_STRIP=flag):
                rc, err = _cli(inp + common + ["--out", r_out])
            t_port = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{name}/{sweep}: port rc {rc}\n{err}")
            if ENGINE_TAG not in err:
                raise AssertionError(f"{name}/{sweep}: engine did not "
                                     f"report a cuda device:\n{err[:2000]}")
            r_lines = _read_lines(r_out)
            ran = {k: v - c0[k] for k, v in counts().items()}
            if sweep == "gather":
                # the run's pairs fill less than one block: one launch, of
                # the kernel the ladder picks for it
                n_rows = len(r_lines) - 1
                want = {k: 0 for k in ran}
                want[_GATHER_COUNT[pmod.pick_gather_kernel(
                    24, 4, "cuda:0", n_rows)]] = 1
                ok = n_rows < MAIN_P and ran == want
            else:
                want = "strip kernels only"
                ok = ran["strip"] >= 1 and sum(ran.values()) == ran["strip"]
            if not ok:
                raise AssertionError(f"{name}/{sweep}: launches {ran}, "
                                     f"expected {want}")
            cmp_vs_strict(s_lines, r_lines, 1000)
            print(f"  {name}/{sweep}: {len(r_lines) - 1} rows, pair set "
                  f"byte-exact, f32 contract held; launches "
                  + json.dumps({k: v for k, v in ran.items() if v})
                  + f"; port {t_port:.3f} s, strict {t_strict:.3f} s")

    # the same variants on a band wide enough that the one block reaches
    # the lane groups (GATHER_MIN_PAIRS; the narrow band's block goes to the
    # rows kernel): pair_em.cu on every variant, a row sample held against
    # strict recomputes; min_maf 0, so that the plan gives the pair count
    wide = ["--n_ind", "24", "--n_sites", "2000", "--pos", files["pos"],
            "--max_kb_dist", "0", "--max_snp_dist", str(SLICE_BAND),
            "--min_maf", "0", "--extend_out", "--verbose", "0"]
    for name, inp in variants.items():
        argv = inp + wide
        pars, blocks = _plan_blocks(argv, files["pos"], 2000)
        want = _ladder_launches(24, 4, blocks)
        if want["pair_em"] != len(blocks):
            raise AssertionError(f"wide/{name}: blocks of {blocks} pairs do "
                                 "not all reach the lane groups")
        sink, wall, launches, _, _ = _counted_run(argv, tmp, sum(blocks),
                                                  "0")
        if launches != want:
            raise AssertionError(f"wide/{name}: launches {launches}, "
                                 f"expected {want}")
        n_rows = _sample_vs_strict(sink, sim, pars)
        print(f"  {name}/gather, band {SLICE_BAND}: {sum(blocks)} rows in "
              f"{len(blocks)} block(s) of {blocks} pairs, pair_em launches "
              f"{launches['pair_em']} = blocks, no other kernel; {n_rows} "
              f"sampled rows within the f32 contract of strict; port "
              f"{wall:.3f} s")

    # the gz-text input through the streamed text loader, and through
    # strict.read_geno (NGSLD_NO_FASTTEXT=1): the same bytes
    timings = os.path.join(tmp, "slice_timings.json")
    outs = {}
    for name, knob in (("loader", None), ("read_geno", "1")):
        out = os.path.join(tmp, f"text_{name}.ld")
        with _env(NGSLD_NO_FASTTEXT=knob, NGSLD_TIMINGS_JSON=timings,
                  NGSLD_BLOCK_STRIP="0"):
            rc, err = _cli(beagle + common + ["--out", out])
        with open(timings) as fh:
            streamed = json.load(fh)["counters"].get("gl_streamed", 0)
        if rc != 0 or streamed != (1 if knob is None else 0):
            raise AssertionError(f"text {name}: rc {rc}, gl_streamed "
                                 f"{streamed}\n{err[-2000:]}")
        with open(out, "rb") as fh:
            outs[name] = fh.read()
    if outs["loader"] != outs["read_geno"] or outs["loader"].count(b"\n") < 1000:
        raise AssertionError("gz-text: the streamed loader's rows differ "
                             "from the strict reader's")
    print(f"  gz-text 24 x 2,000: {outs['loader'].count(b'\n') - 1} rows "
          "through the streamed text loader, byte-equal to the run through "
          "strict.read_geno")

    # all-pairs fixture: flat and compact strip emission, byte-equal
    files = write_all(simulate(n_ind=12, n_sites=384, seed=9,
                               contig_kb=500.0), os.path.join(tmp, "allp"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "12",
            "--n_sites", "384", "--pos", files["pos"], "--max_kb_dist", "0",
            "--extend_out", "--verbose", "0"]
    outs = {}
    for mode in ("compact", "flat"):
        out = os.path.join(tmp, f"allp_{mode}.ld")
        n0 = smod.LAUNCHES
        with _env(NGSLD_BLOCK_STRIP="1", NGSLD_STRIP_EMIT=mode):
            rc, err = _cli(argv + ["--out", out])
        if rc != 0 or smod.LAUNCHES <= n0:
            raise AssertionError(f"all-pairs {mode}: rc {rc}, strip launches "
                                 f"+{smod.LAUNCHES - n0}\n{err}")
        with open(out, "rb") as fh:
            outs[mode] = fh.read()
    if outs["flat"] != outs["compact"] or \
            outs["flat"].count(b"\n") != 1 + 384 * 383 // 2:
        raise AssertionError("all-pairs: flat and compact emission differ, "
                             "or a row is missing")
    print(f"  all-pairs 12 x 384: {outs['flat'].count(b'\n') - 1} rows, "
          "flat emission byte-equal to compact")


# ---------------------------------------------------------------- phase 5

class _CountingStdout:
    """Stands in for sys.stdout: counts the rows the CLI prints and keeps
    the header plus every `keep_every`-th row for a spot check."""

    def __init__(self, keep_every, pairs=False):
        self.buffer = self
        self.keep_every = keep_every
        self.n_lines = 0
        self.n_bytes = 0
        self.kept = []
        self._tail = b""
        # pairs=True: a digest of every row's first two columns, the pair
        # set in its order
        self.pairs = hashlib.sha256() if pairs else None

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        self.n_bytes += len(data)
        buf = self._tail + data
        lines = buf.split(b"\n")
        self._tail = lines.pop()
        for ln in lines:
            if self.n_lines % self.keep_every == 0:
                self.kept.append(ln.decode())
            if self.pairs is not None:
                self.pairs.update(b"\t".join(ln.split(b"\t", 2)[:2])
                                  + b"\n")
            self.n_lines += 1
        return len(data)

    def flush(self):
        pass


def _plan_blocks(argv, pos, n_sites, first=None):
    """The host plan a run must emit at min_maf 0 (the MAF filter passes
    all): (pars, each gather block's pair count); with a list `first`, the
    first block is appended to it."""
    from ngsld_tpu_torch.cli import params_from_args
    from ngsld_tpu_torch.plan.band import iter_pair_blocks
    from ngsld_tpu_torch.strict import read_pos
    pars = params_from_args(argv)
    pos_dist, _ = read_pos(pos, False, n_sites)
    sizes = []
    for blk in iter_pair_blocks(pars, np.zeros(n_sites), pos_dist,
                                block_pairs=pars.chunk_pairs):
        if first is not None and not sizes:
            first.append(blk)
        sizes.append(len(blk.s1))
    return pars, sizes


def _plan(argv, pos, n_sites):
    """(pars, pairs, gather blocks) of _plan_blocks."""
    pars, sizes = _plan_blocks(argv, pos, n_sites)
    return pars, sum(sizes), len(sizes)


def _ladder_launches(n_ind, esz, sizes):
    """The launches (in _counted_run's keys) a gather sweep over blocks of
    these pair counts makes: one a block, of the kernel the ladder picks."""
    from ngsld_tpu_torch.kernels import pair_em as pmod
    want = dict(_NO_LAUNCHES)
    for n_pairs in sizes:
        want[_GATHER_COUNT[pmod.pick_gather_kernel(n_ind, esz, "cuda:0",
                                                   n_pairs)]] += 1
    return want


def _zero_launches():
    from ngsld_tpu_torch.kernels import pair_em as pmod
    from ngsld_tpu_torch.kernels import strip_em as smod
    pmod.LAUNCHES = pmod.LAUNCHES_ROWS = pmod.LAUNCHES_ICHUNK = 0
    pmod.LAUNCHES_ICHUNK_STREAM = pmod.LAUNCHES_OPTS = 0
    smod.LAUNCHES = smod.LAUNCHES_STREAM = smod.LAUNCHES_EPS = 0


def _read_launches():
    """The EM kernels' launches: launch_counts() without gl_narrow, the
    binary loader's kernel (one a slab, which phase 12 counts)."""
    from ngsld_tpu_torch.kernels import launch_counts
    launches = launch_counts()
    del launches["gl_narrow"]
    return launches


def _counted_run(argv, tmp, n_pairs, strip, n_keep=1000, pairs=False):
    """One run of the port's CLI with rows to a counting sink, the kernels'
    launch counts set to 0 just before it and read just after. strip:
    "1"/"0" forces the sweep, None leaves the engine's auto rule; pairs:
    the sink keeps a digest of the pair set."""
    timings = os.path.join(tmp, "timings.json")
    sink = _CountingStdout(keep_every=max(1, n_pairs // n_keep), pairs=pairs)
    real_stdout = sys.stdout
    _zero_launches()    # the path's counts start here
    t0 = time.perf_counter()
    try:
        sys.stdout = sink
        with _env(NGSLD_TIMINGS_JSON=timings, NGSLD_BLOCK_STRIP=strip):
            rc, err = _cli(argv)   # its rows are on the host: no sync needed
    finally:
        sys.stdout = real_stdout
    wall = time.perf_counter() - t0
    launches = _read_launches()
    if rc != 0:
        raise AssertionError(f"run rc {rc}\n{err[-4000:]}")
    if sink._tail:
        raise AssertionError("output does not end with a newline")
    if sink.n_lines != 1 + n_pairs:
        raise AssertionError(f"{sink.n_lines} lines, expected 1 + {n_pairs}")
    with open(timings) as fh:
        tim = json.load(fh)
    return sink, wall, launches, tim, err


_NO_LAUNCHES = dict(pair_em=0, strip_em=0, pair_em_rows=0, pair_em_ichunk=0,
                    pair_em_ichunk_stream=0,
                    strip_em_stream=0)
# the ladder's rungs by the name of their launch count
_GATHER_COUNT = {"gather": "pair_em", "rows": "pair_em_rows",
                 "ichunk": "pair_em_ichunk"}
# the kernels line's names by the name of their launch count
_RING_COUNT = {"pair_em_gather": "pair_em", "strip_em": "strip_em",
               "strip_em_stream": "strip_em_stream",
               "pair_em_rows": "pair_em_rows",
               "pair_em_ichunk": "pair_em_ichunk"}


def _sample_vs_strict(sink, sim, pars, f64=False):
    """The sink's kept rows (about 1,000, evenly spaced) against strict
    recomputes of the same pairs, under the f32 column contract (f64: the
    f64 one, compare)."""
    from ngsld_tpu_torch.io.writer import RowWriter
    from ngsld_tpu_torch.refine import StrictRefiner
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict, compare
    labels = [f"{c}:{p}" for c, p in zip(sim.chrom, sim.pos)]
    site = {lab: i for i, lab in enumerate(labels)}
    rows = sink.kept[1:]
    s1 = np.array([site[r.split("\t")[0]] for r in rows], np.int64)
    s2 = np.array([site[r.split("\t")[1]] for r in rows], np.int64)
    chrom = np.array(sim.chrom)
    dist = np.where(chrom[s1] == chrom[s2],
                    (sim.pos[s2] - sim.pos[s1]).astype(np.float64), np.inf)
    ref = StrictRefiner(pars).refine_columns(s1, s2)
    data = RowWriter(None, labels, True).format_block(
        s1, s2, dist, ref["r2p"], ref["D"], ref["Dp"], ref["r2"],
        n_used=ref["n_used"], maf1=ref["maf1"], maf2=ref["maf2"],
        hap=ref["f"], hmaf1=ref["hmaf1"], hmaf2=ref["hmaf2"],
        chi2=ref["chi2"], n_iter=ref["n_iter"])
    s_lines = [sink.kept[0]] + data.decode().splitlines()
    if f64:
        compare(s_lines, sink.kept)
    else:
        cmp_vs_strict(s_lines, sink.kept, 100)
    return len(rows)


def phase_real(tmp, card):
    import dataclasses

    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    from ngsld_tpu_torch.utils.simulate import (simulate, write_beagle,
                                                write_pos)

    n_ind, n_sites = REAL_I, REAL_S
    t0 = time.perf_counter()
    # the 25k fixture of bench.py (_fixture_25k: contig_kb=500), as beagle,
    # and its first 10,000 sites as a second pair of files
    sim = simulate(n_ind=n_ind, n_sites=n_sites, seed=17, contig_kb=500.0)
    cut = dataclasses.replace(
        sim, n_sites=GATHER_S, genos=sim.genos[:GATHER_S],
        gl=sim.gl[:GATHER_S], chrom=sim.chrom[:GATHER_S],
        pos=sim.pos[:GATHER_S])
    d = os.path.join(tmp, "real")
    os.makedirs(d, exist_ok=True)
    geno, pos = os.path.join(d, "sim.beagle.gz"), os.path.join(d, "sim.pos")
    geno_c, pos_c = os.path.join(d, "cut.beagle.gz"), os.path.join(d, "cut.pos")
    for sm, g, p in ((sim, geno, pos), (cut, geno_c, pos_c)):
        write_beagle(sm, g)
        write_pos(sm, p)
    print(f"  fixtures written in {time.perf_counter() - t0:.3f} s")

    def argv_for(g, p, n):
        return ["--geno", g, "--probs", "--n_ind", str(n_ind), "--n_sites",
                str(n), "--pos", p, "--max_kb_dist", "100", "--extend_out",
                "--verbose", "2"]

    # ---- the dense main path at full width: the engine's auto rule must
    # take the strip sweep (NGSLD_BLOCK_STRIP unset)
    argv = argv_for(geno, pos, n_sites)
    pars, n_pairs, n_blocks = _plan(argv, pos, n_sites)
    print(f"  plan: {n_pairs} pairs ({n_blocks} gather blocks)")
    sink, wall, launches, tim, err = _counted_run(argv, tmp, n_pairs, None)
    chunks = tim["counters"]["blocks_computed"]
    if "==> strip sweep:" not in err:
        raise AssertionError("the auto rule did not take the strip sweep:\n"
                             + err[-3000:])
    if launches != dict(_NO_LAUNCHES, strip_em=chunks) or chunks < 1:
        raise AssertionError(f"launches {launches} for {chunks} strip chunks")
    n_rows = _sample_vs_strict(sink, sim, pars)
    plan_line = [ln for ln in err.splitlines() if "==> strip sweep:" in ln][0]
    print(f"  {plan_line.strip()}")
    print(f"  strip: {sink.n_lines - 1} rows ({sink.n_bytes} bytes), "
          f"{launches['strip_em']} strip launches = chunks, 0 gather "
          f"launches, {n_rows} sampled rows within the f32 contract of "
          "strict")
    print(f"  wall {wall:.3f} s, {n_pairs / wall:.4e} pairs/s [{card}]")
    print("  phases: " + json.dumps(tim["phases"]))
    print("  stages: " + json.dumps(tim["stages"]))
    print("  counters: " + json.dumps(tim["counters"]))
    real = dict(strip_launches=launches["strip_em"], wall=wall, pairs=n_pairs,
                argv=argv, sim=sim, pars=pars)

    # ---- the gather path, driven again at 10,000 sites of the same
    # fixture, and the strip sweep on the same sites beside it
    argv_c = argv_for(geno_c, pos_c, GATHER_S)
    pars_c, sizes_c = _plan_blocks(argv_c, pos_c, GATHER_S)
    n_pairs_c, n_blocks_c = sum(sizes_c), len(sizes_c)
    sink, wall_g, launches, tim, _ = _counted_run(argv_c, tmp, n_pairs_c, "0")
    # every block large enough for the lane groups, so the ladder gives
    # them all to pair_em.cu
    want = _ladder_launches(REAL_I, 4, sizes_c)
    if launches != want or want["pair_em"] != n_blocks_c:
        raise AssertionError(f"launches {launches} for {n_blocks_c} gather "
                             f"blocks of {sizes_c} pairs; expected {want}")
    n_rows = _sample_vs_strict(sink, cut, pars_c)
    print(f"  gather, {GATHER_S} sites: {n_pairs_c} rows, "
          f"{launches['pair_em']} gather launches = blocks, 0 strip "
          f"launches, {n_rows} sampled rows within the f32 contract of "
          f"strict; wall {wall_g:.3f} s [{card}]")
    real["gather_launches"] = launches["pair_em"]
    real["gather_blocks"] = n_blocks_c
    # phase 8 runs this leg again, with and without --profile
    real["gather_argv"] = argv_c[:-2] + ["--verbose", "0"]
    outs = {}
    for sweep, flag in (("gather", "0"), ("strip", "1")):
        out = os.path.join(d, f"cut_{sweep}.ld")
        with _env(NGSLD_BLOCK_STRIP=flag):
            rc, err = _cli(argv_c[:-2] + ["--verbose", "0", "--out", out])
        if rc != 0:
            raise AssertionError(f"{sweep} at {GATHER_S} sites: rc {rc}\n"
                                 + err[-3000:])
        outs[sweep] = _read_lines(out)
    # identical pair set and order, values within the f32 contract: rows
    # that are byte-equal hold both; the rest go through cmp_vs_strict,
    # which holds their first three columns byte-equal
    g, st = outs["gather"], outs["strip"]
    if len(g) != 1 + n_pairs_c or len(st) != len(g) or g[0] != st[0]:
        raise AssertionError(f"gather {len(g)} lines, strip {len(st)}, plan "
                             f"{n_pairs_c} pairs")
    diff = [(a, b) for a, b in zip(g, st) if a != b]
    cmp_vs_strict(g[:1] + [a for a, _ in diff], st[:1] + [b for _, b in diff],
                  0)
    print(f"  gather vs strip, {GATHER_S} sites: {n_pairs_c} rows, same pairs "
          f"in the same order, {n_pairs_c - len(diff)} rows byte-equal, the "
          f"other {len(diff)} within the f32 contract")
    return real


# --------------------------------------------------------------- phase 5b

def _write_tiled_glf(sim, n_ind, path):
    """The panel's GLs tiled to n_ind individuals, as a binary file of
    log-scale doubles (site-major, then individual), written in slabs."""
    reps = -(-n_ind // sim.n_ind)
    with np.errstate(divide="ignore"):
        lg = np.log(sim.gl)
    lg[np.isneginf(lg)] = -1e15
    with open(path, "wb") as fh:
        for s0 in range(0, sim.n_sites, 256):
            np.tile(lg[s0:s0 + 256], (1, reps, 1))[:, :n_ind] \
                .astype(np.float64).tofile(fh)


def phase_large(tmp, card):
    from ngsld_tpu_torch.utils.simulate import simulate, write_pos

    t0 = time.perf_counter()
    d = os.path.join(tmp, "large")
    os.makedirs(d, exist_ok=True)
    sims, pos, glf = {}, {}, {}
    for key, n_sites, seed, cohorts in ((BIG_S, BIG_S, 19, (BIG_I, ROWS_I)),
                                        (FULL_S, FULL_S, 23, (FULL_I,))):
        sims[key] = simulate(n_ind=PANEL_I, n_sites=n_sites, seed=seed,
                             contig_kb=500.0)
        pos[key] = os.path.join(d, f"sim_{key}.pos")
        write_pos(sims[key], pos[key])
        for n in cohorts:
            glf[n] = os.path.join(d, f"tiled_{key}_{n}.glf")
            _write_tiled_glf(sims[key], n, glf[n])
    print(f"  fixtures written in {time.perf_counter() - t0:.3f} s ("
          + ", ".join(f"{os.path.getsize(p)}" for p in glf.values())
          + " bytes of doubles)")

    def argv_for(n_ind, key, band, extra):
        return ["--geno", glf[n_ind], "--log_scale", "--n_ind", str(n_ind),
                "--n_sites", str(key), "--pos", pos[key], "--max_kb_dist",
                "0", "--max_snp_dist", str(band), "--extend_out", *extra,
                "--verbose", "2"]

    def sampled(rate):
        return ["--rnd_sample", str(rate), "--seed", "12345"]

    out = {}
    for name, n_ind, key, band, extra, kernel, per in (
            ("dense", BIG_I, BIG_S, 128, [], "strip_em_stream", "chunks"),
            ("sampled", BIG_I, BIG_S, 128, sampled(0.1), "pair_em_ichunk",
             "blocks"),
            ("rows", ROWS_I, BIG_S, 128, sampled(0.1), "pair_em_rows",
             "blocks"),
            # the rows rung on full default blocks
            ("rows, full blocks", FULL_I, FULL_S, FULL_BAND,
             sampled(FULL_RATE), "pair_em_rows", "blocks")):
        argv = argv_for(n_ind, key, band, extra)
        head = []
        pars, sizes = _plan_blocks(argv, pos[key], key, first=head)
        n_pairs, n_blocks = sum(sizes), len(sizes)
        if name == "rows, full blocks" and n_pairs < pars.chunk_pairs:
            raise AssertionError(f"{name}: {n_pairs} pairs fill no block of "
                                 f"{pars.chunk_pairs}")
        sink, wall, launches, tim, err = _counted_run(
            argv, tmp, n_pairs, None, n_keep=200, pairs=name == "dense")
        units = tim["counters"]["blocks_computed"]
        if launches != dict(_NO_LAUNCHES, **{kernel: units}) or units < 1 \
                or (per == "blocks" and units != n_blocks):
            raise AssertionError(f"{name}: launches {launches} for {units} "
                                 f"{per} ({n_blocks} planned blocks); "
                                 f"expected only {kernel}")
        if tim["counters"].get("gl_streamed") != 1 or \
                "  gl stream+upload" not in tim["phases"] or \
                "Reading data from file" in tim["phases"]:
            raise AssertionError(f"{name}: the streamed loader did not feed "
                                 f"the run: {tim['phases']}")
        if (name == "dense") != ("streamed kernel" in err):
            raise AssertionError(f"{name}: wrong sweep:\n{err[-3000:]}")
        n_rows = _sample_vs_strict(sink, sims[key], pars)
        up, sweep = tim["phases"]["  gl stream+upload"], \
            tim["phases"]["compute: banded pair sweep"]
        print(f"  {name}, {key} x {n_ind}: {n_pairs} rows (band "
              f"{band}{', ' + ' '.join(extra[:2]) if extra else ''}), "
              f"{launches[kernel]} {kernel} launches = {per} (blocks of "
              f"{pars.chunk_pairs} pairs), no other kernel, the streamed "
              f"loader fed the run, {n_rows} sampled rows within the f32 "
              "contract of strict")
        print(f"    wall {wall:.3f} s, {n_pairs / wall:.4e} pairs/s; gl "
              f"stream+upload {up:.3f} s ({up / wall:.4f} of the wall), sweep "
              f"{sweep:.3f} s [{card}]")
        print("    phases: " + json.dumps(tim["phases"]))
        print("    stages: " + json.dumps(tim["stages"]))
        print("    counters: " + json.dumps(tim["counters"]))
        out[name] = launches[kernel]
        if name == "dense":
            # phase 7's ring leg R2 runs the same file and flags
            out["dense_run"] = dict(sink=sink, sim=sims[key], argv=argv,
                                    pars=pars, n_pairs=n_pairs,
                                    glf=glf[n_ind], pos=pos[key])
        if name == "rows, full blocks":
            _rows_full_block(head[0], n_ind, key, card)
    # phase 9 runs the 2,048-site files again on two ranks
    out.update(argv_for=argv_for, sims=sims, pos=pos)
    return out


def _rows_full_block(blk, n_ind, n_sites, card):
    """pair_em_rows at the full-block leg's shape: that run's first planned
    block (a full --chunk_pairs block of banded, sampled pairs) over the
    panel tiled to n_ind individuals. Timed, two launches bit-equal, every
    ROWS_FULL_STRIDE-th pair held against the plain version (a slice keeps
    the plain version's run to a second or so)."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    sidx = torch.from_numpy(np.stack([blk.s1, blk.s2]).astype(np.int32)) \
        .to(dev)
    P = sidx.shape[1]
    if pmod.pick_gather_kernel(n_ind, 4, dev, P) != "rows":
        raise AssertionError(f"the ladder does not give {P} x {n_ind} to rows")
    gn, _, maf = _tiled_panel(n_sites, n_ind, 29, dev)
    ms, out = _time(lambda: pmod.pair_em_rows(gn, sidx, maf, False))
    if not _same(out, pmod.pair_em_rows(gn, sidx, maf, False)):
        raise AssertionError("full block: two launches differ")
    part = sidx[:, ::ROWS_FULL_STRIDE].contiguous()
    plain_ms, plain = _time(
        lambda: pmod.pair_em_rows_ref(gn, part, maf, False), reps=1,
        warm=False)
    err, _ = _check(tuple(t[::ROWS_FULL_STRIDE] for t in out), plain,
                    F32_TOL, f"pair_em_rows full block P={P} I={n_ind}",
                    quiet=True)
    b_ms = _gather_bound(gn, sidx, maf, out[1])[0]
    print(f"  pair_em_rows f32 P={P} I={n_ind} (the full-block leg's first "
          f"block, banded, sampled; tiled panel): {ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_ms / ms:.4f} of it); two launches bit-equal; "
          f"{part.shape[1]} pairs (one in {ROWS_FULL_STRIDE}) against the "
          f"plain version ({plain_ms:.3f} ms): nIter and n_used exact, "
          f"max|df| {err:.3e} (tol {F32_TOL}) [{card}]")
    del gn, maf, sidx, out, plain


# ---------------------------------------------------------------- phase 6

def phase_idle(tmp, card, real):
    """The phase 5 strip run again, under torch.profiler, rows to a file:
    device busy time = the union of the trace's kernel/memcpy/memset
    intervals, idle share = 1 - busy / wall."""
    from ngsld_tpu_torch.utils.devtrace import profile_busy
    argv = real["argv"]
    argv = argv[:argv.index("--verbose")] + [
        "--verbose", "0", "--out", os.path.join(tmp, "real", "prof.ld")]
    (rc, err), wall, busy, by_cat, by_kernel = profile_busy(
        lambda: _cli(argv))
    if rc != 0:
        raise AssertionError(f"profiled run rc {rc}\n{err[-4000:]}")
    em = sum(v for k, v in by_kernel.items() if "strip_em_kernel" in k)
    if not em > 0:
        raise AssertionError("no strip_em_kernel interval in the trace")
    print(f"  wall {wall:.3f} s, device busy {busy:.6f} s (union of "
          f"intervals), idle share {1 - busy / wall:.6f}; strip_em_kernel "
          f"{em:.6f} s [{card}]")
    print("  device s by category: " + json.dumps(by_cat))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print("  top kernels (s): " + json.dumps(dict(top)))
    return dict(wall=wall, busy=busy)


# ---------------------------------------------------------------- phase 7

RING_RATE = 0.01                 # R1: all pairs of the 25k fixture at 1%
RING_STEP_PAT = r"==> ring step \(sub-ring \d+, t \d+\): (\d+) rows"
RING_PEAK_PAT = r"peak device memory (\d+) bytes"


def _file_run(argv, out, profile=False):
    """One run of the port's CLI with rows to the file `out`, the kernels'
    launch counts set to 0 just before it and read just after. profile:
    the run under torch.profiler (utils/devtrace.profile_busy). Returns
    (wall, launches, timings, stderr, (busy, by_cat, by_kernel) or
    None)."""
    from ngsld_tpu_torch.utils.devtrace import profile_busy
    timings = out + ".timings.json"
    trace = None
    _zero_launches()    # the path's counts start here
    with _env(NGSLD_TIMINGS_JSON=timings):
        if profile:
            (rc, err), wall, busy, by_cat, by_kernel = profile_busy(
                lambda: _cli(argv + ["--out", out]))
            trace = (busy, by_cat, by_kernel)
        else:
            t0 = time.perf_counter()
            rc, err = _cli(argv + ["--out", out])
            wall = time.perf_counter() - t0
    launches = _read_launches()
    if rc != 0:
        raise AssertionError(f"run rc {rc}\n{err[-4000:]}")
    with open(timings) as fh:
        tim = json.load(fh)
    return wall, launches, tim, err, trace


def _ring_pieces(err, chunk):
    """The gather stepper's pieces, from the log's step lines: each step's
    live rows cut into pieces of at most `chunk` pairs."""
    import re
    pieces = []
    for m in re.finditer(RING_STEP_PAT, err):
        c = int(m.group(1))
        pieces += [chunk] * (c // chunk) + ([c % chunk] if c % chunk else [])
    return pieces


def _ring_strip_check(tim, launches, err, kernel):
    """A strip-stepper run: one launch of `kernel` a ring step (the log's
    count), no other kernel."""
    steps = tim["counters"].get("ring_steps", 0)
    if "ring: strip-kernel stepper" not in err or steps < 1 or \
            launches != dict(_NO_LAUNCHES, **{kernel: steps}):
        raise AssertionError(f"launches {launches} for {steps} ring steps; "
                             f"expected only {kernel}, once a step\n"
                             + err[-3000:])
    return steps


def _ring_gather_check(n_ind, esz, chunk, launches, err):
    """A gather-stepper run: one launch a piece, of the rung the ladder
    picks for that piece."""
    pieces = _ring_pieces(err, chunk)
    want = _ladder_launches(n_ind, esz, pieces)
    if "ring: gather stepper" not in err or not pieces or launches != want:
        raise AssertionError(f"launches {launches} for pieces {pieces}; "
                             f"expected {want}\n" + err[-3000:])
    return pieces


def _ring_bounds(card):
    """The strip kernels on ring steps, against their plain versions on the
    same inputs: the anchor tables of the whole block, the partner tables
    of one sub-block (views of the resident tables), the band bounds
    shifted to the sub-block's origin, lo = a + 1 - org and hi = hi - org:
    lo runs negative and hi below 0 (sub-ring 1) and past B_sub (sub-ring
    0), which the block engine never passes. Every cell: nIter and n_used
    exact, f within F32_TOL, r2p within R2P_TOL, dead cells at f0."""
    import torch
    from ngsld_tpu_torch.kernels import strip_em as smod
    from ngsld_tpu_torch.plan.strips import TA, TB
    dev = torch.device("cuda", 0)
    for n_ind, B, streamed in ((100, 1_024, False), (300, 512, True)):
        if smod.strip_streamed(n_ind, dev) != streamed:
            raise AssertionError(f"I = {n_ind}: streamed kernel "
                                 f"{not streamed}, expected {streamed}")
        n, B_sub = B - 16, B // 2          # 16 pad sites, two sub-rings
        gl, eg, maf = _sim_tables(n_ind, n, 31)
        rng = np.random.default_rng(n_ind)
        hip = np.zeros(B, np.int64)
        hip[:n] = np.minimum(np.arange(n) + rng.integers(1, B, n), n)
        okp = np.zeros(B, np.float32)
        okp[:n] = rng.random(n) < 0.9
        f32 = np.float32
        mafp = np.pad(maf.astype(f32), (0, B - n), constant_values=0.5)
        gn = torch.from_numpy(np.pad(gl.astype(f32), ((0, B - n), (0, 0),
                                                      (0, 0)),
                                     constant_values=1.0 / 3.0)).to(dev)
        egd = torch.from_numpy(np.pad(eg.astype(f32),
                                      ((0, B - n), (0, 0)))).to(dev)
        ga, gb, ea, eb = smod.strip_tables(
            gn, egd, n_ind, i_align=smod.strip_i_align(n_ind, dev))
        maf_d, ok_d = torch.from_numpy(mafp).to(dev), \
            torch.from_numpy(okp).to(dev)
        nk, nj = B // TA, B_sub // TB
        ta = np.repeat(np.arange(nk, dtype=np.int32), nj)
        tb = np.tile(np.arange(nj, dtype=np.int32), nk)
        for si in (0, 1):
            org = si * B_sub
            lo = np.arange(1, B + 1) - org
            hi = hip - org
            sl = slice(org, org + B_sub)
            args = (ga, gb[:, :, sl], ea, eb[:, sl], maf_d, maf_d[sl],
                    torch.from_numpy(lo.astype(np.int32)).to(dev),
                    torch.from_numpy(hi.astype(np.int32)).to(dev), ok_d,
                    ok_d[sl], torch.from_numpy(ta).to(dev),
                    torch.from_numpy(tb).to(dev))
            kern = smod.strip_em(*args, n_ind=n_ind)
            ref = smod.strip_em_stream_ref if streamed else smod.strip_em_ref
            plain = ref(*args, n_ind=n_ind)
            A = ta.astype(np.int64)[:, None, None] * TA \
                + np.arange(TA)[None, :, None]
            b = tb.astype(np.int64)[:, None, None] * TB \
                + np.arange(TB)[None, None, :]
            live = (b >= lo[A]) & (b < hi[A]) & (okp[A] > 0) \
                & (okp[org + b] > 0)
            dead = ~live
            ma = mafp.astype(np.float64)[np.broadcast_to(A, live.shape)[dead]]
            mb = mafp.astype(np.float64)[
                org + np.broadcast_to(b, live.shape)[dead]]
            f0 = np.stack([(1 - ma) * (1 - mb), (1 - ma) * mb,
                           ma * (1 - mb), ma * mb], axis=1).astype(f32)
            where = (f"lo down to {lo.min()}, hi {hi[:n].min()}..{hi.max()}"
                     f" against B_sub {B_sub}")
            _check_strip(kern, plain, live, f0,
                         f"{'strip_em_stream' if streamed else 'strip_em'} "
                         f"ring step I={n_ind}, {len(ta)} tiles, sub-ring "
                         f"{si} ({where})")
            if si == 1 and not ((lo < 0).any() and (hi < 0).any()):
                raise AssertionError("sub-ring 1: no negative bounds")
            if si == 0 and not (hi > B_sub).any():
                raise AssertionError("sub-ring 0: no bound past B_sub")
        del ga, gb, ea, eb, gn, egd


def _r1(tmp, card, acc):
    """R1: the 25k x 100 fixture of phase 5, all pairs sampled at 1%,
    through the ring (the strip stepper, strip_em.cu once a step) under
    torch.profiler, and through the block engine (the gather sweep: the
    sampled plan's effective use is under the strip sweep's threshold)."""
    import types

    from ngsld_tpu_torch.cli import params_from_args
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    from ngsld_tpu_torch.utils.simulate import (simulate, write_beagle,
                                                write_pos)
    sim = simulate(n_ind=REAL_I, n_sites=REAL_S, seed=17, contig_kb=500.0)
    d = os.path.join(tmp, "real")
    os.makedirs(d, exist_ok=True)
    geno, pos = os.path.join(d, "sim.beagle.gz"), os.path.join(d, "sim.pos")
    if not (os.path.exists(geno) and os.path.exists(pos)):
        write_beagle(sim, geno)
        write_pos(sim, pos)
    argv = ["--geno", geno, "--probs", "--n_ind", str(REAL_I), "--n_sites",
            str(REAL_S), "--pos", pos, "--max_kb_dist", "0", "--rnd_sample",
            str(RING_RATE), "--seed", "1", "--extend_out", "--verbose", "2"]
    r_out, b_out = os.path.join(d, "ring_r1.ld"), os.path.join(d, "block_r1.ld")
    wall, launches, tim, err, (busy, by_cat, by_kernel) = _file_run(
        argv + ["--ring"], r_out, profile=True)
    steps = _ring_strip_check(tim, launches, err, "strip_em")
    acc["strip_em"] += launches["strip_em"]
    if "auto-route" in err:
        raise AssertionError("R1 auto-routed to the block engine")
    import re
    peaks = [int(x) for x in re.findall(RING_PEAK_PAT, err)]
    plan = [ln.strip() for ln in err.splitlines()
            if "==> ring:" in ln and "sub-blocks" in ln]
    wall_b, launches_b, tim_b, err_b, _ = _file_run(argv, b_out)
    if "strip sweep skipped" not in err_b:
        raise AssertionError("the block run did not take the gather sweep:\n"
                             + err_b[-3000:])
    # the pair set, byte-equal and in order; byte-equal rows hold the
    # values too, the rest go through cmp_vs_strict
    n_rows = n_eq = 0
    diff_r, diff_b, kept = [], [], []
    with open(r_out, "rb") as fr, open(b_out, "rb") as fb:
        hdr_r, hdr_b = fr.readline(), fb.readline()
        if hdr_r != hdr_b:
            raise AssertionError("R1: headers differ")
        keep = max(1, tim["counters"]["pairs_emitted"] // 1000)
        kept.append(hdr_r.decode().rstrip("\n"))
        for lr, lb in zip(fr, fb):
            if n_rows % keep == 0:
                kept.append(lr.decode().rstrip("\n"))
            n_rows += 1
            if lr == lb:
                n_eq += 1
                continue
            if lr.split(b"\t", 2)[:2] != lb.split(b"\t", 2)[:2]:
                raise AssertionError(f"R1: pair {n_rows} differs:\n{lr}\n{lb}")
            diff_r.append(lr.decode().rstrip("\n"))
            diff_b.append(lb.decode().rstrip("\n"))
        if fr.readline() or fb.readline():
            raise AssertionError("R1: the ring and block outputs differ in "
                                 "length")
    if n_rows != tim["counters"]["pairs_emitted"] or n_rows < 1_000_000:
        raise AssertionError(f"R1: {n_rows} rows, counted "
                             f"{tim['counters']['pairs_emitted']}")
    hdr = hdr_r.decode().rstrip("\n")
    cmp_vs_strict([hdr] + diff_b, [hdr] + diff_r, 0)
    n_s = _sample_vs_strict(types.SimpleNamespace(kept=kept), sim,
                            params_from_args(argv))
    ph, st = tim["phases"], tim["stages"]
    print(f"  R1 {REAL_S} x {REAL_I}, all pairs at --rnd_sample {RING_RATE}: "
          f"{plan[0] if plan else ''}; {n_rows} rows; {steps} ring steps = "
          f"{launches['strip_em']} strip_em launches, no other kernel; pair "
          f"set byte-equal to the block engine's (gather sweep, "
          f"{sum(launches_b.values())} launches {json.dumps({k: v for k, v in launches_b.items() if v})}), "
          f"{n_eq} rows byte-equal, the other {len(diff_r)} within the f32 "
          f"contract; {n_s} sampled rows within the f32 contract of strict")
    print(f"    ring wall {wall:.3f} s under torch.profiler "
          f"({n_rows / wall:.4e} pairs/s), block engine wall {wall_b:.3f} s "
          f"[{card}]")
    split = {k: ph.get(k) for k in (
        "Reading data from file (site-sharded stream)",
        "Preprocessing (site-sharded) on device",
        "Sampling plan (taus draws, resident anchors)",
        "Building strip tables (device)", "compute: ring sweep",
        "emit: merge + format")}
    split.update({k: st[k] for k in st if k.startswith("ring:")})
    split["emit: refine (all)"] = round(sum(
        v for k, v in st.items() if k.startswith("emit: refine/")), 3)
    print("    stage split (s): " + json.dumps(split))
    print(f"    per-step peak device memory (bytes): {peaks}; max "
          f"{max(peaks) if peaks else 'n/a'}")
    em = sum(v for k, v in by_kernel.items() if "strip_em_kernel" in k)
    print(f"    device busy {busy:.6f} s (union of intervals), idle share "
          f"{1 - busy / wall:.6f}; strip_em_kernel {em:.6f} s")
    print("    device s by category: " + json.dumps(by_cat))
    print("    block engine phases: " + json.dumps(tim_b["phases"]))
    print("    ring counters: " + json.dumps(tim["counters"]))
    if not em > 0:
        raise AssertionError("no strip_em_kernel interval in the trace")
    # phase 10 runs the same argv on two ranks against this file
    return dict(argv=argv, out=r_out, sim=sim)


def _dense_run(tmp):
    """Phase 5b's dense run alone (its fixture and flags), for --ring-only."""
    from ngsld_tpu_torch.utils.simulate import simulate, write_pos
    d = os.path.join(tmp, "large")
    os.makedirs(d, exist_ok=True)
    sim = simulate(n_ind=PANEL_I, n_sites=BIG_S, seed=19, contig_kb=500.0)
    pos = os.path.join(d, f"sim_{BIG_S}.pos")
    glf = os.path.join(d, f"tiled_{BIG_S}_{BIG_I}.glf")
    write_pos(sim, pos)
    _write_tiled_glf(sim, BIG_I, glf)
    argv = ["--geno", glf, "--log_scale", "--n_ind", str(BIG_I), "--n_sites",
            str(BIG_S), "--pos", pos, "--max_kb_dist", "0", "--max_snp_dist",
            "128", "--extend_out", "--verbose", "2"]
    pars, sizes = _plan_blocks(argv, pos, BIG_S)
    sink, _, launches, _, _ = _counted_run(argv, tmp, sum(sizes), None,
                                           n_keep=200, pairs=True)
    if launches != dict(_NO_LAUNCHES, strip_em_stream=1):
        raise AssertionError(f"dense block run: launches {launches}")
    return dict(sink=sink, sim=sim, argv=argv, pars=pars,
                n_pairs=sum(sizes), glf=glf, pos=pos)


def _r2_r3(tmp, card, dense, acc):
    """R2: phase 5b's dense run (2,048 x 20,000 binary, band 128) through
    the ring (strip_em_stream.cu); R3: the same file sampled at 0.1 in f64
    (the gather stepper, the ichunk rung)."""
    import torch

    from ngsld_tpu_torch.cli import params_from_args
    from ngsld_tpu_torch.loaders import _ring_sharded_tables
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    from ngsld_tpu_torch.utils.logging import RunLog
    argv = dense["argv"] + ["--ring", "--ring_sub", "2"]
    pars = params_from_args(argv)
    # the ring loader alone, under tracemalloc: its host peak
    import tracemalloc
    B = -(-BIG_S // 256) * 256
    tracemalloc.start()
    t0 = time.perf_counter()
    try:
        gl, raw = _ring_sharded_tables(pars, 1, B, B, np.float32, RunLog(0),
                                       torch.device("cuda", 0))
        torch.cuda.synchronize()
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    t_load = time.perf_counter() - t0
    size = os.path.getsize(dense["glf"])
    del gl
    if not raw or not peak < size:
        raise AssertionError(f"ring loader: raw {raw}, host peak {peak} of a "
                             f"{size}-byte file")
    print(f"  R2 ring loader, {BIG_S} x {BIG_I} binary ({size} bytes): host "
          f"peak {peak} bytes (tracemalloc), {t_load:.3f} s [{card}]")
    sink, wall, launches, tim, err = _counted_run(
        argv, tmp, dense["n_pairs"], None, n_keep=200, pairs=True)
    steps = _ring_strip_check(tim, launches, err, "strip_em_stream")
    acc["strip_em_stream"] += launches["strip_em_stream"]
    if steps != 2 or sink.pairs.digest() != dense["sink"].pairs.digest():
        raise AssertionError(f"R2: {steps} steps; pair set equal to the "
                             "block run's: "
                             f"{sink.pairs.digest() == dense['sink'].pairs.digest()}")
    cmp_vs_strict(dense["sink"].kept, sink.kept, 100)
    n_s = _sample_vs_strict(sink, dense["sim"], pars)
    print(f"  R2 {BIG_S} x {BIG_I}, band 128, --ring_sub 2: {sink.n_lines - 1} "
          f"rows, {steps} strip_em_stream launches = ring steps, no other "
          f"kernel; pair set byte-equal to phase 5b's dense block run, its "
          f"{len(sink.kept) - 1} kept rows within the f32 contract of the "
          f"block run's, {n_s} within that of strict; wall {wall:.3f} s "
          f"[{card}]")
    print("    phases: " + json.dumps(tim["phases"]))
    print("    stages: " + json.dumps(tim["stages"]))

    # R3: sampled, f64, the gather stepper
    argv3 = dense["argv"] + ["--rnd_sample", "0.1", "--seed", "12345",
                             "--precision", "f64", "--ring", "--ring_sub",
                             "2"]
    pars3, sizes = _plan_blocks(argv3, dense["pos"], BIG_S)
    sink, wall, launches, tim, err = _counted_run(argv3, tmp, sum(sizes),
                                                  None, n_keep=200)
    pieces = _ring_gather_check(BIG_I, 8, pars3.chunk_pairs, launches, err)
    if launches["pair_em_ichunk"] < 1:
        raise AssertionError(f"R3: no ichunk launch: {launches}")
    for k in acc:
        acc[k] += launches.get(k, 0)
    n_s = _sample_vs_strict(sink, dense["sim"], pars3, f64=True)
    print(f"  R3 {BIG_S} x {BIG_I}, --rnd_sample 0.1, f64: {sink.n_lines - 1} "
          f"rows in pieces {pieces}, launches "
          + json.dumps({k: v for k, v in launches.items() if v})
          + f" (the ladder's rung for each piece); {n_s} sampled rows under "
          f"the f64 contract of strict; wall {wall:.3f} s [{card}]")


def _slice_files(tmp):
    from ngsld_tpu_torch.utils.simulate import simulate, write_all
    d = os.path.join(tmp, "slice")
    files = dict(glf=os.path.join(d, "sim.glf"),
                 beagle=os.path.join(d, "sim.beagle.gz"),
                 pos=os.path.join(d, "sim.pos"))
    if not all(os.path.exists(p) for p in files.values()):
        files = write_all(simulate(n_ind=24, n_sites=2000, seed=7), d)
    return files


def _r3_slice_r4(tmp, card, acc):
    """R3 on phase 4's 24 x 2,000 fixture (its four flag variants through
    the ring, f32 on the strip stepper and f64 on the gather stepper),
    then R4: resume by sub-ring, and the narrow-band auto-route."""
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict, compare
    files = _slice_files(tmp)
    common = ["--n_ind", "24", "--n_sites", "2000", "--pos", files["pos"],
              "--max_kb_dist", "10", "--min_maf", "0.05", "--extend_out",
              "--verbose", "2"]
    beagle = ["--geno", files["beagle"], "--probs"]
    variants = {
        "default": beagle,
        "ignore_miss_data": beagle + ["--ignore_miss_data"],
        "rnd_sample": beagle + ["--rnd_sample", "0.5", "--seed", "12345"],
        "binary": ["--geno", files["glf"], "--log_scale"],
    }
    ring = ["--ring", "--ring_sub", "2"]
    d = os.path.join(tmp, "ring_slice")
    os.makedirs(d, exist_ok=True)
    for name, inp in variants.items():
        s_out = os.path.join(d, f"strict_{name}.ld")
        rc, err = _cli(inp + common + ["--engine", "strict", "--out", s_out])
        if rc != 0:
            raise AssertionError(f"{name}: strict rc {rc}\n{err}")
        s_lines = _read_lines(s_out)
        out32, out64 = (os.path.join(d, f"ring_{name}_{p}.ld")
                        for p in ("f32", "f64"))
        _, l32, tim, err, _ = _file_run(inp + common + ring, out32)
        steps = _ring_strip_check(tim, l32, err, "strip_em")
        cmp_vs_strict(s_lines, _read_lines(out32), 1000)
        _, l64, _, err, _ = _file_run(inp + common + ring + ["--precision",
                                                              "f64"], out64)
        pieces = _ring_gather_check(24, 8, 1 << 19, l64, err)
        compare(s_lines, _read_lines(out64))
        for k in acc:
            acc[k] += l32.get(k, 0) + l64.get(k, 0)
        print(f"  R3 24 x 2,000 {name}: {len(s_lines) - 1} rows; f32 "
              f"{steps} strip_em launches = ring steps, f32 contract of "
              f"strict; f64 pieces {pieces}, launches "
              + json.dumps({k: v for k, v in l64.items() if v})
              + ", f64 contract of strict")

    # R4: a checkpointed ring, the later sub-ring's files deleted, resumed
    ck = os.path.join(d, "ck")
    o1, o2 = os.path.join(d, "ck1.ld"), os.path.join(d, "ck2.ld")
    argv = beagle + common + ring + ["--checkpoint", ck]
    _, l1, tim1, _, _ = _file_run(argv, o1)
    removed = [p for p in os.listdir(ck)
               if p.startswith("ring_") and "_s0000_" not in p]
    for p in removed:
        os.remove(os.path.join(ck, p))
    _, l2, tim2, _, _ = _file_run(argv, o2)
    with open(o1, "rb") as f1, open(o2, "rb") as f2:
        same = f1.read() == f2.read()
    c2 = tim2["counters"]
    if not removed or not same or c2.get("ring_steps_resumed") != 1 or \
            c2.get("ring_steps") != 1 or l2["strip_em"] != 1:
        raise AssertionError(f"R4 resume: removed {removed}, byte-equal "
                             f"{same}, counters {c2}, launches {l2}")
    acc["strip_em"] += l1["strip_em"] + l2["strip_em"]
    print(f"  R4 resume: {len(removed)} files of sub-ring 1 deleted, rerun "
          f"resumed sub-ring 0 and recomputed 1 step "
          f"({l2['strip_em']} strip_em launch), byte-equal")
    # the auto-route: the narrow band without --ring_sub runs the block
    # engine, byte-equal to a block run
    ob, oa = os.path.join(d, "block.ld"), os.path.join(d, "auto.ld")
    argv = beagle + common[:-2] + ["--verbose", "1"]
    with _env(NGSLD_RING_AUTOROUTE=None):
        _, lb, _, _, _ = _file_run(argv, ob)
        _, la, _, err, _ = _file_run(argv + ["--ring"], oa)
    with open(ob, "rb") as f1, open(oa, "rb") as f2:
        same = f1.read() == f2.read()
    if "--ring auto-route" not in err or not same or la != lb:
        raise AssertionError(f"R4 auto-route: logged "
                             f"{'--ring auto-route' in err}, byte-equal "
                             f"{same}, launches {la} vs {lb}")
    print("  R4 auto-route: the 10 kb band without --ring_sub ran the block "
          "engine (logged), byte-equal to the block run, launches "
          + json.dumps({k: v for k, v in la.items() if v}))


def phase_ring(tmp, card, large):
    """Phase 7: the ring sweep on the card (--ring, one device). Returns
    its launches (acc), and R1's run and the 2,048-site fixture, which
    phase 10 runs again on two ranks."""
    acc = dict(_NO_LAUNCHES)
    _ring_bounds(card)
    r1 = _r1(tmp, card, acc)
    # R2 holds the ring to phase 5b's dense run (run here when 5b did not)
    dense = (large or {}).get("dense_run") or _dense_run(tmp)
    _r2_r3(tmp, card, dense, acc)
    _r3_slice_r4(tmp, card, acc)
    print("  launches on the ring legs: " + json.dumps(acc))
    return dict(acc=acc, r1=r1, dense=dense)


# ---------------------------------------------------------------- phase 8

PRUNE_KB, PRUNE_W = 10, 0.5      # prune: --max_kb_dist, --min_weight (r2)
REGION_BP = 50_000               # ld_blocks.extract_region's region
N_PARTS = 5                      # merge: the TSV cut into this many shards
FIT_SHARE = 0.2                  # fit_decay: this share of the TSV's rows
# the HMM cell: sequences x sites, 2 states (at 20,000 sites it took 17 s)
HMM_B, HMM_L = 100, 5_000
# the HMM on the card in f64 against the CPU in f64: values within
# HMM_REL * max(|x|, 1), posterior probabilities within HMM_POST
HMM_REL, HMM_POST = 1e-9, 1e-6


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _one_trace(name, trace_dir, kernel, n_launch):
    """The one Chrome trace in trace_dir, parsed, checked to hold one
    device event of `kernel` for each of n_launch launches, and removed:
    (bytes, events, device busy s)."""
    from ngsld_tpu_torch.utils.devtrace import device_busy
    files = os.listdir(trace_dir)
    if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
        raise AssertionError(f"{name}: the trace dir holds {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    busy, by_cat, _ = device_busy(events)
    n_dev = sum(1 for ev in events if ev.get("cat") == "kernel"
                and kernel in ev.get("name", ""))
    if n_dev != n_launch or n_dev < 1:
        raise AssertionError(f"{name}: {n_dev} device events of {kernel} in "
                             f"the trace for {n_launch} launches; device "
                             f"categories {sorted(by_cat)}")
    out = (os.path.getsize(path), len(events), busy / 1e6)
    shutil.rmtree(trace_dir)
    return out


def _profiled_pair(card, argv, d, name, count, kernel, **env):
    """The port's CLI on one run four times in turns, without --profile,
    with it, with it, without: the rows byte-equal, the same launches, and
    each --profile DIR holding one Chrome trace that parses and has one
    device event of `kernel` for each launch that its counter `count`
    made. Returns (the first run's output path, its launches)."""
    tag = name.split()[0]
    first = digest = want = None
    walls = {False: [], True: []}
    traces = []
    with _env(**env):
        for k, traced in enumerate((False, True, True, False)):
            out = os.path.join(d, f"{tag}_{k}.ld")
            trace_dir = os.path.join(d, f"{tag}_trace{k}")
            wall, launches, _, _, _ = _file_run(
                argv + (["--profile", trace_dir] if traced else []), out)
            walls[traced].append(wall)
            if want is None:
                want, first, digest = launches, out, _sha256(out)
            elif launches != want or _sha256(out) != digest:
                raise AssertionError(f"{name}: run {k} (--profile "
                                     f"{traced}): launches {launches} "
                                     f"against {want}, or rows differ")
            else:
                os.remove(out)
            if traced:
                traces.append(_one_trace(name, trace_dir, kernel,
                                         launches[count]))
    w0, w1 = sum(walls[False]), sum(walls[True])
    print(f"  {name}: rows byte-equal in 4 runs, without, with, with and "
          f"without --profile ({os.path.getsize(first)} bytes); launches "
          + json.dumps({k: v for k, v in want.items() if v})
          + f"; walls {walls[False][0]:.3f}, {walls[True][0]:.3f}, "
          f"{walls[True][1]:.3f}, {walls[False][1]:.3f} s (overhead "
          f"{w1 / w0 - 1:.4f}); traces (bytes, events, device busy s) "
          f"{traces}; {want[count]} {kernel} device events a trace = "
          f"launches [{card}]")
    return first, want


def _fresh_pair(card, argv, d, kernel, n_launch, rows, **env):
    """The same run as a user starts it, `python -m ngsld_tpu_torch.cli` in
    a new process, without --profile and then with it (the first profiler
    of that process): rows byte-equal to `rows`, the trace holding the
    kernel's n_launch device events; each process's wall."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(d, "fresh.ld")
    trace_dir = os.path.join(d, "fresh_trace")
    walls = []
    for traced in (False, True):
        cmd = [sys.executable, "-m", "ngsld_tpu_torch.cli", *argv, "--out",
               out] + (["--profile", trace_dir] if traced else [])
        with _env(**env):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600, cwd=root)
            walls.append(time.perf_counter() - t0)
        if r.returncode != 0 or _sha256(out) != _sha256(rows):
            raise AssertionError(f"fresh process (--profile {traced}): rc "
                                 f"{r.returncode} or rows differ\n"
                                 + r.stderr[-3000:])
        os.remove(out)
    trace = _one_trace("fresh process", trace_dir, kernel, n_launch)
    print(f"    the same as a new process each: wall {walls[0]:.3f} s "
          f"without, {walls[1]:.3f} s with --profile (the process's first "
          f"profiler; overhead {walls[1] / walls[0] - 1:.4f}); rows "
          f"byte-equal; trace (bytes, events, device busy s) {trace} "
          f"[{card}]")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _quiet(fn):
    """fn() with its stdout and stderr captured: (result, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        res = fn()
    return res, out.getvalue()


def _tools(tsv, d):
    """The port's four tools on a TSV the card wrote, each timed: prune's
    kept set against the invariant of tests/test_tools.py:62 (no kept pair
    within the distance at or above the weight), a finite decay fit,
    extract_region against a scan of the same rows (these three on the
    TSV's first FIT_SHARE of rows), and merge of the whole TSV cut into
    shards byte-equal to the whole."""
    from ngsld_tpu_torch.tools import fit_decay, ld_blocks, merge, prune
    # the first FIT_SHARE of the TSV's bytes, cut at a row's end: fit_decay's
    # row parse took 24.5 s of the whole file, prune and extract_region 7 s
    whole, tsv = tsv, os.path.join(d, "head.ld")
    with open(whole, "rb") as src, open(tsv, "wb") as dst:
        part = src.read(int(os.path.getsize(whole) * FIT_SHARE))
        dst.write(part[:part.rindex(b"\n") + 1])
    del part
    kept_path = os.path.join(d, "kept.txt")
    (rc, _), t_prune = _timed(lambda: _quiet(lambda: prune.main([
        "--input", tsv, "--max_kb_dist", str(PRUNE_KB), "--min_weight",
        str(PRUNE_W), "--output", kept_path])))
    kept = set(_read_lines(kept_path))
    with open(tsv) as fh:
        fh.readline()
        first = fh.readline()
    chrom, _, p0 = first.split("\t")[0].rpartition(":")
    lo, hi = int(p0), int(p0) + REGION_BP

    def inside(label):
        c, _, p = label.rpartition(":")
        return c == chrom and lo <= int(p) <= hi

    n_rows = n_edges = n_region = 0
    sites = set()
    with open(tsv) as fh:
        fh.readline()
        for ln in fh:
            f = ln.split("\t", 7)
            sites.update(f[:2])
            n_rows += 1
            w = abs(float(f[6]))
            if float(f[2]) <= PRUNE_KB * 1000 and w >= PRUNE_W and \
                    np.isfinite(w):
                n_edges += 1
                if f[0] in kept and f[1] in kept:
                    raise AssertionError(f"prune kept both ends of {ln}")
            if inside(f[0]) and inside(f[1]) and np.isfinite(float(f[6])):
                n_region += 1
    if rc != 0 or not kept or not kept <= sites:
        raise AssertionError(f"prune rc {rc}, {len(kept)} kept")
    print(f"  prune (r2, --max_kb_dist {PRUNE_KB}, --min_weight {PRUNE_W}) "
          f"on the TSV's first {FIT_SHARE} ({n_rows} rows, {len(sites)} "
          f"sites): kept "
          f"{len(kept)}; none of the {n_edges} pairs within {PRUNE_KB} kb "
          f"at or above the weight has both ends kept; {t_prune:.3f} s")

    lst = os.path.join(d, "ld_files.txt")
    with open(lst, "w") as fh:
        fh.write(tsv + "\n")
    (rc, text), t_fit = _timed(lambda: _quiet(lambda: fit_decay.main([
        "--ld_files", lst, "--ld", "r2", "--n_ind", str(REAL_I),
        "--fit_level", "3", "--seed", "1"])))
    hdr, row = text.splitlines()[:2]
    fit = dict(zip(hdr.split("\t"), row.split("\t")))
    if rc != 0 or not np.isfinite(float(fit["DecayRate"])):
        raise AssertionError(f"fit_decay rc {rc}: {text}")
    print(f"  fit_decay --n_ind {REAL_I} on the same rows: DecayRate {fit['DecayRate']}, LDmax {fit['LDmax']}, LDmin "
          f"{fit['LDmin']}; {t_fit:.3f} s")

    (pos, dp, r2), t_reg = _timed(
        lambda: ld_blocks.extract_region(tsv, chrom, lo, hi))
    n_fin = int(np.isfinite(r2[np.triu_indices(len(pos), 1)]).sum())
    if pos != sorted(set(pos)) or n_fin != n_region or n_region < 1 or \
            not np.array_equal(r2, r2.T, equal_nan=True) or \
            not np.array_equal(dp, dp.T, equal_nan=True):
        raise AssertionError(f"extract_region: {len(pos)} sites, {n_fin} "
                             f"finite r2 cells, {n_region} rows in region")
    print(f"  ld_blocks.extract_region {chrom}:{lo}-{hi}: {len(pos)} sites, "
          f"{n_fin} finite r2 cells = the region's rows; {t_reg:.3f} s")

    stem = os.path.join(d, "parts.ld")
    with open(whole, "rb") as fh:
        lines = fh.readlines()
    cut = np.linspace(0, len(lines), N_PARTS + 1).astype(int)
    for k in range(N_PARTS):
        with open(f"{stem}.part{k:05d}", "wb") as fh:
            fh.writelines(lines[cut[k]:cut[k + 1]])
    del lines
    merged = os.path.join(d, "merged.ld")
    (rc, _), t_merge = _timed(lambda: _quiet(
        lambda: merge.main(["--out", merged, "--delete-parts", stem])))
    if rc != 0 or _sha256(merged) != _sha256(whole):
        raise AssertionError(f"merge rc {rc}: not byte-equal to the TSV")
    print(f"  merge of {N_PARTS} shards: byte-equal to the TSV "
          f"({os.path.getsize(merged)} bytes); {t_merge:.3f} s")
    os.remove(merged)


def _hmm(card):
    """extras.hmm on the card at HMM_B x HMM_L x 2 in f64 against the same
    calls on the CPU in f64 (f32 is no reference at this length: the log
    tables reach about -2e4, where one f32 step is 2e-3), and
    findmax_torch on the card."""
    import torch
    from ngsld_tpu_torch.extras import hmm
    from ngsld_tpu_torch.extras.optimize import findmax_torch
    rng = np.random.default_rng(0)
    em = np.log(rng.random((HMM_B, HMM_L, 2)))
    dist = rng.integers(1, 2000, (HMM_B, HMM_L)).astype(np.float64)
    q, alpha = [0.7, 0.3], 1e-3
    names = ("forward", "backward", "posterior", "viterbi")

    def run(device, dtype):
        args = [torch.tensor(x, dtype=dtype, device=device)
                for x in (q, em, dist)]
        out, secs = {}, {}
        for name in names:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = getattr(hmm, name)(args[0], alpha, args[1], args[2])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            res = res if isinstance(res, tuple) else (res,)
            out[name] = [r.cpu() for r in res]
        return out, secs

    ref, t_cpu = run("cpu", torch.float64)
    got, t_card = run("cuda", torch.float64)
    errs = {}
    for name in names:
        for k, (a, b) in enumerate(zip(got[name], ref[name])):
            if a.dtype == torch.int32:
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: Viterbi paths differ at "
                                         f"{int((a != b).sum())} sites")
                continue
            if name == "posterior":
                err, tol = float((a - b).abs().max()), HMM_POST
            else:
                err = float(((a - b).abs() / b.abs().clamp(min=1)).max())
                tol = HMM_REL
            errs[f"{name}[{k}]"] = err
            if not err <= tol:
                raise AssertionError(f"{name}[{k}]: {err:.3e} > {tol}")
    print(f"  hmm {HMM_B} x {HMM_L} x 2, f64 on the card against the CPU in "
          f"f64: paths equal, errors (relative to max(|x|, 1), posterior "
          f"absolute; tolerances {HMM_REL}, {HMM_POST}) " + json.dumps(errs))
    print("    s on the card: " + json.dumps(t_card) + "; on the CPU: "
          + json.dumps(t_cpu) + f" [{card}]")
    x0 = torch.tensor([0.1, 0.9], device="cuda")
    (x, f, ok), t_opt = _timed(lambda: findmax_torch(
        lambda x: -torch.sum((x - 0.3) ** 2), x0, lower=torch.zeros(2),
        upper=torch.ones(2)))
    if not ok or x.device.type != "cuda" or \
            float((x - 0.3).abs().max()) > 1e-4:
        raise AssertionError(f"findmax_torch: x {x}, f {f}, ok {ok}")
    print(f"  findmax_torch on the card: x {x.tolist()} (0.3 each), f_max "
          f"{float(f):.3e}, converged; {t_opt:.3f} s")


def phase_profile_tools(tmp, card, real):
    """Phase 8: --profile on three runs of the main path, the LD tools on
    the rows the card wrote, and extras/ on the card."""
    d = os.path.join(tmp, "phase8")
    os.makedirs(d, exist_ok=True)
    files = _slice_files(tmp)
    ring_argv = ["--geno", files["beagle"], "--probs", "--n_ind", "24",
                 "--n_sites", "2000", "--pos", files["pos"], "--max_kb_dist",
                 "10", "--min_maf", "0.05", "--extend_out", "--verbose", "0",
                 "--ring", "--ring_sub", "2"]
    tsv, launches = _profiled_pair(card, real["gather_argv"], d,
                                   "gather 10,000 x 100", "pair_em",
                                   "pair_em_kernel", NGSLD_BLOCK_STRIP="0")
    _fresh_pair(card, real["gather_argv"], d, "pair_em_kernel",
                launches["pair_em"], tsv, NGSLD_BLOCK_STRIP="0")
    # the strip leg on the gather leg's 10,000 sites (four runs of the
    # 25k x 100 leg took 29 s)
    _profiled_pair(card, real["gather_argv"], d, "strip 10,000 x 100",
                   "strip_em", "strip_em_kernel", NGSLD_BLOCK_STRIP="1")
    _profiled_pair(card, ring_argv, d, "ring 24 x 2,000", "strip_em",
                   "strip_em_kernel")
    _tools(tsv, d)
    _hmm(card)


# ---------------------------------------------------------------- phase 9

# a rank started through launcher variables (as torchrun sets them): the
# port's CLI with jax and the JAX package blocked; its kernels' launch
# counts (from 0 in this new process) to a file
_RANK_CODE = """
import json, sys
sys.modules["jax"] = None
sys.modules["ngsld_tpu"] = None
from ngsld_tpu_torch.cli import main
from ngsld_tpu_torch.kernels import pair_em as pmod
from ngsld_tpu_torch.kernels import strip_em as smod
rc = main(json.loads(sys.argv[1]))
with open(sys.argv[2], "w") as fh:
    json.dump(dict(pair_em=pmod.LAUNCHES, strip_em=smod.LAUNCHES,
                   pair_em_rows=pmod.LAUNCHES_ROWS,
                   pair_em_ichunk=pmod.LAUNCHES_ICHUNK,
                   pair_em_ichunk_stream=pmod.LAUNCHES_ICHUNK_STREAM,
                   strip_em_stream=smod.LAUNCHES_STREAM), fh)
sys.exit(rc)
"""


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _launch_ranks(argv, out, world, tag, **env):
    """The port's CLI as `world` new processes with launcher variables
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT), all
    on this box: rank 0 writes the rows to `out`. A rank that exits
    non-zero ends the others and fails the phase; none outlives the call.
    Returns (wall s, each rank's launch counts, each rank's timings JSON)."""
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.dirname(out)
    port = _free_port()
    tj = os.path.join(d, f"{tag}.json")
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            penv = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        NGSLD_TIMINGS_JSON=tj)
            for k, v in env.items():
                if v is None:
                    penv.pop(k, None)
                else:
                    penv[k] = v
            logs.append(open(os.path.join(d, f"{tag}.err{r}"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_CODE,
                 json.dumps(argv + ["--out", out]),
                 os.path.join(d, f"{tag}.launches{r}")],
                cwd=root, env=penv, stdout=logs[-1], stderr=logs[-1]))
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs):
                break
            if time.perf_counter() - t0 > 600:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for fh in logs:
            fh.close()
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if any(codes):
        with open(os.path.join(d, f"{tag}.err0")) as fh:
            e0 = fh.read()[-3000:]
        with open(os.path.join(d, f"{tag}.err{world - 1}")) as fh:
            e1 = fh.read()[-3000:]
        raise AssertionError(f"{tag}: ranks exited {codes}\nrank 0:\n{e0}"
                             f"\nrank {world - 1}:\n{e1}")
    launches, tims = [], []
    for r in range(world):
        with open(os.path.join(d, f"{tag}.launches{r}")) as fh:
            launches.append(json.load(fh))
        with open(tj + (f".rank{r}" if r else "")) as fh:
            tims.append(json.load(fh))
    return wall, launches, tims


def _same_pairs(one, many, label):
    """`many` holds the pairs of `one` in the same order: each row's first
    two columns equal. Returns (rows byte-equal, rows held to the f32
    contract instead)."""
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    if len(many) != len(one) or one[0] != many[0]:
        raise AssertionError(f"{label}: {len(many)} lines against {len(one)}")
    if [r.split("\t", 2)[:2] for r in one] != \
            [r.split("\t", 2)[:2] for r in many]:
        raise AssertionError(f"{label}: the pair sets differ")
    diff = [(a, b) for a, b in zip(one, many) if a != b]
    if diff:
        cmp_vs_strict(one[:1] + [a for a, _ in diff],
                      many[:1] + [b for _, b in diff], 0)
    return len(one) - 1 - len(diff), len(diff)


def _rank_lines(launches, tims, kernels):
    """One line a rank: its launches of `kernels`, its rungs, blocks or
    chunks, and its 'ind' all-reduces with their host seconds."""
    print("    rank 0's phases: " + json.dumps(tims[0]["phases"]))
    print("    rank 0's stages: " + json.dumps(tims[0]["stages"]))
    for r, (lc, tj) in enumerate(zip(launches, tims)):
        c, st = tj["counters"], tj["stages"]
        rungs = {k: v for k, v in c.items() if k.startswith("rung_")}
        ar_s = st.get("mesh: 'ind' all-reduce", 0.0)
        print(f"    rank {r}: launches " + json.dumps(
            {k: lc[k] for k in kernels}) + f", rungs {json.dumps(rungs)}, "
            f"{c.get('blocks_computed', 0)} blocks or chunks, "
            f"{c.get('ind_allreduces', 0)} 'ind' all-reduces ({ar_s} s), "
            f"pieces to rank 0 {st.get('mesh: pieces to rank 0', 0.0)} s")


def _only(launches, kernel, n, label):
    """Every rank launched `kernel` n times and no other kernel."""
    for r, lc in enumerate(launches):
        if lc != dict(_NO_LAUNCHES, **({kernel: n} if kernel else {})):
            raise AssertionError(f"{label}: rank {r} launches {lc}; expected "
                                 f"{kernel} x {n} only")


def _ind_steps_nccl(card):
    """9d: the two --shard_ind steps at world size 1 over NCCL, on the
    card: a block of 65,536 pairs x 100 individuals through
    parallel.sweep.compute_block_ind against the one-device step
    (compute_block: pair_em.cu and the f32 Pearson), and the first
    IND_STRIP_TILES all-pairs tiles of the strip cell through
    parallel.strip_ind.strip_tiles_ind (whole planes while more than half
    a batch's cells run, then gathered) against strip_em.cu. The
    reference's contract: n_used exact, nIter within 1 (equal at more
    than 99.9%), f within 3e-5 where nIter is equal, r2p within 2e-5."""
    import datetime
    import torch
    import torch.distributed as dist
    from ngsld_tpu_torch import compute
    from ngsld_tpu_torch.kernels.strip_em import strip_em
    from ngsld_tpu_torch.parallel import mesh
    from ngsld_tpu_torch.parallel.strip_ind import strip_tiles_ind
    from ngsld_tpu_torch.parallel.sweep import compute_block_ind
    dev = torch.device("cuda", 0)
    gn, sidx, maf = _table(MAIN_I, 4_096, 65_536, 5, torch.float32, dev)
    eg = gn[..., 1] + 2 * gn[..., 2]
    s_args, live, _ = _strip_case(MAIN_I, STRIP_S, IND_STRIP_TILES, 5, dev)
    store = dist.TCPStore(mesh.HOST, 0, 1, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=120))
    m = mesh.connect(0, 1, 1, 1, dev, 1, store)
    try:
        if m.backend != "nccl":
            raise AssertionError(f"world 1 on a card: backend {m.backend}")
        torch.cuda.synchronize()
        (fm, im), secs = _timed(lambda: compute_block_ind(
            gn, eg, maf, sidx, True, m))
        torch.cuda.synchronize()
        n_gather = m.allreduces
        t0 = time.perf_counter()
        s_out = strip_tiles_ind(*s_args, n_ind=MAIN_I, i_start=0, mesh=m,
                                ignore_miss=True)
        torch.cuda.synchronize()
        s_secs = time.perf_counter() - t0
    finally:
        mesh.teardown()

    def hold(label, f, r2p, it, nu, f_r, r2p_r, it_r, nu_r):
        same = it == it_r
        if not (np.array_equal(nu, nu_r) and np.abs(it - it_r).max() <= 1
                and same.mean() > 0.999):
            raise AssertionError(f"9d {label}: nIter differs at "
                                 f"{(~same).sum()}, or n_used differs")
        fin, rfin = np.isfinite(f_r), np.isfinite(r2p_r)
        err_f = float(np.abs(f - f_r)[same][fin[same]].max())
        err_r = float(np.abs(r2p - r2p_r)[rfin].max())
        if not (np.array_equal(np.isfinite(f), fin) and err_f <= 3e-5
                and np.array_equal(np.isfinite(r2p), rfin)
                and err_r <= 2e-5):
            raise AssertionError(f"9d {label}: max|df| {err_f}, max|dr2p| "
                                 f"{err_r}")
        return int(same.sum()), len(same), err_f, err_r

    ref_fm, ref_im = compute.compute_block(gn, eg, maf, sidx, True)
    fm, im, ref_fm, ref_im = (t.cpu().numpy().astype(np.float64)
                              for t in (fm, im, ref_fm, ref_im))
    g = hold("gather", fm[:, 1:], fm[:, 0], im[:, 0], im[:, 1],
             ref_fm[:, 1:], ref_fm[:, 0], ref_im[:, 0], ref_im[:, 1])
    print(f"  9d: the --shard_ind gather step at world size 1 over NCCL on "
          f"the card, {sidx.shape[1]} pairs x {MAIN_I} (--ignore_miss_data): "
          f"{n_gather} all-reduces, {secs:.3f} s (the group's first "
          f"collective included); against compute_block (pair_em.cu): "
          f"n_used exact, nIter equal at {g[0]} of {g[1]} pairs (the rest "
          f"within 1), max|df| {g[2]:.3e} where equal, max|dr2p| "
          f"{g[3]:.3e} [{card}]")
    k_out = strip_em(*s_args, n_ind=MAIN_I, ignore_miss=True)
    f, r2p, it, nu = (t.cpu().numpy() for t in s_out)
    f_k, r2p_k, it_k, nu_k = (t.cpu().numpy() for t in k_out)
    fl = np.moveaxis(f, 1, -1)[live]
    fkl = np.moveaxis(f_k, 1, -1)[live]
    st = hold("strip", fl, r2p[live], it[live], nu[live], fkl, r2p_k[live],
              it_k[live], nu_k[live])
    print(f"  9d: the --shard_ind strip step at world size 1 over NCCL, "
          f"{IND_STRIP_TILES} all-pairs tiles x {MAIN_I} (--ignore_miss_data,"
          f" {int(live.sum())} live cells): {m.allreduces - n_gather} "
          f"all-reduces, {s_secs:.3f} s; against strip_em.cu on the live "
          f"cells: n_used exact, nIter equal at {st[0]} of {st[1]} (the rest "
          f"within 1), max|df| {st[2]:.3e} where equal, max|dr2p| "
          f"{st[3]:.3e} [{card}]")


def _first_sites(argv, n_sites, n_ind, d):
    """argv with its binary GL file and its POS file cut to their first
    n_sites sites (copies written in d)."""
    argv = list(argv)
    gi, pi, si = (argv.index(k) + 1 for k in ("--geno", "--pos", "--n_sites"))
    glf = os.path.join(d, f"first_{n_sites}_{n_ind}.glf")
    pos = os.path.join(d, f"first_{n_sites}.pos")
    with open(argv[gi], "rb") as fa, open(glf, "wb") as fb:
        fb.write(fa.read(n_sites * n_ind * 3 * 8))
    with open(argv[pi]) as fa, open(pos, "w") as fb:
        fb.writelines(line for _, line in zip(range(n_sites), fa))
    argv[gi], argv[pi], argv[si] = glf, pos, str(n_sites)
    return argv


def phase_shard(tmp, card, real, large):
    """Phase 9: the block engine on two ranks sharing the card (gloo),
    started through launcher variables: 9a --shard 2 on phase 5's gather
    cell, 9b --shard 2 on its strip cell, 9c --shard_ind 2 on phase 5b's
    2,048 x 4,000 file, sampled (the gather step), and dense (the strip
    step) on its first DENSE_IND_S sites, 9d the two --shard_ind steps over
    NCCL at world size 1."""
    import torch
    d = os.path.join(tmp, "shard")
    os.makedirs(d, exist_ok=True)
    print(f"  two ranks on {torch.cuda.device_count()} card(s): the device "
          "collectives run over gloo (walls measure the path on one shared "
          "card, not scaling)")

    # ---- 9a: --shard 2, the 10,000 x 100 gather cell
    one = _read_lines(os.path.join(tmp, "real", "cut_gather.ld"))
    n_blocks = real["gather_blocks"]
    out = os.path.join(d, "gather.ld")
    wall, launches, tims = _launch_ranks(
        real["gather_argv"] + ["--shard", "2"], out, 2, "9a",
        NGSLD_BLOCK_STRIP="0")
    _only(launches, "pair_em", n_blocks, "9a")
    eq, near = _same_pairs(one, _read_lines(out), "9a")
    rungs = [{k: v for k, v in t["counters"].items() if k.startswith("rung_")}
             for t in tims]
    if near and all(rg == {"rung_gather": n_blocks} for rg in rungs):
        raise AssertionError(f"9a: {near} rows differ though both ranks' "
                             "halves took the whole block's rung")
    print(f"  9a --shard 2, {GATHER_S} x {REAL_I} gather: {len(one) - 1} "
          f"rows, the pair set of the one-device run, {eq} rows byte-equal, "
          f"{near} within the f32 contract; pair_em.cu {n_blocks} launches a "
          f"rank (= blocks); wall {wall:.3f} s (two new processes) [{card}]")
    _rank_lines(launches, tims, ("pair_em",))

    # ---- 9b: --shard 2, the 25k x 100 strip cell
    argv = real["argv"][:real["argv"].index("--verbose")] + ["--verbose", "0"]
    one = _read_lines(os.path.join(tmp, "real", "prof.ld"))
    out = os.path.join(d, "strip.ld")
    wall, launches, tims = _launch_ranks(argv + ["--shard", "2"], out, 2,
                                         "9b", NGSLD_BLOCK_STRIP=None)
    chunks = tims[0]["counters"]["blocks_computed"]
    _only(launches, "strip_em", chunks, "9b")
    rows = _read_lines(out)
    eq, near = _same_pairs(one, rows, "9b")
    step = max(1, (len(rows) - 1) // 1000)
    n = _sample_vs_strict(types.SimpleNamespace(kept=rows[:1] + rows[1::step]),
                          real["sim"], real["pars"])
    print(f"  9b --shard 2, {REAL_S} x {REAL_I} strip: {len(rows) - 1} rows, "
          f"the pair set of the one-device run, {eq} byte-equal, {near} within "
          f"the f32 contract, {n} sampled rows within it against strict; "
          f"strip_em.cu {chunks} launches a rank (= chunks) on its tiles; "
          f"wall {wall:.3f} s (two new processes) [{card}]")
    _rank_lines(launches, tims, ("strip_em",))

    # ---- 9c: --shard_ind 2 on the 2,048 x 4,000 file, sampled (the
    # gather step), and dense (the strip step) on its first DENSE_IND_S
    # sites, a cut of depth for the run's time
    sampled = ["--rnd_sample", "0.1", "--seed", "12345"]
    for name, extra, count, n_sites in (
            ("sampled", sampled, "ind_blocks", BIG_S),
            ("dense", [], "ind_strip_chunks", DENSE_IND_S)):
        argv = large["argv_for"](ROWS_I, BIG_S, 128, extra)
        argv = argv[:argv.index("--verbose")] + ["--verbose", "0",
                                                 "--precision", "f32"]
        if n_sites < BIG_S:
            argv = _first_sites(argv, n_sites, ROWS_I, d)
        ref = os.path.join(d, f"ind1_{name}.ld")
        _zero_launches()
        (rc, err), wall1 = _timed(lambda: _cli(argv + ["--out", ref]))
        if rc != 0:
            raise AssertionError(f"9c {name} --shard_ind 1: rc {rc}\n"
                                 + err[-3000:])
        out = os.path.join(d, f"ind2_{name}.ld")
        wall, launches, tims = _launch_ranks(argv + ["--shard_ind", "2"],
                                             out, 2, f"9c_{name}")
        _only(launches, None, 0, f"9c {name}")
        c = tims[0]["counters"]
        if not c.get(count) or c[count] != c["blocks_computed"]:
            raise AssertionError(f"9c {name}: counters {c}")
        rows = _read_lines(out)
        eq, near = _same_pairs(_read_lines(ref), rows, f"9c {name}")
        print(f"  9c --shard_ind 2, {n_sites} x {ROWS_I} {name} ({count}: "
              f"{c[count]}): {len(rows) - 1} rows, the pair set of the "
              f"--shard_ind 1 run, {eq} byte-equal, {near} within the f32 "
              f"contract; no kernel launched (the step is torch operations "
              f"around the all-reduce); wall {wall:.3f} s (two new "
              f"processes), --shard_ind 1 in this process {wall1:.3f} s "
              f"[{card}]")
        _rank_lines(launches, tims, ())

    # ---- 9d: over NCCL, world size 1; 9a over NCCL needs two cards
    _ind_steps_nccl(card)
    if torch.cuda.device_count() < 2:
        print("  9a over NCCL: not run (one card on this box: two ranks "
              "would share it, which NCCL refuses)")
    else:
        out = os.path.join(d, "gather_nccl.ld")
        wall, launches, tims = _launch_ranks(
            real["gather_argv"] + ["--shard", "2"], out, 2, "9a_nccl",
            NGSLD_BLOCK_STRIP="0")
        _only(launches, "pair_em", n_blocks, "9a over NCCL")
        eq, near = _same_pairs(_read_lines(os.path.join(
            tmp, "real", "cut_gather.ld")), _read_lines(out), "9a over NCCL")
        print(f"  9a over NCCL, one card a rank: {eq} rows byte-equal, {near} "
              f"within the f32 contract; wall {wall:.3f} s [{card}]")
        _rank_lines(launches, tims, ("pair_em",))


# ---------------------------------------------------------------- phase 10

def _same_pairs_files(one, many, label):
    """The file `many` holds the pairs of the file `one` in the same order,
    read a line at a time: (rows byte-equal, rows held to the f32 contract
    of cmp_vs_strict instead)."""
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    n_eq = 0
    diff_a, diff_b = [], []
    with open(one, "rb") as fa, open(many, "rb") as fb:
        hdr = fa.readline()
        if fb.readline() != hdr:
            raise AssertionError(f"{label}: headers differ")
        for k, (la, lb) in enumerate(zip(fa, fb)):
            if la == lb:
                n_eq += 1
                continue
            if la.split(b"\t", 2)[:2] != lb.split(b"\t", 2)[:2]:
                raise AssertionError(f"{label}: pair {k} differs:\n{la}\n"
                                     f"{lb}")
            diff_a.append(la.decode().rstrip("\n"))
            diff_b.append(lb.decode().rstrip("\n"))
        if fa.readline() or fb.readline():
            raise AssertionError(f"{label}: the outputs differ in length")
    if diff_a:
        h = hdr.decode().rstrip("\n")
        cmp_vs_strict([h] + diff_a, [h] + diff_b, 0)
    return n_eq, len(diff_a)


def _ring_rank_lines(card, launches, tims, kernels):
    """One line a rank of a ring run on the mesh: its steps, pieces,
    launches, exchanges (count, host s, bytes), 'ind' all-reduces, and its
    host mask, sampling plan and merge seconds."""
    for r, (lc, tj) in enumerate(zip(launches, tims)):
        c, st, ph = tj["counters"], tj["stages"], tj["phases"]
        ar_s = st.get("mesh: 'ind' all-reduce", 0.0)
        print(f"    rank {r}: {c.get('ring_steps', 0)} steps, "
              f"{c.get('ring_pieces', 0)} pieces, launches "
              + json.dumps({k: lc[k] for k in kernels})
              + f", {c.get('ring_exchanges', 0)} ring exchanges "
              f"({st.get('mesh: ring exchange', 0.0)} s, "
              f"{c.get('ring_exchange_bytes', 0)} bytes), "
              f"{c.get('ind_allreduces', 0)} 'ind' all-reduces "
              f"({ar_s} s); host mask "
              f"{st.get('ring: host mask', 0.0)} s, sampling plan "
              f"{ph.get('Sampling plan (taus draws, resident anchors)', 0.0)}"
              f" s, merge {ph.get('emit: merge + format', 0.0)} s, blocks "
              f"to rank 0 {ph.get('emit: blocks to rank 0', 0.0)} s [{card}]")


def _each_rank_only(launches, tims, kernel, count, label):
    """Every rank launched `kernel` as often as its own counter `count`
    says (its steps or its pieces), at least once, and no other kernel."""
    for r, (lc, tj) in enumerate(zip(launches, tims)):
        n = tj["counters"].get(count, 0)
        if kernel is not None and n < 1:
            raise AssertionError(f"{label}: rank {r} counted {n} {count}")
        _only([lc], kernel, n, f"{label}, rank {r}")


# two processes on the card: does gloo's point-to-point take a CUDA tensor
_GLOO_P2P_CODE = """
import datetime, sys
import torch, torch.distributed as dist
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
x = torch.full((4,), float(rank), device="cuda")
y = torch.empty(4, device="cuda")
try:
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                     dist.P2POp(dist.irecv, y, 1 - rank)]):
        w.wait()
    print("accepted", float(y[0]) == 1.0 - rank)
except Exception as e:
    print("refused:", type(e).__name__, str(e).splitlines()[0][:200])
"""


def _gloo_cuda_p2p(d, card):
    """Whether gloo's isend/irecv take CUDA tensors (the exchange stages
    through pinned host buffers where ranks share a card). Prints what
    the library does; the phase does not depend on it."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_P2P_CODE, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0].strip().splitlines())
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(["timed out"] + p.communicate()[0].splitlines())
    print("  gloo isend/irecv of CUDA tensors between two processes on the "
          "card: " + json.dumps([o[-1] if o else "" for o in outs])
          + f" [{card}]")


def phase_ring_mesh(tmp, card, ring):
    """Phase 10: the ring across two ranks that share the card (gloo),
    started through launcher variables: 10a R1 --ring --shard 2 (the strip
    stepper) against phase 7's R1 file; 10b the 2,048 x 4,000 file
    sampled at 0.1 in f64, --ring --shard 2 --ring_sub 2 (the gather
    stepper) against the one-device ring on the same flags; 10c the same
    in f32 with --ring --shard_ind 2 (one block, two 'ind' ranks) against
    the one-device ring; 10d 10a over NCCL where the box has two cards.
    Returns each rank's launches summed over the phase."""
    import torch
    d = os.path.join(tmp, "ringmesh")
    os.makedirs(d, exist_ok=True)
    total = [dict(_NO_LAUNCHES) for _ in range(2)]

    def add(launches):
        for acc, lc in zip(total, launches):
            for k in acc:
                acc[k] += lc[k]

    print(f"  two ranks on {torch.cuda.device_count()} card(s): the device "
          "collectives and the ring's exchange run over gloo, through "
          "pinned host buffers (walls measure the path on one shared card, "
          "not scaling)")
    # ---- 10a: R1 on two site blocks, against phase 7's one-device file
    r1 = ring["r1"]
    argv = r1["argv"][:r1["argv"].index("--verbose")] + ["--verbose", "1",
                                                         "--ring"]
    out = os.path.join(d, "r1_shard2.ld")
    wall, launches, tims = _launch_ranks(argv + ["--shard", "2"], out, 2,
                                         "10a")
    _each_rank_only(launches, tims, "strip_em", "ring_steps", "10a")
    add(launches)
    eq, near = _same_pairs_files(r1["out"], out, "10a")
    print(f"  10a R1 --ring --shard 2, {REAL_S} x {REAL_I}, all pairs at "
          f"--rnd_sample {RING_RATE}: {eq + near} rows, the pair set of "
          f"phase 7's one-device file, {eq} rows byte-equal, {near} within "
          f"the f32 contract; strip_em.cu launches a rank = its steps; wall "
          f"{wall:.3f} s (two new processes) [{card}]")
    _ring_rank_lines(card, launches, tims, ("strip_em",))

    # ---- 10b / 10c: the 2,048 x 4,000 file, sampled at 0.1
    dense = ring["dense"]
    glf = os.path.join(tmp, "large", f"tiled_{BIG_S}_{ROWS_I}.glf")
    if not os.path.exists(glf):
        _write_tiled_glf(dense["sim"], ROWS_I, glf)
    base = ["--geno", glf, "--log_scale", "--n_ind", str(ROWS_I),
            "--n_sites", str(BIG_S), "--pos", dense["pos"], "--max_kb_dist",
            "0", "--max_snp_dist", "128", "--extend_out", "--rnd_sample",
            "0.1", "--seed", "12345", "--ring", "--ring_sub", "2",
            "--verbose", "1"]
    for cell, extra, mesh_flags, kernel, count in (
            ("10b", ["--precision", "f64"], ["--shard", "2"], "pair_em_rows",
             "ring_pieces"),
            ("10c", ["--precision", "f32"], ["--shard_ind", "2"], None,
             "ring_pieces")):
        ref = os.path.join(d, f"{cell}_one.ld")
        _zero_launches()
        (rc, err), wall1 = _timed(lambda: _cli(base + extra + ["--out",
                                                               ref]))
        one_launches = _read_launches()
        if rc != 0:
            raise AssertionError(f"{cell} one device: rc {rc}\n"
                                 + err[-3000:])
        out = os.path.join(d, f"{cell}_mesh.ld")
        wall, launches, tims = _launch_ranks(base + extra + mesh_flags, out,
                                             2, cell)
        _each_rank_only(launches, tims, kernel, count, cell)
        add(launches)
        eq, near = _same_pairs(_read_lines(ref), _read_lines(out), cell)
        if cell == "10c" and not all(t["counters"].get("ind_allreduces")
                                     for t in tims):
            raise AssertionError(f"10c: no 'ind' all-reduce: {tims}")
        print(f"  {cell} --ring {' '.join(mesh_flags)} --ring_sub 2, "
              f"{BIG_S} x {ROWS_I} sampled at 0.1, {extra[1]}: {eq + near} "
              f"rows, the pair set of the one-device ring ("
              + json.dumps({k: v for k, v in one_launches.items() if v})
              + f", {wall1:.3f} s in this process), {eq} byte-equal, {near} "
              f"within the f32 contract; "
              + (f"{kernel} launches a rank = its pieces" if kernel else
                 "no kernel launched (the --shard_ind step is torch "
                 "operations around the all-reduce)")
              + f"; wall {wall:.3f} s (two new processes) [{card}]")
        _ring_rank_lines(card, launches, tims, (kernel,) if kernel else ())

    _gloo_cuda_p2p(d, card)
    # ---- 10d: 10a over NCCL needs two cards
    if torch.cuda.device_count() < 2:
        print("  10d (10a over NCCL): not run (one card on this box: two "
              "ranks would share it, which NCCL refuses)")
    else:
        out = os.path.join(d, "r1_nccl.ld")
        wall, launches, tims = _launch_ranks(argv + ["--shard", "2"], out, 2,
                                             "10d")
        _each_rank_only(launches, tims, "strip_em", "ring_steps", "10d")
        eq, near = _same_pairs_files(r1["out"], out, "10d")
        print(f"  10d R1 --ring --shard 2 over NCCL, one card a rank: {eq} "
              f"rows byte-equal, {near} within the f32 contract; wall "
              f"{wall:.3f} s [{card}]")
        _ring_rank_lines(card, launches, tims, ("strip_em",))
    print("  launches a rank over phase 10: " + json.dumps(total))
    return total

# ---------------------------------------------------------------- phase 11

CAP1_GATHER = 16                 # pair_em_phased's phase-1 cap (default)
CAP1_STRIP = 30                  # strip_em_twophase's phase-A cap (default)
EPS_TILES = 8                    # 11b: tiles whose eps meet the plain version
TWO_PHASE_TOL = 5e-5             # 11c: dev/strip_twophase.py's survivor bound


def _host_time(fn, reps=3):
    """Best of `reps` host-clock seconds of fn() after a warm-up, each
    closed by a device sync (for callers that pull to the host themselves
    or sync inside)."""
    import torch
    out = fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3, out


def _resume(gn, sidx, maf, ign, cap):
    """A launch capped at cap, then the pairs still running there resumed
    from its f64 state with the cap ITER_MAX - cap, merged on the device:
    ((f in gn's dtype, n_iter, n_used), the capped launch's outputs, the
    survivors' indices, the resumed launch's n_iter)."""
    import torch
    from ngsld_tpu_torch.kernels.pair_em import pair_em_gather
    capped = pair_em_gather(gn, sidx, maf, ign, iter_cap=cap, want_eps=True)
    f1, it1, nu1, _ = capped
    un = torch.nonzero(it1 == cap).squeeze(1)
    f2, it2, nu2 = pair_em_gather(gn, sidx.index_select(1, un), maf, ign,
                                  iter_cap=100 - cap,
                                  f0=f1.index_select(0, un))
    if not torch.equal(nu2, nu1.index_select(0, un)):
        raise AssertionError("resumed launch: n_used differs")
    merged = (f1.index_copy(0, un, f2).to(gn.dtype),
              it1.index_copy(0, un, cap + it2), nu1)
    return merged, capped, un, it2


def _gather_options(card, rep, report):
    """11a: pair_em.cu's option instance on phase 3's gather cell."""
    import torch
    from ngsld_tpu_torch.constants import EPSILON
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    cap = CAP1_GATHER
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        gn, sidx, maf = _table(MAIN_I, 20_000, MAIN_P, 5, dtype, dev)
        for ign in (False, True):
            label = f"11a pair_em {tag} P={MAIN_P} I={MAIN_I} " \
                    f"ignore_miss={ign}"
            one = pmod.pair_em_gather(gn, sidx, maf, ign)
            merged, capped, un, it2 = _resume(gn, sidx, maf, ign, cap)
            if not _same(merged, one):
                raise AssertionError(f"{label}: capped at {cap} + resumed "
                                     "differs from the one-phase launch")
            phased = pmod.pair_em_phased(gn, sidx, maf, ign, cap1=cap)
            if not all(np.array_equal(np.nan_to_num(a), np.nan_to_num(
                    b.cpu().numpy())) and np.array_equal(
                        np.isnan(a), np.isnan(b.cpu().numpy()))
                    for a, b in zip(phased, one)):
                raise AssertionError(f"{label}: pair_em_phased differs from "
                                     "pair_em_gather")
            # the capped launch against its plain version: f (both f64
            # states) and eps to the output tolerance, nIter, n_used exact
            ms_plain, plain = _time(lambda: pmod.pair_em_gather_ref(
                gn, sidx, maf, ign, iter_cap=cap, want_eps=True), 1, False)
            err, n_x0 = _check(capped[:3], plain[:3], tol,
                               f"{label} iter_cap={cap}", quiet=True)
            e_err = float((capped[3] - plain[3]).abs().max())
            if not e_err <= tol:
                raise AssertionError(f"{label}: max |eps_kernel - "
                                     f"eps_plain| {e_err} > {tol}")
            it1 = capped[1].cpu().numpy()
            eps = capped[3].cpu().numpy()
            late = (it1 < cap) & (it1 >= 1)
            if not ((eps[late, 0] < EPSILON).all()
                    and (eps[late, 1] >= EPSILON).all()
                    and (eps[it1 == cap, 0] >= EPSILON).all()):
                raise AssertionError(f"{label}: eps semantics broken")
            print(f"  {label}: capped at {cap} + {len(un)} survivors resumed "
                  f"warm = the one-phase launch bit for bit; pair_em_phased "
                  f"= pair_em_gather bit for bit; capped launch vs plain: "
                  f"max|df| {err:.3e}, max|d eps| {e_err:.3e} (tol {tol:g}), "
                  f"nIter and n_used exact, x=0 pairs {n_x0}")
            if ign:
                continue
            ms_one, _ = _time(lambda: pmod.pair_em_gather(gn, sidx, maf, ign))
            ms_p1, _ = _time(lambda: pmod.pair_em_gather(
                gn, sidx, maf, ign, iter_cap=cap, want_eps=True))
            f1, it1_d, _, eps_d = capped

            def pull_and_sort():
                meta = torch.cat([it1_d.double()[:, None], eps_d],
                                 dim=1).cpu().numpy()
                u = np.flatnonzero(meta[:, 0] == cap)
                return torch.from_numpy(u[pmod.phase2_order(
                    torch.from_numpy(meta[u, 1]),
                    torch.from_numpy(meta[u, 2])).numpy()]).to(dev)
            ms_sort, idx = _host_time(pull_and_sort)
            sidx2, f02 = sidx.index_select(1, idx), f1.index_select(0, idx)
            ms_p2, _ = _time(lambda: pmod.pair_em_gather(
                gn, sidx2, maf, ign, iter_cap=100 - cap, f0=f02))
            ms_phased, _ = _host_time(
                lambda: pmod.pair_em_phased(gn, sidx, maf, ign, cap1=cap))
            ms_one_pull, _ = _host_time(
                lambda: [t.cpu() for t in pmod.pair_em_gather(gn, sidx, maf,
                                                              ign)])
            # pair-iterations: a pair that stops at 0-based n ran n + 1
            n_one = one[1].cpu().numpy().astype(np.int64)
            counted = int(np.minimum(n_one + 1, 100).sum())
            exec1 = int(np.minimum(it1.astype(np.int64) + 1, cap).sum())
            exec2 = int(np.minimum(it2.cpu().numpy().astype(np.int64) + 1,
                                   100 - cap).sum())
            # the capped launch's bound: bytes once (table, index, MAFs in;
            # f64 f, two counts and f64 eps out), the updates it needs
            esz = gn.element_size()
            n_bytes = (gn.numel() + maf.numel()) * esz + sidx.numel() * 4 \
                + MAIN_P * (32 + 8 + 16)
            b_ms, b_by = _bound(n_bytes, exec1 * MAIN_I * FLOPS_PER_EVAL)
            phase3 = (f"{rep[tag]['ms']:.3f} ms" if rep and tag in rep
                      else "not run")
            print(f"  {label}: one phase {ms_one:.3f} ms (phase 3 "
                  f"{phase3}); phase 1 (cap {cap}, eps) {ms_p1:.3f} ms, "
                  f"bound {b_ms:.3f} ms by {b_by}, plain version "
                  f"{ms_plain:.3f} ms; pull and sort "
                  f"{ms_sort:.3f} ms (host clock); phase 2 ({len(un)} "
                  f"survivors, hardest first) {ms_p2:.3f} ms; phase 1 + "
                  f"pull + phase 2 {ms_p1 + ms_sort + ms_p2:.3f} ms; "
                  f"pair_em_phased {ms_phased:.3f} ms against the one-phase "
                  f"launch with its pull {ms_one_pull:.3f} ms (host clock); "
                  f"pair-iterations executed: one phase {counted}, phased "
                  f"{exec1} + {exec2} = {exec1 + exec2} (counted {counted}) "
                  f"[{card}]")
            report[tag] = dict(ms=ms_p1, plain_ms=ms_plain, bound_ms=b_ms,
                               bound_by=b_by, max_abs_err=max(err, e_err),
                               ms_one=ms_one, ms_sort=ms_sort, ms_p2=ms_p2,
                               ms_phased=ms_phased, n_surv=len(un))
        del gn, sidx, maf
    torch.cuda.synchronize()



def _strip_eps_semantics(nit, epsl, epsp, live, cap, label):
    """The reference's eps contract (tests/test_pallas_strip.py:706-748)
    on every live cell: a cell stopped at iteration n >= 1 last moved
    below EPSILON and before that not; a cell at the cap not below it;
    dead cells keep 1. Compared in f32, where the kernel rounds its f64
    eps. Returns the cells at the cap."""
    from ngsld_tpu_torch.constants import EPSILON
    eps32 = np.float32(EPSILON)
    nt, el, ep = nit[live], epsl[live], epsp[live]
    late = (nt < cap) & (nt >= 1)
    capped = nt == cap
    if not ((el[late] <= eps32).all() and (ep[late] >= eps32).all()
            and (el[capped] >= eps32).all()
            and (epsl[~live] == 1).all() and (epsp[~live] == 1).all()):
        raise AssertionError(f"{label}: eps semantics broken")
    return int(capped.sum())


def _strip_options(card, report):
    """11b: strip_em.cu's eps export; 11c: strip_em_twophase, both on phase
    3's strip cell."""
    import torch
    from ngsld_tpu_torch.kernels.strip_em import (strip_em, strip_em_compact,
                                                  strip_em_ref)
    from ngsld_tpu_torch.kernels.strip_twophase import strip_em_twophase
    dev = torch.device("cuda", 0)
    args, live, _ = _strip_case(MAIN_I, STRIP_S, STRIP_TILES, 5, dev)
    kw = dict(n_ind=MAIN_I)
    cells = f"tiles={STRIP_TILES} I={MAIN_I}"
    # ---- 11b: the export leaves the outputs as they were; its semantics;
    # its values against the plain version on a slice of tiles
    for cap in (100, CAP1_STRIP):
        label = f"11b strip_em {cells} iter_cap={cap}"
        ms_base, base = _time(lambda: strip_em(*args, iter_cap=cap, **kw))
        ms_eps, out = _time(lambda: strip_em(*args, iter_cap=cap,
                                             want_eps=True, **kw))
        if not _same(out[:4], base):
            raise AssertionError(f"{label}: want_eps changed f, r2p, nIter "
                                 "or n_used")
        nit, el, ep = (t.cpu().numpy() for t in (out[2], out[4], out[5]))
        n_cap = _strip_eps_semantics(nit, el, ep, live, cap, label)
        sl = args[:10] + (args[10][:EPS_TILES], args[11][:EPS_TILES])
        ms_plain, plain = _time(lambda: strip_em_ref(
            *sl, iter_cap=cap, want_eps=True, **kw), 1, False)
        if not torch.equal(plain[2], out[2][:EPS_TILES]):
            raise AssertionError(f"{label}: nIter differs from the plain "
                                 "version")
        e_err = max(float((plain[k] - out[k][:EPS_TILES]).abs().max())
                    for k in (4, 5))
        if not e_err <= F32_TOL:
            raise AssertionError(f"{label}: max |eps_kernel - eps_plain| "
                                 f"{e_err} > {F32_TOL}")
        # bound: phase 3's count with the two eps planes written, and
        # the updates this cap needs
        nit_live = base[2][torch.from_numpy(live).to(dev)]
        n_bytes = _strip_bound(args, nit_live, MAIN_I)[2] \
            + out[4].numel() * 8
        b_ms, b_by = _bound(n_bytes, _needed_evals(nit_live, MAIN_I, cap)
                            * FLOPS_PER_EVAL + STRIP_TILES * 128 * 128 * 2
                            * args[0].shape[2])
        print(f"  {label}: want_eps leaves f, r2p, nIter, n_used bit-equal; "
              f"eps semantics hold on {int(live.sum())} live cells ({n_cap} "
              f"at the cap); eps vs plain on {EPS_TILES} tiles max|d| "
              f"{e_err:.3e} (tol {F32_TOL:g}); {ms_eps:.3f} ms with eps, "
              f"{ms_base:.3f} ms without, bound {b_ms:.3f} ms by {b_by}; "
              f"plain version {ms_plain:.3f} ms for {EPS_TILES} tiles "
              f"[{card}]")
        if cap == CAP1_STRIP:
            ms_a = ms_eps
            report["strip"] = dict(ms=ms_eps, plain_ms=ms_plain,
                                   bound_ms=b_ms, bound_by=b_by,
                                   max_abs_err=e_err, ms_without=ms_base)
    # ---- 11c: two phases against one, on the live cells
    sel = torch.from_numpy(np.flatnonzero(live.reshape(-1))
                           .astype(np.int32)).to(dev)
    C = int(sel.numel())
    ms_one, (fm1, im1) = _time(lambda: strip_em_compact(*args, sel, **kw))
    ms_two, (fm2, im2, n_surv) = _time(lambda: strip_em_twophase(
        *args, sel, C, cap1=CAP1_STRIP, surv_cap=C, **kw))
    fm1, im1, fm2, im2 = (t.cpu().numpy() for t in (fm1, im1, fm2, im2))
    it1, it2 = im1[:, 0].astype(np.int32), im2[:, 0].astype(np.int32)
    conv = it1 < CAP1_STRIP
    label = f"11c strip_em_twophase {cells} cap1={CAP1_STRIP}"
    if n_surv != int((~conv).sum()):
        raise AssertionError(f"{label}: {n_surv} survivors, phase A of the "
                             f"one-phase run leaves {int((~conv).sum())}")
    if not (np.array_equal(np.isnan(fm1[conv]), np.isnan(fm2[conv]))
            and np.array_equal(np.nan_to_num(fm1[conv]),
                               np.nan_to_num(fm2[conv]))
            and np.array_equal(im1[conv], im2[conv])
            and np.array_equal(im1[:, 1], im2[:, 1])):
        raise AssertionError(f"{label}: rows that stopped in phase A are not "
                             "bit-equal")
    a, b = fm1[~conv], fm2[~conv]
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{label}: survivors' NaN positions differ")
    s_err = float(np.max(np.abs(np.nan_to_num(a) - np.nan_to_num(b)),
                         initial=0))
    within = float((np.abs(it1[~conv] - it2[~conv]) <= 1).mean())
    if not (s_err <= TWO_PHASE_TOL and within > 0.95):
        raise AssertionError(f"{label}: survivors max|d| {s_err} (tol "
                             f"{TWO_PHASE_TOL}), nIter within 1 on "
                             f"{within:.4f}")
    print(f"  {label}: {C} rows, {n_surv} survivors; rows stopped in phase A "
          f"bit-equal to strip_em_compact; survivors max|d| {s_err:.3e} (tol "
          f"{TWO_PHASE_TOL:g}), nIter within 1 on {within:.4f} (equal on "
          f"{float((it1[~conv] == it2[~conv]).mean()):.4f}); one phase "
          f"{ms_one:.3f} ms, two phases {ms_two:.3f} ms (phase A with eps "
          f"{ms_a:.3f} ms) [{card}]")
    report["twophase"] = dict(ms_one=ms_one, ms_two=ms_two, n_surv=n_surv)
    del args
    torch.cuda.synchronize()


# 11d: the capped instances of the rows and ichunk kernels, at their cap
# (below the cell's mean nIter) and at the default; their SASS names
CAP_ROWS_ICHUNK = 16
CAP_KERNELS_SASS = (("pair_em_rows", "pair_em_rows_kernel", "IfLb0ELb1E"),
                    ("pair_em_ichunk", "pair_em_cluster_kernel", "IfLb0ELb1E"),
                    ("pair_em_ichunk", "pair_em_ichunk_kernel", "IfLb0ELb1E"))


def _cap_options(card, big, report):
    """11d: pair_em_rows.cu's and both pair_em_ichunk.cu bodies' capped
    instances at phase 3b's large-cohort cells (2,048 random pairs of the
    tiled panel): pair_em_rows at 4,000 individuals (f32 and f64 tables),
    the cluster body and the streamed body (forced) at 20,000. Each at
    CAP_ROWS_ICHUNK and at the default cap: against its plain version
    (n_used and nIter exact, capped pairs at the cap, f to the table
    dtype's rounding), two launches bit-equal, the time beside its bound
    (bytes once and the updates the cap leaves) and phase 3b's default
    launch. Then the capped instances' SASS beside the default ones'."""
    import torch
    from ngsld_tpu_torch.kernels import pair_em as pmod
    dev = torch.device("cuda", 0)
    cap = CAP_ROWS_ICHUNK
    sidx = _random_pairs(BIG_P, 5)
    for name, n_ind, dtype, kern_fn, plain_fn, key in (
            ("pair_em_rows", ROWS_I, torch.float32, pmod.pair_em_rows,
             pmod.pair_em_rows_ref, "rows"),
            ("pair_em_rows", ROWS_I, torch.float64, pmod.pair_em_rows,
             pmod.pair_em_rows_ref, None),
            ("pair_em_ichunk cluster", BIG_I, torch.float32, _ichunk_cluster,
             pmod.pair_em_ichunk_ref, "ichunk"),
            ("pair_em_ichunk streamed", BIG_I, torch.float32,
             _ichunk_streamed, pmod.pair_em_ichunk_ref, None)):
        gn, _, maf = _tiled_panel(4_096, n_ind, 3, dev)
        gn, maf = gn.to(dtype), maf.to(dtype)
        tag = "f32" if dtype == torch.float32 else "f64"
        tol = F32_TOL if dtype == torch.float32 else F64_TOL
        times = {}
        for c in (cap, 100):
            label = f"11d {name} {tag} P={BIG_P} I={n_ind} iter_cap={c}"
            ms, out = _time(lambda: kern_fn(gn, sidx, maf, False, iter_cap=c))
            if not _same(out, kern_fn(gn, sidx, maf, False, iter_cap=c)):
                raise AssertionError(f"{label}: two launches differ")
            ms_p, plain = _time(lambda: plain_fn(gn, sidx, maf, False,
                                                 iter_cap=c), 1, False)
            err, _ = _check(out, plain, tol, label, quiet=True)
            it = out[1].cpu().numpy()
            n_cap = int((it == c).sum())
            if it.max() > c or (c == cap and n_cap == 0):
                raise AssertionError(f"{label}: nIter max {it.max()}, "
                                     f"{n_cap} pairs at the cap")
            b_ms, b_by, _, need = _gather_bound(gn, sidx, maf, out[1], c)
            times[c] = ms
            print(f"  {label}: {ms:.3f} ms, bound {b_ms:.3f} ms by {b_by} "
                  f"({need} needed evals), plain version {ms_p:.3f} ms; "
                  f"max|df| {err:.3e} (tol {tol:g}), nIter and n_used "
                  f"exact, {n_cap} of {BIG_P} pairs at the cap; two "
                  f"launches bit-equal [{card}]")
            if c == cap:
                report[f"{name} {tag}"] = dict(
                    ms=ms, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=err)
        p3 = ("not run" if big is None else
              f"{big[key]['ms']:.3f} ms" if key else
              f"{big['ichunk']['before_ms']:.3f} ms"
              if name.endswith("streamed") else "not timed")
        print(f"  11d {name} {tag}: capped {times[cap]:.3f} ms, default "
              f"launch {times[100]:.3f} ms here, phase 3b's {p3} "
              f"[{card}]")
        report[f"{name} {tag}"]["ms_default"] = times[100]
        del gn, maf, out, plain
    del sidx
    torch.cuda.synchronize()
    sass = _sass_lines(CAP_KERNELS_SASS)
    print("  11d capped instances' registers: "
          + json.dumps({k: v["regs"] for k, v in sass.items()}))


def phase_options(card, rep, big=None):
    """Phase 11: the kernel options (pair_em.cu's cap, warm start and eps;
    strip_em.cu's eps; the rows and ichunk kernels' cap) and the two-phase
    runs built on them. Returns the measurements and each wrapper's
    option-instance launches in the phase."""
    from ngsld_tpu_torch.kernels import pair_em as pmod
    from ngsld_tpu_torch.kernels import strip_em as smod
    pmod.LAUNCHES_OPTS = smod.LAUNCHES_EPS = 0
    pmod.LAUNCHES_ROWS_CAP = pmod.LAUNCHES_ICHUNK_CAP = 0
    report = {}
    _gather_options(card, rep, report)
    _strip_options(card, report)
    _cap_options(card, big, report)
    report["launches"] = dict(pair_em=pmod.LAUNCHES_OPTS,
                              strip_em=smod.LAUNCHES_EPS,
                              pair_em_rows=pmod.LAUNCHES_ROWS_CAP,
                              pair_em_ichunk=pmod.LAUNCHES_ICHUNK_CAP)
    print(f"  option-instance launches in phase 11: "
          + json.dumps(report["launches"]))
    return report


# ---------------------------------------------------------------- phase 12

# 12a: the JAX package's own end-to-end perf leg, 1M sites x 100
# individuals sampled (its 1M-SNP configuration), as OVL_TILES copies
# along the sites of one OVL_TILE-site simulation, the contigs renumbered
# so that the positions go on
OVL_I, OVL_TILE, OVL_TILES = 100, 100_000, 10
OVL_ARGS = ["--max_kb_dist", "0", "--max_snp_dist", "64", "--rnd_sample",
            "0.05", "--seed", "12345", "--extend_out"]
# 12b: a dense binary leg that the auto rule gives to the strip sweep
OVL_DENSE_S, OVL_DENSE_BAND = 4_096, 256
# 12c: slabs of 100 sites of the 12b file, a NaN three values before EOF
OVL_NAN_SLAB = 100 * OVL_I * 24
# 12d: slab sizes (cycled over the table) on both sides of the shapes at
# which a reduction kernel changes its launch; the 20,000-individual CLI
# leg in slabs of 409 sites, the last of 3
OVL_SLABS = (1, 7, 15, 16, 17, 100, 1000)
OVL_BIG_SLAB_SITES = 409
# 12e: one slab of the cohort cells' binary input as the loader cuts it
# (2,048 sites x 10,640 individuals in 256 MB slabs: 1,051 sites a slab)
NARROW_SLAB = (1_051, 10_640)


def _tiled_sites(sim, copies):
    """(chrom, pos) of sim's sites `copies` times over, each copy's
    contigs numbered after the last copy's."""
    n_contig = int(sim.chrom[-1].split("_")[1])
    num = np.array([int(c.split("_")[1]) for c in sim.chrom])
    chrom = [f"chrSIM_{k}" for t in range(copies)
             for k in (num + t * n_contig).tolist()]
    return chrom, np.tile(sim.pos, copies)


def _file_sink(path, n_pairs):
    """A _CountingStdout fed the TSV at `path` (its kept rows for a sample
    against strict, its line count) and the file's sha256."""
    sink = _CountingStdout(keep_every=max(1, n_pairs // 1000))
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            sink.write(chunk)
            h.update(chunk)
    if sink.n_lines != 1 + n_pairs or sink._tail:
        raise AssertionError(f"{path}: {sink.n_lines} lines, expected 1 + "
                             f"{n_pairs}")
    return sink, h.hexdigest()


def _with_and_without(argv, path, n_pairs, want, label, card):
    """The run with the overlap ingest (NGSLD_OVERLAP_UPLOAD unset) and
    without it ("0"), rows to a file: the counter in the first only, the
    launches `want` (or want(timings)) in both, the TSVs byte-equal.
    Returns {mode: (wall, timings, sink, sha256, stderr)} and prints both
    walls and stage splits."""
    runs = {}
    for mode, knob in (("overlap", None), ("without", "0")):
        with _env(NGSLD_OVERLAP_UPLOAD=knob):
            wall, launches, tim, err, _ = _file_run(argv, path)
        sink, sha = _file_sink(path, n_pairs)
        os.remove(path)
        on = tim["counters"].get("overlap_ingest") == 1
        if on != (mode == "overlap") or \
                ("  gl stream+upload" in tim["phases"]) == on:
            raise AssertionError(f"{label} {mode}: overlap counter "
                                 f"{tim['counters'].get('overlap_ingest')}, "
                                 f"phases {tim['phases']}")
        expect = want(tim) if callable(want) else want
        if launches != expect:
            raise AssertionError(f"{label} {mode}: launches {launches}, "
                                 f"expected {expect}")
        # the binary loader's kernel: one launch a slab, either way
        narrows = tim["counters"].get("launch:gl_narrow")
        if narrows != (tim["counters"]["ingest_slabs"] if on else
                       runs["overlap"][1]["counters"]["ingest_slabs"]):
            raise AssertionError(f"{label} {mode}: {narrows} gl_narrow "
                                 "launches, not one a slab")
        runs[mode] = (wall, tim, sink, sha, err)
        st = tim["stages"]
        # the end of the first dispatch span, from the run's start
        first = next((sp[4] for sp in tim["spans"]
                      if sp[0] == "sweep: dispatch"), 0) / 1e6
        print(f"  {label}, {'with' if on else 'without'} the overlap: "
              f"wall {wall:.3f} s, "
              f"{n_pairs / wall:.4e} pairs/s; ingest wait "
              f"{st.get('sweep: ingest wait', 0):.3f} s, start to first "
              f"dispatch {first:.3f} s, "
              f"slabs {tim['counters'].get('ingest_slabs', '-')}, gl_narrow "
              f"launches {narrows}, load: read "
              f"{st.get('load: read', 0):.3f} s [{card}]")
        print("    phases: " + json.dumps(tim["phases"]))
        print("    stages: " + json.dumps(st))
    if runs["overlap"][3] != runs["without"][3]:
        raise AssertionError(f"{label}: the TSVs differ (sha256 "
                             f"{runs['overlap'][3]} / {runs['without'][3]})")
    return runs


def _slabwise_preprocess(card, dev):
    """12d: ops.preprocess on a whole table against the same table in
    slabs of OVL_SLABS sites (cycled), raw log-scale records as the binary
    loader hands them over: every output byte-equal. Beside it, how many
    sites' plain torch.sum over the individuals would have changed bits
    with the slab's shape (what site_sum's fixed order removes)."""
    import torch
    from ngsld_tpu_torch.ops.preprocess import preprocess
    kw = dict(call=False, N_thresh=0.0, call_thresh=0.0,
              ignore_miss_data=False, raw=True, in_log=True)
    for n_ind, n_sites, dtype in ((OVL_I, 20_000, torch.float32),
                                  (OVL_I, 20_000, torch.float64),
                                  (BIG_I, BIG_S, torch.float32)):
        gn, _, _ = _tiled_panel(n_sites, n_ind, 7, dev)
        raw = torch.log(gn.to(dtype)).clamp_min(-1e15)
        del gn
        whole = preprocess(raw, **kw)
        cuts, a, k = [], 0, 0
        while a < n_sites:
            b = min(n_sites, a + OVL_SLABS[k % len(OVL_SLABS)])
            cuts.append((a, b))
            a, k = b, k + 1
        parts = [preprocess(raw[a:b], **kw) for a, b in cuts]
        for j, name in enumerate(("gn", "maf", "eg")):
            if not torch.equal(torch.cat([p[j] for p in parts]), whole[j]):
                raise AssertionError(f"12d I={n_ind} {dtype}: {name} slab "
                                     "by slab differs from the whole table")
        eg = whole[2]
        plain = torch.cat([eg[a:b].sum(dim=1) for a, b in cuts])
        n_diff = int((plain != eg.sum(dim=1)).sum())
        print(f"  12d preprocess {n_sites} x {n_ind} {str(dtype)[6:]}: "
              f"{len(cuts)} slabs of {OVL_SLABS} sites byte-equal to the "
              f"whole table (gn, maf, eg); torch.sum over the individuals "
              f"slab by slab would differ on {n_diff} of {n_sites} sites "
              f"[{card}]")
        del raw, whole, parts, eg, plain
    torch.cuda.synchronize()


def _narrow_slab(card, dev):
    """12e: csrc/gl_narrow.cu on one slab of raw log-scale doubles at
    NARROW_SLAB, narrowed to f32 and checked in f64, against its plain
    version (outputs bit-equal, both flags clear; three -infs in the last
    record set both), its time (CUDA events, best of 10) beside its bound
    and the plain version's time."""
    import torch
    from ngsld_tpu_torch.kernels import gl_narrow as gmod
    k, m = NARROW_SLAB
    gen = torch.Generator(device=dev).manual_seed(12)
    raw = torch.rand((k, m, 3), dtype=torch.float64, device=dev,
                     generator=gen).log_()
    out = {}
    for dtype, out_bytes in ((torch.float32, 12), (torch.float64, 0)):
        name = str(dtype)[6:]
        flags = [torch.zeros(1, dtype=torch.int32, device=dev)
                 for _ in range(2)]
        t_k, (got, f_k) = _time(lambda: (gmod.narrow_check(
            raw, dtype, True, flags[0]), flags[0]), reps=10)
        t_p, (want, f_p) = _time(lambda: (gmod.narrow_check_ref(
            raw, dtype, True, flags[1]), flags[1]), reps=3)
        if not (torch.equal(got, want) and int(f_k) == int(f_p) == 0):
            raise AssertionError(f"12e {name}: the kernel differs from its "
                                 f"plain version (flags {int(f_k)}, "
                                 f"{int(f_p)})")
        bound, side = _bound(k * m * (24 + out_bytes), 0)
        print(f"  12e gl_narrow {name} on {k} x {m} x 3 doubles "
              f"({k * m * 24} bytes): kernel {t_k:.4f} ms, bound "
              f"{bound:.4f} ms ({side}; {100 * bound / t_k:.1f}% of it), "
              f"plain version {t_p:.4f} ms; output bit-equal, flags "
              f"clear [{card}]")
        out[name] = dict(kernel_ms=t_k, bound_ms=bound, plain_ms=t_p)
        del got, want
    raw[-1, -1] = float("-inf")
    for dtype in (torch.float32, torch.float64):
        flags = [torch.zeros(1, dtype=torch.int32, device=dev)
                 for _ in range(2)]
        gmod.narrow_check(raw, dtype, True, flags[0])
        gmod.narrow_check_ref(raw, dtype, True, flags[1])
        if [int(f) for f in flags] != [1, 1]:
            raise AssertionError(f"12e {dtype}: a last record of three "
                                 f"-infs flagged {[int(f) for f in flags]}")
    print("  12e: three -infs in the slab's last record set both flags, "
          "f32 and f64")
    del raw
    torch.cuda.synchronize()
    return out


def phase_overlap(tmp, card, large=None):
    """Phase 12: the overlap ingest on the card (12a the 1M-site sampled
    leg, 12b a dense leg through the strip sweep, 12c a NaN near the end,
    12d 20,000 individuals, 12e the binary loader's kernel on one
    slab)."""
    import types

    import torch
    from ngsld_tpu_torch.utils.simulate import (simulate, write_glf_bin,
                                                write_pos)
    d = os.path.join(tmp, "overlap")
    os.makedirs(d, exist_ok=True)
    report = {}
    # ---- 12a: the 1M-site sampled leg, binary input
    t0 = time.perf_counter()
    sim = simulate(n_ind=OVL_I, n_sites=OVL_TILE, seed=17, contig_kb=500.0)
    n_sites = OVL_TILE * OVL_TILES
    chrom, pos = _tiled_sites(sim, OVL_TILES)
    glf, posf = os.path.join(d, "m1.glf"), os.path.join(d, "m1.pos")
    with np.errstate(divide="ignore"):
        lg = np.log(sim.gl)
    lg[np.isneginf(lg)] = -1e15
    lg = lg.astype(np.float64)
    with open(glf, "wb") as fh:
        for _ in range(OVL_TILES):
            lg.tofile(fh)
    with open(posf, "w") as fh:
        fh.write("".join(f"{c}\t{p}\n" for c, p in zip(chrom, pos.tolist())))
    del lg, sim
    print(f"  12a fixture: {n_sites} sites x {OVL_I} ({os.path.getsize(glf)} "
          f"bytes of doubles) in {time.perf_counter() - t0:.3f} s")
    argv = ["--geno", glf, "--log_scale", "--n_ind", str(OVL_I), "--n_sites",
            str(n_sites), "--pos", posf, *OVL_ARGS, "--verbose", "2"]
    pars, sizes = _plan_blocks(argv, posf, n_sites)
    n_pairs = sum(sizes)
    want = _ladder_launches(OVL_I, 4, sizes)
    label = f"12a {n_sites} x {OVL_I} sampled"
    runs = _with_and_without(argv, os.path.join(d, "m1.ld"), n_pairs, want,
                             label, card)
    n_rows = _sample_vs_strict(runs["overlap"][2], types.SimpleNamespace(
        chrom=chrom, pos=pos), pars)
    w_on, w_off = runs["overlap"][0], runs["without"][0]
    up = runs["without"][1]["phases"]["  gl stream+upload"]
    pre = runs["without"][1]["phases"]["  preprocess"]
    print(f"  {label}: {n_pairs} rows in {len(sizes)} blocks, launches "
          f"{json.dumps({k: v for k, v in want.items() if v})} (the ladder's, "
          f"no other kernel) in both runs, TSVs byte-equal (sha256 "
          f"{runs['overlap'][3][:16]}), {n_rows} sampled rows within the "
          f"f32 contract of strict; wall {w_on:.3f} s with the overlap, "
          f"{w_off:.3f} s without (gl stream+upload {up:.3f} s, preprocess "
          f"{pre:.3f} s there; the first run also allocates the loader's "
          f"pinned host slabs): with the overlap {w_off - w_on:.3f} s "
          f"shorter [{card}]")
    report["12a"] = dict(wall_on=w_on, wall_off=w_off, upload=up,
                         pairs=n_pairs)
    os.remove(glf)
    # ---- 12b: a dense leg through the strip sweep under the overlap
    sim_b = simulate(n_ind=OVL_I, n_sites=OVL_DENSE_S, seed=5,
                     contig_kb=500.0)
    glf_b, pos_b = os.path.join(d, "dense.glf"), os.path.join(d, "dense.pos")
    write_glf_bin(sim_b, glf_b)
    write_pos(sim_b, pos_b)
    argv_b = ["--geno", glf_b, "--log_scale", "--n_ind", str(OVL_I),
              "--n_sites", str(OVL_DENSE_S), "--pos", pos_b, "--max_kb_dist",
              "0", "--max_snp_dist", str(OVL_DENSE_BAND), "--extend_out",
              "--verbose", "2"]
    _, n_pairs_b, _ = _plan(argv_b, pos_b, OVL_DENSE_S)
    runs = _with_and_without(
        argv_b, os.path.join(d, "dense.ld"), n_pairs_b,
        lambda tim: dict(_NO_LAUNCHES,
                         strip_em=tim["counters"]["blocks_computed"]),
        f"12b {OVL_DENSE_S} x {OVL_I} dense", card)
    tim_on, err_on = runs["overlap"][1], runs["overlap"][4]
    chunks = tim_on["counters"]["blocks_computed"]
    if "==> strip sweep:" not in err_on or \
            "  gl ingest join (strip tables)" not in tim_on["phases"]:
        raise AssertionError("12b: not the strip sweep through join_all:\n"
                             + err_on[-3000:])
    print(f"  12b: {n_pairs_b} rows, {chunks} strip_em launches = chunks in "
          f"both runs, the strip tables after join_all ("
          f"{tim_on['phases']['  gl ingest join (strip tables)']:.3f} s), "
          f"TSVs byte-equal [{card}]")
    # ---- 12c: a NaN three values before EOF, many slabs, --out FILE
    raw = np.fromfile(glf_b, np.float64)
    raw[len(raw) - 3] = np.nan
    glf_c = os.path.join(d, "nan.glf")
    raw.tofile(glf_c)
    del raw
    out_c = os.path.join(d, "nan.ld")
    argv_c = ["--geno", glf_c, "--log_scale", "--n_ind", str(OVL_I),
              "--n_sites", str(OVL_DENSE_S), "--pos", pos_b, "--max_kb_dist",
              "0", "--max_snp_dist", "64", "--chunk_pairs", "16384",
              "--verbose", "0", "--out", out_c]
    with _env(NGSLD_SLAB_BYTES=str(OVL_NAN_SLAB), NGSLD_OVERLAP_UPLOAD=None):
        rc, err = _cli(argv_c)
    if rc == 0 or "NaN found" not in err or os.path.getsize(out_c) != 0:
        raise AssertionError(f"12c: rc {rc}, {os.path.getsize(out_c)} bytes "
                             f"out\n{err[-2000:]}")
    print(f"  12c: rc {rc}, 'NaN found' in stderr, the output file at 0 "
          f"bytes ({-(-OVL_DENSE_S // 100)} slabs of 100 sites)")
    for f in (glf_b, glf_c):
        os.remove(f)
    # ---- 12d: 20,000 individuals
    _slabwise_preprocess(card, torch.device("cuda", 0))
    big_glf = os.path.join(tmp, "large", f"tiled_{BIG_S}_{BIG_I}.glf")
    big_pos = os.path.join(tmp, "large", f"sim_{BIG_S}.pos")
    if large is None or not os.path.exists(big_glf):
        big_glf = os.path.join(d, "big.glf")
        big_pos = os.path.join(d, "big.pos")
        sim_p = simulate(n_ind=PANEL_I, n_sites=BIG_S, seed=19,
                         contig_kb=500.0)
        _write_tiled_glf(sim_p, BIG_I, big_glf)
        write_pos(sim_p, big_pos)
    argv_d = ["--geno", big_glf, "--log_scale", "--n_ind", str(BIG_I),
              "--n_sites", str(BIG_S), "--pos", big_pos, "--max_kb_dist", "0",
              "--max_snp_dist", "128", "--extend_out", "--rnd_sample", "0.1",
              "--seed", "12345", "--verbose", "2"]
    _, sizes_d = _plan_blocks(argv_d, big_pos, BIG_S)
    with _env(NGSLD_SLAB_BYTES=str(OVL_BIG_SLAB_SITES * BIG_I * 24)):
        runs = _with_and_without(argv_d, os.path.join(d, "big.ld"),
                                 sum(sizes_d),
                                 _ladder_launches(BIG_I, 4, sizes_d),
                                 f"12d {BIG_S} x {BIG_I} sampled", card)
    slabs = runs["overlap"][1]["counters"]["ingest_slabs"]
    if slabs != -(-BIG_S // OVL_BIG_SLAB_SITES):
        raise AssertionError(f"12d: {slabs} slabs")
    print(f"  12d: {sum(sizes_d)} rows, {slabs} slabs (the last of "
          f"{BIG_S % OVL_BIG_SLAB_SITES} sites), TSVs byte-equal [{card}]")
    # ---- 12e: the binary loader's kernel on one main-path slab
    report["12e"] = _narrow_slab(card, torch.device("cuda", 0))
    return report


# ---------------------------------------------------------------- phase 13

# 13a: entry()'s step against the CPU f64 step, the reference's contract
GRAFT_F, GRAFT_R2P = 3e-5, 2e-5


def _graft_step(card):
    """13a: entry()'s step on the card, its EM through pair_em.cu (one
    launch), against pair_em_gather_ref on the card (the kernel contract)
    and against the same step on the CPU in f64 (the reference's
    contract). Returns its launches."""
    import torch
    from ngsld_tpu_torch import graft_entry
    from ngsld_tpu_torch.kernels import pair_em as pmod
    step, args = graft_entry.entry()
    if not all(a.is_cuda and a.dtype == torch.float32 for a in args):
        raise AssertionError("13a: the example block is not f32 on the card")
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    if launches != dict(_NO_LAUNCHES, pair_em=1):
        raise AssertionError(f"13a: launches {launches}; expected one of "
                             "pair_em.cu")
    gn, sidx, maf = graft_entry.stacked(args[0], args[1], args[4], args[5])
    f_p, it_p, nu_p = pmod.pair_em_gather_ref(gn, sidx, maf, False)
    _zero_launches()
    err = float((out[1] - f_p).abs().max())
    if not (torch.equal(out[2], it_p) and torch.equal(out[3], nu_p)
            and err <= F32_TOL):
        raise AssertionError(f"13a: against pair_em_gather_ref: f {err:.3e}"
                             f" or nIter/n_used differ")
    cpu_step, _ = graft_entry.entry(device="cpu")
    ref = cpu_step(*(a.cpu().double() for a in args))
    f_err = float((out[1].cpu().double() - ref[1]).abs().max())
    r_err = float((out[0].cpu().double() - ref[0]).abs().max())
    close = float(((out[2].cpu().long() - ref[2].long()).abs() <= 1)
                  .double().mean())
    if not (f_err <= GRAFT_F and r_err <= GRAFT_R2P and close > 0.95
            and torch.equal(out[3].cpu(), ref[3])):
        raise AssertionError(f"13a: against the CPU f64 step: f {f_err:.3e}"
                             f", r2p {r_err:.3e}, nIter within 1 on "
                             f"{close:.4f}, or n_used differs")
    if not all(torch.isfinite(o).any() for o in out):
        raise AssertionError("13a: an output without a finite value")
    print(f"  13a entry() on the card: 256 pairs x 32, pair_em.cu 1 launch; "
          f"against pair_em_gather_ref: nIter, n_used equal, f {err:.3e} "
          f"(<= {F32_TOL}); against the CPU f64 step: f {f_err:.3e} (<= "
          f"{GRAFT_F}), r2p {r_err:.3e} (<= {GRAFT_R2P}), nIter within 1 on "
          f"{close:.4f}, n_used equal; step {wall:.4f} s [{card}]")
    return launches


def _graft_dryrun(n, card):
    """13b/13c: dryrun_multichip(n) on the card, the ranks sharing it
    (gloo): every check passes on every rank, strip_em.cu launched on
    each; its wall and each rank's launches."""
    from ngsld_tpu_torch import graft_entry
    out = graft_entry.dryrun_multichip(n)
    lc = out["launches"]
    if out["backend"] != "gloo" or len(lc) != n:
        raise AssertionError(f"dry run on {n}: backend {out['backend']}, "
                             f"{len(lc)} ranks reported")
    for r, c in enumerate(lc):
        if c["strip_em"] < 1 or c["pair_em_rows"] + c["pair_em"] < 1:
            raise AssertionError(f"dry run on {n}: rank {r} launches {c}")
    print(f"  dryrun_multichip({n}): ('pairs', 'ind') = {out['layout']}, "
          f"{n} ranks sharing the card over {out['backend']}; DRYRUN_OK; "
          f"wall {out['seconds']:.3f} s (the ranks' own "
          + ", ".join(f"{s:.3f}" for s in out["rank_seconds"]) + " s); "
          f"launches a rank " + json.dumps(lc) + f" [{card}]")
    return lc


def phase_graft(card):
    """Phase 13: the graft entry points of the port on the card (13a
    entry(), 13b dryrun_multichip(2), 13c dryrun_multichip(4)). Returns
    each kernel's launches: 13a's, and a list a rank for 13b and 13c."""
    one = _graft_step(card)
    two = _graft_dryrun(2, card)
    four = _graft_dryrun(4, card)
    return {k: {"13a": one[k], "13b": [c[k] for c in two],
                "13c": [c[k] for c in four]} for k in _NO_LAUNCHES}


def main(argv=()) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    results = []
    if "--strip-only" in argv:
        # a short look at the two strip kernels: build, their cells of
        # phases 3 and 3b, phase 3c; prints neither the kernels line nor
        # the ok line
        card = _phase(results, "1 environment", phase_env)
        _phase(results, "2 build", phase_build)
        _phase(results, "3 strip kernels vs plain",
               lambda: phase_kernel(card, gather=False))
        _phase(results, "3b streamed strip kernel vs plain",
               lambda: phase_kernel_large(card, gather=False))
        _phase(results, "3c strip kernels' design",
               lambda: phase_strip_design(card))
        print("chip_smoke --strip-only: "
              + ("PASS" if all(results) else "FAILED"))
        return 0 if all(results) else 1
    if "--gather-only" in argv:
        # a short look at the two gather kernels that phases 3 and 3b time:
        # build, their cells of phases 3 and 3b, phase 3d; prints neither
        # the kernels line nor the ok line
        card = _phase(results, "1 environment", phase_env)
        _phase(results, "2 build", phase_build)
        _phase(results, "3 gather kernel vs plain",
               lambda: phase_kernel(card, strip=False))
        _phase(results, "3b large-cohort gather kernels vs plain",
               lambda: phase_kernel_large(card, strip=False))
        _phase(results, "3d gather kernels' design",
               lambda: phase_gather_design(card))
        print("chip_smoke --gather-only: "
              + ("PASS" if all(results) else "FAILED"))
        return 0 if all(results) else 1
    if "--overlap-only" in argv:
        # the overlap ingest alone: build, phase 12; prints neither the
        # kernels line nor the ok line
        with tempfile.TemporaryDirectory(prefix="ngsld_chip_smoke_") as tmp:
            card = _phase(results, "1 environment", phase_env)
            _phase(results, "2 build", phase_build)
            _phase(results, "12 overlap ingest on the card",
                   lambda: phase_overlap(tmp, card))
        print("chip_smoke --overlap-only: "
              + ("PASS" if all(results) else "FAILED"))
        return 0 if all(results) else 1
    if "--dryrun-only" in argv:
        # the graft entry points alone: build, phase 13; prints neither the
        # kernels line nor the ok line
        card = _phase(results, "1 environment", phase_env)
        _phase(results, "2 build", phase_build)
        _phase(results, "13 the graft entry points on the card",
               lambda: phase_graft(card))
        print("chip_smoke --dryrun-only: "
              + ("PASS" if all(results) else "FAILED"))
        return 0 if all(results) else 1
    if "--kernels-only" in argv:
        # the kernels and their options: build, phase 3, phase 11; prints
        # neither the kernels line nor the ok line
        card = _phase(results, "1 environment", phase_env)
        _phase(results, "2 build", phase_build)
        rep = _phase(results, "3 kernel vs plain", lambda: phase_kernel(card))
        _phase(results, "11 the kernel options",
               lambda: phase_options(card, rep))
        print("chip_smoke --kernels-only: "
              + ("PASS" if all(results) else "FAILED"))
        return 0 if all(results) else 1
    if "--shard-only" in argv:
        # the multi-device block engine alone: build, the one-device runs
        # it is held against (phases 5, 5b, 6), phase 9; prints neither the
        # kernels line nor the ok line
        with tempfile.TemporaryDirectory(prefix="ngsld_chip_smoke_") as tmp:
            card = _phase(results, "1 environment", phase_env)
            _phase(results, "2 build", phase_build)
            real = _phase(results, "5 real size",
                          lambda: phase_real(tmp, card))
            large = _phase(results, "5b large cohort through the CLI",
                           lambda: phase_large(tmp, card))
            if real is not None and large is not None:
                _phase(results, "6 device idle share",
                       lambda: phase_idle(tmp, card, real))
                _phase(results, "9 the block engine on two ranks",
                       lambda: phase_shard(tmp, card, real, large))
        print("chip_smoke --shard-only: "
              + ("PASS" if all(results) else "FAILED"))
        return 0 if all(results) and len(results) == 6 else 1
    if "--ring-only" in argv:
        # a look at the ring alone: build, phase 7 (with phase 5b's dense
        # run for R2); prints neither the kernels line nor the ok line
        with tempfile.TemporaryDirectory(prefix="ngsld_chip_smoke_") as tmp:
            card = _phase(results, "1 environment", phase_env)
            _phase(results, "2 build", phase_build)
            ring = _phase(results, "7 ring sweep on the card",
                          lambda: phase_ring(tmp, card, None))
            if ring is not None:
                _phase(results, "10 the ring on two ranks",
                       lambda: phase_ring_mesh(tmp, card, ring))
        print("chip_smoke --ring-only: "
              + ("PASS" if all(results) else "FAILED"))
        return 0 if all(results) else 1
    with tempfile.TemporaryDirectory(prefix="ngsld_chip_smoke_") as tmp:
        card = _phase(results, "1 environment", phase_env)
        _phase(results, "2 build", phase_build)
        rep = _phase(results, "3 kernel vs plain", lambda: phase_kernel(card))
        big = _phase(results, "3b large-cohort kernels vs plain",
                     lambda: phase_kernel_large(card))
        _phase(results, "3c strip kernels' design",
               lambda: phase_strip_design(card))
        _phase(results, "3d gather kernels' design",
               lambda: phase_gather_design(card))
        _phase(results, "4 slice vs strict", lambda: phase_slice(tmp))
        real = _phase(results, "5 real size", lambda: phase_real(tmp, card))
        large = _phase(results, "5b large cohort through the CLI",
                       lambda: phase_large(tmp, card))
        if real is not None:
            _phase(results, "6 device idle share",
                   lambda: phase_idle(tmp, card, real))
        ring = _phase(results, "7 ring sweep on the card",
                      lambda: phase_ring(tmp, card, large))
        if real is not None:
            _phase(results, "8 --profile, the LD tools and extras/",
                   lambda: phase_profile_tools(tmp, card, real))
        if real is not None and large is not None:
            _phase(results, "9 the block engine on two ranks",
                   lambda: phase_shard(tmp, card, real, large))
        if ring is not None:
            mesh_ring = _phase(results, "10 the ring on two ranks",
                               lambda: phase_ring_mesh(tmp, card, ring))
        opts = _phase(results, "11 the kernel options",
                      lambda: phase_options(card, rep, big))
        _phase(results, "12 overlap ingest on the card",
               lambda: phase_overlap(tmp, card, large))
        graft = _phase(results, "13 the graft entry points on the card",
                       lambda: phase_graft(card))
    if not all(results):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # (name, source, the TPU kernel it replaces, launches on its main-path
    # run, phase 3/3b measurements); library_ms: no single PyTorch call
    # computes any of these functions; ring_launches: its launches on the
    # ring legs of phase 7
    rows = [
        ("pair_em_gather", "pair_em.cu", "pallas_em.py:57",
         real["gather_launches"], rep["f32"]),
        ("strip_em", "strip_em.cu", "pallas_strip.py:58",
         real["strip_launches"], rep["strip"]),
        ("strip_em_stream", "strip_em_stream.cu", "pallas_strip.py:273",
         large["dense"], big["stream"]),
        ("pair_em_rows", "pair_em_rows.cu", "pallas_em.py:391",
         large["rows"], big["rows"]),
        ("pair_em_ichunk", "pair_em_ichunk.cu", "pallas_em.py:558",
         large["sampled"], big["ichunk"])]
    # ring_mesh_launches: its launches a rank (rank 0, rank 1) over phase
    # 10's runs on two ranks; options_launches: the launches of its option
    # instance (pair_em.cu's cap, warm start and eps; strip_em.cu's eps;
    # the rows and ichunk kernels' cap) in phase 11; graft_launches: its
    # launches in phase 13 (13a's, then one a rank for 13b and for 13c)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"ngsld_tpu_torch/csrc/{src}",
         "replaces": f"ngsld_tpu/kernels/{tpu}", "launches": launches,
         **{k: m[k] for k in keys}, "library_ms": None,
         "ring_launches": ring["acc"][_RING_COUNT[name]],
         "ring_mesh_launches": [lc[_RING_COUNT[name]] for lc in mesh_ring],
         "graft_launches": graft[_RING_COUNT[name]],
         **({"options_launches": opts["launches"][_RING_COUNT[name]]}
            if _RING_COUNT[name] in opts["launches"] else {})}
        for name, src, tpu, launches, m in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
