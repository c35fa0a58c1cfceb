"""Site-sharded ring sweep (--ring), on one device or on a mesh of ranks,
one site block a rank: see _run_torch_ring
(ngsld_tpu/engine_ring.py::_run_jax_ring)."""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile

import numpy as np
import torch

from . import strict
from .checkpoint import _RingSpill
from .hostcols import _chi2_host, _stats_host
from .io.writer import RowWriter
from .kernels.strip_em import strip_i_align, strip_streamed, strip_tables
from .loaders import _ring_sharded_tables
from .ops.preprocess import preprocess
from .parallel.ring import (ring_subblock_taker, ring_subblock_taker_strip,
                            ring_sweep_stepper, ring_sweep_stepper_ind,
                            ring_sweep_stepper_strip)
from .plan.band import band_limits, child_seeds, contig_positions
from .plan.strips import TA
from .refine import (StrictRefiner, degenerate_tiers, knife_edge_sites,
                     repair_columns)
from .utils.signals import GracefulStop

# the narrow-band auto-route's cap on the tables' bytes (sites x
# individuals x 16): past it the block engine's rank 0 would hold them
# twice (the reference's design value, sized for a 16 GB TPU chip)
AUTOROUTE_MAX_BYTES = 4e9


class RingNarrowBand(RuntimeError):
    """Raised by _run_torch_ring (before any IO/output) when the banded
    plan is too narrow for the ring's rectangle steps: the band fits
    inside ONE step's partner sub-block, so most rectangle cells would be
    dead and the block engine is strictly better. run_torch catches this
    and runs the block engine instead."""

    def __init__(self, mean_w: float, b_sub: int):
        super().__init__(
            f"banded plan (mean live width {mean_w:.0f} sites) fits inside "
            f"one ring step's {b_sub}-site partner sub-block")
        self.mean_w, self.b_sub = mean_w, b_sub


def _local_blocks(arr, m=None) -> dict:
    """{block index -> host ndarray} of this rank's resident blocks (the
    reference's _local_blocks over a process's addressable shards): one
    rank holds one block, its own."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    return {0 if m is None else m.pi: np.asarray(arr)}


def _ind_maf(m, num, den):
    """est_maf over the whole cohort of a block split over its 'ind' ranks:
    numerator and denominator added up over the block's group in f64,
    then divided (the reference's sharded est_maf); in the table dtype."""
    P = num.shape[0]
    s = m.all_reduce(torch.cat([num.to(torch.float64),
                                den.to(torch.float64)]))
    return (s[:P] / s[P:]).to(num.dtype)


def _run_torch_ring(pars, out_fh, log, prec: str, device: torch.device,
                    m=None):
    """Site-sharded ring sweep (--ring), on one device or on the mesh m
    (parallel.mesh.Mesh: --shard N site blocks x --shard_ind M, one rank
    a device, rank r at block m.pi = r // M).

    Each rank loads its own block only (loaders._ring_sharded_tables:
    slab by slab into its device rows, host memory O(one slab); under
    --shard_ind its slice of the cohort) and preprocesses it on its
    device; under --shard_ind the MAF's sums are all-reduced over the
    block's ranks in f64. The (n,) MAF vector of every block is gathered
    to every rank over the host group, so every rank holds the same MAF,
    knife-edge repair, band limits and ok plane: the pair set is one
    device's. The pair space is swept as n_sub sub-rings: sub-ring si
    pairs the resident block's anchors with sub-block si (B_sub sites) of
    the block t positions along the ring, for the steps t the band
    reaches; after each step the visiting sub-block moves one position
    (Mesh.ring_shift). Each step computes its (B, B_sub) rectangle with
    one of three steppers (parallel.ring) and compacts it on the device
    to the live rows, in row-major (a, pj) order; the block's first rank
    (its owner) replays the same emission mask on the host for the
    (a, pj) labels and cross-checks the live count. Stepper rule: the
    strip kernels when NGSLD_FORCE_STRIP=1 or on a CUDA device in f32
    (the reference's rule with CUDA in the TPU's place; not under
    --shard_ind), else the gather stepper through the EM ladder, or its
    --shard_ind form. A kernel that fails to build or launch ends the run
    with its error: there is no retry on the other stepper.

    Every step's rows spill to disk (_RingSpill, files named by rank: a
    temporary directory, shared by the ranks of one node, or the
    --checkpoint dir, which makes the sweep resumable by (sub-ring,
    step); the ranks resume at the least step any of them left
    uncommitted). A stop (SIGINT/SIGTERM) on any rank stops every rank at
    the same step. The emit is a bounded-memory merge of each owner's
    spill (NGSLD_RING_EMIT_ROWS rows a chunk), deriving D/D'/r2/
    hap-MAFs/chi2 on the host and repairing degenerate pairs with
    refine's tiers, keyed on the precision of the values the stepper
    produced. The owners emit in parallel; on one node the blocks after
    the first are formatted into files of the spill directory and rank 0
    appends them to its output in block order, so the TSV is one
    device's; across nodes each owner writes its own OUT.partNNNNN (the
    engine opens it), which tools.merge joins.
    """
    n_dev = 1 if m is None else m.shard
    n_is = 1 if m is None else m.shard_ind
    rank = 0 if m is None else m.rank
    me = 0 if m is None else m.pi           # this rank's site block
    owner = m is None or m.ii == 0          # the block's rank that emits
    if pars.n_ind % n_is:
        raise strict.StrictError("shard", "--shard_ind must divide --n_ind")
    tmp_spill = None
    part_fh = part_path = None
    try:
        with log.phase("Getting sites coordinates"):
            if pars.in_pos:
                pos_dist, labels = strict.read_pos(
                    pars.in_pos, pars.in_pos_header, pars.n_sites)
            else:
                pos_dist = np.full(pars.n_sites, math.inf)
                labels = ["(null)"] * pars.n_sites

        n = pars.n_sites
        B = -(-n // n_dev)
        # sub-block ring: the per-step stat tile is (B, B_sub). 0 = auto:
        # ~4k sites per sub-block AND a cap on the per-step tile AREA (the
        # stepper's outputs and masks cost tens of bytes a cell on the
        # device). NGSLD_RING_AREA overrides the cap. Both are the
        # reference's design values, sized for a 16 GB TPU chip.
        area_cap = int(os.environ.get("NGSLD_RING_AREA", 60_000_000))
        n_sub = getattr(pars, "ring_sub", 0) or max(
            1, -(-B // 4096), -(-(B * B) // area_cap))
        n_sub = min(n_sub, B)
        # the strip-kernel stepper on the card in f32; NGSLD_FORCE_STRIP=1
        # forces it anywhere (the kernels' plain versions on the CPU)
        use_strip = n_is == 1 and (
            os.environ.get("NGSLD_FORCE_STRIP") == "1"
            or (device.type == "cuda" and prec == "f32"))
        # refine's tiers key on the precision of the values the STEPPER
        # produces: the strip kernels' are f32 even when the run is f64
        # (NGSLD_FORCE_STRIP on the CPU), so their fragile band must be
        # repaired as f32 output, or knife-edge D'/r2 ship f32 noise
        tier_prec = "f32" if use_strip else prec
        if use_strip:
            # B and B_sub in whole 128-site tiles
            B = -(-B // (n_sub * TA)) * (n_sub * TA)
        else:
            B = -(-B // n_sub) * n_sub   # sub-blocks must divide the block
        B_sub = B // n_sub

        # narrow-band auto-route: a band that fits inside ONE ring step's
        # partner sub-block leaves most rectangle cells dead; the block
        # engine wins outright there. Every rank decides alike, from the
        # same positions and flags, before any collective. Exempt: ranks
        # on several nodes (the block engine's rank 0 loads the whole
        # table), an explicit --ring_sub (the user is hand-tuning the
        # ring), a resumed ring checkpoint, tables too big to hold twice
        # (AUTOROUTE_MAX_BYTES), NGSLD_RING_AUTOROUTE=0.
        if ((m is None or not m.nodes)
                and not getattr(pars, "ring_sub", 0)
                and os.environ.get("NGSLD_RING_AUTOROUTE") != "0"):
            ck = getattr(pars, "checkpoint", None)
            ring_ckpt = False   # a resumed RING checkpoint pins the engine
            if ck and os.path.exists(os.path.join(ck, "MANIFEST.json")):
                try:
                    with open(os.path.join(ck, "MANIFEST.json")) as fh:
                        ring_ckpt = json.load(fh).get("mode") == "ring"
                except Exception:
                    ring_ckpt = True   # unreadable: don't reroute blindly
            tbl_bytes = float(pars.n_sites) * pars.n_ind * 16.0
            if not ring_ckpt and tbl_bytes <= AUTOROUTE_MAX_BYTES:
                hi_r = band_limits(pos_dist, pars.max_kb_dist,
                                   pars.max_snp_dist)
                live_w = np.maximum(
                    np.minimum(hi_r, n) - np.arange(n) - 1, 0)
                mean_w = float(live_w.mean()) if n else 0.0
                if mean_w <= B_sub:
                    raise RingNarrowBand(mean_w, B_sub)
        Sp = B * n_dev
        # the gather steppers' two visiting slots past the block, where
        # partners come from other ranks
        spare = 2 * B_sub if n_dev > 1 and not use_strip else 0
        np_dt = np.float64 if prec == "f64" else np.float32
        with log.phase("Reading data from file (site-sharded stream)"):
            gl_d, raw_gl = _ring_sharded_tables(
                pars, n_dev, B, Sp, np_dt, log, device, m, spare)
        with log.phase("Preprocessing (site-sharded) on device"):
            gn_d, maf_d, eg_d = preprocess(
                gl_d, call=pars.call_geno, N_thresh=pars.N_thresh,
                call_thresh=pars.call_thresh,
                ignore_miss_data=pars.ignore_miss_data,
                raw=raw_gl, in_log=pars.in_logscale,
                maf_of=(None if n_is == 1
                        else lambda num, den: _ind_maf(m, num, den)))
            del gl_d
            # np.array copies: knife-edge refinement writes into it
            maf = np.array(maf_d[:B].cpu().numpy(), np.float64)
            if n_dev > 1:
                # the masks need every block's MAF (partners live on
                # other ranks): the reference's process_allgather
                parts = m.all_gather_object(maf)
                maf = np.concatenate(parts[::n_is])
            maf = maf[:n]

        refiner = None

        def get_refiner():
            nonlocal refiner
            if refiner is None:
                refiner = StrictRefiner(pars)
            return refiner

        # pair-set stability: knife-edge sites take the strict f64 MAF so
        # the band masks below can never flip vs the reference
        ks = knife_edge_sites(maf, pars.min_maf, prec)
        if len(ks):
            maf[ks] = get_refiner().exact_maf(ks)
            log.log(2, f"==> strict MAF refinement: {len(ks)} knife-edge "
                       f"site(s) at min_maf={pars.min_maf}")
            log.count("maf_refined_sites", len(ks))

        hi = band_limits(pos_dist, pars.max_kb_dist, pars.max_snp_dist)
        contig, pos = contig_positions(pos_dist)
        ok = ~(maf < pars.min_maf)            # NaN passes, ngsLD.cpp:264/270

        # --rnd_sample: the reference's draw discipline (one taus uniform
        # per surviving candidate, in s2 order, from a per-anchor child
        # stream, ngsLD.cpp:164-166,277) without host-planning the global
        # pair set: the resident anchors' sampled draw-index sets, and a
        # pair's draw index recovered in O(1) as the ok-prefix-sum rank of
        # the partner within the anchor's band
        my_blocks = [me] if owner else []
        # the blocks whose step masks this rank replays: its own block's
        # owner, for the labels and the live-count check, and under
        # sampling every rank of the block, for the membership bits its
        # device masks with (each rank of a block computes the same plane
        # rather than receive it)
        mask_blocks = [me] if owner or pars.rnd_sample < 1.0 else []
        samp_keys = okc = None
        if pars.rnd_sample < 1.0:
            from .gsl_rng import iter_uniform_chunks
            seeds = child_seeds(pars.seed, n)
            okc = np.cumsum(ok.astype(np.int64))  # okc[j] = #ok in [0, j]
            # sampled pairs as a SORTED array of keys anchor*n + draw_index
            # (ascending anchors x ascending draw indices => concatenation
            # is already sorted; membership below is one searchsorted)
            parts = []
            with log.phase("Sampling plan (taus draws, resident anchors)"):
                for k in mask_blocks:
                    lo_s, hi_s = k * B, min(k * B + B, n)
                    if lo_s >= n:
                        continue
                    anchors = np.arange(lo_s, hi_s)[ok[lo_s:hi_s]]
                    if not len(anchors):
                        continue
                    # kept-candidate count per anchor (ok partners in band)
                    kept = (okc[np.maximum(hi[anchors] - 1, anchors)]
                            - okc[anchors])
                    for a0, a1, u in iter_uniform_chunks(seeds[anchors],
                                                         kept):
                        for r in range(a0, a1):
                            c_hit = np.flatnonzero(
                                u[r - a0, :kept[r]] <= pars.rnd_sample)
                            if len(c_hit):
                                parts.append(anchors[r] * np.int64(n) + c_hit)
            samp_keys = (np.concatenate(parts) if parts
                         else np.empty(0, np.int64))
        # max forward reach of any block's anchors past its start:
        # sub-ring si needs ring steps t while t*B + si*B_sub < maxspan
        starts = np.arange(n_dev) * B
        maxspan = int(max(
            (hi[s:min(s + B, n)].max(initial=0) - s) for s in starts
            if s < n))
        log.log(2, f"==> ring: {n_dev} block(s) of {B} sites, {n_sub} "
                   f"sub-blocks of {B_sub}")

        persistent = bool(getattr(pars, "checkpoint", None))
        if persistent:
            spill_dir = pars.checkpoint
        elif m is None or m.nodes:
            tmp_spill = tempfile.TemporaryDirectory(prefix="ngsld_ring_")
            spill_dir = tmp_spill.name
        else:
            # one node: rank 0's directory, shared; the emitted blocks
            # pass through it on their way to rank 0's output
            if rank == 0:
                tmp_spill = tempfile.TemporaryDirectory(prefix="ngsld_ring_")
            spill_dir = m.broadcast_object(
                tmp_spill.name if rank == 0 else None)
        # strip= pins WHICH stepper produced the spilled tiles and prec=
        # the precision of the run: values from another stepper or another
        # precision differ in the last bits, so a resume must never mix
        # them; ic= the streamed strip kernel's chunk (its summation
        # order); cols= the spilled record layout (slim-v2: a, pj, r2p, f,
        # n_iter[, n_used], the rest derived at merge); n_proc= and n_is=
        # the world and its 'ind' split, so a checkpoint of another
        # decomposition is refused
        extra = dict(mode="ring", n_dev=n_dev, n_sub=n_sub, block=B,
                     n_proc=1 if m is None else m.world,
                     strip=bool(use_strip), n_is=n_is, cols="slim-v2",
                     prec=prec)
        if use_strip and strip_streamed(pars.n_ind, device):
            extra["ic"] = strip_i_align(pars.n_ind, device)
        spill = _RingSpill(spill_dir, pars, extra, rank, persistent)
        rck = spill if persistent else None

        compact_cfg = dict(
            n=n, B=B, B_sub=B_sub, n_dev=n_dev,
            sample=pars.rnd_sample < 1.0,
            slim_im=not pars.ignore_miss_data,
            use_i16=pars.n_ind <= 32767)
        hip = np.zeros(Sp, np.int32)
        hip[:n] = hi
        okp = np.zeros(Sp, np.float32)
        okp[:n] = ok
        # the resident block's band limits and ok plane
        hi_d = torch.from_numpy(hip[me * B:me * B + B]).to(device)
        ok_d = torch.from_numpy(okp[me * B:me * B + B]).to(device)
        if use_strip:
            with log.phase("Building strip tables (device)"):
                ga_d, gb_d, ea_d, eb_d = strip_tables(
                    gn_d, eg_d, pars.n_ind,
                    i_align=strip_i_align(pars.n_ind, device))
                del gn_d, eg_d   # the strip layouts replace them
                maf_s = maf_d.to(torch.float32)
            stepper = ring_sweep_stepper_strip(
                pars.n_ind, B, B_sub, pars.ignore_miss_data, compact_cfg, m)
            log.log(2, f"==> ring: strip-kernel stepper ({B // TA}x"
                       f"{B_sub // TA} tiles a step"
                       + (", streamed kernel"
                          if strip_streamed(pars.n_ind, device) else "")
                       + ")")
        else:
            stepper = (ring_sweep_stepper if n_is == 1
                       else ring_sweep_stepper_ind)(
                pars.ignore_miss_data, pars.chunk_pairs, compact_cfg, m)
            log.log(2, "==> ring: gather stepper "
                       + ("" if n_is == 1 else
                          f"('sites', 'ind' over {n_is} ranks) ")
                       + f"(pieces of at most {pars.chunk_pairs} pairs)")
        writer = None
        if owner:
            if rank == 0 or m.nodes:
                part_fh = out_fh
            else:
                part_path = os.path.join(spill_dir, f"emit_b{me:05d}.tsv")
                part_fh = open(part_path, "wb")
            writer = RowWriter(part_fh, labels, pars.extend_out)
            if rank == 0:
                writer.write_header()

        def host_mask(i, si, t):
            """The emission mask of one resident block's (B, B_sub) step
            tile (triangle, real sites, MAF, band, sampling): the SAME
            predicate parallel.ring._tile_mask evaluates on the device.
            Returns (valid, samp) where samp is the sampling-membership
            plane the device still needs (packed bits), or None when
            --rnd_sample is off. The host side provides the (a, pj) labels
            and live counts; the device side ships only the surviving
            value rows."""
            A = (i * B + np.arange(B, dtype=np.int64))[:, None]    # (B, 1)
            PJ = (((i + t) % n_dev) * B + si * B_sub
                  + np.arange(B_sub, dtype=np.int64))[None, :]     # (1, Bs)
            valid = (PJ > A) & (PJ < n) & (A < n)
            valid &= ok[np.minimum(A, n - 1)] & ok[np.minimum(PJ, n - 1)]
            valid &= PJ < hi[np.minimum(A, n - 1)]   # band: s2 < hi[s1]
            samp = None
            if samp_keys is not None:
                # draw index of (a, pj) = #ok candidates strictly before
                # pj; one vectorized searchsorted over all valid cells
                samp = np.zeros_like(valid)
                if valid.any():
                    c = (okc[np.maximum(np.minimum(PJ, n) - 1, 0)]
                         - okc[np.minimum(A, n - 1)])
                    q = (np.minimum(A, n - 1) * np.int64(n) + c)[valid]
                    pos_in = np.searchsorted(samp_keys, q)
                    hit = pos_in < len(samp_keys)
                    hit[hit] = samp_keys[pos_in[hit]] == q[hit]
                    samp[valid] = hit
                valid = valid & samp
            return valid, samp

        CAPW = -(-(B * B_sub) // 32)

        def pack_bits(samp):
            """(B, B_sub) bool -> (CAPW,) u32, little-endian bit order
            (the exact layout parallel.ring._unpack_bits reads back, as
            bytes)."""
            by = np.packbits(samp.reshape(-1), bitorder="little")
            by = np.pad(by, (0, CAPW * 4 - len(by)))
            return by.view(np.uint32)

        cuda = device.type == "cuda"
        interrupted = False
        with log.phase("compute: ring sweep", encloses=True), \
                GracefulStop(log) as gs:
            for si in range(n_sub):
                if interrupted:
                    break
                # steps needed by THIS sub-ring: partners at ring step t
                # start t*B + si*B_sub past the anchor block's start
                t_max = min(n_dev,
                            -(-(maxspan - si * B_sub) // B) if B else 0)
                if t_max <= 0:
                    continue
                t0 = 0
                if rck is not None:
                    # resume: steps commit in order, so the first missing
                    # one is where the interrupted sweep stopped; resumed
                    # steps' tiles are already in the spill and the merge
                    # reads them straight from disk. Ranks may have
                    # stopped at different steps; all run the same
                    # collectives, so they resume at the least (a rank
                    # that committed further recomputes and overwrites)
                    while t0 < t_max and rck.done(si, t0):
                        t0 += 1
                    if m is not None:
                        t0 = m.host_reduce(t0, "min")
                    if t0:
                        log.count("ring_steps_resumed", t0)
                        log.log(2, f"==> ring ckpt: sub-ring {si} resumes "
                                   f"at step {t0}/{t_max}")
                if t0 >= t_max:
                    continue
                if use_strip:
                    vis = ring_subblock_taker_strip(
                        n_dev, n_sub, si, offset=t0, mesh=m)(
                            gb_d, eb_d, maf_s, ok_d)
                else:
                    vis = ring_subblock_taker(
                        n_dev, n_sub, si, offset=t0, with_ok=True, mesh=m)(
                            gn_d, eg_d, maf_d, ok_d)
                for t in range(t0, t_max):
                    # a stop on any rank stops every rank at this step
                    # (the survivors would wait in the next collective)
                    if (gs.stopped if m is None
                            else m.host_reduce(gs.stopped)):
                        # the last completed step is committed; a rerun
                        # with the same --checkpoint resumes right here
                        interrupted = True
                        break
                    # host mask pass: (a, pj) labels + live counts, and
                    # (when sampling) the packed membership bits the
                    # device ANDs into its own mask
                    with log.span("ring: host mask"):
                        masks = {i: host_mask(i, si, t) for i in mask_blocks}
                        bits = None
                        if compact_cfg["sample"]:
                            bits = torch.from_numpy(pack_bits(
                                masks[me][1]).view(np.uint8)).to(device)
                    with log.span("ring: steps"):
                        if cuda:
                            torch.cuda.reset_peak_memory_stats(device)
                        if use_strip:
                            res, *vis = stepper(ga_d, ea_d, hi_d, ok_d,
                                                maf_s, *vis, t, si, bits)
                        else:
                            res, *vis = stepper(gn_d, eg_d, maf_d, hi_d,
                                                ok_d, *vis, t, si, bits)
                        fm_d, im_d, cnt = res
                        if not use_strip:
                            # the gather steppers' pieces (one kernel launch
                            # each, or one --shard_ind step)
                            log.count("ring_pieces",
                                      -(-cnt // pars.chunk_pairs))
                        step_rows = {}
                        for i in mask_blocks:
                            valid, _ = masks[i]
                            a_idx, pj_idx = np.nonzero(valid)
                            live = len(a_idx)
                            # device/host mask agreement: the device count
                            # comes back with the rows
                            if cnt != live:
                                raise AssertionError(
                                    f"ring compact mismatch: device {cnt} "
                                    f"vs host {live} rows (block {i}, si "
                                    f"{si}, t {t})")
                            if live == 0 or not owner:
                                step_rows[i] = None
                                continue
                            fm = fm_d.cpu().numpy()
                            im = im_d.cpu().numpy()
                            # spill rows stay slim on disk: int32 labels,
                            # n_iter as pulled, and NO n_used column when
                            # it is the constant the merge synthesizes
                            cols_i = dict(
                                a=(i * B + a_idx).astype(np.int32),
                                pj=((((i + t) % n_dev) * B + si * B_sub
                                     + pj_idx).astype(np.int32)),
                                r2p=fm[:, 0], f=fm[:, 1:5],
                                n_iter=im[:, 0])
                            if im.shape[1] > 1:
                                cols_i["n_used"] = im[:, 1]
                            step_rows[i] = cols_i
                        del res, fm_d, im_d
                    peak = ""
                    if cuda:
                        pk = torch.cuda.max_memory_allocated(device)
                        log.counters["ring_step_peak_bytes"] = max(
                            pk, log.counters.get("ring_step_peak_bytes", 0))
                        peak = f", peak device memory {pk} bytes"
                    log.log(2, f"==> ring step (sub-ring {si}, t {t}): "
                               f"{cnt} rows{peak}")
                    with log.span("ring: spill"):
                        # the block's other ranks commit the step too (a
                        # marker with no rows): each rank resumes from its
                        # own
                        spill.save_step(si, t, step_rows)
                    del step_rows, masks
                    log.count("ring_steps")

        if interrupted:
            hint = (f"resume with the same --checkpoint {rck.dir}"
                    if rck is not None else
                    "rerun with --checkpoint DIR to make ring runs resumable")
            log.log(0, f"==> Interrupted mid ring sweep; completed steps "
                       f"are committed. {hint}")
            raise SystemExit(130)
        if m is not None:
            log.count("ring_exchanges", m.ring_exchanges)
            log.count("ring_exchange_bytes", m.ring_exchange_bytes)
            log.count_time("mesh: ring exchange", m.ring_exchange_s)
            if n_is > 1:
                log.count("ind_allreduces", m.allreduces)
                log.count_time("mesh: 'ind' all-reduce", m.allreduce_s)

        # Emit: bounded-memory merge over the spill. Each tile file is
        # already (a, pj)-sorted (row-major compaction), so rows for an
        # anchor RANGE are a contiguous slice of every tile: memmap the
        # tiles, walk per-tile cursors, and lexsort only one anchor-chunk
        # of rows at a time. Host memory is O(chunk rows), not O(emitted
        # rows); byte-identical to a global per-block lexsort because
        # (a, pj) is unique across a block's tiles.
        budget = int(os.environ.get("NGSLD_RING_EMIT_ROWS", 2_000_000))
        with log.phase("emit: merge + format"):
            for i in my_blocks:
                mms = [np.load(p, mmap_mode="r")
                       for p in spill.block_tiles(i)]
                total = sum(len(x) for x in mms)
                if total == 0:
                    continue
                if not pars.in_bin:
                    # gz-text inputs: prime the refiner's row caches for
                    # ALL of this block's fragile sites in ONE streaming
                    # parse (per-chunk priming would re-decompress the
                    # file once per merge chunk)
                    t1s = set()
                    for x in mms:
                        tt = degenerate_tiers(np.asarray(x["f"]), tier_prec)
                        which = tt == 1   # tier 2 reads no files
                        if which.any():
                            t1s.update(np.asarray(x["a"])[which])
                            t1s.update(np.asarray(x["pj"])[which])
                    if t1s:
                        get_refiner()._ensure(np.fromiter(t1s, np.int64))
                a_lo, a_hi = i * B, min(i * B + B, n)
                step = max(1, int(budget // max(1, total // max(1, B))))
                cursors = [0] * len(mms)
                a0 = a_lo
                while a0 < a_hi:
                    a1 = min(a0 + step, a_hi)
                    parts = []
                    for j, x in enumerate(mms):
                        e = int(np.searchsorted(x["a"], a1, side="left"))
                        if e > cursors[j]:
                            parts.append(np.asarray(x[cursors[j]:e]))
                            cursors[j] = e
                    a0 = a1
                    if not parts:
                        continue
                    cat = np.concatenate(parts)
                    cat = cat[np.lexsort((cat["pj"], cat["a"]))]
                    af, pf = cat["a"], cat["pj"]
                    dist = np.where(contig[af] == contig[pf],
                                    pos[pf] - pos[af], np.inf)
                    # derived columns come from the hap freqs HERE, in the
                    # EM dtype; _stats_host/_chi2_host mirror ops.stats op
                    # for op (the block engine's contract)
                    fh = cat["f"]
                    hmaf1, hmaf2, D, Dp, r2 = _stats_host(fh)
                    chi2 = (_chi2_host(fh) if pars.extend_out
                            else np.zeros(len(fh), np.float32))
                    cols = dict(
                        r2p=cat["r2p"], D=D, Dp=Dp,
                        r2=r2, f=fh, hmaf1=hmaf1,
                        hmaf2=hmaf2,
                        chi2=chi2.astype(np.float32),
                        n_iter=cat["n_iter"].astype(np.int32),
                        n_used=(cat["n_used"].astype(np.int32)
                                if "n_used" in (cat.dtype.names or ())
                                else np.full(len(cat), pars.n_ind,
                                             np.int32)),
                        maf1=maf[af], maf2=maf[pf])
                    tiers = degenerate_tiers(cat["f"], tier_prec,
                                             extra_nonfinite=(Dp, r2))
                    if tiers.any():
                        # the chunk widens to f64 (maf1/maf2 are copies
                        # already) so one formatter call emits the
                        # repaired rows with the rest
                        for k in ("r2p", "D", "Dp", "r2", "f",
                                  "hmaf1", "hmaf2"):
                            cols[k] = np.array(cols[k], np.float64)
                        repair_columns(cols, tiers, af, pf, get_refiner, log)
                    writer.write_block(
                        af, pf, dist, cols["r2p"], cols["D"], cols["Dp"],
                        cols["r2"], n_used=cols["n_used"],
                        maf1=cols["maf1"], maf2=cols["maf2"],
                        hap=cols["f"], hmaf1=cols["hmaf1"],
                        hmaf2=cols["hmaf2"], chi2=cols["chi2"],
                        n_iter=cols["n_iter"])
                    log.count("pairs_emitted", len(af))
        if m is not None and not m.nodes:
            # one node: rank 0 appends the other blocks' formatted rows
            # to its own, in block order, a bounded chunk at a time
            if part_path is not None:
                part_fh.close()
            parts = m.all_gather_object(part_path)
            if rank == 0:
                with log.phase("emit: blocks to rank 0"):
                    for path in parts:
                        if path is not None:
                            with open(path, "rb") as fh:
                                shutil.copyfileobj(fh, out_fh, 1 << 24)
                            os.remove(path)
        if refiner is not None:
            # sub-stage attribution of the strict-repair wall (the block
            # engine's keys: read/prep/cache/gather/pearson/em/stats)
            for k, v in sorted(refiner.t.items()):
                log.count_time(f"emit: refine/{k}", v)
    finally:
        if part_path is not None:
            part_fh.close()
        if tmp_spill is not None:
            tmp_spill.cleanup()
