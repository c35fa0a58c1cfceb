"""Single-device block sweep: ngsld_tpu/engine_block._run_jax_body in
PyTorch, with its two sweep modes.

  host: read GLs and positions (strict.read_pos). Binary and gz-text
        input stream to the device slab by slab (loaders); anything the
        loaders decline goes through strict.read_geno and one upload
  dev:  preprocess (call_geno, MAF, normal-space GLs, E[G]); streamed
        binary records are normalised here too (raw=True)
  host: MAF to host (f64 copy), knife-edge MAF repair, banded pair plan
        (plan.band.iter_pair_blocks) on a prefetch thread
  dev:  gather mode, per block: one (2, P) int32 index upload, Pearson r2
        + pair EM (compute.compute_block; the EM kernel follows the
        cohort size)
        strip mode, per chunk of <= GMAXT tiles: the tile list (and sel)
        upload, rectangle EM + r2 (compute.strip_compute_fn/strip_flat_fn)
        from strip tables built once on the device
  host: 3-stage emit pipeline (pull -> derive + format (native) -> write),
        rows in (s1, s2) order; degenerate pairs take refine's tiers

Under the overlap ingest (loaders._OverlapIngest, the reference's gate:
_overlap_engaged) the binary upload and the preprocess run slab by slab
under the sweep instead: the plan and the strip decision read a MAF of
zeros (at min_maf <= 0 their filter passes every site), each gather block
waits for its sites (stage `sweep: ingest wait`), the strip sweep waits
for the whole table, the emit reads the ingest's MAF, and a read error
that surfaces mid-sweep empties the output before it is raised.

Strip mode is f32-only and is picked when the plan is dense over its
rectangles (effective utilization >= NGSLD_STRIP_MIN_UTIL on a CUDA
device); NGSLD_BLOCK_STRIP=1/0 forces it on/off. Large cohorts take the
streamed strip kernel (kernels.strip_em.strip_streamed), whose tables pad
the individual axis to its chunk. Both modes regroup the
same iter_pair_blocks stream, so their pair sets are identical by
construction. A strip kernel that fails to build or launch ends the run
with its error: there is no retry on the gather sweep.
"""

from __future__ import annotations

import functools
import hashlib
import math
import os
import queue
import threading

import numpy as np
import torch

from . import compute, strict
from .checkpoint import _Checkpoint
from .hostcols import _prefetch_blocks, _unpack
from .io.writer import RowWriter
from .kernels.pair_em import pick_gather_kernel
from .kernels.strip_em import strip_i_align, strip_streamed, strip_tables
from .loaders import _OverlapIngest, _StreamedGLLoader, _StreamedTextLoader
from .native import (LabelBlob, format_rows_derive, get_lib,
                     make_labels_blob)
from .ops.preprocess import preprocess
from .parallel.strip_ind import strip_compute_ind
from .parallel.sweep import compute_block_ind
from .plan.band import PairBlock, band_limits, iter_pair_blocks
from .plan.strips import TA, TB, strip_plan
from .refine import (StrictRefiner, degenerate_tiers, derive_columns_f64,
                     knife_edge_sites)
from .utils.signals import GracefulStop

# pipeline-stage return sentinel: "nothing to forward downstream yet"
# (the fmt stage is accumulating chunks of a split anchor-tile group)
_PENDING = object()


def _overlap_engaged(pars, out_fh, m) -> bool:
    """The overlap ingest's gate (ngsld_tpu/engine_block.py:146-153):
    binary input through the streamed loader, NGSLD_OVERLAP_UPLOAD not
    "0", a plan that cannot depend on sites not yet read (min_maf <= 0:
    the filter `maf < min_maf`, ngsLD.cpp:264,270, passes them all), one
    device, no per-site echo of the tables (verbose < 7), and an output
    that a mid-sweep read error can leave empty (a --checkpoint, which
    writes the output only at the end, or a seekable one)."""
    return (_StreamedGLLoader.applicable(pars)
            and os.environ.get("NGSLD_OVERLAP_UPLOAD", "1") != "0"
            and pars.min_maf <= 0
            and m is None
            and pars.verbose < 7
            and (bool(pars.checkpoint)
                 or bool(getattr(out_fh, "seekable", lambda: False)())))


def _load(pars, log, prec: str, device: torch.device, get_refiner,
          overlap=False):
    """Read, upload and preprocess the input; MAF to the host with its
    knife-edge sites repaired. -> (gn_d, maf_d, eg_d, maf, pos_dist,
    labels, ingest). With overlap, the tables fill under the sweep:
    ingest (loaders._OverlapIngest) holds them, maf is its maf_host, and
    nothing may read a site before ingest.wait() or join_all() covers it;
    without, ingest is None."""
    np_dt = np.float64 if prec == "f64" else np.float32
    loader = None
    raw_gl = False   # the loader delivers UNNORMALISED records
    if _StreamedGLLoader.applicable(pars):
        # binary input: file slabs stream to the device while the positions
        # parse below; normalisation happens on the device
        loader = _StreamedGLLoader(pars, np_dt, device, stream_np=overlap,
                                   log=log)
        raw_gl = True
    elif _StreamedTextLoader.applicable(pars):
        # gz-text input: native line parsing streams to the device the same
        # way; records arrive already log-normalised
        loader = _StreamedTextLoader(pars, np_dt, device, log=log)
    else:
        with log.phase("Reading data from file"):
            geno_log = strict.read_geno(pars.in_geno, pars.in_bin,
                                        pars.in_probs, pars.in_logscale,
                                        pars.n_ind, pars.n_sites)
    with log.phase("Getting sites coordinates"):
        if pars.in_pos:
            pos_dist, labels = strict.read_pos(
                pars.in_pos, pars.in_pos_header, pars.n_sites)
        else:
            pos_dist = np.full(pars.n_sites, math.inf)
            labels = ["(null)"] * pars.n_sites
    if pars.verbose >= 6:
        for s in range(min(10, pars.n_sites)):
            log.log(6, f"{s}\t{pos_dist[s]:f}")

    pre = functools.partial(
        preprocess, call=pars.call_geno, N_thresh=pars.N_thresh,
        call_thresh=pars.call_thresh, ignore_miss_data=pars.ignore_miss_data,
        raw=raw_gl, in_log=pars.in_logscale)
    if overlap:
        with log.span("ingest: tables"):   # allocated on the device
            ingest = _OverlapIngest(
                loader, pars,
                torch.float64 if prec == "f64" else torch.float32, pre,
                device, log)
        log.count("gl_streamed")
        log.count("overlap_ingest")
        log.log(2, "==> overlap ingest: GL upload + preprocess run under "
                   "the sweep (coverage-gated blocks)")
        # knife_edge_sites is empty at min_maf <= 0, and the gate rules out
        # the verbose-7 echo of the tables
        return ingest.tables + (ingest.maf_host, pos_dist, labels, ingest)
    with log.phase("Preprocessing (call_geno, MAF, E[G]) on device",
                   encloses=True):
        if loader is not None:
            with log.phase("  gl stream+upload", level=2):
                gl_d = loader.join()
            log.count("gl_streamed")
        else:
            # narrow on the host first: GLs cross to the device once, at
            # the EM precision
            with log.phase("  gl upload", level=2):
                gl_d = torch.from_numpy(
                    np.asarray(geno_log, np_dt)).to(device)
                del geno_log
        with log.phase("  preprocess", level=2):
            gn_d, maf_d, eg_d = pre(gl_d)
            del gl_d
        # only MAF returns to the host (the plan needs it); the GL/E[G]
        # tables stay on the device for the sweep
        with log.phase("  maf to host", level=2):
            # np.array copies: knife-edge refinement writes into it
            maf = np.array(maf_d.cpu().numpy(), np.float64)

    # pair-set stability: sites whose device MAF sits within precision
    # noise of min_maf get the bit-exact strict MAF, so `maf < min_maf`
    # (ngsLD.cpp:264,270) can never flip a band vs the reference
    ks = knife_edge_sites(maf, pars.min_maf, prec)
    if len(ks):
        maf[ks] = get_refiner().exact_maf(ks)
        log.log(2, f"==> strict MAF refinement: {len(ks)} knife-edge "
                   f"site(s) at min_maf={pars.min_maf}")
        log.count("maf_refined_sites", len(ks))
    if pars.verbose >= 7:
        log.log(7, "==> Geno data")
        gn0 = gn_d[:min(10, pars.n_sites), 0, :].cpu().numpy()
        for s in range(min(10, pars.n_sites)):
            log.log(7, f"{s}\t{labels[s]}\t{maf[s]:f} "
                       f"({gn0[s,0]:f} {gn0[s,1]:f} {gn0[s,2]:f})")
    return gn_d, maf_d, eg_d, maf, pos_dist, labels, None


def _share(m, pars, dt, device, tabs):
    """Rank 0's device tables (gn, maf, eg) and the plan's host inputs
    (the repaired MAF, pos_dist) on every rank: the host arrays over the
    host group, the tables broadcast over the default group (the
    reference replicates them with device_put)."""
    S, I = pars.n_sites, pars.n_ind
    host = m.broadcast_object(None if m.rank else (tabs[3], tabs[4]))
    if m.rank:
        tabs = [torch.empty((S, I, 3), dtype=dt, device=device),
                torch.empty(S, dtype=dt, device=device),
                torch.empty((S, I), dtype=dt, device=device)]
    else:
        assert all(t.dtype == dt for t in tabs[:3])
    gn_d, maf_d, eg_d = (m.broadcast(t.contiguous()) for t in tabs[:3])
    return gn_d, maf_d, eg_d, host[0], host[1]


def _assemble(m, fm, im, spec):
    """Rank 0's rows of a block or chunk: its own piece (row 0's) and the
    other rows' pieces, received in row order. spec[p] = (sending rank,
    rows, places in the block's rows or None for row order)."""
    pieces = [(fm, im)] + [tuple(m.recv_rows(src, n, (fm, im)))
                           for src, n, _ in spec[1:]]
    if spec[0][2] is None:
        return (np.concatenate([p[0] for p in pieces]),
                np.concatenate([p[1] for p in pieces]))
    P = sum(n for _, n, _ in spec)
    out_fm = np.empty((P,) + fm.shape[1:], fm.dtype)
    out_im = np.empty((P,) + im.shape[1:], im.dtype)
    for (pfm, pim), (_, _, pos) in zip(pieces, spec):
        out_fm[pos], out_im[pos] = pfm, pim
    return out_fm, out_im


class _NoStop:
    """GracefulStop's place on ranks other than 0: they stop when rank 0
    ends them."""
    stopped = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _run_torch_body(pars, out_fh, log, prec: str, device: torch.device,
                    m=None):
    """The block sweep on one device, or this rank's part of it on a mesh
    (m, parallel.mesh.Mesh): rank 0 loads, formats and writes; every rank
    walks the same plan and computes its share of each block or chunk."""
    lead = m is None or m.rank == 0
    refiner = None

    def get_refiner():
        nonlocal refiner
        if refiner is None:
            refiner = StrictRefiner(pars)
        return refiner

    overlap = _overlap_engaged(pars, out_fh, m)
    tabs = (_load(pars, log, prec, device, get_refiner, overlap) if lead
            else (None,) * 7)
    gn_d, maf_d, eg_d, maf, pos_dist, labels, ingest = tabs
    try:
        _sweep(pars, out_fh, log, prec, device, m, get_refiner,
               gn_d, maf_d, eg_d, maf, pos_dist, labels, ingest)
    except BaseException:
        if ingest is not None and ingest.failed and not pars.checkpoint:
            # rows went out before the read error surfaced; the reference
            # prints nothing on bad input (it reads the whole table first,
            # read_data.cpp:44): the gate made sure the output can seek
            try:
                out_fh.seek(0)
                out_fh.truncate()
            except (OSError, ValueError):
                pass
        raise
    finally:
        if ingest is not None:
            ingest.stop()   # a no-op once the ingest has read everything
    if refiner is not None:
        for k, v in sorted(refiner.t.items()):
            log.count_time(f"sweep: fmt/refine/{k}", v)


def _sweep(pars, out_fh, log, prec, device, m, get_refiner, gn_d,
           maf_d, eg_d, maf, pos_dist, labels, ingest):
    """_run_torch_body's sweep over rank 0's tables (shared with the other
    ranks here), or over the overlap ingest's as they fill."""
    dt = torch.float64 if prec == "f64" else torch.float32
    lead = m is None or m.rank == 0
    n_shards = 1 if m is None else m.shard
    shard_ind = 1 if m is None else m.shard_ind
    if m is not None:
        with log.phase("Tables to every rank (broadcast from rank 0)"):
            gn_d, maf_d, eg_d, maf, pos_dist = _share(
                m, pars, dt, device, (gn_d, maf_d, eg_d, maf, pos_dist))
    # under the overlap the plan and the strip decision see a MAF of
    # zeros: at min_maf <= 0 their filter passes every site, and nothing
    # reads a site's MAF before the ingest has it
    maf_plan = maf if ingest is None else np.zeros(pars.n_sites)

    # every device receives the same share of a block (the reference's
    # rounding, so the block decomposition and the checkpoint fingerprint
    # match its run under the same flags)
    chunk = -(-int(pars.chunk_pairs) // n_shards) * n_shards

    # ---- sweep-mode selection: dense strip-tile rectangles vs gathered
    # pair blocks (ngsld_tpu/engine_block.py:286-334). Auto rule:
    # effective utilization (live-cell fraction x sampling rate: sampled-
    # out cells still burn EM compute) at least NGSLD_STRIP_MIN_UTIL, on a
    # CUDA device. NGSLD_BLOCK_STRIP=1/0 forces on/off.
    strip_mode = False
    strip_env = os.environ.get("NGSLD_BLOCK_STRIP")
    hi_b = None
    if strip_env != "0" and prec == "f32":
        with log.span("plan: strip plan"):
            hi_b = band_limits(pos_dist, pars.max_kb_dist, pars.max_snp_dist)
            ok_b = ~(maf_plan < pars.min_maf)
            # padded to whole anchor tiles; pad sites are not ok. (The TPU
            # engine adds one more all-dead partner tile to aim the padding
            # slots of a fixed-size dispatch at; here a dispatch launches
            # exactly its chunk's tiles.)
            Sp_b = -(-pars.n_sites // TA) * TA
            hi_p = np.zeros(Sp_b, np.int64)
            hi_p[:pars.n_sites] = hi_b
            ok_p = np.zeros(Sp_b, np.float32)
            ok_p[:pars.n_sites] = ok_b
            s_ta, s_tb, _, s_util = strip_plan(hi_p, ok_p, pars.n_sites, TA,
                                               TB)
        u_eff = s_util * pars.rnd_sample
        min_util = float(os.environ.get("NGSLD_STRIP_MIN_UTIL", "0.08"))
        strip_mode = len(s_ta) > 0 and (
            strip_env == "1"
            or (device.type == "cuda" and u_eff >= min_util))
        if len(s_ta) and not strip_mode and pars.verbose >= 2:
            log.log(2, f"==> strip sweep skipped: eff util {u_eff:.3f} < "
                       f"{min_util} (gather path)")
    if strip_mode:
        if ingest is not None:
            # the strip tables take the whole gn/eg tables (the upload
            # still ran under the positions parse, the plan and the strip
            # decision)
            with log.phase("  gl ingest join (strip tables)", level=2):
                gn_d, maf_d, eg_d = ingest.join_all()
            ingest.tables = ()   # freed with the gather tables below
        # past the resident kernel's cohort limit strip_em takes the
        # streamed kernel, and the tables pad the individual axis to its
        # chunk. With --shard_ind the step is parallel.strip_ind's (no
        # kernel): the individual axis splits over the row in 8-aligned
        # slices (ngsld_tpu/engine_block.py:342-345)
        s_streamed = shard_ind == 1 and strip_streamed(pars.n_ind, device)
        s_ialign = (8 * shard_ind if shard_ind > 1
                    else strip_i_align(pars.n_ind, device))
        with log.phase("strip tables (device)"):
            pad = Sp_b - pars.n_sites
            s_ga, s_gb, s_ea, s_eb = strip_tables(
                torch.nn.functional.pad(gn_d, (0, 0, 0, 0, 0, pad),
                                        value=1.0 / 3.0),
                torch.nn.functional.pad(eg_d, (0, 0, 0, pad)), pars.n_ind,
                i_align=s_ialign)
            # the gather tables are dead weight in strip mode
            del gn_d, eg_d, maf_d
            if shard_ind > 1:
                # this rank's slice of every record: the standardization
                # above used the whole cohort's moments
                ipl = s_ga.shape[2] // shard_ind
                i_start = m.ii * ipl
                cut = slice(i_start, i_start + ipl)
                s_ga, s_gb = (s_ga[:, :, cut].contiguous(),
                              s_gb[:, cut].contiguous())
                s_ea, s_eb = (s_ea[:, cut].contiguous(),
                              s_eb[cut].contiguous())
        s_maf = torch.from_numpy(np.pad(
            np.asarray(maf, np.float32), (0, pad),
            constant_values=0.5)).to(device)
        s_lo = torch.arange(1, Sp_b + 1, dtype=torch.int32, device=device)
        s_hi = torch.from_numpy(hi_p.astype(np.int32)).to(device)
        s_ok = torch.from_numpy(ok_p).to(device)
        # per-dispatch budgets: up to GMAXT tiles (the device output f is
        # (tiles, 4, TA, TB) f32, 67 MB at 256) and about CTARGET pairs per
        # chunk: narrow-band groups batch together so a dispatch carries
        # real work, oversized groups split into <= GMAXT-tile pieces
        GMAXT = max(1, min(len(s_ta), int(os.environ.get(
            "NGSLD_STRIP_TILES", "256"))))
        # --shard: a chunk's tiles split over the 'pairs' rows, so its
        # tile budget is a whole multiple of them (the reference's rule)
        GMAXT = -(-GMAXT // n_shards) * n_shards
        CTARGET = int(os.environ.get("NGSLD_STRIP_CTARGET", str(1 << 20)))
        TA_TB = TA * TB
        log.log(2, f"==> strip sweep: {len(s_ta)} tiles, chunk<= {GMAXT} "
                   f"tiles/{CTARGET} pairs, util {s_util:.2f}"
                   + (f", streamed kernel (I-chunk {s_ialign})"
                      if s_streamed else ""))
    elif shard_ind > 1:
        # the gather step for --shard_ind: this rank's slice of the cohort
        ipl = pars.n_ind // shard_ind
        cut = slice(m.ii * ipl, (m.ii + 1) * ipl)
        gn_d, eg_d = gn_d[:, cut].contiguous(), eg_d[:, cut].contiguous()

    # the in-band candidates the plan walks, before its MAF skip and
    # sampling (iter_pair_blocks' own counts), from the strip plan's band
    # limits where it made them
    if hi_b is None:
        hi_b = band_limits(pos_dist, pars.max_kb_dist, pars.max_snp_dist)
    log.count("plan_candidates", int(np.maximum(
        hi_b - np.arange(pars.n_sites) - 1, 0)[~(maf_plan < pars.min_maf)]
        .sum()))

    ckpt = None
    if pars.checkpoint:
        # the fingerprint pins the sweep decomposition (gather mode's
        # chunk, strip mode's tile-chunk geometry) and the EM precision:
        # shards from another of either must not be mixed. "order": split
        # groups merge to anchor-major rows under their final block index.
        if strip_mode:
            extra = {"mode": "strip", "ta": TA, "tb": TB, "gmaxt": GMAXT,
                     "ctarget": CTARGET, "order": "anchor", "prec": prec}
            if s_streamed:
                # the streamed kernel's chunk sets its summation order
                extra["ic"] = s_ialign
        else:
            extra = {"chunk": chunk, "prec": prec}
        if lead:
            ckpt = _Checkpoint(pars.checkpoint, pars, log, extra=extra)
            # per-block RowWriters share one label blob (O(n_sites))
            if get_lib() is not None:
                labels = LabelBlob(*make_labels_blob(labels))
    # the blocks committed before this run, the same on every rank: a
    # resume skips them all alike
    done_set = ckpt.done_set() if ckpt is not None else set()
    if m is not None and pars.checkpoint:
        done_set = m.broadcast_object(done_set if lead else None)
    writer = fmt_rw = None
    if lead:
        if ckpt is None:
            writer = RowWriter(out_fh, labels, pars.extend_out)
            writer.write_header()
        fmt_rw = writer if writer is not None \
            else RowWriter(None, labels, pars.extend_out)

    def pull(bi, blk, dev_out, meta=None, flat_sel=None, spec=None,
             rung=None):
        """Stage 1: device results -> host numpy (waits for the block's
        kernels on the current stream). Compacted strip chunks and gather
        blocks bring exactly their live rows; flat strip chunks (flat_sel)
        bring their whole tile rectangle and the sel permutation applies
        here as a numpy take. On a mesh (spec: each 'pairs' row's sending
        rank, rows and their places) the other rows' pieces arrive here,
        each from the first rank of its row, and join rank 0's own.
        rung: the gather rung that took the block (rank 0's piece of it
        on a mesh), passed on to fmt's counters."""
        with log.span("sweep: result pull"):
            fm = dev_out[0].cpu().numpy()
            im = dev_out[1].cpu().numpy()
            if flat_sel is not None:
                fm, im = fm[flat_sel], im[flat_sel]
        if spec is not None:
            fm, im = _assemble(m, fm, im, spec)
        return bi, blk, fm, im, meta, rung

    def send(bi, blk, dev_out, meta=None, flat_sel=None, spec=None,
             rung=None):
        """The pull stage of a rank other than 0: the first rank of each
        row sends its piece to rank 0; the others' rows are the same."""
        if m.ii == 0:
            m.send_rows([dev_out[0].cpu().numpy(),
                         dev_out[1].cpu().numpy()])

    pending = []   # pulled chunks of an in-flight split anchor group

    def fmt(bi, blk, fm, im, meta=None, rung=None):
        """Stage 2 (CPU): derive stats, format rows to bytes. Degenerate
        pairs (refine.degenerate_tiers) take the strict recompute (tier 1)
        or the f64 re-derive (tier 2) as override columns of the same
        native derive+format call.

        A split anchor-tile group's chunks (strip sweep, partner span >
        GMAXT*TB sites) arrive window-major; they accumulate here
        (meta="cont") and merge back into global (s1, s2) row order when
        the final chunk lands (meta=("final", run_first)); host memory
        for the merge is O(the group's rows)."""
        span0 = None
        if meta == "cont":
            pending.append((blk, fm, im))
            return _PENDING
        if meta is not None:
            span0 = meta[1]
            if pending:
                blks = [p[0] for p in pending] + [blk]
                blk = PairBlock(
                    s1=np.concatenate([b.s1 for b in blks]),
                    s2=np.concatenate([b.s2 for b in blks]),
                    dist=np.concatenate([b.dist for b in blks]))
                fm = np.concatenate([p[1] for p in pending] + [fm])
                im = np.concatenate([p[2] for p in pending] + [im])
                pending.clear()
                order = np.lexsort((blk.s2, blk.s1))
                blk = PairBlock(s1=blk.s1[order], s2=blk.s2[order],
                                dist=blk.dist[order])
                fm, im = fm[order], im[order]
        with log.span("sweep: format"):
            data = format_rows(blk, fm, im, rung)
        return bi, data, span0

    def format_rows(blk, fm, im, rung=None):
        """fmt's derive and format of a block's (or merged group's) rows
        -> the rows' bytes. rung: see pull."""
        with log.span("sweep: fmt/tiers"):
            n_iter = im[:, 0].astype(np.int32)
            if im.shape[1] > 1:
                n_used = im[:, 1].astype(np.int32)
            else:
                # slim layout (compute._imat): every pair used the whole
                # cohort
                n_used = np.full(im.shape[0], pars.n_ind, np.int32)
                im = np.column_stack([n_iter, n_used])
            its = int(n_iter.astype(np.int64).sum())
            log.count("em_iterations", its)
            if rung is not None:
                log.count("em_iterations_" + rung, its)
            if pars.verbose >= 2:
                log.hist("em_iteration_histogram",
                         np.bincount(np.clip(n_iter, 0, 100)))
            tiers = degenerate_tiers(fm[:, 1:5], prec)
            t1, t2 = tiers == 1, tiers == 2
        data = None
        if tiers.any():
            log.count("pairs_refined", int(t1.sum()))
            log.count("pairs_rederived", int(t2.sum()))
            use_native = bool(fmt_rw.native)
            if use_native:
                idx = np.flatnonzero(tiers)
                s1s, s2s, dists = blk.s1[idx], blk.s2[idx], blk.dist[idx]
                fms, ims = fm[idx], im[idx]
                t1s, t2s = t1[idx], t2[idx]
            else:
                idx = None
                s1s, s2s, dists = blk.s1, blk.s2, blk.dist
                fms, ims = fm, im
                t1s, t2s = t1, t2
            with log.span("sweep: fmt/unpack"):
                r2p, f, n_iter64, n_used64, hmaf0, hmaf1, D, Dp, r2, chi2 \
                    = _unpack(fms, ims, pars.extend_out)
                cols = dict(      # copies: fm-backed views are read-only
                    r2p=np.array(r2p, np.float64),
                    f=np.array(f, np.float64),
                    hmaf1=np.array(hmaf0, np.float64),
                    hmaf2=np.array(hmaf1, np.float64),
                    D=np.array(D, np.float64),
                    Dp=np.array(Dp, np.float64),
                    r2=np.array(r2, np.float64),
                    chi2=np.array(chi2, np.float32),
                    maf1=maf[s1s].copy(), maf2=maf[s2s].copy(),
                    n_iter=np.array(n_iter64, np.int32),
                    n_used=np.array(n_used64, np.int32))
            if t2s.any():
                with log.span("sweep: fmt/rederive"):
                    pol = derive_columns_f64(cols["f"][t2s])
                    for k in pol:
                        cols[k][t2s] = pol[k]
            if t1s.any():
                with log.span("sweep: fmt/refine"):
                    ref = get_refiner().refine_columns(s1s[t1s], s2s[t1s])
                    for k in cols:
                        cols[k][t1s] = ref[k]
            if use_native:
                with log.span("sweep: fmt/bulk"):
                    data = format_rows_derive(
                        fmt_rw.blob, fmt_rw.off, blk.s1, blk.s2, blk.dist,
                        fm[:, 0], fm[:, 1:5], maf[blk.s1], maf[blk.s2],
                        n_used, n_iter, pars.extend_out,
                        overrides=(idx, cols))
                    if data is None:
                        # only reachable on an fm dtype mismatch — a code
                        # bug
                        raise RuntimeError(
                            "native derive formatter rejected the chunk")
            else:
                with log.span("sweep: fmt/rows"):
                    data = fmt_rw.format_block(
                        s1s, s2s, dists, cols["r2p"], cols["D"], cols["Dp"],
                        cols["r2"], n_used=cols["n_used"], maf1=cols["maf1"],
                        maf2=cols["maf2"], hap=cols["f"], hmaf1=cols["hmaf1"],
                        hmaf2=cols["hmaf2"], chi2=cols["chi2"],
                        n_iter=cols["n_iter"])
        elif fmt_rw.native:
            # single native pass: D/D'/r2/hap-MAFs/chi2 derive inside the
            # formatter's worker threads from (r2p, f) directly
            data = format_rows_derive(
                fmt_rw.blob, fmt_rw.off, blk.s1, blk.s2, blk.dist,
                fm[:, 0], fm[:, 1:5], maf[blk.s1], maf[blk.s2], n_used,
                n_iter, pars.extend_out)
        if data is None:
            r2p, f, n_iter64, n_used64, hmaf0, hmaf1, D, Dp, r2, chi2 \
                = _unpack(fm, im, pars.extend_out)
            data = fmt_rw.format_block(
                blk.s1, blk.s2, blk.dist, r2p, D, Dp, r2,
                n_used=n_used64.astype(np.int32), maf1=maf[blk.s1],
                maf2=maf[blk.s2], hap=f, hmaf1=hmaf0, hmaf2=hmaf1,
                chi2=chi2, n_iter=n_iter64.astype(np.int32))
        return data

    def write(bi, data, span0=None):
        """Stage 3 (disk IO): write rows, or commit a checkpoint shard.

        A merged split group writes all its rows under its FINAL bi, then
        commits empty placeholder shards for the run's earlier bis
        (concatenate needs a dense block range; resume treats
        done(final_bi) as group-done and re-ensures placeholders)."""
        with log.span("sweep: write"):
            if ckpt is not None:
                with ckpt.open_block(bi) as bfh:
                    bfh.write(data)
                ckpt.commit_block(bi)
                if span0 is not None:
                    for j in range(span0, bi):
                        with ckpt.open_block(j):
                            pass
                        ckpt.commit_block(j)
            else:
                try:
                    out_fh.write(data)
                except TypeError:
                    out_fh.write(data.decode())

    # 3-stage emit pipeline on daemon threads (pull, fmt, write); FIFO
    # queues keep rows in (s1, s2) order. The heavy parts (device wait,
    # native formatting, file IO) release the GIL, so they overlap each
    # other and the main thread's dispatch.
    emit_q = queue.Queue(maxsize=3)   # main -> pull
    fmt_q = queue.Queue(maxsize=2)    # pull -> fmt
    write_q = queue.Queue(maxsize=2)  # fmt -> write
    emit_err = []

    def _stage(in_q, out_q, fn, name):
        def run():
            while True:
                item = in_q.get()
                if item is None:
                    if out_q is not None:
                        out_q.put(None)
                    return
                try:
                    res = fn(*item)
                except BaseException as e:
                    emit_err.append(e)
                    while in_q.get() is not None:  # unblock the producer
                        pass
                    if out_q is not None:
                        out_q.put(None)
                    return
                if res is _PENDING:
                    continue   # fmt is accumulating a split group
                if out_q is not None:
                    out_q.put(res)
        t = threading.Thread(target=run, daemon=True, name=name)
        t.start()
        return t

    if lead:
        stages = [_stage(emit_q, fmt_q, pull, "ngsld-pull"),
                  _stage(fmt_q, write_q, fmt, "ngsld-fmt"),
                  _stage(write_q, None, write, "ngsld-write")]
    else:
        stages = [_stage(emit_q, None, send, "ngsld-send")]
    # the ranks' pair plans must agree: a digest of every block's pairs,
    # compared at the end
    digest = hashlib.sha256()
    n_blocks = 0
    interrupted = False

    with log.phase("compute: banded pair sweep", encloses=True), \
            (GracefulStop(log) if lead else _NoStop()) as gs:
        if strip_mode:
            use_i16 = pars.n_ind <= 32767
            if shard_ind > 1:
                # ('pairs', 'ind'): parallel.strip_ind's step, one
                # all-reduce over the row an EM iteration
                strip_fn = functools.partial(
                    strip_compute_ind, n_ind=pars.n_ind, i_start=i_start,
                    mesh=m, ignore_miss=pars.ignore_miss_data,
                    use_i16=use_i16)
                log.log(2, "==> strip sweep: ('pairs', 'ind') mesh, one "
                           "all-reduce over 'ind' an EM iteration")
            else:
                strip_fn = compute.strip_compute_fn(
                    pars.n_ind, pars.ignore_miss_data, use_i16)
            # flat cell-major emission for near-full chunks: one relayout
            # on the device and a host-side numpy take in the (pipelined)
            # pull stage instead of the device sel gather. Pull bytes then
            # scale with CELLS, so only chunks with live/cells >= the
            # threshold qualify. NGSLD_STRIP_EMIT=compact|flat|auto. One
            # device only (:724-725).
            strip_flat_fn = None
            flat_util = 1.1
            emit_mode = os.environ.get("NGSLD_STRIP_EMIT", "auto")
            if emit_mode != "compact" and m is None:
                strip_flat_fn = compute.strip_flat_fn(
                    pars.n_ind, pars.ignore_miss_data, use_i16)
                flat_util = (-1.0 if emit_mode == "flat" else float(
                    os.environ.get("NGSLD_STRIP_FLAT_UTIL", "0.92")))

            def strip_chunks():
                """Regroup the banded pair stream (iter_pair_blocks, the
                SAME plan source as the gather sweep, so the pair sets are
                identical by construction, sampling included) by anchor
                tile; BATCH whole anchor-tile groups (splitting oversized
                ones) into dispatch chunks of <= GMAXT tiles / about
                CTARGET pairs. Yields (ta_slots, tb_slots, sel, PairBlock,
                rem): rem > 0 marks a chunk whose anchor-tile group
                continues for `rem` more chunks; its rows are
                window-major, and the emit pipeline merges the whole run
                back into global (s1, s2) order before formatting (a split
                group's non-final pieces span exactly GMAXT tiles, so they
                never share a chunk with anything else)."""
                pend = []      # stream pieces of the CURRENT group
                cur = -1
                acc = []       # whole group-pieces of the open chunk
                acc_tiles = acc_pairs = 0

                def flush(rem=0):
                    nonlocal acc, acc_tiles, acc_pairs
                    ta_l, tb_l, sels, cols = [], [], [], []
                    off = 0
                    for (k, j0, gc, a, b, d) in acc:
                        ta_l.append(np.full(gc, k, np.int32))
                        tb_l.append(np.arange(j0, j0 + gc, dtype=np.int32))
                        sels.append((((off + b // TB - j0) * TA
                                      + (a - k * TA)) * TB
                                     + b % TB).astype(np.int32))
                        cols.append((a, b, d))
                        off += gc
                    acc, acc_tiles, acc_pairs = [], 0, 0
                    return (np.concatenate(ta_l), np.concatenate(tb_l),
                            np.concatenate(sels),
                            PairBlock(
                                s1=np.concatenate([c[0] for c in cols]),
                                s2=np.concatenate([c[1] for c in cols]),
                                dist=np.concatenate([c[2] for c in cols])),
                            rem)

                def add_group(k, a, b, d):
                    """Split the group at GMAXT-tile partner windows
                    (window-major: each tile computes once), then pack
                    pieces into chunks. Every non-final piece spans
                    exactly GMAXT tiles, fills its own chunk and is
                    flushed immediately with rem = pieces of this group
                    still to come; the final piece batches with following
                    groups as usual (rem=0)."""
                    nonlocal acc_tiles, acc_pairs
                    j_end = max(k + 1, -(-int(b.max() + 1) // TB))
                    pieces = []
                    for c0 in range(k, j_end, GMAXT):
                        c1 = min(c0 + GMAXT, j_end)
                        m = (b >= c0 * TB) & (b < c1 * TB)
                        if not m.any():
                            continue
                        pieces.append((k, c0, c1 - c0, a[m], b[m], d[m]))
                    for pi, piece in enumerate(pieces):
                        rem = len(pieces) - 1 - pi
                        if acc and (acc_tiles + piece[2] > GMAXT
                                    or acc_pairs + len(piece[3]) > CTARGET):
                            yield flush()
                        acc.append(piece)
                        acc_tiles += piece[2]
                        acc_pairs += len(piece[3])
                        if rem:
                            yield flush(rem)

                for blk0 in iter_pair_blocks(pars, maf_plan, pos_dist,
                                             block_pairs=chunk):
                    ks = blk0.s1 // TA
                    edges = np.r_[0, np.flatnonzero(np.diff(ks)) + 1,
                                  len(ks)]
                    for e0, e1 in zip(edges[:-1], edges[1:]):
                        k = int(ks[e0])
                        part = (blk0.s1[e0:e1], blk0.s2[e0:e1],
                                blk0.dist[e0:e1])
                        if k != cur and pend:
                            grp = [np.concatenate(x) for x in zip(*pend)]
                            pend.clear()
                            yield from add_group(cur, *grp)
                        cur = k
                        pend.append(part)
                if pend:
                    grp = [np.concatenate(x) for x in zip(*pend)]
                    yield from add_group(cur, *grp)
                if acc:
                    yield flush()

            bi = -1
            skip_until = -1   # resumed split-group fast-forward
            run_first = run_last = -1  # in-flight split-group span
            try:
                for item in _prefetch_blocks(
                        log.spans_of("plan: block", strip_chunks()), depth=2):
                    ta_slots, tb_slots, sel, blk, rem = item
                    bi += 1
                    n_blocks = bi + 1
                    if gs.stopped or emit_err:
                        interrupted = not emit_err
                        break
                    if m is not None:
                        digest.update(blk.s1.tobytes() + blk.s2.tobytes())
                    if bi <= skip_until:
                        log.count("blocks_resumed")
                        continue
                    if pars.checkpoint and bi > run_last:
                        if rem and bi + rem in done_set:
                            # the whole split group was committed as one
                            # merged shard at its final bi; the earlier
                            # bis are empty placeholders: (re)commit any
                            # the writer did not reach
                            for j in range(bi, bi + rem):
                                if lead and not ckpt.done(j):
                                    with ckpt.open_block(j):
                                        pass
                                    ckpt.commit_block(j)
                            skip_until = bi + rem
                            log.count("blocks_resumed")
                            continue
                        if not rem and bi in done_set:
                            log.count("blocks_resumed")
                            continue
                    if rem and bi > run_last:
                        run_first, run_last = bi, bi + rem
                    if run_last >= 0 and bi == run_last:
                        meta = ("final", run_first)
                        run_first = run_last = -1
                    elif bi < run_last:
                        meta = "cont"
                    else:
                        meta = None
                    P = len(sel)
                    gc = len(ta_slots)
                    log.count("pairs_emitted", P)
                    log.count("blocks_computed")
                    if pars.verbose >= 3:
                        log.log(3, f"> Strip chunk {bi}: {gc} tiles (anchor "
                                   f"tiles {ta_slots[0]}..{ta_slots[-1]}), "
                                   f"{P} pairs")
                    # emission mode: flat cell-major for near-full chunks
                    # (host-side sel, no device gather); compacted rows
                    # otherwise
                    use_flat = (strip_flat_fn is not None
                                and P >= flat_util * gc * TA_TB)
                    with log.span("sweep: dispatch"):
                        spec = None
                        if m is not None:
                            # this row's tiles and the cells of sel in them;
                            # rank 0 puts every row's rows at their places
                            shares = compute.strip_shares(gc, sel, n_shards)
                            t_lo, t_hi, _, sel = shares[m.pi]
                            ta_slots = ta_slots[t_lo:t_hi]
                            tb_slots = tb_slots[t_lo:t_hi]
                            spec = [(p * shard_ind, len(sh[2]), sh[2])
                                    for p, sh in enumerate(shares)]
                            if shard_ind > 1:
                                log.count("ind_strip_chunks")
                        # exactly the chunk's tiles launch and, compacted,
                        # exactly P rows come back (no padding to GMAXT tiles
                        # or to a sel capacity)
                        args = (s_ga, s_gb, s_ea, s_eb, s_maf, s_maf, s_lo,
                                s_hi, s_ok, s_ok,
                                torch.from_numpy(ta_slots).to(device),
                                torch.from_numpy(tb_slots).to(device))
                        if use_flat:
                            dev_out = strip_flat_fn(*args)   # async
                        else:
                            dev_out = strip_fn(
                                *args, torch.from_numpy(sel).to(device))
                    with log.span("sweep: emit wait"):
                        emit_q.put((bi, blk, dev_out, meta,
                                    sel if use_flat else None, spec))
            finally:
                with log.span("sweep: emit wait"):
                    emit_q.put(None)
                    for t in stages:
                        t.join()
            if emit_err:
                raise emit_err[0]
        else:
            blocks_it = enumerate(_prefetch_blocks(log.spans_of(
                "plan: block", iter_pair_blocks(pars, maf_plan, pos_dist,
                                                block_pairs=chunk))))
            try:
                while True:
                    with log.span("sweep: plan wait"):
                        bi, blk = next(blocks_it, (None, None))
                    if blk is None:
                        break
                    n_blocks = bi + 1
                    if gs.stopped or emit_err:
                        interrupted = not emit_err
                        break
                    if m is not None:
                        digest.update(blk.s1.tobytes() + blk.s2.tobytes())
                    if bi in done_set:
                        log.count("blocks_resumed")
                        continue
                    P = len(blk.s1)
                    log.count("pairs_emitted", P)
                    log.count("blocks_computed")
                    if pars.verbose >= 3:
                        log.log(3, f"> Block {bi}: anchors "
                                   f"{blk.s1[0]}..{blk.s1[-1]}, {P} pairs")
                    if ingest is not None:
                        # dispatch only once every site of the block is in
                        with log.span("sweep: ingest wait"):
                            gn_d, maf_d, eg_d = ingest.wait(
                                int(blk.s2.max()) + 1)
                    with log.span("sweep: dispatch"):
                        # this row's contiguous piece of the block (all of it
                        # on one device)
                        bnd = compute.split_bounds(P, n_shards)
                        lo_p = bnd[0 if m is None else m.pi]
                        hi_p = bnd[1 if m is None else m.pi + 1]
                        spec = None if m is None else [
                            (p * shard_ind, bnd[p + 1] - bnd[p], None)
                            for p in range(n_shards)]
                        # one fused (2, P) index upload per block; exactly P
                        # pairs launch and P rows come back (no padding
                        # quantum)
                        sidx = torch.from_numpy(np.stack(
                            [blk.s1[lo_p:hi_p], blk.s2[lo_p:hi_p]]).astype(
                                np.int32)).to(device)
                        rung = None
                        if shard_ind > 1:
                            log.count("ind_blocks")
                            dev_out = compute_block_ind(
                                gn_d, eg_d, maf_d, sidx, pars.ignore_miss_data,
                                m)
                        else:
                            # the ladder's rung for this piece, as
                            # compute_block picks it
                            rung = pick_gather_kernel(
                                pars.n_ind, gn_d.element_size(), device,
                                hi_p - lo_p)
                            log.count("rung_" + rung)
                            log.count("pairs_" + rung, hi_p - lo_p)
                            dev_out = compute.compute_block(
                                gn_d, eg_d, maf_d, sidx,
                                pars.ignore_miss_data)  # async
                    with log.span("sweep: emit wait"):
                        emit_q.put((bi, blk, dev_out, None, None, spec,
                                    rung))
            finally:
                # always shut the pipeline down, even when the loop raises:
                # stages blocked on get() would otherwise pin device buffers
                with log.span("sweep: emit wait"):
                    emit_q.put(None)
                    for t in stages:
                        t.join()
            if emit_err:
                raise emit_err[0]

    if ingest is not None and not interrupted:
        # a tail-of-file read error (NaN, EOF) surfaces even when no block
        # needed the last sites: the reference reads the whole table before
        # it computes anything (read_data.cpp:13-116)
        ingest.join_all()
        log.count("ingest_slabs", ingest.n_slabs)
    if interrupted:
        hint = (f"resume with the same --checkpoint {ckpt.dir}"
                if ckpt is not None else
                "rerun with --checkpoint DIR to make runs resumable")
        log.log(0, f"==> Interrupted before block {n_blocks - 1}; "
                   f"completed blocks are flushed. {hint}")
        raise SystemExit(130)

    if m is not None:
        # every rank walked the same plan, block for block
        digests = m.all_gather_object(digest.hexdigest())
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks' pair plans differ over "
                               f"{n_blocks} blocks: digests {digests}")
        log.log(2, f"==> pair plan: the same {n_blocks} blocks on all "
                   f"{m.world} ranks (sha256 {digests[0][:16]})")
        log.count("plan_ranks_agree", m.world)
        log.count("ind_allreduces", m.allreduces)
        log.count_time("mesh: 'ind' all-reduce", m.allreduce_s)
        log.count_time("mesh: pieces to rank 0", m.gather_s)
    if ckpt is not None:
        with log.phase("Merging checkpoint shards"):
            hdr = strict.header_line(pars.extend_out)
            out_fh.write(hdr if hasattr(out_fh, "encoding") else hdr.encode())
            ckpt.concatenate(out_fh, n_blocks)
