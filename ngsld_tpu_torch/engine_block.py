"""Single-device block sweep: ngsld_tpu/engine_block._run_jax_body in
PyTorch, with its two sweep modes.

  host: read GLs and positions (strict.read_pos). Binary and gz-text
        input stream to the device slab by slab (loaders); anything the
        loaders decline goes through strict.read_geno and one upload
  dev:  preprocess (call_geno, MAF, normal-space GLs, E[G]); streamed
        binary records are normalised here too (raw=True)
  host: MAF to host (f64 copy), knife-edge MAF repair, banded pair plan
        (plan.band.iter_pair_blocks) on a prefetch thread
  dev:  gather mode (_GatherSweep), per block: one (2, P) int32 index
        upload, Pearson r2 + pair EM (compute.compute_block; the EM kernel
        follows the cohort size)
        strip mode (_StripSweep), per chunk of <= gmaxt tiles
        (plan.strips.strip_chunks): the tile list (and sel) upload,
        rectangle EM + r2 (compute.strip_compute_fn/strip_flat_fn) from
        strip tables built once on the device
        one dispatch loop for both (_dispatch_all)
  host: 3-stage emit pipeline (_Emit: pull -> derive + format (native)
        -> write), rows in (s1, s2) order; degenerate pairs take
        refine.repair_columns' tiers (format_rows)

Under the overlap ingest (loaders._OverlapIngest, the reference's gate:
_overlap_engaged) the binary upload and the preprocess run slab by slab
under the sweep instead: the plan and the strip decision read a MAF of
zeros (at min_maf <= 0 their filter passes every site), each gather block
waits for its sites (stage `sweep: ingest wait`), the strip sweep waits
for the whole table, the emit reads the ingest's MAF, and a read error
that surfaces mid-sweep empties the output before it is raised.

Strip mode is f32-only and is picked when the plan is dense over its
rectangles (effective utilization >= STRIP_MIN_UTIL on a CUDA
device); NGSLD_BLOCK_STRIP=1/0 forces it on/off. Large cohorts take the
streamed strip kernel (kernels.strip_em.strip_streamed), whose tables pad
the individual axis to its chunk. Both modes regroup the
same iter_pair_blocks stream, so their pair sets are identical by
construction. A strip kernel that fails to build or launch ends the run
with its error: there is no retry on the gather sweep.
"""

from __future__ import annotations

import contextlib
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
from .native import (OUT_POOL, LabelBlob, OutLease, format_rows_derive,
                     get_lib, make_labels_blob)
from .ops.preprocess import preprocess
from .parallel.strip_ind import strip_compute_ind
from .parallel.sweep import compute_block_ind
from .plan.band import PairBlock, band_limits, iter_pair_blocks
from .plan.strips import TA, TB, strip_chunks, strip_plan
from .refine import (StrictRefiner, degenerate_tiers, knife_edge_sites,
                     repair_columns)
from .utils.signals import GracefulStop

# the strip sweep runs on a CUDA device from this effective utilization of
# its plan (live-cell fraction x sampling rate: sampled-out cells still
# burn EM compute); the reference's design value
STRIP_MIN_UTIL = 0.08
# a strip chunk emits flat (cell-major, no device gather) from this share
# of live cells among its tiles' cells
STRIP_FLAT_UTIL = 0.92


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


def _strip_rule(pars, log, prec, device, maf_plan, pos_dist):
    """The sweep-mode rule (ngsld_tpu/engine_block.py:286-334): dense
    strip-tile rectangles when the plan's effective utilization is at
    least STRIP_MIN_UTIL on a CUDA device, f32 only; NGSLD_BLOCK_STRIP=1/0
    forces it on/off. -> (plan, hi_b): plan the padded strip plan (hi_p,
    ok_p, tiles, utilization) when the strip sweep runs, else None; hi_b
    the band limits where the strip plan made them, else None."""
    strip_env = os.environ.get("NGSLD_BLOCK_STRIP")
    if strip_env == "0" or prec != "f32":
        return None, None
    with log.span("plan: strip plan"):
        hi_b = band_limits(pos_dist, pars.max_kb_dist, pars.max_snp_dist)
        # padded to whole anchor tiles; pad sites are not ok. (The TPU
        # engine adds one more all-dead partner tile to aim the padding
        # slots of a fixed-size dispatch at; here a dispatch launches
        # exactly its chunk's tiles.)
        Sp = -(-pars.n_sites // TA) * TA
        hi_p = np.zeros(Sp, np.int64)
        hi_p[:pars.n_sites] = hi_b
        ok_p = np.zeros(Sp, np.float32)
        ok_p[:pars.n_sites] = ~(maf_plan < pars.min_maf)
        s_ta, _, _, util = strip_plan(hi_p, ok_p, pars.n_sites, TA, TB)
    u_eff = util * pars.rnd_sample
    on = len(s_ta) > 0 and (
        strip_env == "1"
        or (device.type == "cuda" and u_eff >= STRIP_MIN_UTIL))
    if len(s_ta) and not on and pars.verbose >= 2:
        log.log(2, f"==> strip sweep skipped: eff util {u_eff:.3f} < "
                   f"{STRIP_MIN_UTIL} (gather path)")
    return ((hi_p, ok_p, len(s_ta), util) if on else None), hi_b


class _StripSweep:
    """The strip sweep's part of the dispatch loop (items: strip_chunks'
    tuples): the strip tables, the split groups' resume and merge marks,
    and a chunk's dispatch, flat or compacted, on a mesh this row's share
    of its tiles."""

    def __init__(self, pars, log, device, m, plan, gn_d, eg_d, maf,
                 ingest):
        hi_p, ok_p, n_tiles, util = plan
        self.log, self.device, self.m = log, device, m
        n_shards = 1 if m is None else m.shard
        shard_ind = 1 if m is None else m.shard_ind
        if ingest is not None:
            # the strip tables take the whole gn/eg tables (the upload
            # still ran under the positions parse, the plan and the strip
            # decision)
            with log.phase("  gl ingest join (strip tables)", level=2):
                gn_d, _, eg_d = ingest.join_all()
            ingest.tables = ()
        # past the resident kernel's cohort limit strip_em takes the
        # streamed kernel, and the tables pad the individual axis to its
        # chunk. With --shard_ind the step is parallel.strip_ind's (no
        # kernel): the individual axis splits over the row in 8-aligned
        # slices (ngsld_tpu/engine_block.py:342-345)
        streamed = shard_ind == 1 and strip_streamed(pars.n_ind, device)
        ialign = (8 * shard_ind if shard_ind > 1
                  else strip_i_align(pars.n_ind, device))
        Sp = len(hi_p)
        pad = Sp - pars.n_sites
        with log.phase("strip tables (device)"):
            ga, gb, ea, eb = strip_tables(
                torch.nn.functional.pad(gn_d, (0, 0, 0, 0, 0, pad),
                                        value=1.0 / 3.0),
                torch.nn.functional.pad(eg_d, (0, 0, 0, pad)), pars.n_ind,
                i_align=ialign)
            if shard_ind > 1:
                # this rank's slice of every record: the standardization
                # above used the whole cohort's moments
                ipl = ga.shape[2] // shard_ind
                i_start = m.ii * ipl
                cut = slice(i_start, i_start + ipl)
                ga, gb = ga[:, :, cut].contiguous(), gb[:, cut].contiguous()
                ea, eb = ea[:, cut].contiguous(), eb[cut].contiguous()
        maf_d = torch.from_numpy(np.pad(
            np.asarray(maf, np.float32), (0, pad),
            constant_values=0.5)).to(device)
        lo_d = torch.arange(1, Sp + 1, dtype=torch.int32, device=device)
        hi_d = torch.from_numpy(hi_p.astype(np.int32)).to(device)
        ok_d = torch.from_numpy(ok_p).to(device)
        self.tables = (ga, gb, ea, eb, maf_d, maf_d, lo_d, hi_d, ok_d, ok_d)
        # per-dispatch budgets: up to gmaxt tiles (the device output f is
        # (tiles, 4, TA, TB) f32, 67 MB at 256) and about ctarget pairs per
        # chunk: narrow-band groups batch together so a dispatch carries
        # real work, oversized groups split into <= gmaxt-tile pieces.
        # --shard: a chunk's tiles split over the 'pairs' rows, so its
        # tile budget is a whole multiple of them (the reference's rule)
        gmaxt = max(1, min(n_tiles, int(os.environ.get(
            "NGSLD_STRIP_TILES", "256"))))
        self.gmaxt = -(-gmaxt // n_shards) * n_shards
        self.ctarget = int(os.environ.get("NGSLD_STRIP_CTARGET",
                                          str(1 << 20)))
        log.log(2, f"==> strip sweep: {n_tiles} tiles, chunk<= {self.gmaxt} "
                   f"tiles/{self.ctarget} pairs, util {util:.2f}"
                   + (f", streamed kernel (I-chunk {ialign})"
                      if streamed else ""))
        # "order": split groups merge to anchor-major rows under their
        # final block index; the strip sweep is f32 only
        self.extra = {"mode": "strip", "ta": TA, "tb": TB,
                      "gmaxt": self.gmaxt, "ctarget": self.ctarget,
                      "order": "anchor", "prec": "f32"}
        if streamed:
            # the streamed kernel's chunk sets its summation order
            self.extra["ic"] = ialign
        use_i16 = pars.n_ind <= 32767
        if shard_ind > 1:
            # ('pairs', 'ind'): parallel.strip_ind's step, one all-reduce
            # over the row an EM iteration
            self.fn = functools.partial(
                strip_compute_ind, n_ind=pars.n_ind, i_start=i_start,
                mesh=m, ignore_miss=pars.ignore_miss_data, use_i16=use_i16)
            log.log(2, "==> strip sweep: ('pairs', 'ind') mesh, one "
                       "all-reduce over 'ind' an EM iteration")
        else:
            self.fn = compute.strip_compute_fn(
                pars.n_ind, pars.ignore_miss_data, use_i16)
        # flat cell-major emission for near-full chunks: one relayout on
        # the device and a host-side numpy take in the (pipelined) pull
        # stage instead of the device sel gather. Pull bytes then scale
        # with CELLS, so only chunks with live/cells >= STRIP_FLAT_UTIL
        # qualify. NGSLD_STRIP_EMIT=compact|flat|auto. One device only
        # (ngsld_tpu/engine_block.py:724-725).
        self.flat_fn = None
        emit_mode = os.environ.get("NGSLD_STRIP_EMIT", "auto")
        if emit_mode != "compact" and m is None:
            self.flat_fn = compute.strip_flat_fn(
                pars.n_ind, pars.ignore_miss_data, use_i16)
        self.flat_util = -1.0 if emit_mode == "flat" else STRIP_FLAT_UTIL
        self.skip_until = -1                   # resumed split group's end
        self.run_first = self.run_last = -1    # in-flight split group

    def plan(self, blocks):
        """(PairBlock, item) pairs of the chunk stream, made on the plan's
        prefetch thread."""
        return ((item[3], item) for item in _prefetch_blocks(
            self.log.spans_of("plan: block", strip_chunks(
                blocks, self.gmaxt, self.ctarget)), depth=2))

    def resumed(self, bi, item, done_set, ckpt):
        """Whether chunk bi was committed before this run. A split group is
        committed as one merged shard at its final chunk, the earlier ones
        as empty placeholders: its first chunk (re)commits any placeholder
        the writer did not reach and skips the whole group."""
        rem = item[4]
        if bi <= self.skip_until:
            return True
        if bi <= self.run_last:
            return False
        if rem and bi + rem in done_set:
            for j in range(bi, bi + rem):
                if ckpt is not None and not ckpt.done(j):
                    with ckpt.open_block(j):
                        pass
                    ckpt.commit_block(j)
            self.skip_until = bi + rem
            return True
        return not rem and bi in done_set

    def describe(self, bi, item):
        ta_slots, _, sel = item[:3]
        return (f"> Strip chunk {bi}: {len(ta_slots)} tiles (anchor tiles "
                f"{ta_slots[0]}..{ta_slots[-1]}), {len(sel)} pairs")

    def ready(self, blk):
        pass   # the tables were whole before the sweep began

    def dispatch(self, bi, item):
        """Launch chunk bi: exactly its tiles run and, compacted, exactly
        its pairs' rows come back (no padding to gmaxt tiles or to a sel
        capacity). meta marks a split group's chunks for fmt's merge:
        "cont", then ("final", its first chunk)."""
        ta_slots, tb_slots, sel, blk, rem = item
        if rem and bi > self.run_last:
            self.run_first, self.run_last = bi, bi + rem
        meta = None
        if self.run_last >= 0 and bi == self.run_last:
            meta = ("final", self.run_first)
            self.run_first = self.run_last = -1
        elif bi < self.run_last:
            meta = "cont"
        # emission mode: flat cell-major for near-full chunks (host-side
        # sel, no device gather); compacted rows otherwise
        gc = len(ta_slots)
        use_flat = (self.flat_fn is not None
                    and len(sel) >= self.flat_util * gc * TA * TB)
        m, spec = self.m, None
        if m is not None:
            # this row's tiles and the cells of sel in them; rank 0 puts
            # every row's rows at their places
            shares = compute.strip_shares(gc, sel, m.shard)
            t_lo, t_hi, _, sel = shares[m.pi]
            ta_slots, tb_slots = ta_slots[t_lo:t_hi], tb_slots[t_lo:t_hi]
            spec = [(p * m.shard_ind, len(sh[2]), sh[2])
                    for p, sh in enumerate(shares)]
            if m.shard_ind > 1:
                self.log.count("ind_strip_chunks")
        args = self.tables + (torch.from_numpy(ta_slots).to(self.device),
                              torch.from_numpy(tb_slots).to(self.device))
        if use_flat:
            return bi, blk, self.flat_fn(*args), meta, sel, spec, None
        dev_out = self.fn(*args, torch.from_numpy(sel).to(self.device))
        return bi, blk, dev_out, meta, None, spec, None


class _GatherSweep:
    """The gather sweep's part of the dispatch loop (items: the plan's
    blocks): each block waits on the overlap ingest for its sites, then
    compute.compute_block (its rung counted) or, under --shard_ind,
    parallel.sweep's step; on a mesh each 'pairs' row takes its share of
    the block (compute.split_bounds)."""

    def __init__(self, pars, log, device, m, chunk, prec, gn_d, maf_d,
                 eg_d, ingest):
        self.pars, self.log, self.device, self.m = pars, log, device, m
        self.ingest = ingest
        if m is not None and m.shard_ind > 1:
            ipl = pars.n_ind // m.shard_ind
            cut = slice(m.ii * ipl, (m.ii + 1) * ipl)
            gn_d, eg_d = gn_d[:, cut].contiguous(), eg_d[:, cut].contiguous()
        self.tables = (gn_d, maf_d, eg_d)
        self.extra = {"chunk": chunk, "prec": prec}

    def plan(self, blocks):
        """(PairBlock, PairBlock) pairs, made on the plan's prefetch
        thread; the main thread's wait for each is `sweep: plan wait`."""
        return self.log.spans_of("sweep: plan wait", (
            (blk, blk) for blk in _prefetch_blocks(
                self.log.spans_of("plan: block", blocks))))

    def resumed(self, bi, blk, done_set, ckpt):
        return bi in done_set

    def describe(self, bi, blk):
        return (f"> Block {bi}: anchors {blk.s1[0]}..{blk.s1[-1]}, "
                f"{len(blk.s1)} pairs")

    def ready(self, blk):
        if self.ingest is not None:
            # dispatch only once every site of the block is in
            with self.log.span("sweep: ingest wait"):
                self.tables = self.ingest.wait(int(blk.s2.max()) + 1)

    def dispatch(self, bi, blk):
        """Launch block bi: exactly its P pairs run and P rows come back
        (no padding quantum)."""
        m, P = self.m, len(blk.s1)
        bnd = compute.split_bounds(P, 1 if m is None else m.shard)
        p = 0 if m is None else m.pi
        lo, hi = bnd[p], bnd[p + 1]
        spec = None if m is None else [
            (q * m.shard_ind, bnd[q + 1] - bnd[q], None)
            for q in range(m.shard)]
        sidx = torch.from_numpy(np.stack([blk.s1[lo:hi], blk.s2[lo:hi]])
                                .astype(np.int32)).to(self.device)
        gn_d, maf_d, eg_d = self.tables
        if m is not None and m.shard_ind > 1:
            self.log.count("ind_blocks")
            dev_out = compute_block_ind(gn_d, eg_d, maf_d, sidx,
                                        self.pars.ignore_miss_data, m)
            return bi, blk, dev_out, None, None, spec, None
        # the ladder's rung for this piece, as compute_block picks it
        rung = pick_gather_kernel(self.pars.n_ind, gn_d.element_size(),
                                  self.device, hi - lo)
        self.log.count("rung_" + rung)
        self.log.count("pairs_" + rung, hi - lo)
        with compute.step_log(self.log):
            dev_out = compute.compute_block(gn_d, eg_d, maf_d, sidx,
                                            self.pars.ignore_miss_data)
        return bi, blk, dev_out, None, None, spec, rung


def _columns(fm, im, maf, s1, s2, extend_out):
    """Rows' output columns from their pull (hostcols._unpack), as writable
    copies keyed like refine.StrictRefiner.refine_columns: f64, chi2 f32,
    n_used and n_iter i32."""
    dtypes = dict(n_iter=np.int32, n_used=np.int32, chi2=np.float32)
    names = ("r2p", "f", "n_iter", "n_used", "hmaf1", "hmaf2", "D", "Dp",
             "r2", "chi2")   # _unpack's order
    return dict(((k, np.array(v, dtypes.get(k, np.float64)))
                 for k, v in zip(names, _unpack(fm, im, extend_out))),
                maf1=maf[s1], maf2=maf[s2])


def _span_if(log, on, name):
    return log.span(name) if on else contextlib.nullcontext()


def format_rows(rw, maf, pars, prec, get_refiner, log, blk, fm, im,
                rung=None, out=None):
    """The fmt stage's derive and format of a block's (or a merged split
    group's) rows -> the rows' bytes. rw: the RowWriter that formats. The
    degenerate pairs (refine.degenerate_tiers) take
    refine.repair_columns' values: as override columns of the one native
    derive+format call, or, without the native library, written into the
    unpacked columns of the one RowWriter.format_block call. rung: the
    gather rung that took the block (rank 0's piece of it on a mesh), for
    its counter. out: a native.OutLease the native call formats into (the
    bytes are then a view of its buffer); the Python path leaves it
    unused."""
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
    idx = np.flatnonzero(tiers)
    fix = None
    if len(idx):
        s1, s2 = blk.s1[idx], blk.s2[idx]
        with log.span("sweep: fmt/unpack"):
            fix = _columns(fm[idx], im[idx], maf, s1, s2, pars.extend_out)
        repair_columns(fix, tiers[idx], s1, s2, get_refiner, log,
                       "sweep: fmt")
    if rw.native:
        # one native pass: D/D'/r2/hap-MAFs/chi2 derive inside the
        # formatter's worker threads from (r2p, f) directly
        with _span_if(log, fix is not None, "sweep: fmt/bulk"):
            data = format_rows_derive(
                rw.blob, rw.off, blk.s1, blk.s2, blk.dist, fm[:, 0],
                fm[:, 1:5], maf[blk.s1], maf[blk.s2], n_used, n_iter,
                pars.extend_out,
                overrides=None if fix is None else (idx, fix), out=out)
        if data is None:
            # only reachable on an fm dtype mismatch — a code bug
            raise RuntimeError("native derive formatter rejected the chunk")
        return data
    with _span_if(log, fix is not None, "sweep: fmt/rows"):
        cols = _columns(fm, im, maf, blk.s1, blk.s2, pars.extend_out)
        if fix is not None:
            for k in cols:
                cols[k][idx] = fix[k]
        return rw.format_block(
            blk.s1, blk.s2, blk.dist, cols["r2p"], cols["D"], cols["Dp"],
            cols["r2"], n_used=cols["n_used"], maf1=cols["maf1"],
            maf2=cols["maf2"], hap=cols["f"], hmaf1=cols["hmaf1"],
            hmaf2=cols["hmaf2"], chi2=cols["chi2"], n_iter=cols["n_iter"])


class _Emit:
    """The emit pipeline on daemon threads, fed (bi, blk, dev_out, meta,
    flat_sel, spec, rung) jobs by the dispatch loop. Rank 0 runs pull
    (device results to host numpy), fmt (a split group's chunks merged
    back, then format_rows) and write (rows, or a checkpoint shard); the
    other ranks run send. FIFO queues keep rows in (s1, s2) order. The
    heavy parts (device wait, native formatting, file IO) release the
    GIL, so they overlap each other and the main thread's dispatch. fmt
    formats into buffers leased from native.OUT_POOL and hands write a
    view; it holds each block back until the next block's native format
    starts. A stage's error ends it and the stages after it and lands in
    err."""

    def __init__(self, log, m, fmt_rows=None, ckpt=None, out_fh=None):
        self.log, self.m, self.fmt_rows = log, m, fmt_rows
        self.ckpt, self.out_fh = ckpt, out_fh
        self.err = []
        self.pending = []   # pulled chunks of an in-flight split group
        self.q = queue.Queue(maxsize=3)            # main -> pull / send
        if m is None or m.rank == 0:
            fmt_q = queue.Queue(maxsize=2)         # pull -> fmt
            # fmt -> write, beside the block fmt holds back (self.held)
            self.write_q = queue.Queue(maxsize=1)
            self.held = None
            self.threads = [
                self._stage(self.q, fmt_q, self.pull, "ngsld-pull"),
                self._stage(fmt_q, self.write_q, self.fmt, "ngsld-fmt",
                            end=self.forward),
                self._stage(self.write_q, None, self.write, "ngsld-write")]
        else:
            self.threads = [self._stage(self.q, None, self.send,
                                        "ngsld-send")]

    def close(self):
        """The end of the jobs: wait for every stage to drain."""
        self.q.put(None)
        for t in self.threads:
            t.join()

    def _stage(self, in_q, out_q, fn, name, end=None):
        """A thread that applies fn to each item of in_q and puts what it
        returns on out_q; end() runs when its input ends or fails, before
        the None that ends out_q."""
        def run():
            try:
                while (item := in_q.get()) is not None:
                    try:
                        res = fn(*item)
                    except BaseException as e:
                        self.err.append(e)
                        while in_q.get() is not None:  # unblock the producer
                            pass
                        return
                    # None: nothing to forward (fmt forwards its blocks
                    # itself)
                    if out_q is not None and res is not None:
                        out_q.put(res)
            finally:
                if end is not None:
                    end()
                if out_q is not None:
                    out_q.put(None)
        t = threading.Thread(target=run, daemon=True, name=name)
        t.start()
        return t

    def pull(self, bi, blk, dev_out, meta, flat_sel, spec, rung):
        """Device results -> host numpy (waits for the block's kernels on
        the current stream). Compacted strip chunks and gather blocks
        bring exactly their live rows; flat strip chunks (flat_sel) bring
        their whole tile rectangle and the sel permutation applies here as
        a numpy take. On a mesh (spec: each 'pairs' row's sending rank,
        rows and their places) the other rows' pieces arrive here, each
        from the first rank of its row, and join rank 0's own."""
        with self.log.span("sweep: result pull"):
            fm = dev_out[0].cpu().numpy()
            im = dev_out[1].cpu().numpy()
            if flat_sel is not None:
                fm, im = fm[flat_sel], im[flat_sel]
        if spec is not None:
            fm, im = _assemble(self.m, fm, im, spec)
        return bi, blk, fm, im, meta, rung

    def send(self, bi, blk, dev_out, *_):
        """The pull stage of a rank other than 0: the first rank of each
        row sends its piece to rank 0; the others' rows are the same."""
        if self.m.ii == 0:
            self.m.send_rows([dev_out[0].cpu().numpy(),
                              dev_out[1].cpu().numpy()])

    def fmt(self, bi, blk, fm, im, meta, rung):
        """Derive and format a block's rows (format_rows). A split
        anchor-tile group's chunks (strip sweep, partner span > gmaxt*TB
        sites) arrive window-major; they accumulate here (meta="cont") and
        merge back into global (s1, s2) row order when the final chunk
        lands (meta=("final", its first chunk)); host memory for the merge
        is O(the group's rows). The formatted block is held back (forward)
        and goes to write when the next block's native format starts, or
        when the input ends."""
        if meta == "cont":
            self.pending.append((blk, fm, im))
            return None
        span0 = None
        if meta is not None:
            span0 = meta[1]
            if self.pending:
                parts = self.pending + [(blk, fm, im)]
                self.pending = []
                s1, s2, dist = (np.concatenate([getattr(p[0], k)
                                                for p in parts])
                                for k in ("s1", "s2", "dist"))
                order = np.lexsort((s2, s1))
                blk = PairBlock(s1=s1[order], s2=s2[order],
                                dist=dist[order])
                fm = np.concatenate([p[1] for p in parts])[order]
                im = np.concatenate([p[2] for p in parts])[order]
        # the block before goes to the write stage when this one's native
        # format starts (the lease's on_take), not when it is done: a
        # write can hold the GIL for its whole copy (an in-memory sink),
        # and this block's Python part would wait on it, so the format
        # and the write would take turns
        lease = OutLease(OUT_POOL, on_take=self.hand_off)
        with self.log.span("sweep: format"):
            data = self.fmt_rows(blk, fm, im, rung, out=lease)
        self.forward()   # the Python path takes no lease
        if lease.buf is not None:
            self.log.count("emit_buf_alloc" if lease.fresh
                           else "emit_buf_reuse")
        self.held = (bi, data, span0, lease)
        return None

    def forward(self):
        """Hand fmt's held block to the write stage."""
        if self.held is not None:
            held, self.held = self.held, None
            self.write_q.put(held)

    def hand_off(self):
        """forward from inside the next block's format (its lease's
        on_take), under a span of its own: the wait for room in write_q
        while the write stage is behind."""
        if self.held is not None:
            with self.log.span("sweep: fmt/hand-off"):
                self.forward()

    def write(self, bi, data, span0, lease):
        """Write rows, or commit a checkpoint shard. A merged split group
        writes all its rows under its final bi, then commits empty
        placeholder shards for the group's earlier bis (concatenate needs a
        dense block range; a resume treats done(final bi) as the
        group's). data may be a view of the lease's buffer: write() reads
        it only during the call (io's contract), so the buffer goes back to
        the pool when the write returns."""
        with self.log.span("sweep: write"):
            if self.ckpt is not None:
                with self.ckpt.open_block(bi) as bfh:
                    bfh.write(data)
                self.ckpt.commit_block(bi)
                for j in range(bi if span0 is None else span0, bi):
                    with self.ckpt.open_block(j):
                        pass
                    self.ckpt.commit_block(j)
            else:
                try:
                    self.out_fh.write(data)
                except TypeError:
                    self.out_fh.write(str(data, "utf-8"))
        lease.release()


def _dispatch_all(pars, log, m, mode, emit, blocks, done_set, ckpt):
    """The dispatch loop, one for both sweep modes: walk mode's plan of
    blocks, skip what a resume already has, dispatch the rest and hand
    each to the emit pipeline; stop at a signal or an emit error, and
    always shut the pipeline down. -> (blocks walked, interrupted, the
    plan's digest)."""
    lead = m is None or m.rank == 0
    # the ranks' pair plans must agree: a digest of every block's pairs,
    # compared at the end
    digest = hashlib.sha256()
    n_blocks = 0
    interrupted = False
    # the other ranks' stop is never armed: they stop when rank 0 ends them
    with log.phase("compute: banded pair sweep", encloses=True), \
            (GracefulStop(log) if lead
             else contextlib.nullcontext(GracefulStop())) as gs:
        try:
            for bi, (blk, item) in enumerate(mode.plan(blocks)):
                n_blocks = bi + 1
                if gs.stopped or emit.err:
                    interrupted = not emit.err
                    break
                if m is not None:
                    digest.update(blk.s1.tobytes() + blk.s2.tobytes())
                if mode.resumed(bi, item, done_set, ckpt):
                    log.count("blocks_resumed")
                    continue
                log.count("pairs_emitted", len(blk.s1))
                log.count("blocks_computed")
                if pars.verbose >= 3:
                    log.log(3, mode.describe(bi, item))
                mode.ready(blk)
                with log.span("sweep: dispatch"):
                    job = mode.dispatch(bi, item)   # async on the device
                with log.span("sweep: emit wait"):
                    emit.q.put(job)
        finally:
            # always shut the pipeline down, even when the loop raises:
            # stages blocked on get() would otherwise pin device buffers
            with log.span("sweep: emit wait"):
                emit.close()
        if emit.err:
            raise emit.err[0]
    return n_blocks, interrupted, digest


def _sweep(pars, out_fh, log, prec, device, m, get_refiner, gn_d,
           maf_d, eg_d, maf, pos_dist, labels, ingest):
    """_run_torch_body's sweep over rank 0's tables (shared with the other
    ranks here), or over the overlap ingest's as they fill."""
    dt = torch.float64 if prec == "f64" else torch.float32
    lead = m is None or m.rank == 0
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
    n_shards = 1 if m is None else m.shard
    chunk = -(-int(pars.chunk_pairs) // n_shards) * n_shards

    plan, hi_b = _strip_rule(pars, log, prec, device, maf_plan, pos_dist)
    if plan is not None:
        mode = _StripSweep(pars, log, device, m, plan, gn_d, eg_d, maf,
                           ingest)
    else:
        mode = _GatherSweep(pars, log, device, m, chunk, prec, gn_d, maf_d,
                            eg_d, ingest)
    # the mode holds what it uses of the tables (the strip sweep none of
    # the gather tables): a mesh rank's broadcast copies go with it
    del gn_d, maf_d, eg_d
    # the in-band candidates the plan walks, before its MAF skip and
    # sampling (iter_pair_blocks' own counts), from the strip plan's band
    # limits where it made them
    if hi_b is None:
        hi_b = band_limits(pos_dist, pars.max_kb_dist, pars.max_snp_dist)
    log.count("plan_candidates", int(np.maximum(
        hi_b - np.arange(pars.n_sites) - 1, 0)[~(maf_plan < pars.min_maf)]
        .sum()))

    ckpt = None
    if pars.checkpoint and lead:
        # the fingerprint pins the sweep decomposition (gather mode's
        # chunk, strip mode's tile-chunk geometry) and the EM precision:
        # shards from another of either must not be mixed
        ckpt = _Checkpoint(pars.checkpoint, pars, log, extra=mode.extra)
        # per-block RowWriters share one label blob (O(n_sites))
        if get_lib() is not None:
            labels = LabelBlob(*make_labels_blob(labels))
    # the blocks committed before this run, the same on every rank: a
    # resume skips them all alike
    done_set = ckpt.done_set() if ckpt is not None else set()
    if m is not None and pars.checkpoint:
        done_set = m.broadcast_object(done_set if lead else None)
    fmt_rows = None
    if lead:
        rw = RowWriter(out_fh if ckpt is None else None, labels,
                       pars.extend_out)
        if ckpt is None:
            rw.write_header()
        fmt_rows = functools.partial(format_rows, rw, maf, pars, prec,
                                     get_refiner, log)
    emit = _Emit(log, m, fmt_rows, ckpt, out_fh)
    n_blocks, interrupted, digest = _dispatch_all(
        pars, log, m, mode, emit,
        iter_pair_blocks(pars, maf_plan, pos_dist, block_pairs=chunk),
        done_set, ckpt)

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
