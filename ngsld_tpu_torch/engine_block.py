"""Single-device gathered-pair block sweep: the gather branch of
ngsld_tpu/engine_block._run_jax_body in PyTorch.

  host: read GLs (strict.read_geno) and positions (strict.read_pos)
  dev:  upload once, preprocess (call_geno, MAF, normal-space GLs, E[G])
  host: MAF to host (f64 copy), knife-edge MAF repair, banded pair plan
        (plan.band.iter_pair_blocks) on a prefetch thread
  dev:  per block: one (2, P) int32 index upload, Pearson r2 + pair EM
        (compute.compute_block; the EM is the CUDA kernel on a GPU)
  host: 3-stage emit pipeline — pull -> derive + format (native) -> write
        — rows in (s1, s2) order; degenerate pairs take refine's tiers

The host stages are ngsld_tpu's own code, reused unchanged.
"""

from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np
import torch

from ngsld_tpu import strict
from ngsld_tpu.checkpoint import _Checkpoint
from ngsld_tpu.engine_block import _prefetch_blocks, _unpack
from ngsld_tpu.io.writer import RowWriter
from ngsld_tpu.plan.band import iter_pair_blocks
from ngsld_tpu.refine import (StrictRefiner, degenerate_tiers,
                              derive_columns_f64, knife_edge_sites)
from ngsld_tpu.utils.signals import GracefulStop

from . import compute
from .ops.preprocess import preprocess


def _run_torch_body(pars, out_fh, log, prec: str, device: torch.device):
    dt = torch.float64 if prec == "f64" else torch.float32
    np_dt = np.float64 if prec == "f64" else np.float32

    with log.phase("Reading data from file"):
        geno_log = strict.read_geno(pars.in_geno, pars.in_bin, pars.in_probs,
                                    pars.in_logscale, pars.n_ind,
                                    pars.n_sites)
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

    with log.phase("Preprocessing (call_geno, MAF, E[G]) on device"):
        # narrow on the host first: GLs cross to the device once, at the
        # EM precision
        with log.phase("  gl upload", level=2):
            gl_d = torch.from_numpy(np.asarray(geno_log, np_dt)).to(device)
            del geno_log
        with log.phase("  preprocess", level=2):
            gn_d, maf_d, eg_d = preprocess(
                gl_d, call=pars.call_geno, N_thresh=pars.N_thresh,
                call_thresh=pars.call_thresh,
                ignore_miss_data=pars.ignore_miss_data)
            del gl_d
        # only MAF returns to the host (the plan needs it); the GL/E[G]
        # tables stay on the device for the sweep
        with log.phase("  maf to host", level=2):
            # np.array copies: knife-edge refinement writes into it
            maf = np.array(maf_d.cpu().numpy(), np.float64)

    refiner = None

    def get_refiner():
        nonlocal refiner
        if refiner is None:
            refiner = StrictRefiner(pars)
        return refiner

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

    chunk = int(pars.chunk_pairs)
    ckpt = None
    if pars.checkpoint:
        # the fingerprint pins the block decomposition and the EM
        # precision: shards from another of either must not be mixed
        ckpt = _Checkpoint(pars.checkpoint, pars, log,
                           extra={"chunk": chunk, "prec": prec})
        # per-block RowWriters share one label blob (O(n_sites) to build)
        from ngsld_tpu.native import LabelBlob, get_lib, make_labels_blob
        if get_lib() is not None:
            labels = LabelBlob(*make_labels_blob(labels))
    writer = None
    if ckpt is None:
        writer = RowWriter(out_fh, labels, pars.extend_out)
        writer.write_header()
    fmt_rw = writer if writer is not None \
        else RowWriter(None, labels, pars.extend_out)

    def pull(bi, blk, dev_out):
        """Stage 1: device results -> host numpy (waits for the block's
        kernels on the current stream)."""
        t0 = time.perf_counter()
        fm = dev_out[0].cpu().numpy()
        im = dev_out[1].cpu().numpy()
        log.count_time("sweep: result pull", time.perf_counter() - t0)
        return bi, blk, fm, im

    def fmt(bi, blk, fm, im):
        """Stage 2 (CPU): derive stats, format rows to bytes. Degenerate
        pairs (refine.degenerate_tiers) take the strict recompute (tier 1)
        or the f64 re-derive (tier 2) as override columns of the same
        native derive+format call."""
        t0 = time.perf_counter()
        n_iter = im[:, 0].astype(np.int32)
        if im.shape[1] > 1:
            n_used = im[:, 1].astype(np.int32)
        else:
            # slim layout (compute._imat): every pair used the whole cohort
            n_used = np.full(im.shape[0], pars.n_ind, np.int32)
            im = np.column_stack([n_iter, n_used])
        log.count("em_iterations", int(n_iter.astype(np.int64).sum()))
        if pars.verbose >= 2:
            log.hist("em_iteration_histogram",
                     np.bincount(np.clip(n_iter, 0, 100)))
        tiers = degenerate_tiers(fm[:, 1:5], prec)
        t1, t2 = tiers == 1, tiers == 2
        log.count_time("sweep: fmt/tiers", time.perf_counter() - t0)
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
            tu = time.perf_counter()
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
            log.count_time("sweep: fmt/unpack", time.perf_counter() - tu)
            if t2s.any():
                tp = time.perf_counter()
                pol = derive_columns_f64(cols["f"][t2s])
                for k in pol:
                    cols[k][t2s] = pol[k]
                log.count_time("sweep: fmt/rederive",
                               time.perf_counter() - tp)
            if t1s.any():
                tr = time.perf_counter()
                ref = get_refiner().refine_columns(s1s[t1s], s2s[t1s])
                for k in cols:
                    cols[k][t1s] = ref[k]
                log.count_time("sweep: fmt/refine", time.perf_counter() - tr)
            tf = time.perf_counter()
            if use_native:
                from ngsld_tpu.native import format_rows_derive
                data = format_rows_derive(
                    fmt_rw.blob, fmt_rw.off, blk.s1, blk.s2, blk.dist,
                    fm[:, 0], fm[:, 1:5], maf[blk.s1], maf[blk.s2], n_used,
                    n_iter, pars.extend_out, overrides=(idx, cols))
                if data is None:
                    # only reachable on an fm dtype mismatch — a code bug
                    raise RuntimeError(
                        "native derive formatter rejected the chunk")
                log.count_time("sweep: fmt/bulk", time.perf_counter() - tf)
            else:
                data = fmt_rw.format_block(
                    s1s, s2s, dists, cols["r2p"], cols["D"], cols["Dp"],
                    cols["r2"], n_used=cols["n_used"], maf1=cols["maf1"],
                    maf2=cols["maf2"], hap=cols["f"], hmaf1=cols["hmaf1"],
                    hmaf2=cols["hmaf2"], chi2=cols["chi2"],
                    n_iter=cols["n_iter"])
                log.count_time("sweep: fmt/rows", time.perf_counter() - tf)
        elif fmt_rw.native:
            # single native pass: D/D'/r2/hap-MAFs/chi2 derive inside the
            # formatter's worker threads from (r2p, f) directly
            from ngsld_tpu.native import format_rows_derive
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
        log.count_time("sweep: format", time.perf_counter() - t0)
        return bi, data

    def write(bi, data):
        """Stage 3 (disk IO): write rows, or commit a checkpoint shard."""
        t0 = time.perf_counter()
        if ckpt is not None:
            with ckpt.open_block(bi) as bfh:
                bfh.write(data)
            ckpt.commit_block(bi)
        else:
            try:
                out_fh.write(data)
            except TypeError:
                out_fh.write(data.decode())
        log.count_time("sweep: write", time.perf_counter() - t0)

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
                if out_q is not None:
                    out_q.put(res)
        t = threading.Thread(target=run, daemon=True, name=name)
        t.start()
        return t

    stages = [_stage(emit_q, fmt_q, pull, "ngsld-pull"),
              _stage(fmt_q, write_q, fmt, "ngsld-fmt"),
              _stage(write_q, None, write, "ngsld-write")]
    n_blocks = 0
    interrupted = False
    with log.phase("compute: banded pair sweep"), GracefulStop(log) as gs:
        blocks_it = enumerate(_prefetch_blocks(
            iter_pair_blocks(pars, maf, pos_dist, block_pairs=chunk)))
        try:
            while True:
                t_top = time.perf_counter()
                try:
                    bi, blk = next(blocks_it)
                except StopIteration:
                    break
                log.count_time("sweep: plan wait",
                               time.perf_counter() - t_top)
                n_blocks = bi + 1
                if gs.stopped or emit_err:
                    interrupted = not emit_err
                    break
                if ckpt is not None and ckpt.done(bi):
                    log.count("blocks_resumed")
                    continue
                P = len(blk.s1)
                log.count("pairs_emitted", P)
                log.count("blocks_computed")
                if pars.verbose >= 3:
                    log.log(3, f"> Block {bi}: anchors "
                               f"{blk.s1[0]}..{blk.s1[-1]}, {P} pairs")
                t0 = time.perf_counter()
                # one fused (2, P) index upload per block; exactly P pairs
                # launch and P rows come back (no padding quantum)
                sidx = torch.from_numpy(
                    np.stack([blk.s1, blk.s2]).astype(np.int32)).to(device)
                dev_out = compute.compute_block(
                    gn_d, eg_d, maf_d, sidx, pars.ignore_miss_data)  # async
                log.count_time("sweep: dispatch", time.perf_counter() - t0)
                emit_q.put((bi, blk, dev_out))
        finally:
            # always shut the pipeline down, even when the loop raises:
            # stages blocked on get() would otherwise pin device buffers
            emit_q.put(None)
            for t in stages:
                t.join()
        if emit_err:
            raise emit_err[0]

    if interrupted:
        hint = (f"resume with the same --checkpoint {ckpt.dir}"
                if ckpt is not None else
                "rerun with --checkpoint DIR to make runs resumable")
        log.log(0, f"==> Interrupted before block {n_blocks - 1}; "
                   f"completed blocks are flushed. {hint}")
        raise SystemExit(130)

    if ckpt is not None:
        with log.phase("Merging checkpoint shards"):
            hdr = strict.header_line(pars.extend_out)
            out_fh.write(hdr if hasattr(out_fh, "encoding") else hdr.encode())
            ckpt.concatenate(out_fh, n_blocks)
    if refiner is not None:
        for k, v in sorted(refiner.t.items()):
            log.count_time(f"sweep: fmt/refine/{k}", v)
    log.summary()
