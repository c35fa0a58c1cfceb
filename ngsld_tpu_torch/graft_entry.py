"""The entry points of __graft_entry__.py (the JAX package's, at the
repository's root) in the port.

  entry()              the one-device LD sweep step and its example block:
                       EM haplotype frequencies (the gather kernel,
                       csrc/pair_em.cu), Pearson r2, D, D', r2, the hap
                       MAFs and chi2 over a block of SNP pairs
  dryrun_multichip(n)  one step of every multi-device path on tiny shapes
                       over n ranks: the ('pairs', 'ind') sweep step, the
                       all-steps ring sweep, the gather stepper and its
                       compaction, the strip stepper, the ('sites', 'ind')
                       stepper, the strip chunk split over the ranks and
                       the ('pairs', 'ind') strip chunk against it

Both run on the card unless the caller asks for the CPU (an explicit
device, or NGSLD_PLATFORM=cpu); without a card and without that request
they refuse with the engine's StrictError. dryrun_multichip starts its
ranks itself, as the CLI's --shard does (parallel.mesh.spawn_ranks): the
caller is rank 0, ranks 1..n-1 are spawned processes that share the
caller's card (device collectives over gloo, as on any shared card) or
take one each where the node has a card a rank (NCCL). A check that fails
raises on its rank and fails the call; a rank that exits non-zero does
too. Each check is the JAX dry run's, with the same shapes, seeds and
assertions; on a compacted stepper the assertion on the full rectangle's
shape becomes one on the live count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import compute
from .hostcols import _chi2_host, _stats_host
from .kernels import launch_counts
from .kernels.pair_em import pair_em_gather
from .kernels.strip_em import strip_tables
from .ops.stats import pearson_r2
from .parallel import mesh as pmesh
from .parallel import ring
from .parallel.strip_ind import strip_compute_ind
from .parallel.sweep import sweep_step
from .plan.strips import TA

STAT_KEYS = ("r2p", "f", "n_iter", "n_used", "hmaf0", "hmaf1", "D", "Dp",
             "r2", "chi2")


def _device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    from .engine import _resolve_device
    return _resolve_device()


def example_block(P: int, I: int, seed: int = 0, device="cpu"):
    """(gn1, gn2, eg1, eg2, maf1, maf2) of P pairs x I individuals in f32,
    drawn as __graft_entry__._example_block draws them (the same numpy
    calls)."""
    rng = np.random.default_rng(seed)
    gl = rng.dirichlet([3.0, 1.0, 1.0], size=(2 * P, I)).astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = (eg.mean(axis=1) / 2).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (gl[:P], gl[P:], eg[:P], eg[P:], maf[:P], maf[P:]))


def stacked(gn1, gn2, maf1, maf2):
    """The gather kernel's operands for pairs (gn1[i], gn2[i]): one table
    cat([gn1, gn2]), sidx (2, P) = (i, P + i), the MAFs stacked alike."""
    P = gn1.shape[0]
    i = torch.arange(P, dtype=torch.int32, device=gn1.device)
    return (torch.cat([gn1, gn2]), torch.stack([i, i + P]),
            torch.cat([maf1, maf2]))


def derived(f: torch.Tensor) -> tuple:
    """(hmaf0, hmaf1, D, Dp, r2, chi2) of hap freqs f (P, 4), derived on
    the host as the engine derives them (hostcols), as tensors on f's
    device."""
    fh = f.cpu().numpy()
    cols = _stats_host(fh) + (_chi2_host(fh),)
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(f.device)
                 for c in cols)


def step(gn1, gn2, eg1, eg2, maf1, maf2):
    """The LD sweep step over pairs (site 1 of pair i, site 2 of pair i):
    gn (P, I, 3) normal-space GLs, eg (P, I) E[G], maf (P,) -> (r2p, f,
    n_iter, n_used, hmaf0, hmaf1, D, Dp, r2, chi2), as the JAX step
    returns them. The EM runs through pair_em_gather (csrc/pair_em.cu on
    the card, its plain version on the CPU)."""
    f, n_iter, n_used = pair_em_gather(*stacked(gn1, gn2, maf1, maf2), False)
    return (pearson_r2(eg1, eg2), f, n_iter, n_used) + derived(f)


def entry(device=None):
    """(step, example_args): the one-device LD sweep step and the example
    block of __graft_entry__.entry (_example_block(256, 32)), on `device`:
    the card unless the caller asks for the CPU."""
    return step, example_block(256, 32, device=_device(device))


# ------------------------------------------------------------ the dry run

def _host(t):
    return t.cpu().numpy()


def _expect(ok, *what) -> None:
    """A check of the dry run (kept under python -O, unlike assert)."""
    if not ok:
        raise AssertionError(what)


def _rows_of(m, piece):
    """Rank 0's view of a result split over the 'pairs' rows: every rank
    sends (row, piece); rank 0 checks that the ranks of a row agree bit
    for bit and returns the rows' pieces in row order (None elsewhere)."""
    got = m.all_gather_object((m.pi, piece))
    if m.rank:
        return None
    rows = {}
    for pi, pc in got:
        if pi in rows:
            for a, b in zip(rows[pi], pc):
                if not np.array_equal(a, b, equal_nan=True):
                    raise AssertionError(
                        f"the ranks of row {pi} disagree on their piece")
        else:
            rows[pi] = pc
    return [rows[p] for p in range(m.shard)]


def _block_valid(i, t, B, n_dev, S):
    """The emission mask of block i's (B, B) step tile at ring step t with
    every site in band and MAF-ok: strict upper triangle, real sites."""
    A = (i * B + np.arange(B))[:, None]
    PJ = (((i + t) % n_dev) * B + np.arange(B))[None, :]
    return (PJ > A) & (PJ < S) & (A < S)


def _tables(gl, eg, maf, rows, spare, dev, cut=slice(None)):
    """This rank's resident gather tables: the sites `rows` (individuals
    `cut`), plus `spare` visiting rows past the block."""
    gn = torch.from_numpy(gl[rows, cut]).to(dev)
    e = torch.from_numpy(eg[rows, cut]).to(dev)
    m = torch.from_numpy(maf[rows]).to(dev)
    if spare:
        gn = torch.cat([gn, gn.new_zeros((spare,) + gn.shape[1:])])
        e = torch.cat([e, e.new_zeros((spare,) + e.shape[1:])])
        m = torch.cat([m, m.new_zeros(spare)])
    return gn, e, m


def _draw(rng, S, I):
    gl = rng.dirichlet([2.0, 1.0, 1.0], size=(S, I)).astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    return gl, eg, (eg.mean(axis=1) / 2).astype(np.float32)


def _hold_rows(fm, ref_fm, ref_nit, nit, label):
    """A step's rows against the gather kernel's on the same pairs, under
    the reference's contract (r2p 2e-5, hap freqs 3e-5, nIter within 1
    on more than 95% of pairs)."""
    np.testing.assert_allclose(fm[:, 0], ref_fm[:, 0], atol=2e-5,
                               err_msg=label)
    np.testing.assert_allclose(fm[:, 1:], ref_fm[:, 1:], atol=3e-5,
                               err_msg=label)
    within = np.abs(nit.astype(np.int64) - ref_nit.astype(np.int64)) <= 1
    _expect(within.mean() > 0.95, label, within.mean())


def _dryrun(m, n: int) -> dict | None:
    """Every check of __graft_entry__.dryrun_multichip on this rank (m: the
    ('pairs', 'ind') mesh). Returns rank 0's outputs (None elsewhere)."""
    t0 = time.perf_counter()
    before = launch_counts()
    dev = m.device
    pairs, ind = m.shard, m.shard_ind
    out = {"layout": (pairs, ind)}

    # sweep_step on the ('pairs', 'ind') mesh: P = 8 a row, I = 8 a rank
    P, I = 8 * pairs, 8 * ind
    args = example_block(P, I, seed=1, device=dev)
    pr = slice(8 * m.pi, 8 * m.pi + 8)
    ic = slice(8 * m.ii, 8 * m.ii + 8)
    gn1, gn2, eg1, eg2, maf1, maf2 = args
    r2p, f, n_iter, n_used = sweep_step(
        gn1[pr, ic], gn2[pr, ic], eg1[pr, ic], eg2[pr, ic], maf1[pr],
        maf2[pr], False, m)
    rows = _rows_of(m, tuple(_host(t) for t in (r2p, f, n_iter, n_used)))
    if rows is not None:
        r2p, f, n_iter, n_used = (np.concatenate(c) for c in zip(*rows))
        cols = _stats_host(f) + (_chi2_host(f),)
        out["sweep_step"] = dict(zip(STAT_KEYS,
                                     (r2p, f, n_iter, n_used) + cols))
        _expect(out["sweep_step"]["r2"].shape == (P,), "sweep_step r2")

    # the ring over an n x 1 site mesh of the same world
    rmesh = pmesh.submesh(m, n, 1)
    i = rmesh.pi
    S, I2, B = 4 * n, 8, 4
    rng = np.random.default_rng(2)
    gl, eg, maf = _draw(rng, S, I2)
    blk = slice(i * B, i * B + B)
    g_d, e_d, m_d = _tables(gl, eg, maf, blk, 0, dev)
    rout = ring.ring_sweep(2, mesh=rmesh)(g_d, e_d, m_d)
    allr = rmesh.all_gather_object(rout)
    if m.rank == 0:
        out["ring_sweep"] = {k: np.concatenate([r[k] for r in allr], axis=1)
                             for k in rout}
        _expect(out["ring_sweep"]["r2"].shape == (2, S, B), "ring_sweep r2")

    # the gather stepper, compacted as the --ring engine pulls it: one
    # step and the visiting block's advance against the all-steps sweep;
    # live counts, the int8 imat and the r2p rows against its cells
    ccfg = dict(n=S, B=B, B_sub=B, n_dev=n, sample=False, slim_im=True,
                use_i16=True)
    spare = 2 * B if n > 1 else 0
    g_d, e_d, m_d = _tables(gl, eg, maf, blk, spare, dev)
    hi_d = torch.full((B,), S, dtype=torch.int32, device=dev)
    ok_d = torch.ones(B, dtype=torch.float32, device=dev)
    stepper = ring.ring_sweep_stepper(False, 1 << 19, ccfg, rmesh)
    vis = ring.ring_subblock_taker(n, 1, 0, with_ok=True, mesh=rmesh)(
        g_d, e_d, m_d, ok_d)
    counts = []
    for t in range(2):
        (fm, im, cnt), *vis = stepper(g_d, e_d, m_d, hi_d, ok_d, *vis, t, 0)
        valid = _block_valid(i, t, B, n, S)
        _expect(cnt == int(valid.sum()), "live count", i, t, cnt)
        _expect(im.dtype == torch.int8 and tuple(im.shape) == (cnt, 1),
                "imat", im.dtype, tuple(im.shape))
        fm = _host(fm)
        np.testing.assert_allclose(fm[:, 0], rout["r2p"][t][valid],
                                   atol=1e-6)
        np.testing.assert_allclose(_stats_host(fm[:, 1:])[4],
                                   rout["r2"][t][valid], atol=1e-6)
        counts.append(cnt)
    allc = rmesh.all_gather_object(counts)
    if m.rank == 0:
        out["stepper_counts"] = allc

    # the strip stepper: one 128-site tile a block
    Bs, Ss = TA, TA * n
    gl2, eg2, maf2 = _draw(rng, Ss, I2)
    blk2 = slice(i * Bs, i * Bs + Bs)
    ga, gb, ea, eb = strip_tables(torch.from_numpy(gl2[blk2]).to(dev),
                                  torch.from_numpy(eg2[blk2]).to(dev), I2)
    m2 = torch.from_numpy(maf2[blk2]).to(dev)
    hi2 = torch.full((Bs,), Ss, dtype=torch.int32, device=dev)
    ok2 = torch.ones(Bs, dtype=torch.float32, device=dev)
    scfg = dict(ccfg, n=Ss, B=Bs, B_sub=Bs)
    sstep = ring.ring_sweep_stepper_strip(I2, Bs, Bs, False, scfg, rmesh)
    svis = ring.ring_subblock_taker_strip(n, 1, 0, mesh=rmesh)(gb, eb, m2,
                                                               ok2)
    (sfm, sim, scnt), *_ = sstep(ga, ea, hi2, ok2, m2, *svis, 0, 0)
    valid = _block_valid(i, 0, Bs, n, Ss)
    _expect(scnt == int(valid.sum()) and tuple(sfm.shape) == (scnt, 5),
            "strip stepper", scnt, tuple(sfm.shape))
    # and its rows against the gather kernels' on the same pairs
    a, p = np.nonzero(valid)
    gfm, gim = compute.compute_block(
        torch.from_numpy(gl2[blk2]).to(dev), torch.from_numpy(
            eg2[blk2]).to(dev), m2, torch.from_numpy(
                np.stack([a, p]).astype(np.int32)).to(dev), False)
    _hold_rows(_host(sfm), _host(gfm), _host(gim)[:, 0], _host(sim)[:, 0],
               "strip stepper against the gather kernels")

    # the ('sites', 'ind') ring stepper: site blocks ride the ring within
    # each 'ind' column, the cohort's sums all-reduced over the block
    if ind > 1:
        S3, B3, Il = 4 * pairs, 4, I2 // ind
        gl3, eg3, maf3 = _draw(rng, S3, I2)
        blk3 = slice(m.pi * B3, m.pi * B3 + B3)
        g3, e3, m3 = _tables(gl3, eg3, maf3, blk3, 2 * B3 if pairs > 1
                             else 0, dev, slice(m.ii * Il, m.ii * Il + Il))
        hi3 = torch.full((B3,), S3, dtype=torch.int32, device=dev)
        ok3 = torch.ones(B3, dtype=torch.float32, device=dev)
        icfg = dict(ccfg, n=S3, B=B3, B_sub=B3, n_dev=pairs)
        istep = ring.ring_sweep_stepper_ind(False, 1 << 19, icfg, m)
        ivis = ring.ring_subblock_taker(pairs, 1, 0, with_ok=True, mesh=m)(
            g3, e3, m3, ok3)
        (ifm, iim, icnt), *_ = istep(g3, e3, m3, hi3, ok3, *ivis, 0, 0)
        valid = _block_valid(m.pi, 0, B3, pairs, S3)
        _expect(icnt == int(valid.sum()) and tuple(ifm.shape) == (icnt, 5),
                "('sites', 'ind') stepper", icnt, tuple(ifm.shape))
        # against the gather kernels on the whole cohort's rows
        a, p = np.nonzero(valid)
        gfm, gim = compute.compute_block(
            *(torch.from_numpy(x[blk3]).to(dev) for x in (gl3, eg3, maf3)),
            torch.from_numpy(np.stack([a, p]).astype(np.int32)).to(dev),
            False)
        _hold_rows(_host(ifm), _host(gfm), _host(gim)[:, 0],
                   _host(iim)[:, 0], "('sites', 'ind') stepper against the "
                   "gather kernels")
        _rows_of(m, (_host(ifm), _host(iim)))

    # the strip chunk split over the n ranks (the block engine's --shard
    # strip sweep): n tiles (anchor tile 0 x partner tile k), the first
    # 256 cells selected, each rank compacting its own tile's cells
    ga, gb, ea, eb = strip_tables(torch.from_numpy(gl2).to(dev),
                                  torch.from_numpy(eg2).to(dev), I2)
    mf = torch.from_numpy(maf2).to(dev)
    lo = torch.arange(1, Ss + 1, dtype=torch.int32, device=dev)
    hi = torch.full((Ss,), Ss, dtype=torch.int32, device=dev)
    ok = torch.ones(Ss, dtype=torch.float32, device=dev)
    sel = np.arange(256, dtype=np.int32)

    def chunk(fn, parts, row, tables, **kw):
        ta = torch.zeros(parts, dtype=torch.int32, device=dev)
        tb = torch.arange(parts, dtype=torch.int32, device=dev) % (Ss // TA)
        t0_, t1_, pos, sel_loc = compute.strip_shares(parts, sel, parts)[row]
        fm_, _ = fn(*tables, mf, mf, lo, hi, ok, ok, ta[t0_:t1_],
                    tb[t0_:t1_], torch.from_numpy(sel_loc).to(dev), **kw)
        return pos, _host(fm_)

    def place(pieces):
        fm_ = np.full((len(sel), 5), np.nan, np.float32)
        for pos, rows_ in pieces:
            fm_[pos] = rows_
        return fm_

    piece = chunk(compute.strip_compute_fn(I2, False, True), n, rmesh.pi,
                  (ga, gb, ea, eb))
    allp = rmesh.all_gather_object(piece)
    fm1 = place(allp) if m.rank == 0 else None
    if m.rank == 0:
        _expect(fm1.shape == (256, 5) and np.isfinite(fm1).all(),
                "strip chunk")
        out["strip_chunk"] = fm1

    # the strip chunk over the full ('pairs', 'ind') mesh: the tables cut
    # on their individual axis, one all-reduce over 'ind' an EM iteration;
    # equal to the 1-D chunk's cells
    if ind > 1:
        ga, gb, ea, eb = strip_tables(torch.from_numpy(gl2).to(dev),
                                      torch.from_numpy(eg2).to(dev), I2,
                                      i_align=8 * ind)
        ipl = ga.shape[2] // ind
        cut = slice(m.ii * ipl, m.ii * ipl + ipl)
        tabs = (ga[:, :, cut].contiguous(), gb[:, cut].contiguous(),
                ea[:, cut].contiguous(), eb[cut].contiguous())
        piece = chunk(strip_compute_ind, pairs, m.pi, tabs, n_ind=I2,
                      i_start=m.ii * ipl, mesh=m, ignore_miss=False,
                      use_i16=True)
        rows = _rows_of(m, piece)
        if rows is not None:
            fm2 = place(rows)
            _expect(fm2.shape == (256, 5), "('pairs', 'ind') strip chunk")
            np.testing.assert_allclose(fm2[:, 0], fm1[:, 0], atol=1e-5)
            np.testing.assert_allclose(fm2[:, 1:], fm1[:, 1:], atol=1e-4)
            out["strip_ind_chunk"] = fm2

    after = launch_counts()
    mine = {k: after[k] - before[k] for k in after}
    allc = m.all_gather_object((mine, time.perf_counter() - t0))
    if m.rank:
        return None
    out["launches"] = [c for c, _ in allc]
    out["rank_seconds"] = [s for _, s in allc]
    return out


def _dryrun_rank(rank: int, world: int, port: int, job: dict) -> None:
    """Entry of a spawned rank of the dry run."""
    pmesh.rank_main(rank, world, port, job, job["pairs"], job["ind"],
                    lambda m: _dryrun(m, world))


def dryrun_multichip(n_devices: int) -> dict:
    """One step of every multi-device path over n_devices ranks on tiny
    shapes (__graft_entry__.dryrun_multichip): the ('pairs', 'ind') mesh
    takes ind = 2 when n_devices is even, pairs = n_devices // ind. The
    caller becomes rank 0 on the card unless the CPU is asked for
    (NGSLD_PLATFORM=cpu); the other ranks are spawned and joined here.
    Prints DRYRUN_OK once every rank has passed every check and exited,
    and returns rank 0's outputs: the sweep step's ten columns over all P pairs, the ring
    sweep's statistics (2, S, B), the stepper's live counts a block, the
    strip chunks' rows, each rank's kernel launches and seconds, and the
    wall. A failed check, or a rank that exits non-zero, raises (the
    ranks' collectives time out after NGSLD_DIST_TIMEOUT seconds)."""
    dev = _device()
    ind = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    pairs = n_devices // ind
    t0 = time.perf_counter()
    with pmesh.spawn_ranks(n_devices, dev, _dryrun_rank,
                           dict(pairs=pairs, ind=ind)) as store:
        m = pmesh.connect(0, n_devices, pairs, ind, dev, n_devices, store)
        try:
            out = _dryrun(m, n_devices)
        finally:
            pmesh.teardown()
    out["seconds"] = time.perf_counter() - t0
    out["backend"] = m.backend
    print("DRYRUN_OK", flush=True)
    return out
