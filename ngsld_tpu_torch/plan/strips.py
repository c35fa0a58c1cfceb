"""Rectangle (strip-tile) decomposition of a banded pair plan
(ngsld_tpu/plan/strips.py, with the tile shape an argument).

Covers every in-band pair (a, b in (a, hi[a])) with ta x tb tiles whose
coordinates feed kernels.strip_em.strip_em: anchor tile k spans sites
[k*ta, (k+1)*ta); its partner tiles j run from k (the triangle starts
inside the diagonal tile) to the last tile touched by the block's
furthest band reach. Tiles are ordered (k asc, j asc), so one anchor
tile's rows interleave back into global (s1, s2) order with a single
lexsort per anchor-tile group (engine strip sweep).

The decomposition is only worth dispatching when the plan is DENSE over
the rectangles: `utilization` reports live-pairs/cells so the engine can
take the gather path for sparse bands. strip_chunks cuts the banded pair
stream into the strip sweep's dispatches.
"""

from __future__ import annotations

import numpy as np

from .band import PairBlock

TA = 128           # anchors per tile
TB = 128           # partners per tile


def strip_plan(hi: np.ndarray, ok: np.ndarray, n_sites: int,
               ta: int = TA, tb: int = TB):
    """(ta, tb, groups, utilization): tile coordinate arrays (int32, in
    ta/tb units over the padded site range), per-anchor-tile group sizes
    (#partner tiles for each k, in tile-list order), and the live-cell
    fraction. hi/ok are over the PADDED range (ok False on pad sites).
    The diagonal start j = k assumes square tiles."""
    Sp = len(hi)
    assert Sp % ta == 0 and ta == tb, (Sp, ta, tb)
    tas, tbs, groups = [], [], []
    for k in range(Sp // ta):
        lo_s, hi_s = k * ta, (k + 1) * ta
        seg_ok = ok[lo_s:hi_s].astype(bool)
        if not seg_ok.any():
            groups.append(0)
            continue
        reach = int(hi[lo_s:hi_s][seg_ok].max(initial=0))
        j_end = max(k + 1, -(-reach // tb))
        groups.append(j_end - k)
        for j in range(k, j_end):
            tas.append(k)
            tbs.append(j)
    tas = np.asarray(tas, np.int32)
    tbs = np.asarray(tbs, np.int32)
    a = np.arange(Sp)
    live = int(np.maximum(np.minimum(hi, Sp) - a - 1, 0)[ok.astype(bool)]
               .sum())
    cells = max(1, len(tas) * ta * tb)
    return tas, tbs, np.asarray(groups, np.int64), live / cells


def strip_chunks(blocks, gmaxt: int, ctarget: int):
    """Cut a banded pair stream (plan.band.iter_pair_blocks, as the gather
    sweep walks it, so both sweeps compute the same pairs, sampling
    included) into the strip sweep's dispatch chunks: whole anchor-tile
    groups batched up to gmaxt tiles and about ctarget pairs; a group wider
    than gmaxt tiles split at gmaxt-tile partner windows (window-major:
    each tile computes once).

    Yields (ta_slots, tb_slots, sel, PairBlock, rem): the chunk's tiles,
    each pair's cell among them (flat over (tiles, TA, TB)), its pairs,
    and rem > 0 for a piece of a split group with rem more chunks to come.
    A split group's non-final pieces span exactly gmaxt tiles and fill a
    chunk alone; its rows are window-major."""
    pend = []        # stream pieces of the current anchor-tile group
    cur = -1
    acc = []         # whole group pieces of the open chunk
    acc_tiles = acc_pairs = 0

    def flush(rem=0):
        nonlocal acc_tiles, acc_pairs
        ta_l, tb_l, sels = [], [], []
        off = 0
        for (k, j0, gc, a, b, _) in acc:
            ta_l.append(np.full(gc, k, np.int32))
            tb_l.append(np.arange(j0, j0 + gc, dtype=np.int32))
            sels.append((((off + b // TB - j0) * TA + (a - k * TA)) * TB
                         + b % TB).astype(np.int32))
            off += gc
        out = (np.concatenate(ta_l), np.concatenate(tb_l),
               np.concatenate(sels),
               PairBlock(s1=np.concatenate([p[3] for p in acc]),
                         s2=np.concatenate([p[4] for p in acc]),
                         dist=np.concatenate([p[5] for p in acc])),
               rem)
        acc.clear()
        acc_tiles = acc_pairs = 0
        return out

    def add_group(k, a, b, d):
        nonlocal acc_tiles, acc_pairs
        j_end = max(k + 1, -(-int(b.max() + 1) // TB))
        pieces = []
        for c0 in range(k, j_end, gmaxt):
            c1 = min(c0 + gmaxt, j_end)
            win = (b >= c0 * TB) & (b < c1 * TB)
            if win.any():
                pieces.append((k, c0, c1 - c0, a[win], b[win], d[win]))
        for pi, piece in enumerate(pieces):
            rem = len(pieces) - 1 - pi
            if acc and (acc_tiles + piece[2] > gmaxt
                        or acc_pairs + len(piece[3]) > ctarget):
                yield flush()
            acc.append(piece)
            acc_tiles += piece[2]
            acc_pairs += len(piece[3])
            if rem:
                yield flush(rem)

    for blk in blocks:
        ks = blk.s1 // TA
        edges = np.r_[0, np.flatnonzero(np.diff(ks)) + 1, len(ks)]
        for e0, e1 in zip(edges[:-1], edges[1:]):
            k = int(ks[e0])
            if k != cur and pend:
                yield from add_group(cur, *(np.concatenate(x)
                                            for x in zip(*pend)))
                pend.clear()
            cur = k
            pend.append((blk.s1[e0:e1], blk.s2[e0:e1], blk.dist[e0:e1]))
    if pend:
        yield from add_group(cur, *(np.concatenate(x) for x in zip(*pend)))
    if acc:
        yield flush()
