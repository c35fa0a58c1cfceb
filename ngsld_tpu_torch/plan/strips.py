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
take the gather path for sparse bands.
"""

from __future__ import annotations

import numpy as np

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
