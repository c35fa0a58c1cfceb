"""Banded pair-plan construction (host side, vectorized NumPy).

Replaces the reference's per-anchor dynamic walk (ngsLD.cpp:229-286) with a
closed-form banded enumeration. Because positions are strictly increasing
within a contig (read_dist errors otherwise, read_data.cpp:204-206), the
walk's break conditions are equivalent to interval bounds:

  * kb band:   same contig AND pos[s2] - pos[s1] <= max_kb_dist*1000
               (cross-contig dist is +inf -> break); max_kb_dist==0 disables
  * snp band:  s2 - s1 <= max_snp_dist; 0 disables
  * anchor:    maf[s1] >= min_maf (else the anchor emits nothing)
  * partner:   maf[s2] >= min_maf (skip, band continues)
  * sampling:  one taus uniform per surviving candidate, in s2 order, from a
               per-anchor child stream seeded by the master stream in anchor
               order (ngsLD.cpp:164-166, 277)

The resulting pair set is identical to the reference's (verified against
strict.enumerate_pairs in tests/test_plan.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..constants import INF
from ..gsl_rng import TausRNG, iter_uniform_chunks


@dataclass
class PairBlock:
    s1: np.ndarray    # (P,) int64 anchor site indices
    s2: np.ndarray    # (P,) int64 partner site indices
    dist: np.ndarray  # (P,) float64 base-pair distances (inf across contigs)


def contig_positions(pos_dist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Recover (contig_id, cumulative position-within-run) from the
    adjacent-distance encoding (inf marks a contig change; element 0 starts
    run 0 whatever its value)."""
    n = len(pos_dist)
    brk = np.isinf(pos_dist)
    brk[0] = False
    contig = np.cumsum(brk).astype(np.int64)
    pos = np.where(np.isinf(pos_dist), 0.0, pos_dist)
    # cumulative within contig: global cumsum minus cumsum at contig start
    csum = np.cumsum(pos)
    first_idx = np.flatnonzero(np.r_[True, brk[1:]])
    # value of csum just before each contig's first site
    base = np.zeros(len(first_idx))
    base[1:] = csum[first_idx[1:] - 1]
    start_map = np.repeat(base, np.diff(np.r_[first_idx, n]))
    return contig, csum - start_map


def band_limits(pos_dist: np.ndarray, max_kb_dist: int, max_snp_dist: int) -> np.ndarray:
    """For every anchor s1, the largest s2 (exclusive) reachable before a
    break condition. Returns hi (n,) with pairs s2 in (s1, hi[s1])."""
    n = len(pos_dist)
    contig, pos = contig_positions(pos_dist)
    hi = np.full(n, n, dtype=np.int64)
    if max_kb_dist > 0:
        # within each contig: last index with pos <= pos[s1] + max_bp
        max_bp = np.float64(max_kb_dist * 1000)
        hi_kb = np.empty(n, dtype=np.int64)
        for c_start in np.flatnonzero(np.r_[True, np.diff(contig) != 0]):
            c_end = c_start
            while c_end < n and contig[c_end] == contig[c_start]:
                c_end += 1
            seg = pos[c_start:c_end]
            hi_kb[c_start:c_end] = c_start + np.searchsorted(seg, seg + max_bp, side="right")
        hi = np.minimum(hi, hi_kb)
    if max_snp_dist > 0:
        hi = np.minimum(hi, np.arange(n) + max_snp_dist + 1)
    return hi


def child_seeds(master_seed: int, n_sites: int) -> np.ndarray:
    """Per-anchor child-stream seeds, drawn sequentially from the master
    stream in site order (ngsLD.cpp:164-166): uint64(uniform * 1e15)."""
    if os.environ.get("NGSLD_NO_NATIVE") != "1":
        from ..native import child_seeds_native
        out = child_seeds_native(master_seed, n_sites)
        if out is not None:
            return out
    m = TausRNG(master_seed)
    return np.array([int(m.uniform() * INF) for _ in range(n_sites)],
                    dtype=np.uint64)


def iter_pair_blocks(pars, maf: np.ndarray, pos_dist: np.ndarray,
                     block_pairs: int = 1 << 20) -> Iterator[PairBlock]:
    """Stream the banded pair plan as flat index blocks of ~block_pairs."""
    n = pars.n_sites
    hi = band_limits(pos_dist, pars.max_kb_dist, pars.max_snp_dist)
    counts = np.maximum(hi - np.arange(n) - 1, 0)
    # the reference filter is `maf < min_maf` -> break (ngsLD.cpp:264): NaN
    # MAFs (all-missing sites under --ignore_miss_data) compare false and
    # therefore PASS the filter; preserve that with ~(maf < min_maf)
    anchor_ok = ~(maf < pars.min_maf)
    # a low-MAF anchor breaks at its first in-band candidate -> emits nothing
    counts = np.where(anchor_ok, counts, 0)

    contig, pos = contig_positions(pos_dist)
    need_rng = pars.rnd_sample < 1.0
    seeds = child_seeds(pars.seed, n) if need_rng else None

    # process anchors in slabs sized so the EMITTED pair count ~ block_pairs:
    # with sampling, only ~rnd_sample of candidates survive, so the
    # candidate budget scales by 1/rnd_sample (else blocks arrive ~5% full
    # and the device computes 95% padding). Capped: extreme rnd_sample
    # would otherwise size multi-GB candidate slabs (native a/b/d output
    # buffers are allocated at the candidate count)
    budget = block_pairs / pars.rnd_sample if need_rng else block_pairs
    budget = min(budget, max(block_pairs, 32_000_000))
    cand_cum = np.cumsum(counts)
    use_native = os.environ.get("NGSLD_NO_NATIVE") != "1"
    s1 = 0
    while s1 < n:
        # maximal anchor prefix whose candidate total fits the budget
        # (at least one anchor, however large its band)
        cand_base = int(cand_cum[s1 - 1]) if s1 > 0 else 0
        s1_end = max(int(np.searchsorted(cand_cum, cand_base + budget,
                                         side="right")), s1 + 1)
        tot = int(cand_cum[s1_end - 1] - cand_base)
        if tot > 0 and use_native:
            from ..native import plan_slab_native
            nat = plan_slab_native(
                s1, s1_end, counts, maf, pars.min_maf, contig, pos,
                pars.rnd_sample if need_rng else 1.0, seeds, tot)
            if nat is not None:
                a, b, d = nat
                if len(a):
                    yield PairBlock(s1=a, s2=b, dist=d)
                s1 = s1_end
                continue
        if tot > 0:
            cslice = counts[s1:s1_end]
            a = np.repeat(np.arange(s1, s1_end), cslice)       # anchor ids
            offs = np.arange(len(a)) - np.repeat(
                np.cumsum(cslice) - cslice, cslice)
            b = a + 1 + offs                                    # partner ids
            # partner MAF skip (same NaN-passes semantics, ngsLD.cpp:270)
            keep = ~(maf[b] < pars.min_maf)
            if need_rng:
                # draws are consumed per surviving candidate in s2 order
                within = keep.astype(np.int64)
                # draw index = rank of this candidate among kept-so-far in its
                # anchor group = per-group exclusive cumsum of `keep`
                grp_start = np.minimum(np.cumsum(cslice) - cslice,
                                       max(len(a) - 1, 0))
                kc = np.cumsum(within)
                excl = kc - within
                base = np.repeat(excl[grp_start], cslice)
                ccum = excl - base
                draw = np.zeros(len(a))
                rows = a - s1
                # chunked so a single wide-band anchor cannot blow the
                # uniforms allocation up for the whole slab
                for a0, a1, u in iter_uniform_chunks(seeds[s1:s1_end],
                                                     cslice):
                    m = keep & (rows >= a0) & (rows < a1)
                    draw[m] = u[rows[m] - a0, ccum[m]]
                keep &= ~(draw > pars.rnd_sample)
            a, b = a[keep], b[keep]
            d = np.where(contig[a] == contig[b], pos[b] - pos[a], np.inf)
            if len(a):
                yield PairBlock(s1=a, s2=b, dist=d)
        s1 = s1_end
