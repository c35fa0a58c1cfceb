"""The pair set of an LD job (ngsLD.cpp calc_pair_LD's band walk): for
each anchor s1 the candidates s2 = s1 + 1, s1 + 2, ... until the distance
passes --max_kb_dist (kb; 0 = no limit) or the index span passes
--max_snp_dist (0 = no limit). A low-MAF anchor (maf < --min_maf) emits
nothing, a low-MAF partner is skipped, and with --rnd_sample < 1 each
remaining candidate draws one uniform from its anchor's child stream and
is kept when the draw is at most the rate."""

from __future__ import annotations

import numpy as np

from . import taus


def read_pos(path: str):
    """(contig id per site, position per site, label bytes per site). A
    label is the line with its first tab turned into ':'."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    names, pos, labels = {}, np.empty(len(lines), np.int64), []
    contig = np.empty(len(lines), np.int64)
    for i, ln in enumerate(lines):
        c, p = ln.split(b"\t", 1)
        contig[i] = names.setdefault(c, len(names))
        pos[i] = int(p)
        labels.append(c + b":" + p)
    return contig, pos, labels


def band_ends(contig, pos, max_kb_dist: int, max_snp_dist: int):
    """Last candidate index (inclusive) of each anchor's band."""
    n = len(pos)
    idx = np.arange(n)
    end = np.full(n, n - 1, np.int64)
    if max_kb_dist > 0:
        # same contig and pos[s2] - pos[s1] <= max_kb_dist * 1000
        key = contig.astype(np.float64) * 1e12 + pos
        end = np.searchsorted(key, key + max_kb_dist * 1000.0,
                              side="right") - 1
    if max_snp_dist > 0:
        end = np.minimum(end, idx + max_snp_dist)
    return end


def enumerate_pairs(contig, pos, *, max_kb_dist: int, max_snp_dist: int,
                    rnd_sample: float, seed: int, maf=None,
                    min_maf: float = 0.0, max_elems: int = 1 << 24):
    """-> (s1, s2, dist) in (s1, s2) order; dist is pos[s2] - pos[s1] on
    one contig and inf across contigs."""
    n = len(pos)
    end = band_ends(contig, pos, max_kb_dist, max_snp_dist)
    ncand = np.maximum(end - np.arange(n), 0)
    if min_maf > 0:
        ncand = np.where(maf < min_maf, 0, ncand)
    need_rng = rnd_sample < 1.0
    seeds = taus.master_child_seeds(seed, n) if need_rng else None
    s1s, s2s = [], []
    width = int(ncand.max()) if n else 0
    step = max(1, max_elems // max(width, 1))
    for a0 in range(0, n, step):
        a1 = min(n, a0 + step)
        w = int(ncand[a0:a1].max()) if a1 > a0 else 0
        if w == 0:
            continue
        anchors = np.arange(a0, a1)
        off = np.arange(1, w + 1)
        s2 = anchors[:, None] + off[None, :]
        live = off[None, :] <= ncand[a0:a1, None]
        if min_maf > 0:
            # a skipped low-MAF partner takes no draw
            ok = live & (maf[np.minimum(s2, n - 1)] >= min_maf)
        else:
            ok = live
        if need_rng:
            draws = np.cumsum(ok, axis=1) - 1   # draw index of each candidate
            u = taus.uniforms(seeds[a0:a1], max(int(ok.sum(1).max()), 1))
            kept = np.take_along_axis(u, np.maximum(draws, 0), axis=1)
            ok = ok & (kept <= rnd_sample)
        r, c = np.nonzero(ok)
        s1s.append(anchors[r])
        s2s.append(s2[r, c])
    s1 = np.concatenate(s1s) if s1s else np.empty(0, np.int64)
    s2 = np.concatenate(s2s) if s2s else np.empty(0, np.int64)
    dist = np.where(contig[s1] == contig[s2],
                    (pos[s2] - pos[s1]).astype(np.float64), np.inf)
    return s1.astype(np.int64), s2.astype(np.int64), dist
