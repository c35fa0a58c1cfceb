"""Whether a job's rows are correct: the comparison with the plain
reference (ldbench/reference/).

* The pair set, whole: every row's two site labels and its distance,
  against the band walk of reference.pairs (the --rnd_sample draws
  included). A pair missing, extra or twice, a row that does not parse,
  or a wrong distance each count one in `pairs_off`.
* The values, on a sample of the pairs drawn from the seed: every column
  the cell prints, against the reference's EM, Pearson r2 and statistics
  in float64 (reference.em). The numbers compared are the widest gaps:
    gap_freq   |a - b| over D, and with --extend_out maf1, maf2, the
               haplotype frequencies and hap_maf1, hap_maf2;
    gap_r2pear |a - b| of r2_ExpG;
    gap_ratio  the ratio columns Dp, r2 (and chi2) times their reference
               denominators (|Dmax|, the hap-MAF product, the least
               expected haplotype frequency): a ratio's gap over a
               denominator near 0 is rounding in any two implementations,
               the product is the gap in the numerator it came from;
    gap_niter  |a - b| of nIter (with --extend_out);
  and sample_size and loglike are exact (counted in pairs_off).
A value that is finite on one side and not on the other counts as a gap
of 1 (times the denominator for the ratio columns).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import em, pairs, readers

BASE = ["r2_ExpG", "D", "Dp", "r2"]
EXTENDED = ["sample_size", "maf1", "maf2", "hap00", "hap01", "hap10",
            "hap11", "hap_maf1", "hap_maf2", "chi2", "loglike", "nIter"]
SAMPLE_CELLS = 1 << 25      # (pair, individual) cells the values compare


def header(extend: bool) -> bytes:
    cols = ["site1", "site2", "dist"] + BASE + (EXTENDED if extend else [])
    return ("\t".join(cols) + "\n").encode()


def _hash_fields(a: np.ndarray, start: np.ndarray, length: np.ndarray,
                 width: int) -> np.ndarray:
    """64-bit polynomial hash of the byte fields a[start:start+length];
    fields longer than width hash to a value no label has (-1)."""
    j = np.arange(width)
    idx = np.minimum(start[:, None] + j, len(a) - 1)
    b = np.where(j < length[:, None], a[idx], 0).astype(np.uint64)
    pw = np.uint64(1099511628211) ** np.arange(1, width + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = (b * pw).sum(axis=1, dtype=np.uint64) \
            + length.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h[length > width] = np.uint64(2**64 - 1)
    return h


def _digits(a: np.ndarray, start: np.ndarray, length: np.ndarray):
    """Non-negative integers written in a[start:start+length]; inf for the
    field 'inf'; nan for anything else."""
    width = 12
    j = np.arange(width)
    idx = np.minimum(start[:, None] + j, len(a) - 1)
    b = np.where(j < length[:, None], a[idx], ord("0")).astype(np.int64)
    d = b - ord("0")
    ok = ((d >= 0) & (d <= 9)).all(axis=1) & (length >= 1) & (length <= width)
    e = length[:, None] - 1 - j
    val = np.where(e >= 0, d * 10 ** np.maximum(e, 0), 0).sum(axis=1)
    out = np.where(ok, val.astype(np.float64), np.nan)
    is_inf = (length == 3) & (a[np.minimum(start, len(a) - 1)] == ord("i"))
    out[is_inf] = np.inf
    return out


def parse_rows(rows, labels: list, chunk: int = 1 << 20):
    """Rows of a job -> dict with per row s1, s2 (site index, -1 for an
    unknown label or a row that does not parse), dist, and the byte range
    of its value columns (vstart, end). Labels map by hash."""
    a = np.frombuffer(rows, np.uint8)
    nl = np.flatnonzero(a == 10)
    width = max(len(x) for x in labels)
    lab_len = np.array([len(x) for x in labels], np.int64)
    lab_blob = np.frombuffer(b"".join(labels), np.uint8)
    lab_start = np.concatenate([[0], np.cumsum(lab_len)[:-1]])
    lab_h = _hash_fields(lab_blob, lab_start, lab_len, width)
    order = np.argsort(lab_h)
    sorted_h = lab_h[order]
    if len(np.unique(sorted_h)) != len(sorted_h):
        raise ValueError("two site labels share a hash")
    starts = np.concatenate([[0], nl[:-1] + 1])[1:]   # the header is line 0
    ends = nl[1:]
    n = len(starts)
    s1 = np.full(n, -1, np.int64)
    s2 = np.full(n, -1, np.int64)
    dist = np.full(n, np.nan)
    vstart = np.zeros(n, np.int64)
    for c0 in range(0, n, chunk):
        st, en = starts[c0:c0 + chunk], ends[c0:c0 + chunk]
        lo, hi = st[0], en[-1]
        t = np.flatnonzero(a[lo:hi] == 9) + lo
        first = np.searchsorted(t, st)
        cnt = np.searchsorted(t, en) - first
        good = cnt >= 3
        f = np.where(good, first, 0)
        t0 = t[np.minimum(f, len(t) - 1)] if len(t) else st
        t1 = t[np.minimum(f + 1, len(t) - 1)] if len(t) else st
        t2 = t[np.minimum(f + 2, len(t) - 1)] if len(t) else st
        for out, fs, fl in ((s1, st, t0 - st), (s2, t0 + 1, t1 - t0 - 1)):
            h = _hash_fields(a, fs, np.maximum(fl, 0), width)
            k = np.minimum(np.searchsorted(sorted_h, h), len(sorted_h) - 1)
            hit = good & (sorted_h[k] == h)
            out[c0:c0 + chunk] = np.where(hit, order[k], -1)
        dist[c0:c0 + chunk] = np.where(
            good, _digits(a, t1 + 1, np.maximum(t2 - t1 - 1, 0)), np.nan)
        vstart[c0:c0 + chunk] = t2 + 1
    head = bytes(a[:nl[0] + 1]) if len(nl) else bytes(a)
    return dict(header=head, s1=s1, s2=s2, dist=dist, vstart=vstart,
                end=ends)


def _values(rows, parsed: dict, idx: np.ndarray, n_cols: int):
    """The value columns of the rows idx -> (len(idx), n_cols) floats and
    the mask of rows that parse (a row that does not is NaN)."""
    mv = memoryview(rows)
    lines = [bytes(mv[parsed["vstart"][i]:parsed["end"][i]]) for i in idx]
    v = np.fromstring(b"\n".join(lines), sep="\t") if lines else \
        np.empty(0)
    if len(v) == len(idx) * n_cols:
        return v.reshape(len(idx), n_cols), np.ones(len(idx), bool)
    out = np.full((len(idx), n_cols), np.nan)
    ok = np.zeros(len(idx), bool)
    for j, line in enumerate(lines):
        v = np.fromstring(line, sep="\t")
        if len(v) == n_cols:
            out[j], ok[j] = v, True
    return out, ok


def as_printed(ref: dict, extend: bool, n_ind: int) -> np.ndarray:
    """A values dict as the rows would print it (%f: 6 decimals), for a
    reference put in the program's place (the control)."""
    cols = [ref["r2_ExpG"], ref["D"], ref["Dp"], ref["r2"]]
    if extend:
        cols += [np.full(len(ref["D"]), float(n_ind)), ref["maf1"],
                 ref["maf2"], *ref["f"].T, ref["hap_maf1"], ref["hap_maf2"],
                 ref["chi2"], np.zeros(len(ref["D"])),
                 ref["nIter"].astype(np.float64)]
    with np.errstate(invalid="ignore"):
        return np.round(np.stack(cols, axis=1).astype(np.float64), 6)


def _gap(a, b, scale=None):
    """Per-element gap: |a - b| (times scale); one side finite and the
    other not reads 1 (times scale); both not finite reads 0."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    with np.errstate(invalid="ignore"):
        g = np.where(fa & fb, np.abs(a - b), np.where(fa ^ fb, 1.0, 0.0))
    if scale is not None:
        g = g * np.abs(np.nan_to_num(scale, nan=0.0, posinf=1.0))
    return g


def reference_pairs(cell: dict, contig, pos, seed: int):
    flags = cell["flags"]

    def flag(name, default):
        return type(default)(flags[flags.index(name) + 1]) \
            if name in flags else default
    return pairs.enumerate_pairs(
        contig, pos, max_kb_dist=flag("--max_kb_dist", 100),
        max_snp_dist=flag("--max_snp_dist", 0),
        rnd_sample=flag("--rnd_sample", 1.0), seed=seed)


def sample_pairs(n_pairs: int, n_ind: int, seed: int) -> np.ndarray:
    k = min(n_pairs, max(2048, SAMPLE_CELLS // max(n_ind, 1)))
    rng = np.random.default_rng([seed & (2**63 - 1), 11])
    return np.sort(rng.choice(n_pairs, size=k, replace=False))


def reference_values(job: dict, s1: np.ndarray, s2: np.ndarray,
                     dtype=torch.float64, device="cpu") -> dict:
    """The reference's columns for the pairs (s1, s2) of the job's input,
    computed in dtype."""
    sites, inv = np.unique(np.concatenate([s1, s2]), return_inverse=True)
    lg = readers.read_rows(job, sites)
    i1, i2 = inv[:len(s1)], inv[len(s1):]
    return em.pair_values(lg, i1, i2, dtype=dtype, device=device)


def compare_values(prog: np.ndarray, ref: dict, extend: bool,
                   n_ind: int) -> dict:
    """prog (K, columns after dist) printed values; ref the reference's
    columns for the same K pairs -> the gaps and the exact-column misses."""
    c = {name: prog[:, j] for j, name in enumerate(BASE + (EXTENDED
                                                            if extend else []))}
    out = {}
    freq = [_gap(c["D"], ref["D"])]
    if extend:
        freq += [_gap(c["maf1"], ref["maf1"]), _gap(c["maf2"], ref["maf2"]),
                 _gap(c["hap_maf1"], ref["hap_maf1"]),
                 _gap(c["hap_maf2"], ref["hap_maf2"])]
        freq += [_gap(c[h], ref["f"][:, k]) for k, h in
                 enumerate(("hap00", "hap01", "hap10", "hap11"))]
    out["gap_freq"] = float(np.max(freq)) if len(c["D"]) else 0.0
    out["gap_r2pear"] = float(np.max(_gap(c["r2_ExpG"], ref["r2_ExpG"]),
                                     initial=0.0))
    ratio = [_gap(c["Dp"], ref["Dp"], ref["den_dp"]),
             _gap(c["r2"], ref["r2"], ref["den_r2"])]
    if extend:
        ratio.append(_gap(c["chi2"], ref["chi2"], ref["exp_min"]))
    out["gap_ratio"] = float(np.max(ratio, initial=0.0))
    exact_off = 0
    if extend:
        out["gap_niter"] = float(np.max(np.abs(c["nIter"] - ref["nIter"]),
                                        initial=0.0))
        exact_off = int(((c["sample_size"] != n_ind)
                         | (c["loglike"] != 0.0)).sum())
    return out, exact_off


def check_job(rows, cell: dict, job: dict, labels: list, contig, pos,
              seed: int, device="cpu", values_dtype=None) -> dict:
    """Every number compared for one job's rows -> {name: value}."""
    extend = "--extend_out" in cell["flags"]
    rs1, rs2, rdist = reference_pairs(cell, contig, pos, seed)
    n = len(pos)
    parsed = parse_rows(rows, labels)
    off = 0 if parsed["header"] == header(extend) else 1
    s1, s2 = parsed["s1"], parsed["s2"]
    bad = (s1 < 0) | (s2 < 0)
    off += int(bad.sum())
    key_p = np.where(bad, -1, s1 * n + s2)
    key_r = rs1 * n + rs2
    good_keys = key_p[~bad]
    uniq, counts = np.unique(good_keys, return_counts=True)
    off += int((counts - 1).sum())                       # twice
    off += int((~np.isin(key_r, uniq, assume_unique=True)).sum())  # missing
    pos_r = np.searchsorted(key_r, key_p)
    known = ~bad & (pos_r < len(key_r))
    known[known] = key_r[pos_r[known]] == key_p[known]
    off += int((~bad & ~known).sum())                    # extra
    dist_bad = known & ~((parsed["dist"] == rdist[np.minimum(
        pos_r, len(rdist) - 1)]))
    off += int(dist_bad.sum())
    # values on a sample of the reference's pairs that the rows hold
    pick = sample_pairs(len(key_r), job["n_ind"], seed)
    row_of = np.full(len(key_r), -1, np.int64)
    row_of[pos_r[known]] = np.flatnonzero(known)
    pick = pick[row_of[pick] >= 0]
    ncols = len(BASE) + (len(EXTENDED) if extend else 0)
    vals, ok = _values(rows, parsed, row_of[pick], ncols)
    off += int((~ok).sum())
    pick, vals = pick[ok], vals[ok]
    ref = reference_values(job, rs1[pick], rs2[pick], device=device,
                           dtype=values_dtype or torch.float64)
    gaps, exact_off = compare_values(vals, ref, extend, job["n_ind"])
    return dict(pairs_off=off + exact_off, **gaps,
                rows=int(len(s1)), compared=int(len(pick)))


def control_job(cell: dict, job: dict, contig, pos, seed: int,
                device="cpu", dtype=torch.bfloat16) -> dict:
    """The control: the reference computed in `dtype` (the nearest
    precision below the configuration's float32) put in the program's
    place, its values as the rows would print them, compared with the
    float64 reference on the same sampled pairs."""
    extend = "--extend_out" in cell["flags"]
    rs1, rs2, _ = reference_pairs(cell, contig, pos, seed)
    pick = sample_pairs(len(rs1), job["n_ind"], seed)
    ref = reference_values(job, rs1[pick], rs2[pick], device=device)
    ctl = reference_values(job, rs1[pick], rs2[pick], device=device,
                           dtype=dtype)
    gaps, exact_off = compare_values(as_printed(ctl, extend, job["n_ind"]),
                                     ref, extend, job["n_ind"])
    return dict(pairs_off=exact_off, **gaps, rows=int(len(rs1)),
                compared=int(len(pick)))
