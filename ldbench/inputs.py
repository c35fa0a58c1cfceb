"""A cell's input files, made from --seed.

The genotypes follow a documented population model, written here:

* Haplotypes: the copying model of Li and Stephens (Genetics 165:2213,
  2003, Appendix A, the "PAC-A" conditional). Haplotype k (k = 1 ... m-1,
  in order) is a mosaic of the k haplotypes before it: between two sites
  d bp apart it switches to a new template, drawn uniformly, with
  probability 1 - exp(-rho d / k), rho = 4 Ne r per bp. The first
  haplotype carries the ancestral allele everywhere.
* Sites: every candidate site is segregating. Its derived allele enters
  on haplotype j, drawn with P(j) proportional to 1/j, and is copied
  from there on, so that the derived counts follow the neutral 1/i
  spectrum (Watterson, Theor Popul Biol 7:256, 1975). Candidate sites
  lie at the density of segregating sites in m haplotypes, theta a_m per
  bp with theta = 4 Ne mu and a_m = sum 1/i (i < m), in one contig.
* The SNP filter: a site is kept if its minor allele count in the
  sample is at least min_maf of the 2n haplotypes, the filter of ngsLD's
  own test (examples/test.sh, --min_maf 0.05) applied upstream; the
  cell's first n_sites kept sites are its sites.
* Individuals: random pairs of haplotypes; reads: Poisson depth, binomial
  reads with a read error; GL(g) = P(reads | g) normalised to a maximum
  of 1, GL = 1/3 for an individual without reads.

The configuration's file names Ne, mu, r, min_maf, the depth, the read
error and their sources. Two departures keep the amount of work the same
for every seed: the position steps and the arrival haplotypes are the
same evenly spread set of quantiles for every seed, in the seed's order;
the copying and the reads are the seed's own draws. The GLs are drawn in
slabs of sites, each from its own stream of the seed, a few at a time on
threads, from a table over (minor, major) read counts.

Binary log-GL files go to an anonymous in-memory file (memfd), opened by
the port as /proc/self/fd/<n>: a run writes no GL bytes to disk. Text
files (Beagle .gz, positions) go to a directory under TMPDIR. Everything
is removed at close()."""

from __future__ import annotations

import gzip
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SLAB_CELLS = 1 << 22   # (site, individual) cells a slab, at most
SLAB_SITES = 1 << 15   # sites a slab, at most
THREADS = 4            # slabs drawn at once
MARGIN = 1.25          # candidate sites drawn over the expected need


def _stream(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**63 - 1), *key])


def _quantiles(cdf: np.ndarray, n: int) -> np.ndarray:
    """n evenly spread quantiles of a discrete distribution (cdf over
    0 ... len-1)."""
    return np.searchsorted(cdf, (np.arange(n) + 0.5) / n)


def _harmonic(n: int) -> float:
    return float((1.0 / np.arange(1, n + 1)).sum())


def kept_share(m: int, min_maf: float) -> float:
    """The expected share of candidate sites whose minor allele count in
    m haplotypes is at least min_maf * m, under the 1/i spectrum."""
    i = np.arange(1, m)
    w = 1.0 / i
    return float(w[np.minimum(i, m - i) >= min_maf * m].sum() / w.sum())


def candidate_positions(seed: int, n: int, m: int, gen: dict,
                        attempt: int = 0):
    """Positions (bp, from 1) of n candidate segregating sites: steps
    from the exponential law of density theta a_m per bp, its n evenly
    spread quantiles in the seed's order, at least 1 bp."""
    theta = 4 * gen["Ne"] * gen["mu"]
    mean = 1.0 / (theta * _harmonic(m - 1))
    q = (np.arange(n) + 0.5) / n
    steps = np.maximum(1, np.rint(-mean * np.log1p(-q))).astype(np.int64)
    return np.cumsum(_stream(seed, 0, attempt).permutation(steps))


def haplotypes(seed: int, pos: np.ndarray, m: int, gen: dict,
               attempt: int = 0) -> np.ndarray:
    """(m, len(pos)) 0/1 alleles of m haplotypes under the copying model,
    each site's derived allele entering on the haplotype its quantile of
    P(j) ~ 1/j names."""
    n = len(pos)
    w = 1.0 / np.arange(1, m)
    arrival = 1 + _quantiles(np.cumsum(w) / w.sum(), n)
    arrival = _stream(seed, 3, attempt).permutation(arrival)
    order = np.argsort(arrival, kind="stable")
    bounds = np.searchsorted(arrival[order], np.arange(m + 1))
    rho = 4 * gen["Ne"] * gen["r"]
    span = float(pos[-1] - pos[0])
    rng = _stream(seed, 4, attempt)
    h = np.zeros((m, n), np.uint8)
    cols = np.arange(n)
    for k in range(1, m):
        # switches: a Poisson process of rate rho / k per bp; a site
        # interval with one or more events switches
        ev = pos[0] + rng.random(rng.poisson(rho * span / k)) * span
        cut = np.unique(np.searchsorted(pos, ev))
        tmpl = rng.integers(0, k, len(cut) + 1)
        # few tracts (most haplotypes): copy slices; a gather over every
        # site of every haplotype would double the cohort's set-up
        if len(cut) < 32:
            edges = [0, *cut.tolist(), n]
            for t, lo, hi in zip(tmpl.tolist(), edges[:-1], edges[1:]):
                h[k, lo:hi] = h[t, lo:hi]
        else:
            tract = np.zeros(n, np.int64)
            tract[cut] = 1
            h[k] = h[tmpl[np.cumsum(tract)], cols]
        h[k, order[bounds[k]:bounds[k + 1]]] = 1
    return h


def sample(seed: int, n_sites: int, n_ind: int, gen: dict):
    """-> (positions, genotypes (n_sites, n_ind) int8) of the cell's
    n_sites kept sites; more candidates are drawn if too few pass the
    filter (a later attempt is a stream of its own)."""
    m = 2 * n_ind
    need = int(n_sites / kept_share(m, gen["min_maf"]) * MARGIN) + 64
    for attempt in range(8):
        pos = candidate_positions(seed, need, m, gen, attempt)
        h = haplotypes(seed, pos, m, gen, attempt)
        c = h.sum(axis=0, dtype=np.int64)
        keep = np.flatnonzero(np.minimum(c, m - c) >= gen["min_maf"] * m)
        if len(keep) >= n_sites:
            keep = keep[:n_sites]
            pair = _stream(seed, 5).permutation(m).reshape(n_ind, 2)
            g = (h[pair[:, 0]][:, keep].astype(np.int8)
                 + h[pair[:, 1]][:, keep])
            return pos[keep], np.ascontiguousarray(g.T)
        need *= 2
    raise RuntimeError("the filter kept too few sites")


MAX_READS = 128


def _gl_table(err: float) -> np.ndarray:
    """(k, m, g): log P(k minor and m major reads | g) less its maximum
    over g; no reads at all: log(1/3) for every g."""
    p = np.array([err, 0.5, 1 - err])
    k = np.arange(MAX_READS)[:, None, None]
    m = np.arange(MAX_READS)[None, :, None]
    t = k * np.log(p) + m * np.log(1 - p)
    t -= t.max(axis=2, keepdims=True)
    t[0, 0] = np.log(1.0 / 3.0)
    return t


def gl_slab(seed: int, j: int, geno: np.ndarray, gen: dict):
    """Log GLs (n_sites, n_ind, 3) of slab j's genotypes: log P(reads |
    g) less its maximum over g (at most a few tens of reads of log(0.01)
    each, so nothing underflows), log(1/3) for an individual without
    reads."""
    rng = _stream(seed, 1, j)
    err = gen["err"]
    depth = rng.poisson(gen["mean_depth"], size=geno.shape)
    k = rng.binomial(depth, np.array([err, 0.5, 1 - err])[geno])
    if depth.max() >= MAX_READS:
        raise ValueError("a depth past the table of read counts")
    return _gl_table(err)[k, depth - k]


def _beagle_lines(lg: np.ndarray, names, contig, pos, s0: int) -> bytes:
    """Rows of Beagle text: marker, allele1, allele2, then each
    individual's three probabilities (summing to 1) as %.6f."""
    p = np.exp(lg)
    p /= p.sum(axis=2, keepdims=True)
    n, m = p.shape[0], p.shape[1] * 3
    iv = np.rint(p.reshape(n, m) * 1e6).astype(np.int64)
    cells = np.empty((n, m, 9), np.uint8)
    cells[:, :, 0] = ord("0") + iv // 1000000
    cells[:, :, 1] = ord(".")
    rest = iv % 1000000
    for d in range(6):
        cells[:, :, 7 - d] = ord("0") + rest % 10
        rest //= 10
    cells[:, :, 8] = ord("\t")
    cells[:, -1, 8] = ord("\n")
    body = cells.reshape(n, m * 9)
    out = []
    for r in range(n):
        s = s0 + r
        out.append(b"%s_%d\t0\t1\t" % (names[contig[s]], pos[s]))
        out.append(body[r].tobytes())
    return b"".join(out)


class CellInputs:
    """The files of one cell's job (self.job) and of its warm-up job over
    the first warm_sites sites of the same data (self.warm): each a dict
    with geno, pos, format, n_ind, n_sites."""

    def __init__(self, seed: int, n_sites: int, n_ind: int, gen: dict,
                 fmt: str, warm_sites: int = 0, tmp_root: str | None = None):
        if fmt not in ("beagle", "glf"):
            raise ValueError(f"unknown input format {fmt!r}")
        self.dir = tempfile.mkdtemp(prefix="ldbench-",
                                    dir=tmp_root or tempfile.gettempdir())
        self._fds = []
        try:
            self._make(seed, n_sites, n_ind, gen, fmt, warm_sites)
        except BaseException:
            self.close()
            raise

    def _make(self, seed, n_sites, n_ind, gen, fmt, warm_sites) -> None:
        self.seed, self.gen, self.n_ind = seed, gen, n_ind
        self.pos, self.geno = sample(seed, n_sites, n_ind, gen)
        self.contig = np.ones(n_sites, np.int64)
        self._names = {c: b"chrSIM_%d" % c for c in np.unique(self.contig)}
        self.labels = [self._names[c] + b":%d" % p
                       for c, p in zip(self.contig.tolist(),
                                       self.pos.tolist())]
        sizes = {"cell": n_sites}
        if warm_sites:
            sizes["warm"] = min(warm_sites, n_sites)
        jobs = {t: dict(format=fmt, n_ind=n_ind, n_sites=n,
                        pos=self._write_pos(n, t)) for t, n in sizes.items()}
        fhs, paths = {}, {}
        try:
            for t in sizes:
                if fmt == "beagle":
                    paths[t] = os.path.join(self.dir, f"{t}.beagle.gz")
                    fhs[t] = gzip.open(paths[t], "wb", compresslevel=1)
                    fhs[t].write(b"\t".join(
                        [b"marker", b"allele1", b"allele2"]
                        + [b"Ind%d" % i for i in range(n_ind)
                           for _ in range(3)]) + b"\n")
                else:
                    fd = os.memfd_create(f"ldbench-{t}.glf")
                    self._fds.append(fd)
                    paths[t] = f"/proc/self/fd/{fd}"
                    fhs[t] = os.fdopen(os.dup(fd), "wb")
            for s0, lg in self._slabs(n_sites):
                if fmt == "beagle":
                    data = _beagle_lines(lg, self._names, self.contig,
                                         self.pos, s0)
                else:
                    data = np.ascontiguousarray(lg, np.float64)
                for t, n in sizes.items():
                    if s0 >= n:
                        continue
                    if fmt == "glf":
                        fhs[t].write(data[:n - s0].tobytes())
                    elif s0 + len(lg) <= n:
                        fhs[t].write(data)
                    else:
                        fhs[t].write(_beagle_lines(lg[:n - s0], self._names,
                                                   self.contig, self.pos, s0))
        finally:
            for fh in fhs.values():
                fh.close()
        for t in sizes:
            jobs[t]["geno"] = paths[t]
        self.job, self.warm = jobs["cell"], jobs.get("warm")

    def _write_pos(self, n_sites: int, tag: str) -> str:
        path = os.path.join(self.dir, f"{tag}.pos")
        with open(path, "wb") as fh:
            fh.write(b"".join(
                b"%s\t%d\n" % (self._names[c], p) for c, p in
                zip(self.contig[:n_sites].tolist(),
                    self.pos[:n_sites].tolist())))
        return path

    def _slabs(self, n_sites: int):
        """(first site, log GLs) of each slab, in order; slabs are drawn
        from streams of their own, THREADS at a time."""
        slab = max(1, min(SLAB_SITES, SLAB_CELLS // self.n_ind))
        starts = list(range(0, n_sites, slab))
        with ThreadPoolExecutor(THREADS) as pool:
            futs = {}
            for j, s0 in enumerate(starts):
                futs[j] = pool.submit(gl_slab, self.seed, j,
                                      self.geno[s0:s0 + slab], self.gen)
                if j >= THREADS:
                    yield starts[j - THREADS], futs.pop(j - THREADS).result()
            for jj in sorted(futs):
                yield starts[jj], futs[jj].result()

    def close(self) -> None:
        for fd in self._fds:
            os.close(fd)
        self._fds = []
        shutil.rmtree(self.dir, ignore_errors=True)
