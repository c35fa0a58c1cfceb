"""Synthetic genotype-likelihood fixture generator.

The reference's test fixtures are produced by external tools (ngsSim + ANGSD,
ngsLD examples/test.sh:14-29) and are not bundled. This module
generates equivalent fixtures deterministically: per-site allele frequencies,
HWE genotypes, a Poisson read-depth / binomial read-error GL model, missing
individuals (depth 0), monomorphic sites, and multi-contig positions.

Writers produce the three input formats the reference accepts
(read_data.cpp:13-116, ngsLD.cpp:45-57):
  * text genotypes ({-1,0,1,2}, leading label columns, gzip)
  * Beagle-style text probs (3 cols/ind, header row, gzip)
  * binary log-GLs (raw float64 triplets)
plus the position TSV (chr, pos).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SimData:
    n_ind: int
    n_sites: int
    genos: np.ndarray       # (n_sites, n_ind) int in {-1,0,1,2}; -1 = missing
    gl: np.ndarray          # (n_sites, n_ind, 3) float64 normal-space likelihoods (unnormalized)
    chrom: list = field(default_factory=list)   # (n_sites,) str
    pos: np.ndarray = None  # (n_sites,) int


def simulate(n_ind: int, n_sites: int, seed: int = 1, *, mean_depth: float = 4.0,
             err: float = 0.01, miss_to_uniform: bool = True,
             mono_rate: float = 0.03, contig_kb: float = 10.0,
             all_missing_site_rate: float = 0.0) -> SimData:
    rng = np.random.default_rng(seed)
    freq = rng.uniform(0.03, 0.5, size=n_sites)
    mono = rng.random(n_sites) < mono_rate
    freq[mono] = 0.0

    # HWE genotype draws
    g_probs = np.stack([(1 - freq) ** 2, 2 * freq * (1 - freq), freq ** 2], axis=1)
    u = rng.random((n_sites, n_ind, 1))
    cdf = np.cumsum(g_probs, axis=1)[:, None, :]
    genos = (u > cdf).sum(axis=2)  # (n_sites, n_ind) in {0,1,2}

    depth = rng.poisson(mean_depth, size=(n_sites, n_ind))
    if all_missing_site_rate > 0:
        wipe = rng.random(n_sites) < all_missing_site_rate
        depth[wipe, :] = 0

    # reads of the minor allele: Binomial(depth, p_minor(geno))
    p_minor = genos / 2.0 * (1 - err) + (1 - genos / 2.0) * err
    k = rng.binomial(depth, p_minor)

    # GL(g) = P(reads | g) = C(d,k) p_g^k (1-p_g)^(d-k), constants cancel on
    # normalization so we drop the binomial coefficient.
    p_g = np.array([err, 0.5, 1 - err])
    with np.errstate(divide="ignore", invalid="ignore"):
        loggl = (k[:, :, None] * np.log(p_g)[None, None, :]
                 + (depth - k)[:, :, None] * np.log(1 - p_g)[None, None, :])
    gl = np.exp(loggl - loggl.max(axis=2, keepdims=True))
    missing = depth == 0
    gl[missing] = 1.0 / 3.0

    genos_out = genos.copy()
    genos_out[missing] = -1

    # positions: random steps 1..999, new contig roughly every contig_kb
    steps = rng.integers(1, 1000, size=n_sites)
    pos = np.empty(n_sites, dtype=np.int64)
    chrom = []
    cur = 0
    contig = 1
    limit = contig_kb * 1000
    for s in range(n_sites):
        cur += int(steps[s])
        if cur > limit:
            contig += 1
            cur = int(steps[s])
        pos[s] = cur
        chrom.append(f"chrSIM_{contig}")

    return SimData(n_ind=n_ind, n_sites=n_sites, genos=genos_out, gl=gl,
                   chrom=chrom, pos=pos)


def write_pos(sim: SimData, path: str, header: bool = False) -> None:
    with open(path, "w") as fh:
        if header:
            fh.write("chr\tpos\n")
        for c, p in zip(sim.chrom, sim.pos):
            fh.write(f"{c}\t{p}\n")


def write_geno_text(sim: SimData, path: str) -> None:
    """Called-genotype text format: label cols + one {-1,0,1,2} col per ind
    (the reference keeps only the last n_ind numeric columns,
    read_data.cpp:64-95; non-numeric tokens are dropped by split)."""
    with gzip.open(path, "wt") as fh:
        for s in range(sim.n_sites):
            genos = "\t".join(str(int(g)) for g in sim.genos[s])
            fh.write(f"{sim.chrom[s]}\t{sim.pos[s]}\t{genos}\n")


def write_beagle(sim: SimData, path: str, header: bool = True, decimals: int = 6,
                 normalize: bool = True) -> None:
    """Beagle-style text probs: marker/allele cols + 3 probability cols per
    individual. The reference drops the non-numeric marker token and keeps the
    last 3*n_ind numeric columns (read_data.cpp:64-86)."""
    gl = sim.gl
    if normalize:
        gl = gl / gl.sum(axis=2, keepdims=True)
    with gzip.open(path, "wt") as fh:
        if header:
            cols = ["marker", "allele1", "allele2"]
            for i in range(sim.n_ind):
                cols += [f"Ind{i}"] * 3
            fh.write("\t".join(cols) + "\n")
        for s in range(sim.n_sites):
            fields = [f"{sim.chrom[s]}_{sim.pos[s]}", "0", "1"]
            for i in range(sim.n_ind):
                fields += [f"%.{decimals}f" % v for v in gl[s, i]]
            fh.write("\t".join(fields) + "\n")


def write_glf_bin(sim: SimData, path: str, log_scale: bool = True) -> None:
    """Binary float64 GL triplets, site-major then individual
    (read_data.cpp:28-47). With log_scale=True values are log-GLs (the
    --log_scale path used in test.sh:24)."""
    gl = sim.gl
    if log_scale:
        with np.errstate(divide="ignore"):
            out = np.log(gl)
        out[np.isneginf(out)] = -1e15
    else:
        out = gl
    out.astype(np.float64).tofile(path)


def write_all(sim: SimData, outdir: str, prefix: str = "sim") -> dict:
    os.makedirs(outdir, exist_ok=True)
    paths = {
        "pos": os.path.join(outdir, f"{prefix}.pos"),
        "geno_text": os.path.join(outdir, f"{prefix}.geno.gz"),
        "beagle": os.path.join(outdir, f"{prefix}.beagle.gz"),
        "glf": os.path.join(outdir, f"{prefix}.glf"),
    }
    write_pos(sim, paths["pos"])
    write_geno_text(sim, paths["geno_text"])
    write_beagle(sim, paths["beagle"])
    write_glf_bin(sim, paths["glf"])
    return paths
