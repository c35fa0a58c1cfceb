"""The GL rows of chosen sites, read from the job's own input file and
normalised as ngsLD's read_geno does: per individual, the three log
likelihoods minus their log-sum (post_prob). Beagle text holds
probabilities (logged here, log(0) = -inf); the binary file holds
log-scale float64 triplets, site-major, then individual."""

from __future__ import annotations

import gzip

import numpy as np


def _normalise(lg: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        m = lg.max(axis=-1, keepdims=True)
        m = np.where(np.isneginf(m), 0.0, m)
        return lg - (np.log(np.exp(lg - m).sum(axis=-1, keepdims=True)) + m)


def beagle_rows(path: str, n_ind: int, sites: np.ndarray) -> np.ndarray:
    """(len(sites), n_ind, 3) log-normalised GLs; the first line is the
    header, the last 3 * n_ind numeric fields of a line are its probs."""
    with gzip.open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    rows = lines[1:]
    out = np.empty((len(sites), n_ind, 3), np.float64)
    for j, s in enumerate(sites):
        vals = np.fromstring(rows[int(s)].split(b"\t", 1)[1], sep="\t")
        out[j] = vals[-3 * n_ind:].reshape(n_ind, 3)
    with np.errstate(divide="ignore"):
        return _normalise(np.log(out))


def glf_rows(path: str, n_ind: int, n_sites: int,
             sites: np.ndarray) -> np.ndarray:
    mm = np.memmap(path, np.float64, mode="r", shape=(n_sites, n_ind, 3))
    try:
        out = np.asarray(mm[np.asarray(sites, np.int64)])
    finally:
        del mm
    return _normalise(out)


def read_rows(job, sites: np.ndarray) -> np.ndarray:
    if job["format"] == "beagle":
        return beagle_rows(job["geno"], job["n_ind"], sites)
    return glf_rows(job["geno"], job["n_ind"], job["n_sites"], sites)
