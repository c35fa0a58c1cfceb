"""GSL's taus generator (L'Ecuyer 1996, gsl_rng_taus), scalar and
vectorised over independent streams: a frozen copy of the arithmetic that
ngsLD's --rnd_sample uses (a master stream seeded with --seed hands one
child seed per anchor site; each child draws one uniform per candidate)."""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF


def _seed_words(s: int):
    s &= 0xFFFFFFFFFFFFFFFF
    if s == 0:
        s = 1
    s1 = (69069 * s) & _MASK
    if s1 < 2:
        s1 += 2
    s2 = (69069 * s1) & _MASK
    if s2 < 8:
        s2 += 8
    s3 = (69069 * s2) & _MASK
    if s3 < 16:
        s3 += 16
    return s1, s2, s3


def _step(s1: int, s2: int, s3: int):
    s1 = ((((s1 & 4294967294) << 12) & _MASK)
          ^ ((((s1 << 13) & _MASK) ^ s1) >> 19))
    s2 = ((((s2 & 4294967288) << 4) & _MASK)
          ^ ((((s2 << 2) & _MASK) ^ s2) >> 25))
    s3 = ((((s3 & 4294967280) << 17) & _MASK)
          ^ ((((s3 << 3) & _MASK) ^ s3) >> 11))
    return s1, s2, s3


def master_child_seeds(seed: int, n: int) -> np.ndarray:
    """The n child seeds the master stream hands out in site order:
    (uint64)(uniform() * 1e15), uniform = get() / 2**32."""
    s1, s2, s3 = _seed_words(seed)
    for _ in range(6):
        s1, s2, s3 = _step(s1, s2, s3)
    out = np.empty(n, np.uint64)
    for i in range(n):
        s1, s2, s3 = _step(s1, s2, s3)
        out[i] = int(((s1 ^ s2 ^ s3) / 4294967296.0) * 1e15)
    return out


def _step_vec(s1, s2, s3):
    u = np.uint32
    s1 = ((s1 & u(4294967294)) << u(12)) ^ (((s1 << u(13)) ^ s1) >> u(19))
    s2 = ((s2 & u(4294967288)) << u(4)) ^ (((s2 << u(2)) ^ s2) >> u(25))
    s3 = ((s3 & u(4294967280)) << u(17)) ^ (((s3 << u(3)) ^ s3) >> u(11))
    return s1, s2, s3


def uniforms(seeds: np.ndarray, n_draws: int) -> np.ndarray:
    """(len(seeds), n_draws): draw j of the stream seeded with seeds[i]."""
    s = seeds.astype(np.uint64).copy()
    s[s == 0] = 1
    m = np.uint64(_MASK)
    s1 = ((np.uint64(69069) * s) & m).astype(np.uint32)
    s1[s1 < 2] += np.uint32(2)
    s2 = ((np.uint64(69069) * s1.astype(np.uint64)) & m).astype(np.uint32)
    s2[s2 < 8] += np.uint32(8)
    s3 = ((np.uint64(69069) * s2.astype(np.uint64)) & m).astype(np.uint32)
    s3[s3 < 16] += np.uint32(16)
    for _ in range(6):
        s1, s2, s3 = _step_vec(s1, s2, s3)
    out = np.empty((len(seeds), n_draws), np.float64)
    for j in range(n_draws):
        s1, s2, s3 = _step_vec(s1, s2, s3)
        out[:, j] = (s1 ^ s2 ^ s3).astype(np.float64) / 4294967296.0
    return out
