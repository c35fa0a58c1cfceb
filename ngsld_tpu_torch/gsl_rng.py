"""Tausworthe ("taus", L'Ecuyer 1996) RNG compatible with GSL's gsl_rng_taus.

The reference uses GSL's taus generator for reproducible pair sampling
(ngsLD ngsLD.cpp:68-70,164-166,277 and gen_func.cpp:117-119):
a master stream seeded with --seed hands one child seed per anchor site, and
each anchor's child stream draws one uniform per candidate pair. Replicating
`--rnd_sample --seed` runs bit-for-bit therefore requires this exact
generator. Implemented from the published recurrence/seeding procedure.

Two implementations:
  * TausRNG        — scalar, for the strict oracle engine.
  * taus_uniforms  — NumPy-vectorized over many independent streams, used to
                     generate each anchor's draws in one shot (the band sweep
                     needs up to `band` draws per anchor).
"""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF


def _taus_step_scalar(s1: int, s2: int, s3: int) -> tuple[int, int, int]:
    s1 = ((((s1 & 4294967294) << 12) & _MASK) ^ ((((s1 << 13) & _MASK) ^ s1) >> 19)) & _MASK
    s2 = ((((s2 & 4294967288) << 4) & _MASK) ^ ((((s2 << 2) & _MASK) ^ s2) >> 25)) & _MASK
    s3 = ((((s3 & 4294967280) << 17) & _MASK) ^ ((((s3 << 3) & _MASK) ^ s3) >> 11)) & _MASK
    return s1, s2, s3


class TausRNG:
    """Scalar taus stream; get()/uniform() match gsl_rng_taus bit-for-bit."""

    def __init__(self, seed: int):
        # Seeding procedure: zero-test on the full (64-bit) seed, then an
        # LCG cascade mod 2^32 with per-word minima, then 6 warm-up draws.
        s = seed & 0xFFFFFFFFFFFFFFFF
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
        self.s1, self.s2, self.s3 = s1, s2, s3
        for _ in range(6):
            self.get()

    def get(self) -> int:
        self.s1, self.s2, self.s3 = _taus_step_scalar(self.s1, self.s2, self.s3)
        return (self.s1 ^ self.s2 ^ self.s3) & _MASK

    def uniform(self) -> float:
        """Uniform in [0,1) with 32-bit resolution (taus get_double)."""
        return self.get() / 4294967296.0

    def draw_rnd(self, lo: float, hi: float) -> float:
        """Mirror of draw_rnd (gen_func.cpp:117-119): lo + u*(hi-lo)."""
        return lo + self.uniform() * (hi - lo)


def taus_seed_states(seeds: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized seeding of many independent taus streams (uint64 seeds)."""
    s = seeds.astype(np.uint64).copy()
    s[s == 0] = 1
    s1 = ((np.uint64(69069) * s) & np.uint64(_MASK)).astype(np.uint32)
    s1[s1 < 2] += np.uint32(2)
    s2 = ((np.uint64(69069) * s1.astype(np.uint64)) & np.uint64(_MASK)).astype(np.uint32)
    s2[s2 < 8] += np.uint32(8)
    s3 = ((np.uint64(69069) * s2.astype(np.uint64)) & np.uint64(_MASK)).astype(np.uint32)
    s3[s3 < 16] += np.uint32(16)
    for _ in range(6):
        s1, s2, s3 = _taus_step_vec(s1, s2, s3)
    return s1, s2, s3


def _taus_step_vec(s1: np.ndarray, s2: np.ndarray, s3: np.ndarray):
    u = np.uint32
    s1 = (((s1 & u(4294967294)) << u(12)) ^ (((s1 << u(13)) ^ s1) >> u(19)))
    s2 = (((s2 & u(4294967288)) << u(4)) ^ (((s2 << u(2)) ^ s2) >> u(25)))
    s3 = (((s3 & u(4294967280)) << u(17)) ^ (((s3 << u(3)) ^ s3) >> u(11)))
    return s1, s2, s3


def taus_uniforms(seeds: np.ndarray, n_draws: int) -> np.ndarray:
    """(len(seeds), n_draws) uniforms: draw j of stream i == TausRNG(seeds[i])
    uniform #j. Vectorized across streams; lockstep across draws."""
    s1, s2, s3 = taus_seed_states(seeds)
    out = np.empty((len(seeds), n_draws), dtype=np.float64)
    for j in range(n_draws):
        s1, s2, s3 = _taus_step_vec(s1, s2, s3)
        out[:, j] = (s1 ^ s2 ^ s3).astype(np.float64) / 4294967296.0
    return out


def iter_uniform_chunks(seeds: np.ndarray, n_draws: np.ndarray,
                        max_elems: int = 1 << 26):
    """Yield (a0, a1, u) stream chunks where u is the
    (a1-a0, max(n_draws[a0:a1])) uniforms matrix for streams [a0, a1).

    Bounds the transient allocation to ~max_elems doubles when per-stream
    draw counts are ragged: a single wide stream cannot blow the matrix up
    for the whole batch (the memory discipline of the banded pair plan and
    the ring sampling plan, which both consume per-anchor draw prefixes).
    Chunks with max draws == 0 are skipped."""
    max_m = int(n_draws.max()) if len(n_draws) else 0
    step = max(1, max_elems // max(max_m, 1))
    for a0 in range(0, len(seeds), step):
        a1 = min(a0 + step, len(seeds))
        sub_max = int(n_draws[a0:a1].max())
        if sub_max == 0:
            continue
        yield a0, a1, taus_uniforms(seeds[a0:a1], sub_max)
