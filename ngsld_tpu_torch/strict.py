"""Strict engine: a bit-exact CPython/NumPy re-implementation of ngsLD.

This engine reproduces the reference binary's output byte-for-byte (after the
thread-order sort the reference's own tests apply, examples/test.sh:16) and
serves two roles:

  1. The conformance oracle the fast TPU engine is validated against.
  2. A usable `--engine strict` CLI engine for users who need exact
     reference-concordant numbers.

Bit-exactness notes (why the code looks the way it does):
  * All transcendentals go through libm via ``math.exp``/``math.log`` —
    NumPy's SIMD exp/log differ from libm by ~1 ulp, which is enough to flip
    a printed 6th decimal on knife-edge values.
  * All floating-point accumulations reproduce the reference's operation
    ORDER (left-to-right, per-individual sequential folds), because fp
    addition is not associative. Vectorization happens only across
    independent lanes (sites, pairs), never across a sequential reduction.
  * Arithmetic uses NumPy float64 scalars/arrays (not Python floats) so that
    0/0 produces IEEE NaN with x86 sign semantics instead of raising.

Reference semantics citations are given per function (file:line into
the ngsLD sources).
"""

from __future__ import annotations

import gzip
import math
import os
import re
import struct
import sys
import time
from dataclasses import dataclass

import numpy as np

from .constants import EPSILON, INF, ITER_MAX, N_GENO
from .gsl_rng import TausRNG

_NEG_INF_SENTINEL = -INF  # reference stores "log 0" as -1e15 (gen_func.hpp:15)

_LIBM_EXP = np.frompyfunc(math.exp, 1, 1)


def libm_exp(a: np.ndarray) -> np.ndarray:
    """Element-wise libm exp (bit-identical to C exp())."""
    return _LIBM_EXP(a).astype(np.float64)


def _libm_log1(x: float) -> float:
    if x > 0.0:
        return math.log(x)
    if x == 0.0:
        return -math.inf
    return math.nan  # C log(negative) -> NaN (domain error)


_LIBM_LOG = np.frompyfunc(_libm_log1, 1, 1)


def libm_log(a: np.ndarray) -> np.ndarray:
    return _LIBM_LOG(a).astype(np.float64)


class StrictError(RuntimeError):
    """Mirror of the reference's fail-fast error() (gen_func.cpp:12-18)."""

    def __init__(self, func: str, msg: str):
        super().__init__(f"ERROR: [{func}] {msg}")


# ---------------------------------------------------------------------------
# Parsing utilities (mirror shared/gen_func.cpp string handling)
# ---------------------------------------------------------------------------

def chomp(line: str) -> str:
    """Remove ONE trailing newline/CR, like chomp (gen_func.cpp:184-192)."""
    if line and line[-1] in ("\n", "\r"):
        return line[:-1]
    return line


_C_WS = " \t\r\n\v\f"
_C_FLOAT_RE = re.compile(
    r"[ \t\r\n\v\f]*"  # strtod skips LEADING whitespace (isspace)
    r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|0[xX](?:[0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?|\.[0-9a-fA-F]+)"
    r"(?:[pP][+-]?\d+)?"
    r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?"
    r"|[nN][aA][nN](?:\([0-9a-zA-Z_]*\))?)")


def _strtod_full(tok: str) -> float | None:
    """C strtod that must consume the whole token (split drops partial
    parses, gen_func.cpp:390-411: `if(*end_ptr) i--`).

    Python's float() diverges from C strtod both ways: it strips TRAILING
    whitespace (a CRLF file's '\\r' would pass where C leaves it in
    *end_ptr and the reference DROPS the token) and accepts '1_0' digit
    separators; C additionally skips leading whitespace and consumes
    'nan(payload)' and digitless hex fractions like '0x.8p1' (all
    verified against glibc). Validate C syntax, then parse."""
    if not _C_FLOAT_RE.fullmatch(tok):
        return None
    t = tok.lstrip(_C_WS)
    body = t.lstrip("+-").lower()
    if body.startswith("nan"):
        return math.copysign(math.nan, -1.0 if t[:1] == "-" else 1.0)
    if body.startswith("0x"):
        try:
            return float.fromhex(t)
        except ValueError:
            return None
    try:
        return float(t)
    except ValueError:
        return None


def split_doubles(line: str) -> list:
    """split(str, " \\t", double**): tokenize on space/tab runs, keep only
    fully-numeric tokens (gen_func.cpp:390-416)."""
    out = []
    for tok in line.replace("\t", " ").split(" "):
        if not tok:
            continue
        v = _strtod_full(tok)
        if v is not None:
            out.append(v)
    return out


def open_maybe_gz(path: str, mode: str = "rt"):
    """open_gzfile reads transparently whether gzipped or not
    (gen_func.cpp:208-227; zlib gz* reads plain files too)."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode.replace("b", "") if "t" in mode else mode)


# ---------------------------------------------------------------------------
# Population-genetics primitives (mirror shared/gen_func.cpp:862-1178)
# ---------------------------------------------------------------------------

def logsum3(a0: float, a1: float, a2: float) -> float:
    """Stable log(e^a0+e^a1+e^a2) with the reference's exact op order
    (gen_func.cpp:135-151)."""
    m = a0
    if a1 >= m:
        m = a1
    if a2 >= m:
        m = a2
    if m == -math.inf:
        return -math.inf
    s = math.exp(a0 - m)
    s += math.exp(a1 - m)
    s += math.exp(a2 - m)
    return math.log(s) + m


def post_prob3(g: list) -> list:
    """log-normalize a 3-vector: pp = gl - logsum(gl) (gen_func.cpp:920-932,
    NULL prior path)."""
    norm = logsum3(g[0], g[1], g[2])
    return [g[0] - norm, g[1] - norm, g[2] - norm]


def miss_data_rows(gn: np.ndarray) -> np.ndarray:
    """miss_data (gen_func.cpp:862-868): all three genotype values equal
    within EPSILON — |g0-g1|<eps and |g1-g2|<eps. Works on (..., 3)."""
    return (np.abs(gn[..., 0] - gn[..., 1]) < EPSILON) & \
           (np.abs(gn[..., 1] - gn[..., 2]) < EPSILON)


def call_geno_inplace(geno_log: np.ndarray, N_thresh: float, call_thresh: float) -> None:
    """call_geno on log-scale normalized GLs (gen_func.cpp:886-914), applied
    per ind/site as in main (ngsLD.cpp:92-98), miss_data mode 0.

    max_pos/min_pos take the FIRST extreme with strict comparison
    (gen_func.cpp:73-98)."""
    n_sites, n_ind, _ = geno_log.shape
    log_third = math.log(1.0 / N_GENO)
    for s in range(n_sites):
        for i in range(n_ind):
            g = geno_log[s, i]
            g0, g1, g2 = float(g[0]), float(g[1]), float(g[2])
            # array_max_pos: first strict max; array_min_pos: first strict min
            max_pos = 0
            mx = -math.inf
            for c, v in enumerate((g0, g1, g2)):
                if v > mx:
                    max_pos, mx = c, v
            min_pos = 0
            mn = math.inf
            for c, v in enumerate((g0, g1, g2)):
                if v < mn:
                    min_pos, mn = c, v
            max_pp = math.exp(mx)
            if (g0, g1, g2)[min_pos] == (g0, g1, g2)[max_pos]:
                max_pp = -1.0  # missing sentinel (mode 0)
            if max_pp < N_thresh:
                g[:] = log_third
            if max_pp >= call_thresh:
                g[:] = _NEG_INF_SENTINEL
                g[max_pos] = 0.0  # log(1)


def est_maf_all(geno_log: np.ndarray, ignore_miss_data: bool) -> np.ndarray:
    """est_maf with NULL prior for every site (gen_func.cpp:974-1009, called
    from ngsLD.cpp:103-104).

    The reference's num/den accumulators are NOT reset between EM iterations.
    With a NULL prior the per-individual posteriors are frequency-independent,
    so the loop runs exactly one pass if |0.01 - A/B| <= EPSILON (or A/B is
    NaN), otherwise exactly two passes, returning (A+A')/(B+B') accumulated in
    the reference's sequential order. Both passes are reproduced here.

    Missing individuals are skipped only when --ignore_miss_data; missingness
    is tested on the LOG-scale GLs at this stage (all-equal within EPSILON).
    """
    n_sites, n_ind, _ = geno_log.shape
    # pp = exp(post_prob(gl)) per ind/site, conv_space via libm exp
    # (gen_func.cpp:988-996). geno_log rows are already normalized by
    # read_geno EXCEPT empty-line sites; post_prob is applied again here
    # regardless (post_prob of a normalized row changes bits: norm ~ -0.0/eps).
    pp = np.empty_like(geno_log)
    for s in range(n_sites):
        for i in range(n_ind):
            row = post_prob3([float(geno_log[s, i, 0]),
                              float(geno_log[s, i, 1]),
                              float(geno_log[s, i, 2])])
            pp[s, i, 0] = math.exp(row[0])
            pp[s, i, 1] = math.exp(row[1])
            pp[s, i, 2] = math.exp(row[2])

    miss = miss_data_rows(geno_log)  # (n_sites, n_ind), log-scale test
    include = ~(miss & ignore_miss_data)

    num = np.zeros(n_sites)
    den = np.zeros(n_sites)
    with np.errstate(all="ignore"):
        # pass 1 (sequential over individuals; vectorized over sites)
        for i in range(n_ind):
            inc_n = pp[:, i, 1] + pp[:, i, 2] * 2.0        # pp1 + pp2*(2-F), F=0
            inc_d = 2.0 * pp[:, i, 1] + (pp[:, i, 0] + pp[:, i, 2]) * 2.0
            num = np.where(include[:, i], num + inc_n, num)
            den = np.where(include[:, i], den + inc_d, den)
        freq1 = num / den
        # while(|prev-freq| > EPSILON && ...): prev=0.01 on pass 1
        done = ~(np.abs(0.01 - freq1) > EPSILON)           # NaN -> done
        # pass 2 (accumulators keep growing)
        for i in range(n_ind):
            inc_n = pp[:, i, 1] + pp[:, i, 2] * 2.0
            inc_d = 2.0 * pp[:, i, 1] + (pp[:, i, 0] + pp[:, i, 2]) * 2.0
            num = np.where(include[:, i], num + inc_n, num)
            den = np.where(include[:, i], den + inc_d, den)
        freq2 = num / den
    return np.where(done, freq1, freq2)


# genotype-sum index maps _G1(k,h)=(k>>1)+(h>>1), _G2(k,h)=(k&1)+(h&1)
# (gen_func.cpp:1073-1074); order of (k,h) pairs follows the reference loops.
_G1 = [[(k >> 1) + (h >> 1) for h in range(4)] for k in range(4)]
_G2 = [[(k & 1) + (h & 1) for h in range(4)] for k in range(4)]


def pair_em_batch(gn1: np.ndarray, gn2: np.ndarray, maf1: np.ndarray,
                  maf2: np.ndarray, ignore_miss_data: bool):
    """Batched bit-exact haplo_freq + pair_freq_iter (gen_func.cpp:1027-1119)
    over P pairs.

    gn1, gn2: (P, n_ind, 3) float64 NORMAL-space GLs (haplo_freq is called
    with log_scale=false from ngsLD.cpp:294).
    Returns (hap_freq (P,4), n_iter (P,), n_used (P,)).
    """
    P, n_ind, _ = gn1.shape
    f = np.empty((P, 4))
    # init from MAFs (gen_func.cpp:1034-1037)
    f[:, 0] = (1 - maf1) * (1 - maf2)
    f[:, 1] = (1 - maf1) * maf2
    f[:, 2] = maf1 * (1 - maf2)
    f[:, 3] = maf1 * maf2

    if ignore_miss_data:
        include = ~(miss_data_rows(gn1) | miss_data_rows(gn2))  # (P, n_ind)
    else:
        include = np.ones((P, n_ind), dtype=bool)
    n_used = include.sum(axis=1).astype(np.int64)

    n_iter = np.full(P, ITER_MAX, dtype=np.int64)

    # Active-set compaction: every pair's EM is independent and converged
    # pairs never change again, so retired rows are gathered OUT of the
    # working arrays. Bit-exactness is unaffected (all ops below are
    # elementwise per row); the win is that the per-individual fold (4 *
    # n_ind numpy calls per iteration) runs only on still-active pairs —
    # typically a small tail after ~20 iterations.
    work = np.arange(P)
    g1w, g2w, xw = gn1, gn2, n_used
    exclw = ~include
    activew = np.ones(P, dtype=bool)  # active rows within the working set
    # Preallocated scratch: the inner loop below otherwise allocates ~30
    # (P, n_ind) temporaries per EM iteration, and mmap/munmap churn on
    # multi-hundred-MB arrays dominates wall time at large cohorts. All
    # in-place rewrites below preserve bit-exactness: values and operation
    # ORDER are unchanged (IEEE multiply is commutative bitwise).
    SUM = np.empty((P, n_ind))
    TK = np.empty((P, n_ind))
    U = np.empty((P, n_ind))
    V = np.empty((P, n_ind))

    with np.errstate(all="ignore"):
        for it in range(ITER_MAX):
            fw = f[work]
            fk = [fw[:, k] for k in range(4)]
            Pw = len(work)
            s_, tk, u, v = SUM[:Pw], TK[:Pw], U[:Pw], V[:Pw]
            # Per-individual denominator: 16 sequential fused terms in C's
            # exact order ((f[k]*f[h])*p0)*p1 (gen_func.cpp:1094-1097).
            s_[:] = 0.0
            for k in range(4):
                for h in range(4):
                    np.multiply(g1w[:, :, _G1[k][h]],
                                (fk[k] * fk[h])[:, None], out=u)
                    u *= g2w[:, :, _G2[k][h]]
                    s_ += u
            # ff_k = per k: numerator tmp_k (4 sequential terms each, the
            # two orderings (h,k)/(k,h) kept as explicit x+x like C,
            # gen_func.cpp:1099-1104), then the sequential fold over
            # individuals of tmp/sum (gen_func.cpp:1106) skipping excluded
            # individuals. cumsum's per-row accumulation is the same
            # strictly-sequential order as the reference's loop, and adding
            # +0.0 for an excluded individual is bit-exact skipping here
            # (terms and accumulator are always >= +0.0).
            ff = np.zeros((Pw, 4))
            for k in range(4):
                if not n_ind:
                    break
                tk[:] = 0.0
                for h in range(4):
                    np.multiply(g1w[:, :, _G1[h][k]],
                                g2w[:, :, _G2[h][k]], out=u)
                    np.multiply(g1w[:, :, _G1[k][h]],
                                g2w[:, :, _G2[k][h]], out=v)
                    u += v
                    u *= (fk[k] * fk[h])[:, None]
                    tk += u
                tk /= s_
                np.copyto(tk, 0.0, where=exclw)
                np.cumsum(tk, axis=1, out=tk)  # in-place prefix sum is safe
                ff[:, k] = tk[:, -1]
            # f_k = ff_k / (2x) (gen_func.cpp:1109-1110)
            two_x = (2.0 * xw).astype(np.float64)
            f_new = ff / two_x[:, None]
            # In-place sequential normalization (gen_func.cpp:1112-1113):
            # each k's denominator sees already-normalized f[0..k-1].
            for k in range(4):
                denom = ((f_new[:, 0] + f_new[:, 1]) + f_new[:, 2]) + f_new[:, 3]
                f_new[:, k] = f_new[:, k] / denom
            # frozen (converged but not yet compacted) rows keep their state
            f[work] = np.where(activew[:, None], f_new, fw)
            # eps = fold of `if (x > eps) eps = x` over k (gen_func.cpp:1048-1052):
            # NaN diffs compare false and are SKIPPED, so an all-NaN update
            # (e.g. x=0 with --ignore_miss_data) leaves eps at 0 -> converged.
            diffs = np.abs(f_new - fw)
            eps = np.zeros(Pw)
            for k in range(4):
                eps = np.where(diffs[:, k] > eps, diffs[:, k], eps)
            newly = activew & (eps < EPSILON)
            n_iter[work[newly]] = it
            activew &= ~newly
            n_act = int(activew.sum())
            if n_act == 0:
                break
            # compact only when a quarter of the set is dead weight:
            # per-iteration compaction would recopy the (P, n_ind, 3) GL
            # slices every time a single straggler retires
            if Pw - n_act >= max(256, Pw // 4):
                keep = activew
                work = work[keep]
                g1w, g2w = g1w[keep], g2w[keep]
                xw = xw[keep]
                exclw = exclw[keep]
                activew = np.ones(len(work), dtype=bool)
    return f, n_iter, n_used


def pearson_r2_batch(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """pearson_r (ngsLD.cpp:365-367): squared gsl_stats_correlation.

    gsl_stats_correlation uses the stable one-pass update with LONG DOUBLE
    accumulators; on x86 that is 80-bit extended, which np.longdouble
    matches. `ratio` is computed in double (i/(i+1.0)) then widened, and the
    final sqrt is double (C sqrt on an implicitly-converted argument).
    x, y: (P, n_ind) float64. Returns (P,) float64 r^2.
    """
    try:  # native mirror: same long double op order, ~45 us -> ~0.2 us/pair
        from .native import pearson_r2_native
        out = pearson_r2_native(x, y)
        if out is not None:
            return out
    except ImportError:
        pass
    P, n = x.shape
    ld = np.longdouble
    mean_x = x[:, 0].astype(ld)
    mean_y = y[:, 0].astype(ld)
    sum_xsq = np.zeros(P, dtype=ld)
    sum_ysq = np.zeros(P, dtype=ld)
    sum_cross = np.zeros(P, dtype=ld)
    for i in range(1, n):
        ratio = ld(np.float64(i) / np.float64(i + 1.0))
        delta_x = x[:, i].astype(ld) - mean_x
        delta_y = y[:, i].astype(ld) - mean_y
        sum_xsq = sum_xsq + delta_x * delta_x * ratio
        sum_ysq = sum_ysq + delta_y * delta_y * ratio
        sum_cross = sum_cross + delta_x * delta_y * ratio
        mean_x = mean_x + delta_x / ld(np.float64(i + 1.0))
        mean_y = mean_y + delta_y / ld(np.float64(i + 1.0))
    with np.errstate(all="ignore"):
        denom = np.sqrt(sum_xsq.astype(np.float64)) * np.sqrt(sum_ysq.astype(np.float64))
        r = (sum_cross / denom.astype(ld)).astype(np.float64)
        return r * r  # pow(r, 2)


def _c_min(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C macro min(a,b) = (a<=b ? a : b) including its NaN asymmetry
    (gen_func.hpp:22)."""
    return np.where(a <= b, a, b)


def ld_stats_batch(f: np.ndarray):
    """D, D', r2 from EM haplotype frequencies (ngsLD.cpp:296-306)."""
    with np.errstate(all="ignore"):
        maf0 = 1 - (f[:, 0] + f[:, 1])
        maf1 = 1 - (f[:, 0] + f[:, 2])
        D = f[:, 0] * f[:, 3] - f[:, 1] * f[:, 2]
        neg = -_c_min(maf0 * maf1, (1 - maf0) * (1 - maf1))
        pos = _c_min(maf0 * (1 - maf1), (1 - maf0) * maf1)
        Dp = D / np.where(D < 0, neg, pos)
        rr = D / np.sqrt(maf0 * maf1 * (1 - maf0) * (1 - maf1))
        r2 = rr * rr  # pow(x, 2)
    return maf0, maf1, D, Dp, r2


def chi2_batch(f: np.ndarray) -> np.ndarray:
    """Extended-output chi^2 (ngsLD.cpp:328-333). The reference computes it
    in FLOAT (32-bit) accumulators with double intermediate terms; replicate
    the exact mixed-precision sequence."""
    f32 = np.float32
    with np.errstate(all="ignore"):
        freq_A = (f[:, 0] + f[:, 1]).astype(f32)      # double sum -> float
        freq_B = (f[:, 0] + f[:, 2]).astype(f32)
        one = f32(1.0)
        exp_hap = [freq_A * freq_B, freq_A * (one - freq_B),
                   (one - freq_A) * freq_B, (one - freq_A) * (one - freq_B)]
        chi2 = np.zeros(len(f), dtype=f32)
        for i in range(4):
            e64 = exp_hap[i].astype(np.float64)
            diff = f[:, i] - e64
            term = (diff * diff) / e64                 # double
            chi2 = (chi2.astype(np.float64) + term).astype(f32)  # float += double
    return chi2


# ---------------------------------------------------------------------------
# Input readers (mirror shared/read_data.cpp)
# ---------------------------------------------------------------------------

def read_geno(path: str, in_bin: bool, in_probs: bool, in_logscale: bool,
              n_ind: int, n_sites: int) -> np.ndarray:
    """read_geno (read_data.cpp:13-116): returns (n_sites, n_ind, 3) float64
    log-scale normalized GLs (the reference transposes after load,
    ngsLD.cpp:88; we build site-major directly).

    Dispatches to the native C++ reader when available (same libm, same
    tokenizer rules — bit-identical, ~100x faster); NGSLD_NO_NATIVE=1
    forces this pure-Python path."""
    if os.environ.get("NGSLD_NO_NATIVE") != "1":
        from .native import read_geno_native
        native = read_geno_native(path, in_bin, in_probs, in_logscale,
                                  n_ind, n_sites)
        if native is not None:
            return native

    geno = np.full((n_sites, n_ind, 3), _NEG_INF_SENTINEL, dtype=np.float64)
    n_geno = N_GENO if in_probs else 1

    if in_bin:
        data = np.fromfile(path, dtype=np.float64)
        if data.size < n_sites * n_ind * N_GENO:
            raise StrictError("read_geno", "GENO file at premature EOF. "
                              "Check GENO file and number of sites!")
        if data.size > n_sites * n_ind * N_GENO:
            raise StrictError("read_geno", "GENO file not at EOF. "
                              "Check GENO file and number of sites!")
        raw = data.reshape(n_sites, n_ind, 3)
        for s in range(n_sites):
            for i in range(n_ind):
                g = [float(raw[s, i, 0]), float(raw[s, i, 1]), float(raw[s, i, 2])]
                if not in_logscale:
                    # conv_space(log) with -inf -> -INF clamp (read_data.cpp:38,
                    # gen_func.cpp:125-132)
                    g = [_NEG_INF_SENTINEL if _libm_log1(v) == -math.inf
                         else _libm_log1(v) for v in g]
                g = post_prob3(g)
                if math.isnan(g[0]) or math.isnan(g[1]) or math.isnan(g[2]):
                    raise StrictError("read_geno", "NaN found! Is the file format correct?")
                geno[s, i] = g
        return geno

    log_third = math.log(1.0 / N_GENO)
    with open_maybe_gz(path, "rt") as fh:
        s = 0
        while s < n_sites:
            line = fh.readline()
            if line == "":
                raise StrictError("read_geno", "GENO file at premature EOF. "
                                  "Check GENO file and number of sites!")
            buf = chomp(line)
            if len(buf) == 0:
                # empty line CONSUMES a site slot and leaves it at the raw
                # -INF init, unnormalized (read_data.cpp:57-59)
                s += 1
                continue
            fields = split_doubles(buf)
            # header rule (read_data.cpp:63-72): no numeric fields anywhere,
            # or a short first row
            if not fields or (s == 0 and len(fields) < n_ind * n_geno):
                sys.stderr.write("> Header found! Skipping line...\n")
                continue
            if len(fields) < n_ind * n_geno:
                raise StrictError("read_geno", "wrong GENO file format. Less fields than expected!")
            ptr = fields[len(fields) - n_ind * n_geno:]
            for i in range(n_ind):
                if in_probs:
                    if in_logscale:
                        g = [ptr[i * N_GENO], ptr[i * N_GENO + 1], ptr[i * N_GENO + 2]]
                    else:
                        # direct log() WITHOUT the -INF clamp (read_data.cpp:86)
                        g = [_libm_log1(ptr[i * N_GENO]),
                             _libm_log1(ptr[i * N_GENO + 1]),
                             _libm_log1(ptr[i * N_GENO + 2])]
                else:
                    gcall = int(ptr[i])  # C double->int truncation
                    if gcall >= 0:
                        if gcall > 2:
                            raise StrictError("read_geno", "wrong GENO file format. "
                                              "Genotypes must be coded as {-1,0,1,2} !")
                        g = [_NEG_INF_SENTINEL] * 3
                        g[gcall] = 0.0  # log(1)
                    else:
                        g = [log_third] * 3
                geno[s, i] = post_prob3(g)
            s += 1
        # EOF check both directions (read_data.cpp:106-109)
        if fh.read(1) != "":
            raise StrictError("read_geno", "GENO file not at EOF. "
                              "Check GENO file and number of sites!")
    return geno


def _read_file_lines(path: str, offset: int, n_rows: int) -> list:
    """read_file (gen_func.cpp:233-282): skip blank lines and lines starting
    with '#', then skip `offset` additional leading lines; read up to n_rows
    lines. Raises if fewer than n_rows remain (when n_rows is finite)."""
    out = []
    skipped = 0
    with open_maybe_gz(path, "rt") as fh:
        for line in fh:
            buf = chomp(line)
            if len(buf) == 0 or buf.startswith("#"):
                continue
            if skipped < offset:
                skipped += 1
                continue
            out.append(buf)
            if n_rows is not None and len(out) == n_rows:
                break
    if n_rows is not None and len(out) != n_rows:
        raise StrictError("read_file", "could not read specified number of lines!")
    return out


def _strtod_prefix(tok: str) -> float:
    """C strtod: parse the longest numeric prefix, 0.0 if none."""
    best = 0.0
    for end in range(len(tok), 0, -1):
        try:
            return float(tok[:end])
        except ValueError:
            continue
    return best


def _strtoul_prefix(tok: str) -> int:
    """C strtoul(tok, NULL, 0): longest integer prefix with base
    auto-detection (0x hex, leading-0 octal)."""
    tok = tok.strip()
    neg = tok.startswith("-")
    body = tok[1:] if tok[:1] in "+-" else tok
    if body[:2].lower() == "0x":
        digits = "0123456789abcdef"
        base, body2 = 16, body[2:]
    elif body.startswith("0") and len(body) > 1:
        digits = "01234567"
        base, body2 = 8, body[1:]
    else:
        digits = "0123456789"
        base, body2 = 10, body
    val = 0
    seen = False
    for ch in body2:
        if ch.lower() in digits[:base]:
            val = val * base + int(ch, base)
            seen = True
        else:
            break
    if base == 8 and not seen:
        return 0  # bare "0"-prefixed with no octal digits is just 0
    if base == 16 and not seen:
        return 0
    # C strtoul semantics (verified against glibc): overflow of the
    # MAGNITUDE (either sign) clamps to ULONG_MAX; otherwise '-N' negates
    # MODULO 2^64 ('-5' -> 2^64-5). A negative position then makes the
    # next same-chr distance hugely negative, so the reference errors
    # 'invalid distance' — a Python negative would silently accept it.
    if val > 2**64 - 1:
        return 2**64 - 1
    return (2**64 - val) % 2**64 if neg else val


def read_pos(path: str, header: bool, n_sites: int) -> tuple:
    """read_dist + label pass (read_data.cpp:165-218, ngsLD.cpp:119-132).

    Returns (pos_dist (n_sites,) float64, labels list[str]).
    pos_dist[s] = pos[s]-pos[s-1] on the same chr (must be >= 1), INFINITY at
    contig changes. Labels are the raw lines with the FIRST tab -> ':'.

    Dispatches to the native C++ reader when available (real C
    strtod/strtoul, same messages; labels come back as a zero-copy
    LabelBlob); NGSLD_NO_NATIVE=1 forces this pure-Python path."""
    if os.environ.get("NGSLD_NO_NATIVE") != "1":
        from .native import read_pos_native
        native = read_pos_native(path, header, n_sites)
        if native is not None:
            return native

    # read_split reads ALL lines and the reference errors on any count
    # mismatch (read_data.cpp:175-179) — truncating extra lines would
    # silently produce output the reference refuses to produce
    lines = _read_file_lines(path, 1 if header else 0, None)
    if len(lines) != n_sites:
        raise StrictError("read_dist", "wrong number of lines in POS file!")
    rows = [ln.split("\t") for ln in lines]  # read_split sep="\t", keeps empties
    n_fields = len(rows[0])
    for r in rows:
        if len(r) != n_fields:
            raise StrictError("read_split", "invalid number of fields in file!")
    if n_fields < 2:
        raise StrictError("read_dist", "wrong POS file format!")

    pos_dist = np.full(n_sites, math.inf, dtype=np.float64)
    prev_chr = None
    prev_pos = 0
    for s in range(n_sites):
        if _strtod_prefix(rows[s][1]) == 0.0:
            # the reference's in-loop header skip (read_data.cpp:188-196)
            # underflows its unsigned index and loops forever; surface it as
            # an error instead (use --posH for headered files).
            raise StrictError("read_dist", "non-numeric/zero position found "
                              "(headered POS file? use --posH)")
        if prev_chr is None:
            prev_chr = rows[s][0]
        if prev_chr == rows[s][0]:
            pos_dist[s] = _strtod_prefix(rows[s][1]) - np.float64(prev_pos)
            if pos_dist[s] < 1:
                raise StrictError("read_dist", "invalid distance between adjacent sites!")
        else:
            pos_dist[s] = math.inf
            prev_chr = rows[s][0]
        prev_pos = _strtoul_prefix(rows[s][1])

    labels = [ln.replace("\t", ":", 1) for ln in lines]
    return pos_dist, labels


# ---------------------------------------------------------------------------
# Output formatting (mirror ngsLD.cpp:314-351 printf contract)
# ---------------------------------------------------------------------------

def fmt_f(v) -> str:
    """C printf %f, including glibc's nan/-nan/inf/-inf spellings."""
    v = np.float64(v)
    if np.isnan(v):
        return "-nan" if np.signbit(v) else "nan"
    return "%f" % float(v)


def fmt_f0(v) -> str:
    """C printf %.0f."""
    v = np.float64(v)
    if np.isnan(v):
        return "-nan" if np.signbit(v) else "nan"
    return "%.0f" % float(v)


def header_line(extend_out: bool) -> str:
    base = "site1\tsite2\tdist\tr2_ExpG\tD\tDp\tr2"
    if extend_out:
        base += ("\tsample_size\tmaf1\tmaf2\thap00\thap01\thap10\thap11"
                 "\thap_maf1\thap_maf2\tchi2\tloglike\tnIter")
    return base + "\n"


# ---------------------------------------------------------------------------
# Banded pair sweep + run loop (mirror ngsLD.cpp:27-359)
# ---------------------------------------------------------------------------

def enumerate_pairs(pars, maf: np.ndarray, pos_dist: np.ndarray,
                    trace=None):
    """Replicates calc_pair_LD's band walk and filter semantics
    (ngsLD.cpp:229-286) for every anchor site, including the RNG discipline:
    a master taus stream seeded with --seed hands ONE child seed per anchor
    in site order (ngsLD.cpp:164-166); each anchor's child stream is drawn
    once per candidate pair that survives the dist/MAF checks (ngsLD.cpp:277).

    Yields (s1, s2, dist) for pairs that must be emitted.
    Filter order per candidate s2 (break ends the anchor's row):
      1. break  if max_kb_dist>0 and dist > max_kb_dist*1000
      2. break  if max_snp_dist>0 and s2-s1 > max_snp_dist
      3. break  if maf[s1] < min_maf        (low-MAF anchor emits nothing)
      4. skip   if maf[s2] < min_maf
      5. skip   if child_uniform() > rnd_sample

    trace: optional (labels, expected_geno) — with --verbose > 8 every
    candidate prints the reference's per-pair filter trace
    (ngsLD.cpp:242-283: the header with [min_maf: mafs], [max_bp: dist],
    [max_snp: span] and the joined E[G] rows, then the break/skip/PASS
    verdict). join() uses %.10f with ',' (gen_func.cpp:479-487)."""
    n_sites = pars.n_sites
    master = TausRNG(pars.seed)
    max_bp = pars.max_kb_dist * 1000
    need_rng = pars.rnd_sample < 1.0
    tr = None
    if trace is not None and pars.verbose > 8:
        labels, eg = trace
        egj = {}   # joined E[G] rows are reused across the anchor's band

        def _join(s):
            if s not in egj:
                egj[s] = ",".join("%.10f" % v for v in eg[s])
            return egj[s]

        def tr(s1, s2, dist):
            sys.stderr.write(
                f"{s1}\t{labels[s1]}\t{s2}\t{labels[s2]}: "
                + "\t[%f: %f,%f]" % (pars.min_maf, maf[s1], maf[s2])
                + "\t[%d: %.0f]" % (max_bp, dist)
                + "\t[%d: %d]" % (pars.max_snp_dist, s2 - s1)
                + f"\t{_join(s1)}\t{_join(s2)}\n")

    out = []
    for s1 in range(n_sites):
        child_seed = int(master.uniform() * INF)  # draw_rnd(rnd, 0, INF) -> uint64
        child = TausRNG(child_seed) if need_rng else None
        dist = np.float64(0.0)
        s2 = s1 + 1
        while s2 < n_sites:
            dist = dist + pos_dist[s2]
            if tr:
                tr(s1, s2, dist)
            if pars.max_kb_dist > 0 and max_bp < dist:
                if tr:
                    sys.stderr.write("\tMax dist (kb) exceeded: %f\n"
                                     % (dist / 1000))
                break
            if pars.max_snp_dist > 0 and pars.max_snp_dist < s2 - s1:
                if tr:
                    sys.stderr.write("\tMax number of SNPs exceeded: %d\n"
                                     % (s2 - s1))
                break
            if maf[s1] < pars.min_maf:
                if tr:
                    sys.stderr.write("\tLow MAF on site1: %f\n" % maf[s1])
                break
            if maf[s2] < pars.min_maf:
                if tr:
                    sys.stderr.write("\tLow MAF on site2: %f\n" % maf[s2])
                s2 += 1
                continue
            if need_rng and child.uniform() > pars.rnd_sample:
                if tr:
                    sys.stderr.write("\tRandom sampling\n")
                s2 += 1
                continue
            if tr:
                sys.stderr.write("\tPASS\n")
            out.append((s1, s2, float(dist)))
            s2 += 1
    return out


def run(pars, out_fh=None) -> None:
    """End-to-end strict run; mirror of main() (ngsLD.cpp:27-223).

    Emits rows grouped by anchor in (s1, s2) order — the reference's own row
    order is thread-nondeterministic and its tests sort before comparing
    (examples/test.sh:16), so deterministic order is a strict improvement.
    """
    close = False
    if out_fh is None:
        if pars.out is not None:
            out_fh = open(pars.out, "w")
            close = True
        else:
            out_fh = sys.stdout

    try:
        if pars.verbose >= 1:
            from .utils.logging import echo_config
            echo_config(pars, "(strict, cpu, f64 bit-exact)")
        geno_log = read_geno(pars.in_geno, pars.in_bin, pars.in_probs,
                             pars.in_logscale, pars.n_ind, pars.n_sites)
        if pars.call_geno:
            call_geno_inplace(geno_log, pars.N_thresh, pars.call_thresh)
        maf = est_maf_all(geno_log, pars.ignore_miss_data)
        # conv_space(exp): GLs in NORMAL space for the rest of the run
        # (ngsLD.cpp:107-114)
        gn = libm_exp(geno_log)
        expected_geno = gn[:, :, 1] + 2 * gn[:, :, 2]

        if pars.in_pos:
            pos_dist, labels = read_pos(pars.in_pos, pars.in_pos_header, pars.n_sites)
            if pars.verbose >= 6:   # ngsLD.cpp:120-122
                for s in range(min(10, pars.n_sites)):
                    sys.stderr.write("%d\t%f\n" % (s, pos_dist[s]))
        else:
            pos_dist = np.full(pars.n_sites, math.inf)
            # the reference's no-pos label alloc returns NULL pointers which
            # glibc prints as "(null)" (ngsLD.cpp:135 with init_ptr B=0,
            # gen_func.cpp:749-772); reproduce that output contract.
            labels = ["(null)"] * pars.n_sites

        if pars.verbose >= 7:   # ngsLD.cpp:138-143 (normal-space GLs)
            sys.stderr.write("==> Geno data\n")
            for s in range(min(10, pars.n_sites)):
                sys.stderr.write(
                    "%d\t%s\t%f (%f %f %f)\n"
                    % (s, labels[s], maf[s], gn[s, 0, 0], gn[s, 0, 1],
                       gn[s, 0, 2]))

        from .io.writer import RowWriter
        writer = RowWriter(out_fh, labels, pars.extend_out)
        writer.write_header()

        pairs = enumerate_pairs(pars, maf, pos_dist,
                                trace=(labels, expected_geno))

        chunk = max(1, int(pars.chunk_pairs))
        for lo in range(0, len(pairs), chunk):
            batch = pairs[lo:lo + chunk]
            s1_idx = np.array([p[0] for p in batch], dtype=np.int64)
            s2_idx = np.array([p[1] for p in batch], dtype=np.int64)
            dists = np.array([p[2] for p in batch], dtype=np.float64)

            r2pear = pearson_r2_batch(expected_geno[s1_idx], expected_geno[s2_idx])
            f, n_iter, n_used = pair_em_batch(gn[s1_idx], gn[s2_idx],
                                              maf[s1_idx], maf[s2_idx],
                                              pars.ignore_miss_data)
            hmaf0, hmaf1, D, Dp, r2 = ld_stats_batch(f)
            chi2 = chi2_batch(f) if pars.extend_out else None
            writer.write_block(s1_idx, s2_idx, dists, r2pear, D, Dp, r2,
                               n_used=n_used, maf1=maf[s1_idx],
                               maf2=maf[s2_idx], hap=f, hmaf1=hmaf0,
                               hmaf2=hmaf1, chi2=chi2, n_iter=n_iter)
    finally:
        if close:
            out_fh.close()
