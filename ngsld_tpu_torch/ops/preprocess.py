"""Preprocessing ops, op for op with ngsld_tpu/ops/preprocess.py.

  * normalize_gl   — log-softmax normalization (gen_func.cpp:920-932)
  * call_geno      — genotype calling w/ thresholds (gen_func.cpp:886-914)
  * est_maf        — per-site MAF, closed form mean(E[G])/2
  * expected_geno  — E[G] = p1 + 2*p2 (ngsLD.cpp:107-114)

All ops take gl as (n_sites, n_ind, 3); log-space in, as read_geno returns.
"""

from __future__ import annotations

import torch

from ..constants import EPSILON, INF, N_GENO


def normalize_gl(gl_log: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the genotype axis with an explicit max shift (not
    torch.logsumexp: all -inf rows must stay -inf, as in the reference)."""
    m = gl_log.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    norm = torch.log(torch.exp(gl_log - m).sum(dim=-1, keepdim=True)) + m
    return gl_log - norm


def miss_mask(gl: torch.Tensor) -> torch.Tensor:
    """miss_data (gen_func.cpp:862-868): |g0-g1|<eps and |g1-g2|<eps."""
    return ((gl[..., 0] - gl[..., 1]).abs() < EPSILON) & \
           ((gl[..., 1] - gl[..., 2]).abs() < EPSILON)


def call_geno(gl_log: torch.Tensor, N_thresh: float,
              call_thresh: float) -> torch.Tensor:
    """Vectorized call_geno, miss-mode 0 (gen_func.cpp:886-914).

    torch.argmax returns the first maximal index, the reference's
    first-max tie rule (array_max_pos, gen_func.cpp:73-98)."""
    dt = gl_log.dtype
    max_pos = gl_log.argmax(dim=-1)
    mx = gl_log.gather(-1, max_pos[..., None])[..., 0]
    mn = gl_log.amin(dim=-1)
    max_pp = torch.exp(mx)
    missing = mn == mx  # min==max => all equal => missing sentinel
    max_pp = torch.where(missing, torch.full_like(max_pp, -1.0), max_pp)

    log_third = torch.log(torch.tensor(1.0 / N_GENO, dtype=dt,
                                       device=gl_log.device))
    out = torch.where((max_pp < N_thresh)[..., None], log_third, gl_log)
    onehot = torch.where(
        torch.nn.functional.one_hot(max_pos, N_GENO).bool(),
        torch.tensor(0.0, dtype=dt, device=gl_log.device),
        torch.tensor(-1e15, dtype=dt, device=gl_log.device))
    return torch.where((max_pp >= call_thresh)[..., None], onehot, out)


def site_sum(x: torch.Tensor) -> torch.Tensor:
    """x (n_sites, n) summed over its second axis in a fixed pairwise
    order: the first half of the columns added to the second, element by
    element, until one is left (an odd column rides along to the next
    round). A reduction kernel picks its launch shape, and so the order of
    its additions, from the tensor's shape; here every site's bits depend
    on its own row alone, so a table preprocessed slab by slab (the overlap
    ingest) is the monolithic table byte for byte, on any device."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] + x[:, h:2 * h]
        x = torch.cat([y, x[:, 2 * h:]], dim=1) if x.shape[1] % 2 else y
    return x[:, 0]


def maf_sums(gl_log: torch.Tensor, ignore_miss_data: bool):
    """est_maf's numerator sum(pp1 + 2*pp2) and denominator 2 * n_used, a
    site each: sums over individuals (site_sum's order), which a table
    split over the individual axis adds up over its ranks before
    dividing."""
    pp = torch.exp(normalize_gl(gl_log))
    if ignore_miss_data:
        include = ~miss_mask(gl_log)
    else:
        include = torch.ones(gl_log.shape[:2], dtype=torch.bool,
                             device=gl_log.device)
    eg = pp[..., 1] + 2.0 * pp[..., 2]
    num = site_sum(torch.where(include, eg, torch.zeros_like(eg)))
    den = 2.0 * include.sum(dim=1).to(gl_log.dtype)
    return num, den


def est_maf(gl_log: torch.Tensor, ignore_miss_data: bool) -> torch.Tensor:
    """Closed-form MAF with a NULL prior: sum(pp1 + 2*pp2) / (2 * n_used);
    an all-excluded site yields NaN as in the reference."""
    num, den = maf_sums(gl_log, ignore_miss_data)
    return num / den


def expected_geno(gl_normal: torch.Tensor) -> torch.Tensor:
    """E[G] per site/ind from normal-space GLs (ngsLD.cpp:113)."""
    return gl_normal[..., 1] + 2.0 * gl_normal[..., 2]


def preprocess(gl_log: torch.Tensor, call: bool, N_thresh: float,
               call_thresh: float, ignore_miss_data: bool, raw: bool = False,
               in_log: bool = True, maf_of=None):
    """Full preprocessing pass (ngsLD.cpp:92-114) -> (gn, maf, eg).

    raw=True accepts UNNORMALIZED binary-file records and applies the
    binary reader's semantics: optional log-convert with the -INF clamp
    (read_data.cpp:38, gen_func.cpp:125-132), then post_prob
    (read_data.cpp:42). maf_of(num, den) -> maf replaces est_maf's
    division (the ring's --shard_ind adds the sums over its ranks)."""
    if raw:
        if not in_log:
            lg = torch.log(gl_log)
            gl_log = torch.where(torch.isinf(lg) & (lg < 0),
                                 torch.full_like(lg, -INF), lg)
        gl_log = normalize_gl(gl_log)
    if call:
        gl_log = call_geno(gl_log, N_thresh, call_thresh)
    maf = (est_maf(gl_log, ignore_miss_data) if maf_of is None
           else maf_of(*maf_sums(gl_log, ignore_miss_data)))
    gn = torch.exp(gl_log)
    eg = expected_geno(gn)
    return gn, maf, eg
