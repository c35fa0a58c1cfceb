"""Distance-aware HMM over SNP sequences, in PyTorch.

The port of ngsld_tpu/extras/hmm.py (itself the counterpart of the
reference's vestigial HMM module, shared/HMM.cpp, which ngsLD ships for
its sibling tools but does not compile, Makefile:5,14):

  * forward / backward       — log-space filtering over sites with
                               distance-dependent transitions
                               (HMM.cpp:6-75)
  * posterior                — the forward-backward smoother
  * viterbi                  — most likely state path (HMM.cpp:115-140)
  * log_trans_matrix         — P(k->l | d) = (1-e^{-alpha d}) q_l
                               [+ e^{-alpha d} if k==l] (HMM.cpp:130-140)
  * emission_hwe             — single-site HWE-prior emission
                               (HMM.cpp:144-155)
  * emission_ld              — two-locus LD emission from haplotype
                               frequencies via the 9-entry joint genotype
                               table (HMM.cpp:175-208, 211-236)

The JAX package's lax.scan over sites becomes a Python loop that fills
preallocated (..., L, K) tables, one site a step. Where the JAX functions
are vmapped over individuals or regions, these take leading batch
dimensions instead: q_prop (..., K), log_emission (..., L, K), pos_dist
(..., L), and alpha a number or a tensor that broadcasts against
pos_dist. Every tensor a function makes takes the device and dtype of its
inputs; nothing moves to the CPU.
"""

from __future__ import annotations

import torch


def log_trans_matrix(q_prop: torch.Tensor, alpha, dist: torch.Tensor):
    """(..., K, K) log transition matrices for each distance.
    T[k,l] = (1 - e^{-alpha d}) q_l + [k==l] e^{-alpha d}; q_prop's shape
    without its last axis broadcasts against dist's."""
    K = q_prop.shape[-1]
    stay = torch.exp(-alpha * dist)[..., None, None]
    base = (1 - stay) * q_prop[..., None, :]
    eye = torch.eye(K, dtype=q_prop.dtype, device=q_prop.device)
    return torch.log(base + stay * eye)


def _site_tables(q_prop, alpha, log_emission, pos_dist):
    """(T (..., L, K, K), log q_prop (..., K), log_emission (..., L, K)),
    the last two expanded to the batch shape that all inputs broadcast
    to."""
    batch = torch.broadcast_shapes(q_prop.shape[:-1], log_emission.shape[:-2],
                                   pos_dist.shape[:-1],
                                   getattr(alpha, "shape", ())[:-1])
    T = log_trans_matrix(q_prop[..., None, :], alpha, pos_dist)
    log_q = torch.log(q_prop).expand(batch + q_prop.shape[-1:])
    return T, log_q, log_emission.expand(batch + log_emission.shape[-2:])


def forward(q_prop, alpha, log_emission, pos_dist):
    """Log-space forward pass.

    log_emission: (..., L, K) per-site log emission; pos_dist: (..., L)
    distance to the previous site (pos_dist[..., 0] unused). Returns
    (log-likelihood (...), (..., L, K) forward table); every row carries
    its emission, row 0 the prior times it (HMM.cpp:6-29)."""
    T, log_q, log_emission = _site_tables(q_prop, alpha, log_emission,
                                          pos_dist)
    L = log_emission.shape[-2]
    table = torch.empty_like(log_emission)
    f = log_q + log_emission[..., 0, :]
    table[..., 0, :] = f
    for s in range(1, L):
        f = torch.logsumexp(f[..., :, None] + T[..., s, :, :], dim=-2) \
            + log_emission[..., s, :]
        table[..., s, :] = f
    return torch.logsumexp(f, dim=-1), table


def backward(q_prop, alpha, log_emission, pos_dist):
    """Log-space backward pass; returns (log-likelihood, (..., L, K)
    table)."""
    T, log_q, log_emission = _site_tables(q_prop, alpha, log_emission,
                                          pos_dist)
    L = log_emission.shape[-2]
    table = torch.empty_like(log_emission)
    b = torch.zeros_like(log_emission[..., 0, :])
    table[..., L - 1, :] = b
    for s in range(L - 1, 0, -1):
        b = torch.logsumexp(
            T[..., s, :, :] + (log_emission[..., s, :] + b)[..., None, :],
            dim=-1)
        table[..., s - 1, :] = b
    ll = torch.logsumexp(log_q + log_emission[..., 0, :] + table[..., 0, :],
                         dim=-1)
    return ll, table


def posterior(q_prop, alpha, log_emission, pos_dist):
    """Per-site posterior state probabilities (forward-backward smoother),
    (..., L, K)."""
    ll, fw = forward(q_prop, alpha, log_emission, pos_dist)
    _, bw = backward(q_prop, alpha, log_emission, pos_dist)
    return torch.exp(fw + bw - ll[..., None, None])


def viterbi(q_prop, alpha, log_emission, pos_dist):
    """Most likely state path; returns (path log-probability (...),
    (..., L) int32 path). Ties go to the lowest state, as jnp.argmax's
    first maximum (torch.argmax returns the first maximal index too)."""
    T, log_q, log_emission = _site_tables(q_prop, alpha, log_emission,
                                          pos_dist)
    L = log_emission.shape[-2]
    v = log_q + log_emission[..., 0, :]
    backs = torch.empty(log_emission.shape[:-2] + (L - 1,)
                        + log_emission.shape[-1:], dtype=torch.int64,
                        device=log_emission.device)
    for s in range(1, L):
        scores = v[..., :, None] + T[..., s, :, :]
        backs[..., s - 1, :] = torch.argmax(scores, dim=-2)
        v = torch.amax(scores, dim=-2) + log_emission[..., s, :]
    last = torch.argmax(v, dim=-1, keepdim=True)
    path = torch.empty(log_emission.shape[:-1], dtype=torch.int64,
                       device=log_emission.device)
    path[..., L - 1] = last[..., 0]
    state = last
    for s in range(L - 2, -1, -1):
        state = torch.gather(backs[..., s, :], -1, state)
        path[..., s] = state[..., 0]
    return torch.gather(v, -1, last)[..., 0], path.to(torch.int32)


# --------------------------------------------------------------- emissions

def hwe_genotype_logfreq(maf, F):
    """HWE genotype frequencies with inbreeding F (calc_HWE semantics,
    gen_func.cpp:938-957, incl. the F==1 heterozygote guard); (..., 3)."""
    F = torch.as_tensor(F, dtype=maf.dtype, device=maf.device)
    g0 = (1 - maf) ** 2 + (1 - maf) * maf * F
    g1 = 2 * (1 - maf) * maf - 2 * (1 - maf) * maf * F
    g2 = maf ** 2 + (1 - maf) * maf * F
    g1 = torch.where(F == 1.0, torch.full_like(g1, 1e-300), g1)
    return torch.log(torch.stack(torch.broadcast_tensors(g0, g1, g2),
                                 dim=-1))


def emission_hwe(gl_log, maf, F):
    """log P(reads | maf, F) = logsumexp_g gl[g] + log HWE_g (HMM.cpp:144-155).
    gl_log (..., 3) log-GLs; maf, F broadcastable."""
    return torch.logsumexp(gl_log + hwe_genotype_logfreq(maf, F), dim=-1)


def joint_geno_logprob(hap_freq, F: int = 0):
    """(..., 3, 3) joint genotype probability table P(G_prev, G_curr |
    hap_freq) for hap_freq (..., 4) (HMM.cpp:211-236). F=0: outcrossed
    (products of haplotype draws); F=1: fully inbred (single haplotype
    draw, hets impossible)."""
    h0, h1, h2, h3 = hap_freq.unbind(-1)
    if F == 0:
        rows = [[h0 ** 2, 2 * h0 * h1, h1 ** 2],
                [2 * h0 * h2, 2 * (h0 * h3 + h1 * h2), 2 * h1 * h3],
                [h2 ** 2, 2 * h2 * h3, h3 ** 2]]
    else:
        z = torch.zeros_like(h0)
        rows = [[h0, z, h1], [z, z, z], [h2, z, h3]]
    t = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return torch.log(t)


def emission_ld(hap_freq, gl_prev_log, gl_curr_log, maf_prev, F: int = 0):
    """Two-locus LD emission (HMM.cpp:175-208): log of
    sum_{gp,gc} P(gp,gc|hap) L(gp) L(gc), conditioned on the previous
    site's single-locus HWE emission."""
    joint = joint_geno_logprob(hap_freq, F)
    ll = torch.logsumexp(joint + gl_prev_log[..., :, None]
                         + gl_curr_log[..., None, :], dim=(-2, -1))
    maf_prev = torch.as_tensor(maf_prev, dtype=gl_prev_log.dtype,
                               device=gl_prev_log.device)
    return ll - emission_hwe(gl_prev_log, maf_prev, F)
