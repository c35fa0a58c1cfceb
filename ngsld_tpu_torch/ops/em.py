"""Two-locus haplotype-frequency EM, plain PyTorch (ngsld_tpu/ops/em.py).

The CPU engine and the oracle of the CUDA kernel (kernels/pair_em.py).
Per individual and iteration (gen_func.cpp:1027-1119):

    D_k[i]   = sum_h f_h * P_i[G1(k,h), G2(k,h)]
    s[i]     = sum_k f_k * D_k[i]
    f_k_new  = f_k * (sum_i include_i * D_k[i] / s[i]) * (1/x)

normalised by ((f0+f1)+f2)+f3. A pair freezes when the NaN-ignoring max
|df_k| drops below EPSILON (n_iter = that 0-based iteration), else runs to
ITER_MAX. x = 0 pairs (all individuals excluded) update to NaN, and the
NaN-ignoring fold freezes them at n_iter 0 with NaN frequencies.

Shapes: gl1, gl2 (P, I, 3) normal-space GLs; all outputs (P, ...).
"""

from __future__ import annotations

import torch

from ..constants import EPSILON, ITER_MAX

from .preprocess import miss_mask

# (k -> site-1 allele bit, site-2 allele bit); k = 2*a1 + a2
_KBITS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _isum(t, i_chunk):
    """Sum over the individual axis: at once, or chunk by chunk in index
    order as the streamed kernels accumulate it."""
    if i_chunk is None:
        return t.sum(dim=1)
    acc = None
    for part in t.split(i_chunk, dim=1):
        acc = part.sum(dim=1) if acc is None else acc + part.sum(dim=1)
    return acc


def em_sums(f, gl1, gl2, include, i_chunk=None):
    """The four sums over individuals of one EM step,
    sum_i include_i * D_k[i] / s[i], each (P,). f: (P,4); gl1/gl2:
    (P,I,3); include: (P,I) float mask."""
    D = []
    for (a1k, a2k) in _KBITS:
        d = None
        for (a, b) in _KBITS:
            t = f[:, 2 * a + b, None] * gl1[:, :, a1k + a] * gl2[:, :, a2k + b]
            d = t if d is None else d + t
        D.append(d)
    s = None
    for k in range(4):
        t = f[:, k, None] * D[k]
        s = t if s is None else s + t
    r = include / s  # masked reciprocal; excluded inds contribute 0
    return [_isum(D[k] * r, i_chunk) for k in range(4)]


def em_apply(f, S, inv_x):
    """The EM update from the step's sums S (four (P,) tensors):
    f_k * S_k / x, normalised by ((f0+f1)+f2)+f3."""
    f_new = [f[:, k] * S[k] * inv_x for k in range(4)]
    norm = ((f_new[0] + f_new[1]) + f_new[2]) + f_new[3]
    return torch.stack([fk / norm for fk in f_new], dim=1)


def _em_update(f, gl1, gl2, include, inv_x, i_chunk=None):
    """One EM step for all pairs. f: (P,4); gl1/gl2: (P,I,3);
    include: (P,I) float mask; inv_x: (P,) = 1/n_used."""
    return em_apply(f, em_sums(f, gl1, gl2, include, i_chunk), inv_x)


def nan_ignoring_eps(f_next, f):
    """Per pair max_k |f_next - f| folded as `if (x > eps) eps = x`: NaN
    never wins (torch.maximum would propagate it)."""
    diffs = (f_next - f).abs()
    eps = torch.zeros(f.shape[0], dtype=f.dtype, device=f.device)
    for k in range(4):
        eps = torch.where(diffs[:, k] > eps, diffs[:, k], eps)
    return eps


def pair_em(gl1: torch.Tensor, gl2: torch.Tensor, maf1: torch.Tensor,
            maf2: torch.Tensor, ignore_miss_data: bool, live=None,
            i_chunk: int | None = None, *, iter_cap: int = ITER_MAX,
            f0: torch.Tensor | None = None, want_eps: bool = False):
    """EM haplotype frequencies for P pairs.

    Returns (f (P,4), n_iter (P,) int32, n_used (P,) int32). live (P,)
    bool (optional): pairs outside it freeze at the f0 init with
    n_iter == iter_cap. i_chunk: add the per-individual terms up in chunks
    of that many individuals (the streamed kernels' order). The options of
    pallas_em._em_kernel: iter_cap stops the pairs still running there
    (n_iter == iter_cap); f0 (P, 4) starts f there in place of the MAFs (a
    capped run's f, to resume it); want_eps appends eps (P, 2) =
    [eps_last, eps_prev], each pair's last two update magnitudes, 1 until
    the pair runs and unchanged once it stops."""
    dt = gl1.dtype
    P = gl1.shape[0]
    if f0 is None:
        f = torch.stack([(1 - maf1) * (1 - maf2), (1 - maf1) * maf2,
                         maf1 * (1 - maf2), maf1 * maf2], dim=1).to(dt)
    else:
        f = f0.to(dt)
    if ignore_miss_data:
        include = ~(miss_mask(gl1) | miss_mask(gl2))
    else:
        include = torch.ones(gl1.shape[:2], dtype=torch.bool,
                             device=gl1.device)
    n_used = include.sum(dim=1).to(torch.int32)
    incf = include.to(dt)
    inv_x = 1.0 / n_used.to(dt)

    active = (torch.ones(P, dtype=torch.bool, device=gl1.device)
              if live is None else live.clone())
    n_iter = torch.full((P,), iter_cap, dtype=torch.int32, device=gl1.device)
    eps_last = torch.ones(P, dtype=dt, device=gl1.device)
    eps_prev = torch.ones(P, dtype=dt, device=gl1.device)
    it = 0
    while it < iter_cap and bool(active.any()):
        f_new = _em_update(f, gl1, gl2, incf, inv_x, i_chunk)
        f_next = torch.where(active[:, None], f_new, f)
        eps = nan_ignoring_eps(f_next, f)
        if want_eps:
            eps_prev = torch.where(active, eps_last, eps_prev)
            eps_last = torch.where(active, eps, eps_last)
        newly = active & (eps < EPSILON)
        n_iter = torch.where(newly, torch.full_like(n_iter, it), n_iter)
        active = active & ~newly
        f = f_next
        it += 1
    if want_eps:
        return f, n_iter, n_used, torch.stack([eps_last, eps_prev], dim=1)
    return f, n_iter, n_used
