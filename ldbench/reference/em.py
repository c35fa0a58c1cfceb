"""Per-pair values of an LD job in plain PyTorch: the site preprocessing
(normal-space GLs, E[G], the allele frequency), Pearson r2 of E[G], the
two-locus EM of ngsLD (haplo_freq / pair_freq_iter) and the statistics it
prints (ngsLD.cpp:295-349). `dtype` is the arithmetic precision: float64
for the reference, bfloat16 for the control."""

from __future__ import annotations

import numpy as np
import torch

EPSILON = 1e-5      # EM stop: max |f_new - f| < EPSILON (gen_func.hpp:16)
ITER_MAX = 100      # EM iteration cap (gen_func.hpp:18)
# genotype index of locus 1 / locus 2 in the haplotype pair (k, h)
_G1 = [[(k >> 1) + (h >> 1) for h in range(4)] for k in range(4)]
_G2 = [[(k & 1) + (h & 1) for h in range(4)] for k in range(4)]


def site_tables(lg: np.ndarray, dtype, device):
    """log-normalised GL rows (S, I, 3) -> gn (S, I, 3) normal space,
    eg (S, I) = E[G], maf (S,) = sum_i E[G] / (2 * sum_i sum_g gn)."""
    gn = torch.exp(torch.as_tensor(lg, device=device).to(dtype))
    eg = gn[..., 1] + 2 * gn[..., 2]
    maf = eg.sum(dim=1) / (2 * gn.sum(dim=(1, 2)))
    return gn, eg, maf


def pearson_r2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xc = x - x.mean(dim=1, keepdim=True)
    yc = y - y.mean(dim=1, keepdim=True)
    r = (xc * yc).sum(dim=1) / (torch.sqrt((xc * xc).sum(dim=1))
                                * torch.sqrt((yc * yc).sum(dim=1)))
    return r * r


def pair_em(g1: torch.Tensor, g2: torch.Tensor, m1: torch.Tensor,
            m2: torch.Tensor):
    """g1, g2 (P, I, 3) normal-space GLs of the two sites, m1, m2 (P,)
    their allele frequencies -> (f (P, 4) haplotype frequencies, n_iter
    (P,) the 0-based iteration at which max |f_new - f| fell under
    EPSILON, ITER_MAX when it never did). Every individual counts
    (--ignore_miss_data off)."""
    n = g1.shape[1]
    f = torch.stack([(1 - m1) * (1 - m2), (1 - m1) * m2, m1 * (1 - m2),
                     m1 * m2], dim=1)
    n_iter = torch.full((len(f),), ITER_MAX, dtype=torch.int64,
                        device=f.device)
    active = torch.ones(len(f), dtype=torch.bool, device=f.device)
    prod = [[g1[:, :, _G1[k][h]] * g2[:, :, _G2[k][h]] for h in range(4)]
            for k in range(4)]
    for it in range(ITER_MAX):
        ff = [f[:, k:k + 1] for k in range(4)]
        den = sum(ff[k] * ff[h] * prod[k][h]
                  for k in range(4) for h in range(4))
        new = torch.stack(
            [(sum((prod[h][k] + prod[k][h]) * (ff[k] * ff[h])
                  for h in range(4)) / den).sum(dim=1) / (2 * n)
             for k in range(4)], dim=1)
        cols = list(new.unbind(1))
        for k in range(4):    # ngsLD normalises in place, one k at a time
            cols[k] = cols[k] / (cols[0] + cols[1] + cols[2] + cols[3])
        new = torch.stack(cols, dim=1)
        diff = (new - f).abs()
        # a NaN difference never raises the running maximum
        eps = torch.nan_to_num(diff, nan=0.0).amax(dim=1)
        f = torch.where(active[:, None], new, f)
        done = active & (eps < EPSILON)
        n_iter[done] = it
        active &= ~done
        if not bool(active.any()):
            break
    return f, n_iter


def ld_stats(f: torch.Tensor) -> dict:
    """Columns of a row from its haplotype frequencies (f64 on the host,
    whatever f's dtype: only the EM and the tables carry the precision)."""
    f = f.double().cpu().numpy()
    with np.errstate(all="ignore"):
        hm1 = 1 - (f[:, 0] + f[:, 1])
        hm2 = 1 - (f[:, 0] + f[:, 2])
        D = f[:, 0] * f[:, 3] - f[:, 1] * f[:, 2]
        den_dp = np.where(D < 0, -np.minimum(hm1 * hm2, (1 - hm1) * (1 - hm2)),
                          np.minimum(hm1 * (1 - hm2), (1 - hm1) * hm2))
        den_r2 = hm1 * hm2 * (1 - hm1) * (1 - hm2)
        Dp = D / den_dp
        r2 = D * D / den_r2
        pa, pb = f[:, 0] + f[:, 1], f[:, 0] + f[:, 2]
        exp_hap = np.stack([pa * pb, pa * (1 - pb), (1 - pa) * pb,
                            (1 - pa) * (1 - pb)], axis=1)
        chi2 = (((f - exp_hap) ** 2) / exp_hap).sum(axis=1)
    return dict(f=f, hap_maf1=hm1, hap_maf2=hm2, D=D, Dp=Dp, r2=r2,
                chi2=chi2, den_dp=den_dp, den_r2=den_r2,
                exp_min=exp_hap.min(axis=1))


def pair_values(lg: np.ndarray, i1: np.ndarray, i2: np.ndarray,
                dtype=torch.float64, device="cpu",
                block: int = 1 << 24) -> dict:
    """Every printed value of the pairs (i1[p], i2[p]) of the sites whose
    log-normalised GL rows are lg (S, I, 3), computed in dtype, in blocks
    of at most `block` (pair, individual) cells."""
    gn, eg, maf = site_tables(lg, dtype, device)
    i1 = torch.as_tensor(np.asarray(i1, np.int64), device=device)
    i2 = torch.as_tensor(np.asarray(i2, np.int64), device=device)
    step = max(1, block // max(gn.shape[1], 1))
    parts = []
    for a in range(0, len(i1), step):
        j1, j2 = i1[a:a + step], i2[a:a + step]
        f, n_iter = pair_em(gn[j1], gn[j2], maf[j1], maf[j2])
        parts.append(dict(maf1=maf[j1].double().cpu().numpy(),
                          maf2=maf[j2].double().cpu().numpy(),
                          r2_ExpG=pearson_r2(eg[j1], eg[j2])
                          .double().cpu().numpy(),
                          nIter=n_iter.cpu().numpy(), **ld_stats(f)))
    if not parts:
        return {}
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
