"""Gathered-pair block step of the sweep (ngsld_tpu/compute.py:14-28,
64-123, single device).

The site tables stay on the device; per block only the (2, P) index
crosses over, and only (r2p, hap freqs) plus int metadata come back. The
other columns (D, D', r2, hap MAFs, chi2) derive on the host
(ngsld_tpu.engine_block._stats_host/_chi2_host)."""

from __future__ import annotations

import torch

from .kernels.pair_em import pair_em_gather
from .ops.stats import pearson_r2


def _imat(n_iter, n_used, ignore_miss_data: bool, n_ind: int):
    """Pack the per-pair int metadata for the host pull.

    With --ignore_miss_data off every pair uses all n_ind individuals, so
    n_used is a constant the host synthesizes and n_iter (<= ITER_MAX)
    ships as one int8: (P, 1) i8. Otherwise (P, 2) i16 (i32 past 32767
    individuals)."""
    if not ignore_miss_data:
        return n_iter.to(torch.int8)[:, None]
    idt = torch.int16 if n_ind <= 32767 else torch.int32
    return torch.stack([n_iter.to(idt), n_used.to(idt)], dim=1)


def compute_block(gn: torch.Tensor, eg: torch.Tensor, maf: torch.Tensor,
                  sidx: torch.Tensor, ignore_miss_data: bool):
    """gn (S, I, 3), eg (S, I), maf (S,) device tables; sidx (2, P) int32
    -> fmat (P, 5) = [r2p, f0..f3] in the EM dtype, imat (see _imat)."""
    s1, s2 = sidx[0].long(), sidx[1].long()
    r2p = pearson_r2(eg.index_select(0, s1), eg.index_select(0, s2))
    f, n_iter, n_used = pair_em_gather(gn, sidx, maf, ignore_miss_data)
    fmat = torch.cat([r2p[:, None].to(f.dtype), f], dim=1)
    return fmat, _imat(n_iter, n_used, ignore_miss_data, gn.shape[1])
