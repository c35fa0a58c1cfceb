"""Pearson r² of expected genotypes (ngsLD.cpp:365-367).

The LD statistics and chi² derive on the host from the EM frequencies
(ngsld_tpu.engine_block._stats_host/_chi2_host, reused unchanged)."""

from __future__ import annotations

import torch


def pearson_r2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Pearson correlation over individuals; x, y: (P, I).

    Two-pass mean-centred, as ngsld_tpu.ops.stats.pearson_r2. Element-wise
    products and sums only: no matmul, so TF32 cannot enter."""
    xc = x - x.mean(dim=1, keepdim=True)
    yc = y - y.mean(dim=1, keepdim=True)
    num = (xc * yc).sum(dim=1)
    den = torch.sqrt((xc * xc).sum(dim=1)) * torch.sqrt((yc * yc).sum(dim=1))
    r = num / den
    return r * r
