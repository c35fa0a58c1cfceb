"""Two-phase strip sweep: a capped rectangle, then the survivors pair by
pair (the reference package's dev/strip_twophase.py::strip_em_twophase).

Phase A runs strip_em (csrc/strip_em.cu) on the chunk's tiles to cap1
iterations with the eps export. The live rows still running at cap1 (the
survivors) are compacted on the device in sel's order, up to surv_cap of
them. Phase B finishes them in pair_em_gather (csrc/pair_em.cu's option
path) on their sites, warm from phase A's f and capped at iter_cap - cap1,
the pair queue ordered hardest first by kernels.pair_em.phase2_order's
predictor on phase A's eps. Their f and n_iter are scattered back into the
rows.

What is kept of the reference's contract: rows that stopped in phase A are
bit-equal to strip_em_compact's (their whole run is phase A's). Survivors
resume from phase A's float f in a kernel whose sums run in another order,
so they land within the cross-kernel contract (f within 5e-5, nIter within
+/-1 on more than 95%) instead of bit-matching. n_surv > surv_cap is an
overflow: the rows past the first surv_cap survivors then hold phase A's
state, and the caller must redo the chunk in one phase (the reference's
protocol). The engine's strip sweep runs one phase only; this function
is measured against it by chip_smoke.py phase 11c.
"""

from __future__ import annotations

import torch

from ..constants import ITER_MAX
from ..plan.strips import TA, TB
from .pair_em import pair_em_gather, phase2_order
from .strip_em import _imat, strip_em


def strip_em_twophase(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta,
                      tb, sel, n_live, *, n_ind: int, cap1: int = 30,
                      surv_cap: int = 65536, iter_cap: int = ITER_MAX,
                      ignore_miss: bool = False, use_i16: bool = True,
                      slim_im: bool = False, ta_sz: int = TA, tb_sz: int = TB):
    """strip_em_compact's rows (fm (C, 5) f32 = [r2p, f00, f01, f10, f11]
    and im, see strip_em._imat) through two phases, and n_surv (int), the
    survivors of phase A.

    The arguments up to sel are strip_em_compact's; n_live: the rows of sel
    that are live pairs (the rest are padding and stay at phase A's
    state). Phase B reads the survivors' rows of the strip tables, as the
    reference does."""
    if not 0 < cap1 < iter_cap:
        raise ValueError(f"cap1 must lie in (0, iter_cap = {iter_cap}), got "
                         f"{cap1}")
    if surv_cap < 0:
        raise ValueError(f"surv_cap must be >= 0, got {surv_cap}")
    f, r2p, nit, nu, epsl, epsp = strip_em(
        ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
        n_ind=n_ind, iter_cap=cap1, ignore_miss=ignore_miss, ta_sz=ta_sz,
        tb_sz=tb_sz, want_eps=True)
    n, dev = ta.shape[0], ga.device
    cells = ta_sz * tb_sz
    sel = sel.long()
    C = sel.shape[0]
    fc = f.view(n, 4, cells)[sel // cells, :, sel % cells].double()
    r2c = r2p.reshape(-1).index_select(0, sel)
    nitc = nit.reshape(-1).index_select(0, sel)
    nuc = nu.reshape(-1).index_select(0, sel)

    live = torch.arange(C, device=dev) < n_live
    surv = torch.nonzero((nitc == cap1) & live).squeeze(1)  # in sel's order
    n_surv = int(surv.numel())
    surv = surv[:surv_cap]
    if surv.numel():
        cs = sel.index_select(0, surv)
        surv = surv.index_select(0, phase2_order(
            epsl.reshape(-1)[cs].double(), epsp.reshape(-1)[cs].double()))
        cs = sel.index_select(0, surv)
        tile, cell = cs // cells, cs % cells
        s1 = ta.long()[tile] * ta_sz + cell // tb_sz
        s2 = tb.long()[tile] * tb_sz + cell % tb_sz
        # the survivors' anchor rows, then their partner rows, as a site
        # table of 2 P records (pad individuals left out)
        table = torch.cat([ga[:, s1, :n_ind].permute(1, 2, 0),
                           gb[:, :n_ind, s2].permute(2, 1, 0)])
        P = len(cs)
        sidx = torch.arange(2 * P, device=dev, dtype=torch.int32).view(2, P)
        # the MAFs are not read: every pair starts from f0
        maf = torch.zeros(table.shape[0], dtype=table.dtype, device=dev)
        fB, itB, _ = pair_em_gather(table.contiguous(), sidx, maf,
                                    ignore_miss, iter_cap=iter_cap - cap1,
                                    f0=fc.index_select(0, surv))
        fc = fc.index_copy(0, surv, fB)
        nitc = nitc.index_copy(0, surv, cap1 + itB)
    fm = torch.cat([r2c[:, None], fc.float()], dim=1)
    return fm, _imat(nitc, nuc, slim_im, use_i16, ignore_miss), n_surv
