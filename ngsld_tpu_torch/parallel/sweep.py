"""The gathered-pair step with the individual axis split over the ranks of
a 'pairs' row (--shard_ind; ngsld_tpu/parallel/sweep.py:31-127, and the
block step around it, ngsld_tpu/compute.py:31-61).

Each rank of a row holds the same pairs and its own slice of the cohort.
Every per-individual reduction becomes one all-reduce over the row's
group: the Pearson sums with n_used (one), the centred moments (one), and
the EM's four sums once an iteration. The EM state f is the same on every
rank of the row, since every rank applies the same update to the same
all-reduced sums; so is the set of running pairs, from which each rank
decides alone whether to go on, and all stay in lockstep. Each
iteration's all-reduce also carries the rank's count of running pairs:
ranks that disagree raise instead of deadlocking.

Not a kernel port: the reference runs these steps in XLA, since a
collective cannot run inside a Pallas kernel body. As in every kernel of
the port, the EM (and here the Pearson moments) runs in f64 whatever the
table dtype, and f and r2p come back in the table dtype.
"""

from __future__ import annotations

import torch

from ..constants import EPSILON, ITER_MAX
from ..ops.em import em_apply, em_sums, nan_ignoring_eps
from ..ops.preprocess import miss_mask

# bytes of one gathered f64 (p, I/M, 3) operand: pairs go through in
# pieces this size bounds (the EM's temporaries are a few times it)
_PIECE_BYTES = 1 << 28


def em_loop(gl1, gl2, f, incf, inv_x, act, mesh, it0: int = 0,
            iter_cap: int = ITER_MAX):
    """The EM from iteration it0 on, for pairs whose rows are gathered
    here: this rank's individuals, the four sums all-reduced over the row
    once an iteration.

    gl1, gl2 (P, I_loc, 3) f64; f (P, 4) the state at it0; incf (P, I_loc)
    the inclusion mask as f64; inv_x (P,) 1/n_used of the row; act (P,)
    the pairs still running. Running pairs are packed together whenever at
    most half the working set still runs (a pair's sums do not depend on
    which others share the pass). Returns (f, n_iter (P,) int32: the
    iteration a pair stopped at, iter_cap for the pairs that never did)."""
    dt = gl1.dtype
    P = gl1.shape[0]
    dev = gl1.device
    f = f.clone()
    n_iter = torch.full((P,), iter_cap, dtype=torch.int32, device=dev)
    idx = torch.arange(P, device=dev)
    w = (gl1, gl2, incf, inv_x, f)
    n_act = int(act.sum())
    it = it0
    while it < iter_cap and n_act:
        if 2 * n_act <= idx.numel():
            f[idx] = w[4]
            keep = act.nonzero().squeeze(1)
            idx, act = idx[keep], act[keep]
            w = tuple(t[keep] for t in w)
        gw1, gw2, incw, invw, fw = w
        S = torch.stack(em_sums(fw, gw1, gw2, incw), dim=1)       # (p, 4)
        buf = torch.cat([S.reshape(-1),
                         torch.tensor([float(n_act)], dtype=dt, device=dev)])
        mesh.all_reduce(buf)
        check_lockstep(buf, n_act, it, mesh)
        S = buf[:-1].view(-1, 4)
        f_new = em_apply(fw, [S[:, k] for k in range(4)], invw)
        f_next = torch.where(act[:, None], f_new, fw)
        newly = act & (nan_ignoring_eps(f_next, fw) < EPSILON)
        n_iter[idx[newly]] = it
        act = act & ~newly
        w = (gw1, gw2, incw, invw, f_next)
        n_act = int(act.sum())
        it += 1
    f[idx] = w[4]
    return f, n_iter


def check_lockstep(buf, n_act: int, it: int, mesh) -> None:
    """buf's last entry is the row's sum of each rank's running count: all
    ranks of the row must run the same pairs (or cells) at iteration it,
    else they would wait on each other's next all-reduce forever."""
    if int(buf[-1]) != mesh.shard_ind * n_act:
        raise RuntimeError(
            f"rank {mesh.rank}: the ranks of its row left lockstep at EM "
            f"iteration {it} ({n_act} running here, {int(buf[-1])} summed "
            f"over {mesh.shard_ind} ranks)")


def _pair_em_shard(gl1, gl2, f0, include, n_used, mesh, live=None):
    """EM on this rank's individuals, the sums all-reduced over the row
    (em_loop from iteration 0). gl1, gl2 (P, I_loc, 3) f64; f0 (P, 4);
    include (P, I_loc) bool; n_used (P,) the row's total. Pairs outside
    `live` freeze at f0 with n_iter ITER_MAX. Returns (f, n_iter)."""
    dt = gl1.dtype
    act = (torch.ones(gl1.shape[0], dtype=torch.bool, device=gl1.device)
           if live is None else live.clone())
    return em_loop(gl1, gl2, f0, include.to(dt), 1.0 / n_used.to(dt), act,
                   mesh)


def _pearson_shard(x, y, sums, mesh):
    """Pearson r^2 with the individual axis split over the row: two-pass
    moments. `sums` holds the all-reduced (sum x, sum y) and the cohort
    size; one more all-reduce adds up the centred moments."""
    P = x.shape[0]
    n = sums[-1]
    mx, my = sums[:P] / n, sums[P:2 * P] / n
    xc = x - mx[:, None]
    yc = y - my[:, None]
    mom = mesh.all_reduce(torch.cat([(xc * yc).sum(dim=1),
                                     (xc * xc).sum(dim=1),
                                     (yc * yc).sum(dim=1)]))
    sxy, sxx, syy = mom[:P], mom[P:2 * P], mom[2 * P:]
    r = sxy / (torch.sqrt(sxx) * torch.sqrt(syy))
    return r * r


def sweep_step(gn1, gn2, eg1, eg2, maf1, maf2, ignore_miss_data: bool,
               mesh):
    """One piece of pairs on this rank's individuals: gn (P, I_loc, 3),
    eg (P, I_loc), maf (P,) -> (r2p (P,) f64, f (P, 4) f64, n_iter (P,)
    int32, n_used (P,) int32), equal on every rank of the row. The other
    columns (D, D', r2, hap MAFs, chi2) derive on the host."""
    f64 = torch.float64
    gl1, gl2 = gn1.to(f64), gn2.to(f64)
    m1, m2 = maf1.to(f64), maf2.to(f64)
    f0 = torch.stack([(1 - m1) * (1 - m2), (1 - m1) * m2,
                      m1 * (1 - m2), m1 * m2], dim=1)
    if ignore_miss_data:
        include = ~(miss_mask(gl1) | miss_mask(gl2))
    else:
        include = torch.ones(gl1.shape[:2], dtype=torch.bool,
                             device=gl1.device)
    x, y = eg1.to(f64), eg2.to(f64)
    P, I_loc = x.shape
    # one all-reduce for the Pearson sums, n_used and the cohort size;
    # Pearson uses every individual, missing ones included (ngsLD.cpp:290)
    s1 = mesh.all_reduce(torch.cat([
        x.sum(dim=1), y.sum(dim=1), include.sum(dim=1).to(f64),
        torch.tensor([float(I_loc)], dtype=f64, device=x.device)]))
    n_used = s1[2 * P:3 * P].round().to(torch.int32)
    r2p = _pearson_shard(x, y, torch.cat([s1[:2 * P], s1[-1:]]), mesh)
    f, n_iter = _pair_em_shard(gl1, gl2, f0, include, n_used, mesh)
    return r2p, f, n_iter, n_used


def compute_block_ind(gn, eg, maf, sidx, ignore_miss_data: bool, mesh):
    """compute.compute_block on ('pairs', 'ind'): gn (S, I_loc, 3) and eg
    (S, I_loc) hold this rank's slice of the cohort, maf (S,) the whole
    table's; sidx (2, P) int32 is the row's piece of the block. Pairs go
    through in pieces that bound the gathered (p, I_loc, 3) operands (the
    reference gathers the whole block at once). Returns fmat (P, 5) and
    imat as compute_block does, on every rank of the row."""
    from ..compute import _imat
    dt = gn.dtype
    I_loc = gn.shape[1]
    P = sidx.shape[1]
    step = max(1, _PIECE_BYTES // (I_loc * 3 * 8))
    fms, its, nus = [], [], []
    for i in range(0, P, step):
        s1, s2 = sidx[0, i:i + step].long(), sidx[1, i:i + step].long()
        r2p, f, n_iter, n_used = sweep_step(
            gn.index_select(0, s1), gn.index_select(0, s2),
            eg.index_select(0, s1), eg.index_select(0, s2),
            maf.index_select(0, s1), maf.index_select(0, s2),
            ignore_miss_data, mesh)
        fms.append(torch.cat([r2p[:, None], f], dim=1).to(dt))
        its.append(n_iter)
        nus.append(n_used)
    if not fms:
        fms = [torch.empty((0, 5), dtype=dt, device=gn.device)]
        its = nus = [torch.empty(0, dtype=torch.int32, device=gn.device)]
    return torch.cat(fms), _imat(torch.cat(its), torch.cat(nus),
                                 ignore_miss_data,
                                 I_loc * mesh.shard_ind)
