"""The strip step with the individual axis split over the ranks of a
'pairs' row (--shard_ind; ngsld_tpu/parallel/strip_ind.py:47-199).

The block engine's dense sweep computes rectangles of pairs, an anchor
tile of TA sites against a partner tile of TB, from contiguous slices of
the strip tables. Here each rank holds its slice of every site record
(the tables' individual axis cut into shard_ind parts, built with
i_align = 8 x shard_ind) and every per-individual reduction is one
all-reduce over the row: the r2p dot with n_used (one a batch of tiles),
then the EM's four sums once an iteration. f is the same on every rank of
the row, so the freeze and nIter decisions are too (the lockstep of
parallel.sweep, checked the same way).

Not a kernel port: the reference's step is XLA, since a collective cannot
run inside a Pallas kernel body. Tiles go through in batches whose
(tiles, TA, I/M, TB) f64 planes stay under _PLANE_BYTES, as the
reference's lax.map takes one tile at a time. An iteration computes
whole planes while more than 1/TAIL of a batch's cells run; the cells
still running then go on with their rows gathered (parallel.sweep's
em_loop), as the strip kernels reseat their running cells, instead of
whole planes for a few cells up to the cap. The EM, the r2p dot and the
n_used count run in f64 (torch.matmul on f64: TF32 cannot enter), f and
r2p come back in f32, as from the strip kernels.

Convergence follows the kernels and strict: the max |df| over the four
frequencies folds NaN away, so a cell with no usable individual
(--ignore_miss_data, x = 0) freezes at nIter 0 with NaN frequencies. The
reference step folds with jnp.max, which keeps the NaN, and runs such a
cell to the iteration cap.
"""

from __future__ import annotations

import torch

from ..constants import EPSILON, ITER_MAX
from ..kernels.strip_em import compact_tiles
from ..plan.strips import TA, TB
from .sweep import check_lockstep, em_loop

# bytes of one f64 (tiles, TA, I/M, TB) plane of a batch
_PLANE_BYTES = 1 << 27
# whole planes an iteration while more than 1/TAIL of a batch's cells
# (live or dead) run
TAIL = 2


def _is_miss(g0, g1, g2):
    return ((g0 - g1).abs() < EPSILON) & ((g1 - g2).abs() < EPSILON)


def _tile_step(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
               n_ind, i_start, ignore_miss, iter_cap, mesh):
    """One batch of tiles on this rank's individuals (ngsld_tpu's
    _tile_step over a batch). Individuals i_start + j >= n_ind are the
    tables' padding and count nowhere. Returns f (n, 4, TA, TB) f32, r2p
    (n, TA, TB) f32, n_iter, n_used (n, TA, TB) int32, the same on every
    rank of the row."""
    dev = ga.device
    f64 = torch.float64
    n, Ipl = ta.shape[0], ga.shape[2]
    ar = (ta.long() * TA)[:, None] + torch.arange(TA, device=dev)
    bc = (tb.long() * TB)[:, None] + torch.arange(TB, device=dev)
    # anchors (n, TA, Ipl, 1), partners (n, 1, Ipl, TB)
    x = [ga[c][ar][:, :, :, None].to(f64) for c in range(3)]
    y = [gb[c][:, bc].permute(1, 0, 2)[:, None].to(f64) for c in range(3)]
    real = (i_start + torch.arange(Ipl, device=dev)) < n_ind
    keep_x = real[None, None, :, None].expand(n, TA, Ipl, 1)
    keep_y = real[None, None, :, None].expand(n, 1, Ipl, TB)
    if ignore_miss:
        keep_x = keep_x & ~_is_miss(*x)
        keep_y = keep_y & ~_is_miss(*y)
    kx, ky = keep_x.to(f64), keep_y.to(f64)

    # one all-reduce: the r2p dot of the standardized tables (global
    # moments: strip_tables ran on the whole cohort before the cut) and
    # n_used, both local products summed over the row
    ea_t = ea[ar].to(f64)                                   # (n, TA, Ipl)
    eb_t = eb[:, bc].permute(1, 0, 2).to(f64)               # (n, Ipl, TB)
    red = mesh.all_reduce(torch.stack([
        torch.matmul(ea_t, eb_t),
        torch.matmul(kx[..., 0], ky[:, 0])]))
    corr, nu = red[0], red[1]
    r2p = (corr * corr).to(torch.float32)
    n_used = nu.round().to(torch.int32)
    inc = kx * ky                                           # (n,TA,Ipl,TB)
    inv_x = (1.0 / nu)[:, :, None, :]                       # (n,TA,1,TB)

    ma = maf_a[ar].to(f64)[:, :, None, None]
    mb = maf_b[bc].to(f64)[:, None, None, :]
    f = [(1 - ma) * (1 - mb), (1 - ma) * mb, ma * (1 - mb), ma * mb]
    f = [t.expand(n, TA, 1, TB) for t in f]
    bg = bc[:, None, :]
    active = ((bg >= lo[ar].long()[:, :, None])
              & (bg < hi[ar].long()[:, :, None])
              & (ok_a[ar] > 0)[:, :, None]
              & (ok_b[bc] > 0)[:, None, :])[:, :, None, :]  # (n,TA,1,TB)
    n_iter = torch.full((n, TA, 1, TB), iter_cap, dtype=torch.int32,
                        device=dev)
    n_act = int(active.sum())
    it = 0
    while it < iter_cap and n_act and TAIL * n_act > n * TA * TB:
        # D_k = sum_{a,b} f[2a+b] x[a1k+a] y[a2k+b], through
        # Q[a][c] = f[2a] y[c] + f[2a+1] y[c+1]
        q00 = f[0] * y[0] + f[1] * y[1]
        q01 = f[0] * y[1] + f[1] * y[2]
        q10 = f[2] * y[0] + f[3] * y[1]
        q11 = f[2] * y[1] + f[3] * y[2]
        D = [x[0] * q00 + x[1] * q10, x[0] * q01 + x[1] * q11,
             x[1] * q00 + x[2] * q10, x[1] * q01 + x[2] * q11]
        s = ((f[0] * D[0] + f[1] * D[1]) + f[2] * D[2]) + f[3] * D[3]
        r = inc / s             # masked reciprocal; excluded add 0
        S = torch.stack([(D[k] * r).sum(dim=2) for k in range(4)])
        buf = torch.cat([S.reshape(-1),
                         torch.tensor([float(n_act)], dtype=f64, device=dev)])
        mesh.all_reduce(buf)
        check_lockstep(buf, n_act, it, mesh)
        S = buf[:-1].view(4, n, TA, 1, TB)
        f_new = [f[k] * S[k] * inv_x for k in range(4)]
        norm = ((f_new[0] + f_new[1]) + f_new[2]) + f_new[3]
        f_next = [torch.where(active, f_new[k] / norm, f[k])
                  for k in range(4)]
        # NaN-ignoring max fold (`if (x > eps) eps = x`), as strict
        eps = torch.zeros_like(f_next[0])
        for k in range(4):
            d = (f_next[k] - f[k]).abs()
            eps = torch.where(d > eps, d, eps)
        newly = active & (eps < EPSILON)
        n_iter = torch.where(newly, torch.full_like(n_iter, it), n_iter)
        active = active & ~newly
        f = f_next
        n_act = int(active.sum())
        it += 1
    f_out = torch.stack([fk[:, :, 0, :] for fk in f], dim=1)  # (n,4,TA,TB)
    n_iter = n_iter[:, :, 0, :]
    if it < iter_cap and n_act:
        # the tail: the few cells still running go on with their rows
        # gathered (parallel.sweep's loop), as the strip kernels reseat
        # their running cells, instead of whole planes an iteration
        t, a, _, b = active.nonzero(as_tuple=True)
        sa, sb = ar[t, a], bc[t, b]
        gl1 = ga[:, sa, :].permute(1, 2, 0).to(f64)        # (p, Ipl, 3)
        gl2 = gb[:, :, sb].permute(2, 1, 0).to(f64)
        incf = (keep_x[t, a, :, 0] & keep_y[t, 0, :, b]).to(f64)
        f_c, it_c = em_loop(
            gl1, gl2, f_out[t, :, a, b], incf, inv_x[t, a, 0, b],
            torch.ones(len(t), dtype=torch.bool, device=dev), mesh, it0=it,
            iter_cap=iter_cap)
        f_out[t, :, a, b] = f_c
        n_iter[t, a, b] = it_c
    return f_out.to(torch.float32), r2p, n_iter, n_used


def strip_tiles_ind(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta,
                    tb, *, n_ind: int, i_start: int, mesh,
                    ignore_miss: bool = False, iter_cap: int = ITER_MAX):
    """strip_em's function on ('pairs', 'ind'): the tables hold this rank's
    individuals [i_start, i_start + Ipl) of the padded cohort; ta/tb are
    the row's tiles. Same outputs as strip_em, on every rank of the row."""
    Ipl = ga.shape[2]
    nb = max(1, _PLANE_BYTES // (8 * TA * TB * max(Ipl, 1)))
    outs = [_tile_step(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b,
                       ta[i:i + nb], tb[i:i + nb], n_ind, i_start,
                       ignore_miss, iter_cap, mesh)
            for i in range(0, ta.shape[0], nb)]
    if not outs:
        dev = ga.device
        return (torch.empty((0, 4, TA, TB), device=dev),
                torch.empty((0, TA, TB), device=dev),
                torch.empty((0, TA, TB), dtype=torch.int32, device=dev),
                torch.empty((0, TA, TB), dtype=torch.int32, device=dev))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(4))


def strip_compute_ind(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta,
                      tb, sel, *, n_ind: int, i_start: int, mesh,
                      ignore_miss: bool = False, use_i16: bool = True,
                      iter_cap: int = ITER_MAX):
    """strip_tiles_ind + the compaction of strip_em_compact: sel (C,)
    int32 flat indices into the row's (tiles, TA, TB) cells -> fm (C, 5)
    f32 and im (the strip step's layout). The counterpart of the
    reference's strip_compute_ind_fn for one row's share of a chunk."""
    f, r2p, nit, nu = strip_tiles_ind(
        ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
        n_ind=n_ind, i_start=i_start, mesh=mesh, ignore_miss=ignore_miss,
        iter_cap=iter_cap)
    return compact_tiles(f, r2p, nit, nu, sel, slim_im=not ignore_miss,
                         use_i16=use_i16, ignore_miss=ignore_miss)
