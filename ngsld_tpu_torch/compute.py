"""Device steps of the sweep (ngsld_tpu/compute.py): the gathered-pair
block step (:14-28, 64-123), with the ladder that picks its EM kernel by
cohort size (:99-117), and the strip-chunk steps (:139-172). On several
devices (--shard, :125-136 and :174-208) each 'pairs' row runs the same
steps on its share of a block's pairs or of a chunk's tiles
(split_bounds, strip_shares); --shard_ind's steps are in parallel/.

The site tables stay on the device; per block only the (2, P) index (or
the chunk's tile list and sel) crosses over, and only (r2p, hap freqs)
plus int metadata come back. The other columns (D, D', r2, hap MAFs, chi2)
derive on the host (hostcols._stats_host/_chi2_host).

The Pearson r2 step of compute_block records one span `compute: r2p` a
block into the RunLog that step_log sets for the calling thread (a
torch.profiler range of that name while a profiler runs, over the card
kernels it launches)."""

from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch

from .kernels.pair_em import GATHER_KERNELS, pick_gather_kernel
from .kernels.strip_em import strip_em_compact, strip_em_flat
from .ops.stats import pearson_r2
from .plan.strips import TA, TB


# bytes of one gathered E[G] operand of the Pearson r2 step
_R2P_BYTES = 1 << 28

# the RunLog of the calling thread's compute_block calls (step_log)
_STEP_LOG = contextvars.ContextVar("ngsld_step_log", default=None)


@contextlib.contextmanager
def step_log(log):
    """compute_block calls inside record their r2 step's span into log
    (the calling thread's; the step's five arguments stay as they are,
    since ldbench's fault checks put a function of those five in its
    place)."""
    token = _STEP_LOG.set(log)
    try:
        yield
    finally:
        _STEP_LOG.reset(token)


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
    -> fmat (P, 5) = [r2p, f0..f3] in the EM dtype, imat (see _imat).

    The EM kernel follows the cohort size and the block's pair count
    (pick_gather_kernel): lane groups fed from a pair queue for small
    cohorts on large blocks, one block a pair with both rows in its shared
    memory up to the card's limit, a pair's rows held across a
    thread-block cluster beyond it, and streamed in chunks past the
    cluster's capacity."""
    s1, s2 = sidx[0].long(), sidx[1].long()
    log = _STEP_LOG.get()
    # Pearson r2 is row-wise: slices of pairs keep the two gathered (p, I)
    # operands bounded at large cohorts (one slice at I = 100)
    step = max(1, _R2P_BYTES // (eg.shape[1] * eg.element_size()))
    with (log.span("compute: r2p") if log is not None
          else contextlib.nullcontext()):
        r2p = torch.cat([pearson_r2(eg.index_select(0, s1[i:i + step]),
                                    eg.index_select(0, s2[i:i + step]))
                         for i in range(0, max(len(s1), 1), step)])
    rung = pick_gather_kernel(gn.shape[1], gn.element_size(), gn.device,
                              sidx.shape[1])
    f, n_iter, n_used = GATHER_KERNELS[rung](gn, sidx, maf, ignore_miss_data)
    fmat = torch.cat([r2p[:, None].to(f.dtype), f], dim=1)
    return fmat, _imat(n_iter, n_used, ignore_miss_data, gn.shape[1])


def strip_flat_fn(n_ind: int, ignore_miss: bool, use_i16: bool):
    """Flat cell-major strip step: the kernel's tile outputs relayout to
    dense (cells, 5)/(cells, k) rows with no device gather; the host
    applies the chunk's sel permutation in the pull stage. For chunks
    whose live-cell fraction is near 1."""
    return functools.partial(strip_em_flat, n_ind=n_ind,
                             ignore_miss=ignore_miss, use_i16=use_i16,
                             slim_im=not ignore_miss)


def strip_compute_fn(n_ind: int, ignore_miss: bool, use_i16: bool):
    """Compacted strip step: the tile kernel, then the sel gather on the
    device, so only the chunk's live rows come back."""
    return functools.partial(strip_em_compact, n_ind=n_ind,
                             ignore_miss=ignore_miss, use_i16=use_i16,
                             slim_im=not ignore_miss)


def split_bounds(n: int, parts: int) -> list:
    """Contiguous shares of n items over `parts` rows, in row order: row p
    takes [bounds[p], bounds[p + 1])."""
    return [n * p // parts for p in range(parts + 1)]


def strip_shares(n_tiles: int, sel: np.ndarray, parts: int) -> list:
    """A strip chunk's tiles split over `parts` rows (split_bounds): for
    each row (t0, t1, pos, sel_loc), pos the places in sel of the cells
    that fall in its tiles, sel_loc those cells' flat indices among its
    own tiles. Each row compacts its own tiles' cells, so no uncompacted
    tile leaves a device; rank 0 puts row p's rows at pos."""
    cells = TA * TB
    tile = sel // cells
    b = split_bounds(n_tiles, parts)
    out = []
    for p in range(parts):
        pos = np.flatnonzero((tile >= b[p]) & (tile < b[p + 1]))
        out.append((b[p], b[p + 1], pos,
                    (sel[pos] - b[p] * cells).astype(np.int32)))
    return out
