"""Ring banded sweep over a SITE-SHARDED table
(ngsld_tpu/parallel/ring.py).

The table is split into n_dev blocks of B sites, one a site block of the
mesh (parallel.mesh: rank r holds block r // shard_ind). At ring step t
the rank holding anchor block i computes the (B, B_sub) rectangle of
pairs between its resident block and a visiting partner sub-block:
sub-block si of block (i + t) mod n_dev, whose first site is

    org = ((i + t) % n_dev) * B + si * B_sub

(ring.py:113 of the reference). After each step the visiting state moves
one position along the ring (Mesh.ring_shift, the reference's ppermute
`nxt`): block i receives block i + 1's. On one device n_dev = 1, i = 0,
every sub-ring has one step (t = 0), the visiting state is a slice (a
view) of the resident tables, and nothing is exchanged.

Each step compacts on the device: the emission mask (_tile_mask: strict
upper triangle, real sites, MAF-ok anchor and partner, band limit,
--rnd_sample membership from a packed-bits plane) picks the live cells in
row-major (a, pj) order, and only their rows leave the device:
fm = [r2p, f0..f3] in the EM dtype and im = n_iter as int8 (or n_iter,
n_used under --ignore_miss_data), the layout of _device_compact. Three
steppers fill them:

  ring_sweep_stepper_strip  the strip kernels (kernels/strip_em.strip_em:
                            csrc/strip_em.cu, or csrc/strip_em_stream.cu
                            past the resident kernel's cohort limit) over
                            all tiles of the step, with the anchor tables
                            and the partner sub-block's tables apart and
                            the band bounds shifted to the sub-block
  ring_sweep_stepper        the step's live cells as gathered pairs,
                            through compute.compute_block in pieces of at
                            most --chunk_pairs, so the gather ladder
                            (pick_gather_kernel) picks pair_em.cu,
                            pair_em_rows.cu or pair_em_ichunk.cu for each
                            piece
  ring_sweep_stepper_ind    the same pairs through parallel.sweep.
                            compute_block_ind (--shard_ind: each rank
                            holds its slice of the cohort, one 'ind'
                            all-reduce an EM iteration; no kernel)

The gather kernels take one table and pair indices into it. Across
devices a step's partners are the visiting sub-block's rows, so the
resident tables of the gather steppers carry two visiting slots past the
block (rows [B, B + B_sub) and [B + B_sub, B + 2 B_sub)): each shift
receives into the slot that is idle, and a step's pairs are (a, row of
the visiting sub-block + p). On one device the visiting sub-block is a
slice of the resident rows and no slot is allocated.

ring_sweep is the reference's all-steps sweep (every statistic of every
(B, B) step tile; only tests use it, as in the reference). On CPU tensors
the kernels' plain versions run.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import compute
from ..hostcols import _chi2_host, _stats_host
from ..kernels.strip_em import _imat as _strip_imat
from ..kernels.strip_em import strip_em_compact
from ..plan.strips import TA, TB


def _shift(mesh, tensors, out=None, offset: int = 1) -> tuple:
    """The visiting state one (or `offset`) ring position on; the identity
    on one device (no mesh)."""
    if mesh is None:
        return tuple(tensors)
    return mesh.ring_shift(tensors, offset, out)


def _block(mesh) -> int:
    """This rank's site block (the reference's axis_index('sites'))."""
    return 0 if mesh is None else mesh.pi


def _unpack_bits(bytes_: torch.Tensor, area: int) -> torch.Tensor:
    """(4 * ceil(area / 32),) uint8 -> (area,) bool, little-endian bit
    order: the host's packing (np.packbits bitorder='little', shipped as
    the bytes of little-endian uint32 words) read back byte by byte, since
    uint32 has few operators on CUDA."""
    sh = torch.arange(8, dtype=torch.uint8, device=bytes_.device)
    b = ((bytes_[:, None] >> sh) & 1) != 0
    return b.reshape(-1)[:area]


def _tile_mask(i: int, t: int, si: int, cfg: dict, hi_loc: torch.Tensor,
               ok_loc: torch.Tensor, vok: torch.Tensor,
               bits: torch.Tensor | None) -> torch.Tensor:
    """The emission mask of one (B, B_sub) step tile, on the device: strict
    upper triangle, real sites, MAF-ok anchor AND partner, band limit,
    optional --rnd_sample membership from the packed `bits` plane. The
    visiting ok is the host's knife-edge-refined ok, never recomputed from
    the MAF here. Mirrors engine_ring's host_mask cell for cell (the host
    replays it for the (a, pj) labels)."""
    B, B_sub, n, n_dev = cfg["B"], cfg["B_sub"], cfg["n"], cfg["n_dev"]
    dev = hi_loc.device
    A = (i * B + torch.arange(B, dtype=torch.int64, device=dev))[:, None]
    org = ((i + t) % n_dev) * B + si * B_sub
    PJ = (org + torch.arange(B_sub, dtype=torch.int64, device=dev))[None, :]
    valid = (PJ > A) & (PJ < n) & (A < n)
    valid &= (ok_loc[:, None] > 0.0) & (vok[None, :] > 0.0)
    valid &= PJ < hi_loc[:, None]
    if cfg["sample"]:
        valid &= _unpack_bits(bits, B * B_sub).reshape(B, B_sub)
    return valid


def _imat(nit, nu, cfg):
    """int metadata of the compacted rows (kernels.strip_em._imat): (C, 1)
    int8 n_iter when n_used is the constant n_ind the host synthesizes,
    else (C, 2) int16 (int32 past 32,767 individuals)."""
    return _strip_imat(nit, nu, cfg["slim_im"], cfg["use_i16"],
                       not cfg["slim_im"])


def _device_compact(r2p, f, nit, nu, valid, cfg):
    """Row compaction of one (B, B_sub) step tile by its emission mask
    (_tile_mask): the surviving cells in row-major (a, pj) order ->
    (fm (cnt, 5) = [r2p, f0..f3], im (see _imat), cnt). The reference
    returns buffers of B * B_sub rows of which the host reads [:cnt]; here
    the buffers hold exactly cnt rows (torch.nonzero syncs, and the host
    pulls cnt at once anyway)."""
    idx = torch.nonzero(valid.reshape(-1)).squeeze(1)
    fm = torch.cat([r2p.reshape(-1)[idx][:, None],
                    f.reshape(-1, 4)[idx]], dim=1)
    im = _imat(nit.reshape(-1)[idx], nu.reshape(-1)[idx], cfg)
    return fm, im, int(idx.numel())


def ring_subblock_taker_strip(n_dev: int, n_sub: int, si: int,
                              offset: int = 0, mesh=None):
    """fn(gb, eb, maf, ok) -> the si-th B_sub-lane sub-block of the
    resident gb (3, Ip, S) / eb (Ip, S) strip tables plus the matching
    maf / ok slices, fast-forwarded `offset` ring positions (one
    ring_shift: checkpoint resume skips committed steps). On one device
    these are views and every offset lands on the resident block itself;
    across devices the sub-block's columns are copied to contiguous
    tensors first, since the visiting state rides the ring."""
    assert (mesh.shard if mesh is not None else 1) == n_dev

    def take(gb, eb, maf, ok):
        B_sub = gb.shape[2] // n_sub
        lo = si * B_sub
        out = (gb[:, :, lo:lo + B_sub], eb[:, lo:lo + B_sub],
               maf[lo:lo + B_sub], ok[lo:lo + B_sub])
        if n_dev == 1:
            return out
        return _shift(mesh, [t.contiguous() for t in out], offset=offset)

    return take


def ring_subblock_taker(n_dev: int, n_sub: int, si: int, offset: int = 0,
                        with_ok: bool = False, mesh=None):
    """fn(gn, eg, maf[, ok]) -> (vgn, veg, vmaf[, vok]): the si-th of n_sub
    equal sub-blocks of the resident rows, fast-forwarded `offset` ring
    positions, as views of the tables. with_ok adds the MAF-ok plane (the
    compacted steppers mask partner cells with the host's
    knife-edge-refined ok); its length is the block's, B. Across devices
    the tables hold two visiting slots past the block (the gather
    steppers' layout) and a fast-forwarded sub-block arrives in the first
    slot; the ok plane rides apart."""
    assert (mesh.shard if mesh is not None else 1) == n_dev

    def take(gn, eg, maf, ok=None):
        B = gn.shape[0] if n_dev == 1 else ok.shape[0]
        B_sub = B // n_sub
        lo = si * B_sub
        out = (gn[lo:lo + B_sub], eg[lo:lo + B_sub], maf[lo:lo + B_sub])
        if with_ok:
            out = out + (ok[lo:lo + B_sub],)
        if n_dev == 1 or offset % n_dev == 0:
            return out
        assert with_ok and gn.shape[0] == B + 2 * B_sub
        slot = (gn[B:B + B_sub], eg[B:B + B_sub], maf[B:B + B_sub],
                torch.empty_like(out[3]))
        return _shift(mesh, out, slot, offset)

    return take


def ring_sweep_stepper_strip(n_ind: int, B: int, B_sub: int,
                             ignore_miss_data: bool, compact_cfg: dict,
                             mesh=None):
    """The strip-kernel stepper, compacted form:
    fn(ga, ea, hi_g, ok_g, maf, vgb, veb, vmafb, vokb, t, si[, bits])
    -> ((fm, im, cnt), vgb', veb', vmafb', vokb').

    ga (3, B, Ip) / ea (B, Ip) are the resident anchor tables, vgb
    (3, Ip, B_sub) / veb (Ip, B_sub) the visiting partner sub-block's
    (ring_subblock_taker_strip); hi_g / ok_g / maf (B,) the anchors' band
    limit, ok and MAF, vmafb / vokb (B_sub,) the partners'. All nk x nj
    tiles of the step run in one strip_em launch with the bounds shifted
    to the sub-block, lo = a + 1 - org and hi = hi_g - org for the global
    anchor a (lo goes negative and hi past B_sub or below 0: the kernel
    compares them with the partner's lane, so such bounds only widen or
    empty a row). The step's live cells map straight to their (tile,
    cell) place in the kernel's output (the sel of strip_em_compact), so
    rows come back in row-major (a, pj) order with no full-rectangle
    relayout. Values are f32 (the strip tables' dtype). The primed
    visiting state is the next ring position's (the same tensors on one
    device). B % TA == 0 and B_sub % TB == 0 (the engine rounds)."""
    n_dev = compact_cfg["n_dev"]
    i = _block(mesh)
    assert B % TA == 0 and B_sub % TB == 0, (B, B_sub)
    nk, nj = B // TA, B_sub // TB
    cells = TA * TB

    def step(ga, ea, hi_g, ok_g, maf, vgb, veb, vmafb, vokb, t, si,
             bits=None):
        dev = ga.device
        ta = torch.arange(nk, dtype=torch.int32, device=dev) \
            .repeat_interleave(nj)
        tb = torch.arange(nj, dtype=torch.int32, device=dev).repeat(nk)
        org = ((i + t) % n_dev) * B + si * B_sub
        lo = torch.arange(i * B + 1, i * B + B + 1, dtype=torch.int32,
                          device=dev) - org
        hi = hi_g - org
        valid = _tile_mask(i, t, si, compact_cfg, hi_g, ok_g, vokb, bits)
        idx = torch.nonzero(valid.reshape(-1)).squeeze(1)
        del valid
        a, p = idx // B_sub, idx % B_sub
        sel = (((a // TA) * nj + p // TB) * cells
               + (a % TA) * TB + p % TB).to(torch.int32)
        del idx, a, p
        fm, im = strip_em_compact(
            ga, vgb, ea, veb, maf, vmafb, lo, hi, ok_g, vokb, ta, tb, sel,
            n_ind=n_ind, ignore_miss=ignore_miss_data,
            use_i16=compact_cfg["use_i16"], slim_im=compact_cfg["slim_im"])
        nxt = _shift(mesh, (vgb, veb, vmafb, vokb))
        return ((fm, im, int(sel.numel())), *nxt)

    return step


def _row_of(view: torch.Tensor, table: torch.Tensor) -> int:
    """The table row where `view` (a slice of the table's rows) starts."""
    assert view.untyped_storage().data_ptr() == \
        table.untyped_storage().data_ptr()
    return (view.storage_offset() - table.storage_offset()) \
        // table.stride(0)


def _gather_stepper(pieces, chunk_pairs: int, cfg: dict, mesh):
    """The step body both gather steppers share: the step's live cells
    (_tile_mask, row-major (a, pj) order, the order _device_compact
    gives) as pairs (anchor row, visiting row) of the resident tables,
    through pieces(gn, eg, maf, sidx) -> (fm, im) in pieces of at most
    chunk_pairs; then the visiting state moves one ring position, into
    the idle visiting slot."""
    B, B_sub, n_dev = cfg["B"], cfg["B_sub"], cfg["n_dev"]
    i = _block(mesh)
    chunk_pairs = max(1, int(chunk_pairs))

    def step(gn, eg, maf, hi_g, ok_g, vgn, veg, vmaf, vok, t, si,
             bits=None):
        valid = _tile_mask(i, t, si, cfg, hi_g, ok_g, vok, bits)
        idx = torch.nonzero(valid.reshape(-1)).squeeze(1)
        del valid
        cnt = int(idx.numel())
        row0 = _row_of(vgn, gn)
        sidx = torch.stack([idx // B_sub, row0 + idx % B_sub]) \
            .to(torch.int32)
        del idx
        fms, ims = [], []
        for c0 in range(0, cnt, chunk_pairs):
            fm, im = pieces(gn, eg, maf,
                            sidx[:, c0:c0 + chunk_pairs].contiguous())
            fms.append(fm)
            ims.append(im)
        if not fms:
            fms = [torch.empty((0, 5), dtype=gn.dtype, device=gn.device)]
            ims = [_imat(torch.empty(0, dtype=torch.int32, device=gn.device),
                         torch.empty(0, dtype=torch.int32, device=gn.device),
                         cfg)]
        res = (torch.cat(fms), torch.cat(ims), cnt)
        if n_dev == 1:
            return (res, vgn, veg, vmaf, vok)
        dst = B + B_sub if row0 == B else B
        nxt = _shift(mesh, (vgn, veg, vmaf, vok),
                     (gn[dst:dst + B_sub], eg[dst:dst + B_sub],
                      maf[dst:dst + B_sub], torch.empty_like(vok)))
        return (res, *nxt)

    return step


def ring_sweep_stepper(ignore_miss_data: bool, chunk_pairs: int,
                       compact_cfg: dict, mesh=None):
    """The gather stepper, compacted form, for f64 and for any run off the
    strip kernel:
    fn(gn, eg, maf, hi_g, ok_g, vgn, veg, vmaf, vok, t, si[, bits])
    -> ((fm, im, cnt), vgn', veg', vmaf', vok').

    The reference computes the step as an XLA rectangle with a live mask;
    here the step's live cells become pairs of rows of the resident tables
    gn (rows, I, 3), eg (rows, I), maf (rows,) and run through
    compute.compute_block in pieces of at most chunk_pairs: the gather
    ladder picks each piece's kernel by its size, as in the block engine.
    fm is in the tables' dtype. The visiting sub-block (vgn, veg, vmaf)
    is a slice of those tables: of the resident rows on one device, where
    it stays in place; across devices one of the two visiting slots, and
    the primed state is the other slot, filled by the shift."""
    return _gather_stepper(
        lambda gn, eg, maf, sidx: compute.compute_block(
            gn, eg, maf, sidx, ignore_miss_data),
        chunk_pairs, compact_cfg, mesh)


def ring_sweep_stepper_ind(ignore_miss_data: bool, chunk_pairs: int,
                           compact_cfg: dict, mesh):
    """The ring stepper on a ('sites', 'ind') mesh (--shard_ind): the
    gather stepper's pairs and tables, with each rank's tables holding
    only its slice of the cohort, through parallel.sweep.compute_block_ind
    (the EM and Pearson sums all-reduced over the block's 'ind' group
    once an iteration, in f64, with its lockstep check; its stop folds
    |df| ignoring NaN, as strict does). Every rank of a block computes the
    same mask, so they run the same pieces in lockstep; the visiting
    slices ride the ring within each 'ind' column. Signature and results
    as ring_sweep_stepper's, equal on every rank of the block."""
    from .sweep import compute_block_ind
    return _gather_stepper(
        lambda gn, eg, maf, sidx: compute_block_ind(
            gn, eg, maf, sidx, ignore_miss_data, mesh),
        chunk_pairs, compact_cfg, mesh)


_STAT_KEYS = ("r2p", "f", "n_iter", "n_used", "hmaf1", "hmaf2",
              "D", "Dp", "r2", "chi2")


def _tile_stats(gn_a, eg_a, maf_a, gn_b, eg_b, maf_b,
                ignore_miss_data: bool, extend_out: bool) -> dict:
    """Every statistic of all Ba x Bb pairs between an anchor and a partner
    block (the reference's _tile_stats_fn): r2p, f, n_iter and n_used
    through compute.compute_block (the gather ladder), then hap MAFs, D,
    D', r2 and chi2 on the host columns, as hostcols derives them. Host
    arrays of shape (Ba, Bb), f (Ba, Bb, 4)."""
    Ba, Bb = gn_a.shape[0], gn_b.shape[0]
    dev = gn_a.device
    a = torch.arange(Ba, device=dev).repeat_interleave(Bb)
    b = Ba + torch.arange(Bb, device=dev).repeat(Ba)
    fm, im = compute.compute_block(
        torch.cat([gn_a, gn_b]), torch.cat([eg_a, eg_b]),
        torch.cat([maf_a, maf_b]), torch.stack([a, b]).to(torch.int32),
        ignore_miss_data)
    fm, im = fm.cpu().numpy(), im.cpu().numpy().astype(np.int32)
    f = fm[:, 1:]
    hmaf1, hmaf2, D, Dp, r2 = _stats_host(f)
    out = dict(r2p=fm[:, 0], f=f, n_iter=im[:, 0],
               n_used=(im[:, 1] if ignore_miss_data
                       else np.full(len(f), gn_a.shape[1], np.int32)),
               hmaf1=hmaf1, hmaf2=hmaf2, D=D, Dp=Dp, r2=r2,
               chi2=(_chi2_host(f) if extend_out
                     else np.zeros(len(f), np.float32)))
    return {k: v.reshape((Ba, Bb) + v.shape[1:]) for k, v in out.items()}


def ring_sweep(n_steps: int, ignore_miss_data: bool = False,
               extend_out: bool = True, mesh=None):
    """The all-steps ring sweep (the reference's ring_sweep): fn(gn, eg,
    maf) on this rank's resident block (B rows) -> {stat: (n_steps, B, B)
    host array} (f adds a trailing 4). Entry [t, a, o] is the pair (site
    a of this block, site o of block (i + t) mod n_dev), see
    partner_index; pairs with partner <= a at t == 0 duplicate the
    symmetric triangle, and callers mask them with out-of-band pairs.
    The whole partner block rides the ring, one shift a step."""

    def sweep(gn, eg, maf):
        vis = (gn, eg, maf)
        outs = []
        for t in range(n_steps):
            outs.append(_tile_stats(gn, eg, maf, *vis, ignore_miss_data,
                                    extend_out))
            if t + 1 < n_steps:
                vis = _shift(mesh, vis)
        return {k: np.stack([o[k] for o in outs]) for k in _STAT_KEYS}

    return sweep


def partner_index(t: int, a, block_size: int, n_sites: int):
    """Global site index of out[t, a, o]'s partner for o in [0, B): the
    sites of block (block(a) + t) mod n_blocks."""
    blk = (a // block_size + t) % (n_sites // block_size)
    return blk * block_size + np.arange(block_size)


def steps_for_band(hi, block_size: int) -> int:
    """Ring steps needed so every in-band pair (s1, s2 < hi[s1]) is covered:
    1 + max blocks spanned by any anchor's band."""
    n = len(hi)
    a = np.arange(n)
    span = np.maximum(hi - 1, a) // block_size - a // block_size
    return int(span.max()) + 1 if n else 1
