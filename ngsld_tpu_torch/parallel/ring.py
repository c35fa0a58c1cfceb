"""Ring banded sweep over a SITE-SHARDED table, on one device
(ngsld_tpu/parallel/ring.py).

At ring step t the device holding anchor block i computes the (B, B_sub)
rectangle of pairs between its resident block and a visiting partner
sub-block: sub-block si of block (i + t) mod n_dev, whose first site is

    org = ((i + t) % n_dev) * B + si * B_sub

(ring.py:113 of the reference). On one device n_dev = 1, so i = 0, every
sub-ring has one step (t = 0) and the visiting state is a slice (a view)
of the resident tables: it stays in place, and nothing is exchanged. The
exchange between devices is not ported; the takers and steppers refuse a
ring of more than one block.

Each step compacts on the device: the emission mask (_tile_mask: strict
upper triangle, real sites, MAF-ok anchor and partner, band limit,
--rnd_sample membership from a packed-bits plane) picks the live cells in
row-major (a, pj) order, and only their rows leave the device:
fm = [r2p, f0..f3] in the EM dtype and im = n_iter as int8 (or n_iter,
n_used under --ignore_miss_data), the layout of _device_compact. Two
steppers fill them:

  ring_sweep_stepper_strip  the strip kernels (kernels/strip_em.strip_em:
                            csrc/strip_em.cu, or csrc/strip_em_stream.cu
                            past the resident kernel's cohort limit) over
                            all tiles of the step, with the anchor tables
                            and the partner sub-block's tables apart and
                            the band bounds shifted to the sub-block
  ring_sweep_stepper        the step's live cells as gathered pairs of
                            global site indices, through compute.
                            compute_block in pieces of at most
                            --chunk_pairs, so the gather ladder
                            (pick_gather_kernel) picks pair_em.cu,
                            pair_em_rows.cu or pair_em_ichunk.cu for each
                            piece

On CPU tensors the kernels' plain versions run.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import compute
from ..kernels.strip_em import _imat as _strip_imat
from ..kernels.strip_em import strip_em_compact
from ..plan.strips import TA, TB


def _one_block(n_dev: int, what: str) -> None:
    if n_dev != 1:
        raise NotImplementedError(
            f"{what}: a ring of {n_dev} blocks needs the exchange between "
            "devices, which the torch engine does not have (one device)")


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
                              offset: int = 0):
    """fn(gb, eb, maf, ok) -> the si-th B_sub-lane sub-block of the
    resident gb (3, Ip, S) / eb (Ip, S) strip tables plus the matching
    maf / ok slices: views, no copies. `offset` fast-forwards the ring by
    that many positions; on one device every offset lands on the resident
    block itself."""
    _one_block(n_dev, "ring_subblock_taker_strip")
    assert offset % n_dev == 0

    def take(gb, eb, maf, ok):
        B_sub = gb.shape[2] // n_sub
        lo = si * B_sub
        return (gb[:, :, lo:lo + B_sub], eb[:, lo:lo + B_sub],
                maf[lo:lo + B_sub], ok[lo:lo + B_sub])

    return take


def ring_subblock_taker(n_dev: int, n_sub: int, si: int, offset: int = 0,
                        with_ok: bool = False):
    """fn(gn, eg, maf[, ok]) -> (vgn, veg, vmaf[, vok]): the si-th of n_sub
    equal sub-blocks of the resident rows, as views. with_ok adds the
    MAF-ok plane (the compacted steppers mask partner cells with the
    host's knife-edge-refined ok). `offset` as in
    ring_subblock_taker_strip."""
    _one_block(n_dev, "ring_subblock_taker")
    assert offset % n_dev == 0

    def take(gn, eg, maf, ok=None):
        B_sub = gn.shape[0] // n_sub
        lo = si * B_sub
        out = (gn[lo:lo + B_sub], eg[lo:lo + B_sub], maf[lo:lo + B_sub])
        if with_ok:
            out = out + (ok[lo:lo + B_sub],)
        return out

    return take


def ring_sweep_stepper_strip(n_ind: int, B: int, B_sub: int,
                             ignore_miss_data: bool, compact_cfg: dict):
    """The strip-kernel stepper, compacted form:
    fn(ga, ea, hi_g, ok_g, maf, vgb, veb, vmafb, vokb, t, si[, bits])
    -> ((fm, im, cnt), vgb, veb, vmafb, vokb).

    ga (3, S, Ip) / ea (S, Ip) are the resident anchor tables, vgb
    (3, Ip, B_sub) / veb (Ip, B_sub) the visiting partner sub-block's
    (ring_subblock_taker_strip); hi_g / ok_g / maf (S,) the anchors' band
    limit, ok and MAF, vmafb / vokb (B_sub,) the partners'. All nk x nj
    tiles of the step run in one strip_em launch with the bounds shifted
    to the sub-block, lo = a + 1 - org and hi = hi_g - org (lo goes
    negative and hi past B_sub or below 0: the kernel compares them with
    the partner's lane, so such bounds only widen or empty a row). The
    step's live cells map straight to their (tile, cell) place in the
    kernel's output (the sel of strip_em_compact), so rows come back in
    row-major (a, pj) order with no full-rectangle relayout. Values are
    f32 (the strip tables' dtype). The visiting state stays in place on
    one device. B % TA == 0 and B_sub % TB == 0 (the engine rounds)."""
    _one_block(compact_cfg["n_dev"], "ring_sweep_stepper_strip")
    assert B % TA == 0 and B_sub % TB == 0, (B, B_sub)
    nk, nj = B // TA, B_sub // TB
    cells = TA * TB

    def step(ga, ea, hi_g, ok_g, maf, vgb, veb, vmafb, vokb, t, si,
             bits=None):
        dev = ga.device
        ta = torch.arange(nk, dtype=torch.int32, device=dev) \
            .repeat_interleave(nj)
        tb = torch.arange(nj, dtype=torch.int32, device=dev).repeat(nk)
        org = ((0 + t) % compact_cfg["n_dev"]) * B + si * B_sub
        lo = (torch.arange(1, B + 1, dtype=torch.int32, device=dev) - org)
        hi = hi_g - org
        valid = _tile_mask(0, t, si, compact_cfg, hi_g, ok_g, vokb, bits)
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
        return (fm, im, int(sel.numel())), vgb, veb, vmafb, vokb

    return step


def ring_sweep_stepper(ignore_miss_data: bool, chunk_pairs: int,
                       compact_cfg: dict):
    """The gather stepper, compacted form, for f64 and for any run off the
    strip kernel:
    fn(gn, eg, maf, hi_g, ok_g, vgn, veg, vmaf, vok, t, si[, bits])
    -> ((fm, im, cnt), vgn, veg, vmaf, vok).

    The reference computes the step as an XLA rectangle with a live mask;
    here the step's live cells (_tile_mask, row-major (a, pj) order, the
    order _device_compact gives) become pairs of global site indices into
    the resident tables gn (S, I, 3), eg (S, I), maf (S,), and run through
    compute.compute_block in pieces of at most chunk_pairs: the gather
    ladder picks each piece's kernel by its size, as in the block engine.
    fm is in the tables' dtype. On one device the visiting sub-block is a
    slice of those tables; it rides along unchanged."""
    _one_block(compact_cfg["n_dev"], "ring_sweep_stepper")
    B, B_sub = compact_cfg["B"], compact_cfg["B_sub"]
    chunk_pairs = max(1, int(chunk_pairs))

    def step(gn, eg, maf, hi_g, ok_g, vgn, veg, vmaf, vok, t, si,
             bits=None):
        valid = _tile_mask(0, t, si, compact_cfg, hi_g, ok_g, vok, bits)
        idx = torch.nonzero(valid.reshape(-1)).squeeze(1)
        del valid
        cnt = int(idx.numel())
        org = ((0 + t) % compact_cfg["n_dev"]) * B + si * B_sub
        sidx = torch.stack([idx // B_sub, org + idx % B_sub]) \
            .to(torch.int32)
        del idx
        fms, ims = [], []
        for c0 in range(0, cnt, chunk_pairs):
            fm, im = compute.compute_block(
                gn, eg, maf, sidx[:, c0:c0 + chunk_pairs].contiguous(),
                ignore_miss_data)
            fms.append(fm)
            ims.append(im)
        if not fms:
            fms = [torch.empty((0, 5), dtype=gn.dtype, device=gn.device)]
            ims = [_imat(torch.empty(0, dtype=torch.int32, device=gn.device),
                         torch.empty(0, dtype=torch.int32, device=gn.device),
                         compact_cfg)]
        return ((torch.cat(fms), torch.cat(ims), cnt),
                vgn, veg, vmaf, vok)

    return step


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
