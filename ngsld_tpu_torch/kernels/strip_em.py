"""Strip-tile EM: tables, the CUDA kernel's wrapper, its plain version and
the two emission epilogues (ngsld_tpu/kernels/pallas_strip.py).

A tile is a rectangle of pairs, anchors [ta*TA, (ta+1)*TA) x partners
[tb*TB, (tb+1)*TB), computed from contiguous slices of the strip tables
(no gathers). strip_em runs a list of tiles. On CUDA tensors it launches
a kernel or raises: csrc/strip_em.cu (the port of
pallas_strip._strip_kernel; a block's strips stay in shared memory, as
doubles, for the whole run), or, when strip_streamed(n_ind) says so,
csrc/strip_em_stream.cu (the port of pallas_strip._strip_ichunk_kernel;
the individual axis streams through shared memory in chunks, and the
tables must be padded to the chunk: strip_tables(i_align=
strip_i_align(n_ind))). Both kernels share their block body
(csrc/strip_core.cuh): every ROUND_ITERS (ROUND_ITERS_STREAM) iterations
a block seats the cells still running over all its lanes again. On CPU
tensors strip_em runs the matching plain PyTorch version, strip_em_ref or
strip_em_stream_ref. LAUNCHES and LAUNCHES_STREAM count the two kernels'
launches, nothing else (LAUNCHES_EPS those of strip_em.cu that took the
eps export). NGSLD_STRIP_STREAM=1 forces the streamed kernel at
any cohort size and NGSLD_STRIP_IC sets its chunk (the reference package's
test knobs). strip_em(want_eps=True) also returns each cell's last two
update magnitudes (pallas_strip._strip_kernel's want_eps), from the
resident kernel only, as in the reference.

Per cell (a, b): live iff lo[a] <= b < hi[a] and both sites ok. Live
cells run the two-locus EM of ops/em.py to their own convergence; dead
cells keep the f0 init and n_iter == iter_cap. Every cell gets r2p, the
squared dot of the standardized E[G] rows, and n_used. As in
kernels/pair_em.py the tables and outputs are f32 while the EM arithmetic
(and the r2p dot) runs in f64: an f32 EM stops one iteration away from the
f64 reference wherever eps lands within f32 rounding of EPSILON.
"""

from __future__ import annotations

import os

import torch

from ..constants import EPSILON, ITER_MAX
from ..plan.strips import TA, TB
from .build import smem_limits

LAUNCHES = 0          # csrc/strip_em.cu
LAUNCHES_STREAM = 0   # csrc/strip_em_stream.cu
LAUNCHES_EPS = 0      # csrc/strip_em.cu, its eps-export instance

# individuals per staged chunk of the streamed kernel
IC_STREAM = 64
# iterations between two repacks of a block's running cells over its
# lanes: the resident kernel, and the streamed one (whose iterations are
# long against a repack)
ROUND_ITERS = 2
ROUND_ITERS_STREAM = 1
# anchors of a block's sub-tile (x 32 partners): resident, streamed
_ROWS, _ROWS_STREAM = 8, 16

# plain version: tiles per batch are bounded so that one f64
# (tiles, TA, I, TB) plane stays under this many bytes
_REF_PLANE_BYTES = 1 << 27


def strip_tables(gn: torch.Tensor, eg: torch.Tensor, n_ind: int,
                 i_align: int = 8):
    """Build the strip tables from the engine's site-major arrays
    (pallas_strip.strip_tables).

    gn (S, I, 3) normal-space GLs -> ga (3, S, Ip) + gb (3, Ip, S); padded
    individuals hold the uniform 1/3 record (never counted: the EM and
    n_used stop at n_ind). eg (S, I) expected genotypes -> standardized
    tables ea (S, Ip), eb (Ip, S) carrying (e - mean)/(sqrt(n)*sd), so a
    pair's Pearson r2 is the squared dot product; zero-variance sites
    produce inf/NaN exactly like the two-pass formula's 0-division."""
    S, I, _ = gn.shape
    assert I == n_ind, (I, n_ind)   # cross-check the caller's cohort size
    Ip = -(-I // i_align) * i_align
    g = torch.nn.functional.pad(gn.to(torch.float32), (0, 0, 0, Ip - I),
                                value=1.0 / 3.0)
    ga = g.permute(2, 0, 1).contiguous()
    gb = g.permute(2, 1, 0).contiguous()
    e = eg.to(torch.float32)
    c = e - e.mean(dim=1, keepdim=True)
    ss = (c * c).sum(dim=1, keepdim=True)
    et = torch.nn.functional.pad(c / torch.sqrt(ss), (0, Ip - I))
    return ga, gb, et, et.t().contiguous()


def _ic_stream() -> int:
    return int(os.environ.get("NGSLD_STRIP_IC", IC_STREAM))


def strip_smem(n_ind: int, streamed: bool = False,
               want_eps: bool = False) -> int:
    """Bytes of shared memory a block of the resident kernel needs for a
    cohort of n_ind, or of the streamed kernel for a chunk of n_ind
    (csrc/strip_core.cuh::strip_smem_bytes): an individual's record of
    3 planes x (rows + 32) + 1 doubles (streamed: two buffers of a chunk
    and the next chunk's floats), and per cell four frequencies, n_used
    and a list entry (with the eps export, two floats more), plus two
    counts (streamed: and a mask) a warp."""
    rows = _ROWS_STREAM if streamed else _ROWS
    rec = (3 * (rows + 32) + 1) * 8
    per_ind = 2 * rec + 3 * (rows + 32) * 4 if streamed else rec
    return (per_ind * n_ind + rows * 32 * (32 + 4 + 2 + (8 if want_eps else 0))
            + (3 if streamed else 2) * rows * 4)


def strip_streamed(n_ind: int, device="cpu") -> bool:
    """Whether strip_em takes the streamed kernel for this cohort: when a
    block's strips for the whole cohort (strip_smem) no longer fit the
    shared memory a block may opt into (beyond 230 individuals on an H100;
    the CPU path assumes that card). NGSLD_STRIP_STREAM=1 forces it at any
    cohort size."""
    if os.environ.get("NGSLD_STRIP_STREAM") == "1":
        return True
    return strip_smem(n_ind) > smem_limits(device)[1]


def strip_i_align(n_ind: int, device="cpu") -> int:
    """Individual-axis padding quantum strip_tables must use so the tables
    match the kernel strip_em will pick for this cohort size."""
    return _ic_stream() if strip_streamed(n_ind, device) else 8


def _is_miss(g0, g1, g2):
    return ((g0 - g1).abs() < EPSILON) & ((g1 - g2).abs() < EPSILON)


def _ref_batch(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
               I, iter_cap, ignore_miss, ta_sz, tb_sz, i_chunk=None,
               want_eps=False):
    """Plain EM for one batch of tiles, on (n, TA, chunk, TB) broadcasts:
    the whole cohort at once (i_chunk None), or chunk after chunk of
    i_chunk individuals with the sums carried across, as the streamed
    kernel walks them. want_eps: also each cell's last two update
    magnitudes (1 until the cell runs, unchanged once it stops)."""
    dev = ga.device
    f64 = torch.float64
    n = ta.shape[0]
    ar = (ta.long() * ta_sz)[:, None] + torch.arange(ta_sz, device=dev)
    bc = (tb.long() * tb_sz)[:, None] + torch.arange(tb_sz, device=dev)
    # anchors (n, TA, I, 1), partners (n, 1, I, TB), real individuals only
    x = [ga[c][ar][:, :, :I, None].to(f64) for c in range(3)]
    y = [gb[c][:I][:, bc].permute(1, 0, 2)[:, None].to(f64)
         for c in range(3)]
    Ip = ga.shape[2]
    chunks = [(c0, min(c0 + (i_chunk or I), I))
              for c0 in range(0, I, i_chunk or I)]
    ea_t, eb_t = ea[ar].to(f64), eb[:, bc].permute(1, 0, 2).to(f64)
    corr = None
    for c0 in range(0, Ip, i_chunk or Ip):
        part = torch.matmul(ea_t[:, :, c0:c0 + (i_chunk or Ip)],
                            eb_t[:, c0:c0 + (i_chunk or Ip)])
        corr = part if corr is None else corr + part
    r2p = (corr * corr).to(torch.float32)

    if ignore_miss:
        # per side; a chunk's (n, TA, chunk, TB) inclusion is their product
        keep_x, keep_y = ~_is_miss(*x), ~_is_miss(*y)
        n_used = sum((keep_x[:, :, c0:c1] & keep_y[:, :, c0:c1]).sum(dim=2)
                     for c0, c1 in chunks).to(torch.int32)
    else:
        n_used = torch.full((n, ta_sz, tb_sz), I, dtype=torch.int32,
                            device=dev)
    inv_x = (1.0 / n_used.to(f64))[:, :, None, :]            # (n,TA,1,TB)

    ma = maf_a[ar].to(f64)[:, :, None, None]
    mb = maf_b[bc].to(f64)[:, None, None, :]
    f = [(1 - ma) * (1 - mb), (1 - ma) * mb, ma * (1 - mb), ma * mb]
    bg = bc[:, None, :]
    active = ((bg >= lo[ar].long()[:, :, None])
              & (bg < hi[ar].long()[:, :, None])
              & (ok_a[ar] > 0)[:, :, None]
              & (ok_b[bc] > 0)[:, None, :])[:, :, None, :]   # (n,TA,1,TB)
    n_iter = torch.full((n, ta_sz, 1, tb_sz), iter_cap, dtype=torch.int32,
                        device=dev)
    eps_last = torch.ones_like(f[0])
    eps_prev = torch.ones_like(eps_last)
    it = 0
    while it < iter_cap and bool(active.any()):
        S = [None] * 4
        for c0, c1 in chunks:
            xc = [t[:, :, c0:c1] for t in x]
            yc = [t[:, :, c0:c1] for t in y]
            # D_k = sum_{a,b} f[2a+b] x[a1k+a] y[a2k+b], through
            # Q[a][c] = f[2a] y[c] + f[2a+1] y[c+1]
            q00 = f[0] * yc[0] + f[1] * yc[1]
            q01 = f[0] * yc[1] + f[1] * yc[2]
            q10 = f[2] * yc[0] + f[3] * yc[1]
            q11 = f[2] * yc[1] + f[3] * yc[2]
            D = [xc[0] * q00 + xc[1] * q10, xc[0] * q01 + xc[1] * q11,
                 xc[1] * q00 + xc[2] * q10, xc[1] * q01 + xc[2] * q11]
            s = ((f[0] * D[0] + f[1] * D[1]) + f[2] * D[2]) + f[3] * D[3]
            # masked reciprocal; excluded individuals add 0
            r = (keep_x[:, :, c0:c1] & keep_y[:, :, c0:c1]).to(f64) / s \
                if ignore_miss else 1.0 / s
            for k in range(4):
                part = (D[k] * r).sum(dim=2, keepdim=True)
                S[k] = part if S[k] is None else S[k] + part
        f_new = [f[k] * S[k] * inv_x for k in range(4)]
        norm = ((f_new[0] + f_new[1]) + f_new[2]) + f_new[3]
        f_next = [torch.where(active, f_new[k] / norm, f[k])
                  for k in range(4)]
        # NaN-ignoring max fold (`if (x > eps) eps = x`); torch.maximum
        # would propagate NaN instead
        eps = torch.zeros_like(f[0])
        for k in range(4):
            d = (f_next[k] - f[k]).abs()
            eps = torch.where(d > eps, d, eps)
        if want_eps:
            eps_prev = torch.where(active, eps_last, eps_prev)
            eps_last = torch.where(active, eps, eps_last)
        newly = active & (eps < EPSILON)
        n_iter = torch.where(newly, torch.full_like(n_iter, it), n_iter)
        active = active & ~newly
        f = f_next
        it += 1
    f_out = torch.stack([fk[:, :, 0, :] for fk in f], dim=1)
    out = (f_out.to(torch.float32), r2p, n_iter[:, :, 0, :], n_used)
    if want_eps:
        out += tuple(e[:, :, 0, :].to(torch.float32)
                     for e in (eps_last, eps_prev))
    return out


def strip_em_ref(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
                 *, n_ind: int, iter_cap: int = ITER_MAX,
                 ignore_miss: bool = False, ta_sz: int = TA,
                 tb_sz: int = TB, i_chunk: int | None = None,
                 want_eps: bool = False):
    """Plain PyTorch version of strip_em's resident kernel: same arguments,
    same outputs. Tiles go through in bounded batches so a chunk of
    hundreds of tiles fits in memory."""
    n = ta.shape[0]
    per_tile = 8 * ta_sz * max(min(n_ind, i_chunk or n_ind), 1) * tb_sz
    nb = max(1, _REF_PLANE_BYTES // per_tile)
    outs = [_ref_batch(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b,
                       ta[i:i + nb], tb[i:i + nb], n_ind, iter_cap,
                       ignore_miss, ta_sz, tb_sz, i_chunk, want_eps)
            for i in range(0, n, nb)]
    if not outs:
        return _empty_out(0, ta_sz, tb_sz, ga.device, want_eps)
    return tuple(torch.cat([o[k] for o in outs]) for k in range(len(outs[0])))


def _empty_out(n, ta_sz, tb_sz, dev, want_eps):
    """strip_em's outputs for n tiles, allocated: f, r2p, n_iter, n_used
    [, epsl, epsp]."""
    f32, i32 = torch.float32, torch.int32
    out = (torch.empty((n, 4, ta_sz, tb_sz), dtype=f32, device=dev),
           torch.empty((n, ta_sz, tb_sz), dtype=f32, device=dev),
           torch.empty((n, ta_sz, tb_sz), dtype=i32, device=dev),
           torch.empty((n, ta_sz, tb_sz), dtype=i32, device=dev))
    if want_eps:
        out += (torch.empty((n, ta_sz, tb_sz), dtype=f32, device=dev),
                torch.empty((n, ta_sz, tb_sz), dtype=f32, device=dev))
    return out


def strip_em_stream_ref(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b,
                        ta, tb, *, n_ind: int, iter_cap: int = ITER_MAX,
                        ignore_miss: bool = False, ta_sz: int = TA,
                        tb_sz: int = TB, i_chunk: int | None = None):
    """Plain PyTorch version of the streamed kernel: strip_em_ref with the
    sums over individuals (the EM's four, n_used and the r2p dot) taken
    chunk by chunk in index order. i_chunk defaults to the tables' chunk
    (NGSLD_STRIP_IC); any other value is the same function with another
    summation order."""
    return strip_em_ref(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta,
                        tb, n_ind=n_ind, iter_cap=iter_cap,
                        ignore_miss=ignore_miss, ta_sz=ta_sz, tb_sz=tb_sz,
                        i_chunk=int(i_chunk or _ic_stream()))


def _check(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
           n_ind, ta_sz, tb_sz):
    if ga.dim() != 3 or ga.shape[0] != 3:
        raise ValueError(f"ga must be (3, Sa, Ip), got {tuple(ga.shape)}")
    _, Sa, Ip = ga.shape
    if gb.dim() != 3 or gb.shape[0] != 3 or gb.shape[1] != Ip:
        raise ValueError(f"gb must be (3, Ip, Sb), got {tuple(gb.shape)}")
    Sb = gb.shape[2]
    if ea.shape != (Sa, Ip) or eb.shape != (Ip, Sb):
        raise ValueError("ea must be (Sa, Ip) and eb (Ip, Sb), got "
                         f"{tuple(ea.shape)} and {tuple(eb.shape)}")
    if not 0 < n_ind <= Ip:
        raise ValueError(f"n_ind {n_ind} outside (0, Ip = {Ip}]")
    if ta_sz % 8 or tb_sz % 32:
        raise ValueError("tile shape must be a multiple of (8, 32), got "
                         f"({ta_sz}, {tb_sz})")
    for name, t, shape, dt in (
            ("ga", ga, None, torch.float32), ("gb", gb, None, torch.float32),
            ("ea", ea, None, torch.float32), ("eb", eb, None, torch.float32),
            ("maf_a", maf_a, (Sa,), torch.float32),
            ("maf_b", maf_b, (Sb,), torch.float32),
            ("lo", lo, (Sa,), torch.int32), ("hi", hi, (Sa,), torch.int32),
            ("ok_a", ok_a, (Sa,), torch.float32),
            ("ok_b", ok_b, (Sb,), torch.float32),
            ("ta", ta, (ta.shape[0],), torch.int32),
            ("tb", tb, (ta.shape[0],), torch.int32)):
        if t.dtype != dt or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name} must be {dt} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ga.device:
            raise ValueError(f"{name} is on {t.device}, ga on {ga.device}")


def strip_em(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb, *,
             n_ind: int, iter_cap: int = ITER_MAX, ignore_miss: bool = False,
             ta_sz: int = TA, tb_sz: int = TB, want_eps: bool = False):
    """Run one batch of tiles.

    ga (3, Sa, Ip), gb (3, Ip, Sb), ea (Sa, Ip), eb (Ip, Sb): f32 strip
    tables (strip_tables); the anchor (Sa) and partner (Sb) axes may be
    different site ranges. maf_a/ok_a (Sa,) and maf_b/ok_b (Sb,) f32;
    lo/hi (Sa,) int32 live-partner bounds [lo, hi) in partner-axis
    coordinates; ta/tb (n,) int32 tile coordinates in ta_sz/tb_sz units.
    The caller guarantees every tile lies inside the tables
    ((ta+1)*ta_sz <= Sa, (tb+1)*tb_sz <= Sb). Returns f (n, 4, TA, TB)
    f32, r2p (n, TA, TB) f32, n_iter and n_used (n, TA, TB) int32; with
    want_eps, then epsl and epsp (n, TA, TB) f32, each cell's last two
    update magnitudes (1 until it runs, unchanged once it stops; dead
    cells 1), from the resident kernel's instance with the export (f, r2p,
    n_iter and n_used are those of the launch without it).

    Cohorts past the resident kernel's limit (strip_streamed) take the
    streamed kernel; their tables must be built with
    strip_tables(..., i_align=strip_i_align(n_ind)), else ValueError. The
    streamed kernel exports no eps: want_eps there is a ValueError, as in
    the reference. A kernel whose block needs more shared memory than the
    device allows is refused with a ValueError that names both numbers."""
    global LAUNCHES, LAUNCHES_STREAM, LAUNCHES_EPS
    _check(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb, n_ind,
           ta_sz, tb_sz)
    if ga.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no strip-EM kernel for device {ga.device}")
    kw = dict(n_ind=n_ind, iter_cap=iter_cap, ignore_miss=ignore_miss,
              ta_sz=ta_sz, tb_sz=tb_sz)
    streamed = strip_streamed(n_ind, ga.device)
    if streamed and want_eps:
        raise ValueError(
            f"want_eps: the streamed strip kernel ({n_ind} individuals) "
            "exports no eps; only the resident kernel does")
    if streamed:
        ic = _ic_stream()
        if ic < 1 or ga.shape[2] % ic:   # tables built without the chunk
            raise ValueError(
                f"streamed strip kernel needs Ip % {ic} == 0; build tables "
                "with strip_tables(..., i_align=strip_i_align(n_ind)) (got "
                f"Ip={ga.shape[2]})")
        if ta_sz % _ROWS_STREAM:
            raise ValueError("streamed strip kernel needs a tile height "
                             f"that is a multiple of {_ROWS_STREAM}, got "
                             f"{ta_sz}")
    # a block's shared memory against what the device allows (for CPU
    # tensors: what the card the routing assumes would allow)
    need = strip_smem(ic if streamed else n_ind, streamed, want_eps)
    limit = smem_limits(ga.device)[1]
    if need > limit:
        raise ValueError(
            (f"streamed strip kernel: chunk {ic}" if streamed else
             f"resident strip kernel: {n_ind} individuals"
             + (" with the eps export" if want_eps else ""))
            + f" needs {need} bytes of shared memory, the device allows "
            f"{limit}")
    if ga.device.type == "cpu":
        if streamed:
            return strip_em_stream_ref(ga, gb, ea, eb, maf_a, maf_b, lo, hi,
                                       ok_a, ok_b, ta, tb, **kw)
        return strip_em_ref(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b,
                            ta, tb, want_eps=want_eps, **kw)
    from .build import get_library
    lib = get_library("strip_em_stream" if streamed else "strip_em")
    built = (lib.ngsld_strip_em_stream_smem(ic) if streamed
             else lib.ngsld_strip_em_smem(n_ind, int(want_eps)))
    if built != need:
        raise RuntimeError(f"strip_smem says {need} bytes of shared memory, "
                           f"the built kernel {built}")
    tens = [t.contiguous() for t in (ga, gb, ea, eb, maf_a, maf_b, lo, hi,
                                     ok_a, ok_b, ta, tb)]
    n, dev = ta.shape[0], ga.device
    out = _empty_out(n, ta_sz, tb_sz, dev, want_eps)
    if n == 0:
        return out
    shape = (n, ga.shape[1], gb.shape[2], ga.shape[2], n_ind)
    tail = (ta_sz, tb_sz, iter_cap, int(bool(ignore_miss)),
            ROUND_ITERS_STREAM if streamed else ROUND_ITERS,
            *(t.data_ptr() for t in out[:4]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in tens]
        if streamed:
            err = lib.ngsld_strip_em_stream(*ptrs, *shape, ic, *tail, stream)
        else:
            eps = [t.data_ptr() for t in out[4:]] or [None, None]
            err = lib.ngsld_strip_em(*ptrs, *shape, *tail, *eps, stream)
    if err != 0:
        raise RuntimeError(
            f"{'strip_em_stream' if streamed else 'strip_em'} CUDA kernel "
            f"launch failed: cudaError {err}")
    if streamed:
        LAUNCHES_STREAM += 1
    else:
        LAUNCHES += 1
        LAUNCHES_EPS += int(want_eps)
    return out


def _imat(nit, nu, slim_im: bool, use_i16: bool, ignore_miss: bool):
    """Per-row int metadata: (C, 1) i8 n_iter when slim (n_used is then the
    constant n_ind the host synthesizes; n_iter <= ITER_MAX fits i8), else
    (C, 2) i16|i32 [n_iter, n_used]."""
    if slim_im:
        assert not ignore_miss, "slim_im requires the constant-n_used mode"
        return nit.to(torch.int8)[:, None]
    idt = torch.int16 if use_i16 else torch.int32
    return torch.stack([nit.to(idt), nu.to(idt)], dim=1)


def strip_em_compact(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta,
                     tb, sel, *, n_ind: int, iter_cap: int = ITER_MAX,
                     ignore_miss: bool = False, use_i16: bool = True,
                     slim_im: bool = False, ta_sz: int = TA,
                     tb_sz: int = TB):
    """strip_em + on-device row compaction (pallas_strip.strip_em_compact).

    sel (C,) int32 holds flat indices into the (n_tiles, TA, TB) cell
    space, in the caller's emission order. Only the selected rows leave
    the device: fm (C, 5) f32 = [r2p, f00, f01, f10, f11] and im (see
    _imat), so host-link bytes scale with live pairs, not tile area."""
    f, r2p, nit, nu = strip_em(
        ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
        n_ind=n_ind, iter_cap=iter_cap, ignore_miss=ignore_miss,
        ta_sz=ta_sz, tb_sz=tb_sz)
    return compact_tiles(f, r2p, nit, nu, sel, slim_im=slim_im,
                         use_i16=use_i16, ignore_miss=ignore_miss)


def compact_tiles(f, r2p, nit, nu, sel, *, slim_im: bool, use_i16: bool,
                  ignore_miss: bool):
    """The rows sel (C,) of a batch of tile outputs (strip_em's f, r2p,
    n_iter, n_used): fm (C, 5) = [r2p, f00, f01, f10, f11] and im (see
    _imat), in sel's order."""
    n, ta_sz, tb_sz = r2p.shape
    cells = ta_sz * tb_sz
    sel = sel.long()
    # f is (n, 4, TA*TB): pick (tile, :, cell) without a full relayout
    ff = f.view(n, 4, cells)[sel // cells, :, sel % cells]
    fm = torch.cat([r2p.reshape(-1).index_select(0, sel)[:, None], ff],
                   dim=1)
    im = _imat(nit.reshape(-1).index_select(0, sel),
               nu.reshape(-1).index_select(0, sel), slim_im, use_i16,
               ignore_miss)
    return fm, im


def strip_em_flat(ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
                  *, n_ind: int, iter_cap: int = ITER_MAX,
                  ignore_miss: bool = False, use_i16: bool = True,
                  slim_im: bool = False, ta_sz: int = TA, tb_sz: int = TB):
    """strip_em + flat cell-major emission (pallas_strip.strip_em_flat):
    every cell of the chunk's tiles as dense rows in (tile, a, b) order,
    fm (n*TA*TB, 5) f32 and im (see _imat): the same flat index space
    strip_em_compact's sel addresses, so the host applies sel as a numpy
    take. All cells cross the link, so the engine picks this form only for
    chunks whose live-cell fraction is near 1."""
    f, r2p, nit, nu = strip_em(
        ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb,
        n_ind=n_ind, iter_cap=iter_cap, ignore_miss=ignore_miss,
        ta_sz=ta_sz, tb_sz=tb_sz)
    n_cells = ta.shape[0] * ta_sz * tb_sz
    ff = f.permute(0, 2, 3, 1).reshape(n_cells, 4)
    fm = torch.cat([r2p.reshape(n_cells, 1), ff], dim=1)
    im = _imat(nit.reshape(-1), nu.reshape(-1), slim_im, use_i16,
               ignore_miss)
    return fm, im
