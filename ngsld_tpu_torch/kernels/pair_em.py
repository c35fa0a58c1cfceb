"""Gathered-pair EM: the three CUDA kernels' wrappers, their plain versions
and the ladder that picks one by cohort size.

Each wrapper runs the EM for the pairs sidx (2, P) straight from the
device-resident site table gn (S, I, 3): on a CUDA tensor it launches its
kernel or raises; on a CPU tensor it runs its plain PyTorch version.

  pair_em_gather   csrc/pair_em.cu         lane groups of G lanes a pair fed
                   (pallas_em._em_kernel)  from a pair queue, a pair's rows
                                           in its group's slot of shared
                                           memory
  pair_em_rows     csrc/pair_em_rows.cu    one block per pair, both rows
                   (_em_kernel_rows)       resident in shared memory, one
                                           block barrier an iteration
  pair_em_ichunk   csrc/pair_em_ichunk.cu  one cluster of C blocks per pair,
                   (_em_kernel_ichunk)     the rows held across the
                                           cluster's shared memory; past
                                           its capacity one block per pair,
                                           rows streamed per chunk

pick_gather_kernel(n_ind, itemsize, device, n_pairs) is the ladder of
ngsld_tpu/compute.py:99-117 with the card's shared memory in the place of
the TPU's VMEM and the switches where the card measured them (by cohort
size and, for the lane groups, by the block's pair count). The launch
arithmetic of the three kernels (group size, slot, block width, cluster
size, threads) lives here, so that the CPU tests reach it. LAUNCHES,
LAUNCHES_ROWS and LAUNCHES_ICHUNK count kernel launches, nothing else;
LAUNCHES_ICHUNK_STREAM counts the launches of pair_em_ichunk that took the
streamed body, LAUNCHES_OPTS those of pair_em_gather that took the option
instance, LAUNCHES_ROWS_CAP and LAUNCHES_ICHUNK_CAP those of the rows and
ichunk rungs that took the capped instance.

pair_em_gather also takes the options of pallas_em._em_kernel (an
iteration cap, a warm start, the export of each pair's last two eps), and
pair_em_phased is the two-phase driver built on them (pallas_em.
pair_em_phased): a capped launch, one small pull, the capped pairs resumed
warm. The rows and ichunk rungs take the cap of _em_kernel_rows and
_em_kernel_ichunk (iter_cap; f stays in the table dtype, as there), and
no warm start or eps export (their JAX wrappers take none).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPSILON, ITER_MAX
from ..ops.em import pair_em
from .build import smem_limits

LAUNCHES = 0                 # pair_em_gather
LAUNCHES_OPTS = 0            # pair_em_gather, its option instance
LAUNCHES_ROWS = 0            # pair_em_rows
LAUNCHES_ROWS_CAP = 0        # pair_em_rows, its capped instance
LAUNCHES_ICHUNK = 0          # pair_em_ichunk, either body
LAUNCHES_ICHUNK_STREAM = 0   # pair_em_ichunk, the streamed body
LAUNCHES_ICHUNK_CAP = 0      # pair_em_ichunk, either body's capped instance

# individuals per staged chunk of pair_em_ichunk's streamed body: 2 buffers
# x 2 rows x 12 bytes x 1,024 = 48 KB of shared memory in f32
I_CHUNK = 1024
# static shared memory of the streamed body's block (its reductions)
_STREAM_RESERVED = 1024
# shared memory the card keeps for itself in every resident block
_BLOCK_RESERVED = 1024

# ---- csrc/pair_em.cu: lane groups fed from a pair queue
GATHER_THREADS = 64     # a block: two warps (kThreads in the source)
# warps an SM the group size aims at: the smallest G whose slots leave this
# many resident warps
GATHER_WARPS_SM = 16
# the gather rung's last cohort size, by table itemsize: the measured
# crossover with the rows kernel (phase 3d of chip_smoke.py), unless the
# design limit comes first
GATHER_MAX_IND = {4: 500, 8: 250}
# the fewest pairs a launch of the gather rung takes, by table itemsize: the
# smallest block of phase 3d's sweep on which the lane groups won most of
# their cohorts (the rows kernel most of them on the next smaller block)
GATHER_MIN_PAIRS = {4: 65_536, 8: 32_768}

# ---- csrc/pair_em_rows.cu: one block a pair
# warps an SM the block width aims at: the smallest width whose blocks
# leave this many resident warps
ROWS_WARPS_SM = 16
ROWS_THREADS = 512       # the widest block the rule gives

# ---- csrc/pair_em_ichunk.cu, the cluster body
CLUSTER_MAX = 8          # blocks in a cluster, the portable limit
CLUSTER_BLOCKS_SM = 2    # resident blocks an SM the cluster size aims at
CLUSTER_TERMS = 16       # individuals a thread an iteration, at most
# static shared memory of the cluster body's block, and the card's own
_CLUSTER_RESERVED = 2048

def _options(iter_cap, f0, want_eps) -> bool:
    """Whether a call asks for pair_em_gather's options (then f is the
    f64 state)."""
    return iter_cap != ITER_MAX or f0 is not None or bool(want_eps)


def _check_options(gn, sidx, iter_cap, f0=None):
    if int(iter_cap) != iter_cap or iter_cap < 1:
        raise ValueError(f"iter_cap must be a positive integer, got "
                         f"{iter_cap}")
    P = sidx.shape[1]
    if f0 is not None and (f0.shape != (P, 4) or f0.dtype != torch.float64
                           or f0.device != gn.device):
        raise ValueError("f0 must be a (P, 4) float64 tensor on gn's "
                         f"device, got {tuple(f0.shape)} {f0.dtype} "
                         f"{f0.device}")


def _pair_em_ref(gn, sidx, maf, ignore_miss_data, i_chunk=None,
                 iter_cap=ITER_MAX, f0=None, want_eps=False):
    s1, s2 = sidx[0].long(), sidx[1].long()
    out = pair_em(
        gn.index_select(0, s1).double(), gn.index_select(0, s2).double(),
        maf.index_select(0, s1).double(), maf.index_select(0, s2).double(),
        ignore_miss_data, i_chunk=i_chunk, iter_cap=iter_cap, f0=f0,
        want_eps=want_eps)
    if _options(iter_cap, f0, want_eps):
        return out
    f, n_iter, n_used = out
    return f.to(gn.dtype), n_iter, n_used


def pair_em_gather_ref(gn: torch.Tensor, sidx: torch.Tensor,
                       maf: torch.Tensor, ignore_miss_data: bool,
                       iter_cap: int = ITER_MAX,
                       f0: torch.Tensor | None = None,
                       want_eps: bool = False):
    """Plain twin: index_select of both sites' rows, then ops.em.pair_em.

    As in the kernel, the EM runs in f64 whatever the table dtype, and f
    comes back in the table dtype: an f32 EM stops one iteration away from
    the f64 reference wherever eps lands within f32 rounding of EPSILON.
    With an option, f is the f64 state (see pair_em_gather)."""
    return _pair_em_ref(gn, sidx, maf, ignore_miss_data, iter_cap=iter_cap,
                        f0=f0, want_eps=want_eps)


def _capped_ref(gn, sidx, maf, ignore_miss_data, i_chunk, iter_cap):
    """_pair_em_ref under a cap alone: f in the table dtype."""
    f, n_iter, n_used = _pair_em_ref(gn, sidx, maf, ignore_miss_data,
                                     i_chunk=i_chunk, iter_cap=iter_cap)
    return f.to(gn.dtype), n_iter, n_used


def pair_em_rows_ref(gn: torch.Tensor, sidx: torch.Tensor,
                     maf: torch.Tensor, ignore_miss_data: bool,
                     iter_cap: int = ITER_MAX):
    """Plain version of pair_em_rows: the whole row summed at once, in
    f64."""
    return _capped_ref(gn, sidx, maf, ignore_miss_data, None, iter_cap)


def pair_em_ichunk_ref(gn: torch.Tensor, sidx: torch.Tensor,
                       maf: torch.Tensor, ignore_miss_data: bool,
                       i_chunk: int = I_CHUNK, iter_cap: int = ITER_MAX):
    """Plain version of pair_em_ichunk: the per-individual terms added up
    chunk by chunk in index order, in f64 (the last chunk may be partial)."""
    return _capped_ref(gn, sidx, maf, ignore_miss_data, int(i_chunk),
                       iter_cap)


def _check(gn, sidx, maf):
    if gn.dim() != 3 or gn.shape[2] != 3:
        raise ValueError(f"gn must be (S, I, 3), got {tuple(gn.shape)}")
    if sidx.dim() != 2 or sidx.shape[0] != 2 or sidx.dtype != torch.int32:
        raise ValueError("sidx must be a (2, P) int32 tensor, got "
                         f"{tuple(sidx.shape)} {sidx.dtype}")
    if maf.shape != (gn.shape[0],) or maf.dtype != gn.dtype:
        raise ValueError("maf must be (S,) in gn's dtype")
    if gn.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {gn.dtype}")
    devs = {t.device for t in (gn, sidx, maf)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def rows_smem_bytes(n_ind: int, itemsize: int = 4) -> int:
    """Both rows of a pair: 6 I table values."""
    return 2 * 3 * n_ind * itemsize


def rows_block_smem(n_ind: int, itemsize: int = 4,
                    threads: int = ROWS_THREADS) -> int:
    """Dynamic shared memory of a pair_em_rows block: two slots of the
    warps' four sums (64 bytes a warp), then both rows."""
    return 2 * threads + rows_smem_bytes(n_ind, itemsize)


def rows_max_ind(itemsize: int = 4, device="cpu") -> int:
    """The rows rung's ceiling: the largest cohort whose block at
    ROWS_THREADS fits the opt-in shared memory (9,642 individuals in f32,
    4,821 in f64 on an H100)."""
    return (smem_limits(device)[1] - rows_block_smem(0)) // rows_smem_bytes(
        1, itemsize)


def _rows_blocks_smem(n_ind: int, itemsize: int, device, threads: int) -> int:
    """pair_em_rows blocks an SM's shared memory holds: each its own and
    the card's reserve of a block."""
    return _sm_bytes(device) // (rows_block_smem(n_ind, itemsize, threads)
                                 + _BLOCK_RESERVED)


def rows_threads(n_ind: int, itemsize: int = 4, device="cpu") -> int:
    """Threads of a pair_em_rows block: the smallest power of two from 64
    to ROWS_THREADS whose blocks, as many as an SM's shared memory holds,
    leave ROWS_WARPS_SM warps an SM."""
    t = 64
    while t < ROWS_THREADS and \
            rows_pairs_sm(n_ind, itemsize, device, t) * t < ROWS_WARPS_SM * 32:
        t *= 2
    return t


def rows_pairs_sm(n_ind: int, itemsize: int = 4, device="cpu",
                  threads: int | None = None) -> int:
    """pair_em_rows blocks (one pair each) an SM holds at once at a block
    width: by its shared memory and by the SM's 2,048 threads; at most
    32."""
    threads = threads or rows_threads(n_ind, itemsize, device)
    return min(32, _rows_blocks_smem(n_ind, itemsize, device, threads),
               2048 // threads)


def _sm_bytes(device) -> int:
    """Shared memory of an SM: a block's opt-in limit and the card's own
    reserve of one block (232,448 + 1,024 on an H100)."""
    return smem_limits(device)[1] + _BLOCK_RESERVED


def gather_slot(n_ind: int, group: int, itemsize: int = 4) -> int:
    """A lane group's slot, in table values: both rows, 6 I, padded up to
    a stride congruent to 3 G modulo the banks (32 words of 4 bytes; 16
    for 8-byte values, which a warp reads half at a time), so that lane q
    of the j-th group of a warp, reading value 3 (q + k G) + c of its slot,
    hits bank 3 (j G + q) + const: 32 distinct banks."""
    mod = 32 if itemsize == 4 else 16
    need = 6 * n_ind
    return need + (3 * group - need) % mod


def gather_smem(n_ind: int, group: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one pair_em_gather block: its groups'
    slots."""
    return (GATHER_THREADS // group) * gather_slot(n_ind, group,
                                                   itemsize) * itemsize


def gather_warps_sm(n_ind: int, group: int, itemsize: int = 4,
                    device="cpu") -> int:
    """Warps of pair_em_gather an SM's shared memory holds at group size
    G (registers and the card's thread limit may allow fewer)."""
    need = gather_smem(n_ind, group, itemsize)
    if need > smem_limits(device)[1]:
        return 0
    return GATHER_THREADS // 32 * (_sm_bytes(device)
                                   // (need + _BLOCK_RESERVED))


def gather_group(n_ind: int, itemsize: int = 4, device="cpu") -> int | None:
    """Lanes a pair in pair_em_gather: the smallest power of two whose
    slots leave GATHER_WARPS_SM warps an SM (fewer lanes a pair, fewer
    reductions and less idle lane time per term), 32 when none does but a
    block still fits, None when not even that (the rung's design limit)."""
    for g in (1, 2, 4, 8, 16, 32):
        if gather_warps_sm(n_ind, g, itemsize, device) >= GATHER_WARPS_SM:
            return g
    return 32 if gather_warps_sm(n_ind, 32, itemsize, device) else None


def cluster_slice(n_ind: int, blocks: int, itemsize: int = 4) -> int:
    """Individuals a block of the cluster body holds: its share of the
    cohort, on whole 16-byte runs of the row."""
    per = 16 // itemsize
    return -(-(-(-n_ind // blocks)) // per) * per


def cluster_smem(n_ind: int, blocks: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of a block of the cluster body: its slice of
    both rows."""
    return 6 * cluster_slice(n_ind, blocks, itemsize) * itemsize


def ichunk_cluster(n_ind: int, itemsize: int = 4, device="cpu") -> int | None:
    """Blocks in the cluster that holds a pair's rows in pair_em_ichunk:
    the smallest C <= CLUSTER_MAX whose slices fit CLUSTER_BLOCKS_SM blocks
    an SM, else the smallest that fits one block an SM; None past the
    cluster's capacity (CLUSTER_MAX blocks of the opt-in shared memory,
    77,120 individuals in f32 and 38,560 in f64 on an H100), where the
    streamed body runs."""
    for per_sm in (CLUSTER_BLOCKS_SM, 1):
        room = _sm_bytes(device) // per_sm - _CLUSTER_RESERVED
        for c in range(1, CLUSTER_MAX + 1):
            if cluster_smem(n_ind, c, itemsize) <= room:
                return c
    return None


def cluster_threads(n_ind: int, blocks: int, itemsize: int = 4) -> int:
    """Threads a block of the cluster body: a power of two from 64 to 512
    giving each thread at most CLUSTER_TERMS individuals an iteration."""
    per = -(-cluster_slice(n_ind, blocks, itemsize) // CLUSTER_TERMS)
    t = 64
    while t < 512 and t < per:
        t *= 2
    return t


def pick_gather_kernel(n_ind: int, itemsize: int,
                       device: torch.device | str, n_pairs: int) -> str:
    """Which gather kernel runs a block of n_pairs pairs of a cohort of
    n_ind: "gather", "rows" or "ichunk".

    pair_em_gather to GATHER_MAX_IND individuals on blocks of at least
    GATHER_MIN_PAIRS pairs, or to its design limit where that comes first
    (a block of two warps with one slot each must fit the opt-in shared
    memory: 4,842 individuals in f32, 2,421 in f64). The switches are the
    crossovers of chip_smoke phase 3d with the rows kernel on an H100, on
    random pairs and on the band planner's blocks alike. At 65,536-524,288
    pairs the lane groups won to 500 individuals in f32 and 250 in f64
    (rows ahead from 550 and 300). On smaller blocks the dtypes part: in
    f32 the rows kernel won two of three cohorts (100, 400; not 500, by
    2-5%) at 32,768 pairs and all at 16,384; in f64 the lane groups won
    both cohorts at 32,768 pairs and only 200 of 100, 200, 250 at 16,384.
    Then pair_em_rows, the rows resident in one block's shared memory, to
    its ceiling (rows_max_ind: 9,642 individuals in f32, 4,821 in f64),
    ahead of the cluster body at C = 1 and 2 at every cohort measured but
    6,000 in f32, where the cluster body's own rule (C = 2, three blocks
    an SM) led by a few percent; then pair_em_ichunk (rows held across a
    cluster, streamed past its capacity)."""
    if n_ind <= GATHER_MAX_IND[itemsize] \
            and n_pairs >= GATHER_MIN_PAIRS[itemsize] \
            and gather_group(n_ind, itemsize, device) is not None:
        return "gather"
    if n_ind <= rows_max_ind(itemsize, device):
        return "rows"
    return "ichunk"


def _empty(gn, sidx, f_dtype=None):
    P = sidx.shape[1]
    return (torch.empty((P, 4), dtype=f_dtype or gn.dtype, device=gn.device),
            torch.empty(P, dtype=torch.int32, device=gn.device),
            torch.empty(P, dtype=torch.int32, device=gn.device))


def _launch(lib_name, fn_stem, gn, sidx, maf, ignore_miss_data, pre=(),
            post=(), f_dtype=None):
    """Allocate the outputs (f in f_dtype, default gn's) and launch one of
    the kernels on P > 0 pairs (all share the argument list; `pre` goes
    between I and ignore_miss, `post` between ignore_miss and the
    outputs)."""
    from .build import get_library
    lib = get_library(lib_name)
    gn, sidx, maf = gn.contiguous(), sidx.contiguous(), maf.contiguous()
    P, I = sidx.shape[1], gn.shape[1]
    f, n_iter, n_used = _empty(gn, sidx, f_dtype)
    fn = getattr(lib, fn_stem + ("_f32" if gn.dtype == torch.float32
                                 else "_f64"))
    with torch.cuda.device(gn.device):
        stream = torch.cuda.current_stream(gn.device).cuda_stream
        err = fn(gn.data_ptr(), sidx.data_ptr(), maf.data_ptr(), P, I, *pre,
                 int(bool(ignore_miss_data)), *post, f.data_ptr(),
                 n_iter.data_ptr(), n_used.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"{lib_name} CUDA kernel launch failed: cudaError {err}")
    return f, n_iter, n_used


def _entry(stem, iter_cap):
    """(entry point, its arguments after ignore_miss) of a rows or ichunk
    launch: the capped instance's for a cap below ITER_MAX."""
    if iter_cap == ITER_MAX:
        return stem, ()
    return stem + "_cap", (int(iter_cap),)


def _device_kind(gn, name):
    """"cpu" or "cuda"; any other device raises (there is no fallback)."""
    if gn.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {gn.device}")
    return gn.device.type


def pair_em_gather(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                   ignore_miss_data: bool, iter_cap: int = ITER_MAX,
                   f0: torch.Tensor | None = None, want_eps: bool = False):
    """EM for P gathered pairs -> (f (P, 4), n_iter (P,) int32,
    n_used (P,) int32), in gn's dtype. Lane groups of gather_group lanes a
    pair, fed from a pair queue; raises ValueError for a cohort whose
    block of slots exceeds the device's opt-in shared memory.

    Options (pallas_em._em_kernel's; the kernel's second instance, so the
    launch without them keeps its code): iter_cap >= 1 stops the pairs
    still running there (n_iter == iter_cap); f0 (P, 4) float64 starts f
    there in place of the MAFs; want_eps appends eps (P, 2) float64, each
    pair's [eps_last, eps_prev] (1 until the pair runs; an x = 0 pair
    stops at n_iter 0 with NaN f and eps_last 0). With any of them f comes
    back as (P, 4) float64 whatever gn's dtype: the EM's own state, so a
    capped launch resumed from it (f0, iter_cap - cap) is the one-phase
    launch bit for bit."""
    global LAUNCHES, LAUNCHES_OPTS
    _check(gn, sidx, maf)
    opts = _options(iter_cap, f0, want_eps)
    if opts:
        _check_options(gn, sidx, iter_cap, f0)
    if _device_kind(gn, "pair-EM") == "cpu":
        return pair_em_gather_ref(gn, sidx, maf, ignore_miss_data, iter_cap,
                                  f0, want_eps)
    I, esz = gn.shape[1], gn.element_size()
    group = gather_group(I, esz, gn.device)
    if group is None:
        raise ValueError(
            f"pair_em_gather: {I} individuals need {gather_smem(I, 32, esz)} "
            "bytes of shared memory a block, the device allows "
            f"{smem_limits(gn.device)[1]}; use pair_em_rows")
    P = sidx.shape[1]
    eps = (torch.empty((P, 2), dtype=torch.float64, device=gn.device)
           if want_eps else None)
    if P == 0:
        out = _empty(gn, sidx, torch.float64 if opts else None)
        return out + (eps,) if want_eps else out
    # the pair queue's head, zeroed for this launch on its stream
    head = torch.zeros(1, dtype=torch.int64, device=gn.device)
    pre = (group, gather_slot(I, group, esz))
    if not opts:
        out = _launch("pair_em", "ngsld_pair_em", gn, sidx, maf,
                      ignore_miss_data, pre=pre, post=(head.data_ptr(),))
    else:
        f0 = f0.contiguous() if f0 is not None else None
        out = _launch("pair_em", "ngsld_pair_em_opts", gn, sidx, maf,
                      ignore_miss_data, pre=pre,
                      post=(int(iter_cap),
                            None if f0 is None else f0.data_ptr(),
                            None if eps is None else eps.data_ptr(),
                            head.data_ptr()),
                      f_dtype=torch.float64)
        if want_eps:
            out = out + (eps,)
        LAUNCHES_OPTS += 1
    LAUNCHES += 1
    return out


def pair_em_rows(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                 ignore_miss_data: bool, iter_cap: int = ITER_MAX):
    """pair_em_gather's function with both rows of a pair resident in
    shared memory (one block per pair). Raises ValueError for a cohort
    whose rows exceed the device's opt-in shared memory. iter_cap >= 1
    (pallas_em._em_kernel_rows's): the pairs still running there stop with
    n_iter == iter_cap, through the kernel's capped instance (the launch
    without a cap keeps its code)."""
    global LAUNCHES_ROWS, LAUNCHES_ROWS_CAP
    _check(gn, sidx, maf)
    _check_options(gn, sidx, iter_cap)
    if _device_kind(gn, "pair-EM rows") == "cpu":
        return pair_em_rows_ref(gn, sidx, maf, ignore_miss_data, iter_cap)
    I, esz = gn.shape[1], gn.element_size()
    threads = rows_threads(I, esz, gn.device)
    need = rows_block_smem(I, esz, threads)
    limit = smem_limits(gn.device)[1]
    if need > limit:
        raise ValueError(
            f"pair_em_rows: {I} individuals need {need} bytes of "
            f"shared memory, the device allows {limit}; use pair_em_ichunk")
    if sidx.shape[1] == 0:
        return _empty(gn, sidx)
    stem, post = _entry("ngsld_pair_em_rows", iter_cap)
    out = _launch("pair_em_rows", stem, gn, sidx, maf, ignore_miss_data,
                  pre=(threads,), post=post)
    LAUNCHES_ROWS += 1
    LAUNCHES_ROWS_CAP += bool(post)
    return out


_CLUSTER_FITS: dict = {}


def _cluster_fits(gn, I, blocks, threads, ignore_miss_data):
    """Raise ValueError unless the card holds at least one cluster of the
    cluster body at this shape (asked once per shape)."""
    key = (gn.device, gn.dtype, I, blocks, threads, bool(ignore_miss_data))
    if key not in _CLUSTER_FITS:
        import ctypes

        from .build import get_library
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(gn.device):
            err = get_library("pair_em_ichunk") \
                .ngsld_pair_em_cluster_occupancy(
                    int(gn.dtype == torch.float64), I, blocks, threads,
                    int(bool(ignore_miss_data)), ctypes.addressof(out))
        if err != 0:
            raise RuntimeError("ngsld_pair_em_cluster_occupancy failed: "
                               f"cudaError {err}")
        _CLUSTER_FITS[key] = int(out[0])
    if _CLUSTER_FITS[key] < 1:
        raise ValueError(
            f"pair_em_ichunk: a cluster of {blocks} blocks with "
            f"{cluster_smem(I, blocks, gn.element_size())} bytes of shared "
            f"memory each: the device holds {_CLUSTER_FITS[key]} such "
            "clusters")


def pair_em_ichunk(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                   ignore_miss_data: bool, i_chunk: int = I_CHUNK,
                   iter_cap: int = ITER_MAX):
    """pair_em_gather's function for any cohort size: the rows held across
    a cluster of ichunk_cluster blocks (each block a slice, in its shared
    memory for the whole EM), or, past the cluster's capacity, streamed
    through shared memory in chunks of i_chunk individuals inside every
    iteration (one block per pair). The route is decided here, before the
    launch, by cohort size; a cluster the card cannot hold raises.
    iter_cap >= 1 (pallas_em._em_kernel_ichunk's): the pairs still running
    there stop with n_iter == iter_cap, through the capped instance of
    either body (the card is asked about the cluster of the instance
    without the cap: the same shared memory and block shape)."""
    global LAUNCHES_ICHUNK, LAUNCHES_ICHUNK_CAP
    _check(gn, sidx, maf)
    _check_options(gn, sidx, iter_cap)
    i_chunk = int(i_chunk)
    if i_chunk < 1:
        raise ValueError(f"i_chunk must be positive, got {i_chunk}")
    if _device_kind(gn, "pair-EM ichunk") == "cpu":
        return pair_em_ichunk_ref(gn, sidx, maf, ignore_miss_data, i_chunk,
                                  iter_cap)
    I, esz = gn.shape[1], gn.element_size()
    blocks = ichunk_cluster(I, esz, gn.device)
    if blocks is not None:
        threads = cluster_threads(I, blocks, esz)
        _cluster_fits(gn, I, blocks, threads, ignore_miss_data)
        if sidx.shape[1] == 0:
            return _empty(gn, sidx)
        stem, post = _entry("ngsld_pair_em_cluster", iter_cap)
        out = _launch("pair_em_ichunk", stem, gn, sidx, maf,
                      ignore_miss_data, pre=(blocks, threads), post=post)
        LAUNCHES_ICHUNK += 1
        LAUNCHES_ICHUNK_CAP += bool(post)
        return out
    return _pair_em_ichunk_stream(gn, sidx, maf, ignore_miss_data, i_chunk,
                                  iter_cap)


def _pair_em_ichunk_stream(gn, sidx, maf, ignore_miss_data,
                           i_chunk=I_CHUNK, iter_cap=ITER_MAX):
    """pair_em_ichunk's streamed body on CUDA tensors of the shapes
    pair_em_ichunk checks, whatever the cohort size: pair_em_ichunk routes
    here past the cluster's capacity; chip_smoke.py and the gpu-marked
    tests call it directly to hold the body against its plain version."""
    global LAUNCHES_ICHUNK, LAUNCHES_ICHUNK_STREAM, LAUNCHES_ICHUNK_CAP
    _check_options(gn, sidx, iter_cap)
    esz = gn.element_size()
    need = 2 * rows_smem_bytes(i_chunk, esz) + _STREAM_RESERVED
    limit = smem_limits(gn.device)[1]
    if need > limit:
        raise ValueError(
            f"pair_em_ichunk: i_chunk {i_chunk} needs {need} bytes of shared "
            f"memory, the device allows {limit}")
    if sidx.shape[1] == 0:
        return _empty(gn, sidx)
    stem, post = _entry("ngsld_pair_em_ichunk", iter_cap)
    out = _launch("pair_em_ichunk", stem, gn, sidx, maf, ignore_miss_data,
                  pre=(i_chunk,), post=post)
    LAUNCHES_ICHUNK += 1
    LAUNCHES_ICHUNK_CAP += bool(post)
    LAUNCHES_ICHUNK_STREAM += 1
    return out


GATHER_KERNELS = {"gather": pair_em_gather, "rows": pair_em_rows,
                  "ichunk": pair_em_ichunk}


# ------------------------------------------------------- phased driver

def phase2_order(eps: torch.Tensor, eps_prev: torch.Tensor) -> torch.Tensor:
    """The order in which phase 2 hands out capped pairs, from their last
    two eps (f64, on any device): hardest first, by pallas_em.
    pair_em_phased's estimate of the iterations left from the contraction
    rate at the cap, eps_k ~ C rho^k => log(EPSILON / eps) / log(rho),
    rho = eps / eps_prev (non-finite -> ITER_MAX). The reference sorts
    easiest first so that equally hard pairs share a tile; a pair queue
    has no tiles, and handing the longest pairs out first keeps them out
    of the launch's tail."""
    rho = (eps / eps_prev.clamp_min(1e-30)).clamp(1e-6, 0.9999)
    pred = torch.log((EPSILON / eps.clamp_min(1e-30)).clamp_min(1e-30)) \
        / torch.log(rho)
    pred = torch.where(torch.isfinite(pred), pred, float(ITER_MAX))
    return torch.argsort(pred, descending=True, stable=True)


def pair_em_phased(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                   ignore_miss_data: bool, *, cap1: int = 16):
    """Two-phase EM with exact resume (pallas_em.pair_em_phased): host
    numpy (f (P, 4) in gn's dtype, n_iter (P,) int32, n_used (P,) int32),
    bit-equal to pair_em_gather on the same inputs.

    Phase 1 runs every pair capped at cap1 (pair_em_gather with iter_cap
    and want_eps: f64 state and eps); one small pull of (n_iter, eps_last,
    eps_prev) finds the pairs still running at the cap; phase 2 resumes
    them warm from their f64 state, capped at ITER_MAX - cap1, on
    sidx[:, order] (the pair queue reads rows by index, so nothing is
    gathered), and n_iter = cap1 + phase 2's. The order is phase2_order's,
    hardest first; the result does not depend on it (a pair's sums depend
    on its own rows only). The reference's pair_tile and bucket have no
    counterpart: the queue has no tiles, and nothing recompiles. Phase 1's
    and phase 2's launches are pair_em_gather's (the lane groups) whatever
    rung the ladder would pick."""
    if not 1 <= cap1 < ITER_MAX:
        raise ValueError(f"cap1 must lie in [1, {ITER_MAX}), got {cap1}")
    f1, it1, n_used, eps = pair_em_gather(gn, sidx, maf, ignore_miss_data,
                                          iter_cap=cap1, want_eps=True)
    meta = torch.cat([it1.double()[:, None], eps], dim=1).cpu().numpy()
    n_iter = meta[:, 0].astype(np.int32)
    un = np.flatnonzero(n_iter == cap1)
    if len(un):
        order = un[phase2_order(torch.from_numpy(meta[un, 1]),
                                torch.from_numpy(meta[un, 2])).numpy()]
        idx = torch.from_numpy(order).to(gn.device)
        f2, it2, _ = pair_em_gather(gn, sidx.index_select(1, idx), maf,
                                    ignore_miss_data,
                                    iter_cap=ITER_MAX - cap1,
                                    f0=f1.index_select(0, idx))
        f1 = f1.index_copy(0, idx, f2)
        n_iter[order] = cap1 + it2.cpu().numpy()
    return (f1.to(gn.dtype).cpu().numpy(), n_iter,
            n_used.cpu().numpy())
