"""Gathered-pair EM: the three CUDA kernels' wrappers, their plain versions
and the ladder that picks one by cohort size.

Each wrapper runs the EM for the pairs sidx (2, P) straight from the
device-resident site table gn (S, I, 3): on a CUDA tensor it launches its
kernel or raises; on a CPU tensor it runs its plain PyTorch version.

  pair_em_gather   csrc/pair_em.cu         one warp per pair, rows re-read
                   (pallas_em._em_kernel)  from L1/L2 every iteration
  pair_em_rows     csrc/pair_em_rows.cu    one block per pair, both rows
                   (_em_kernel_rows)       resident in shared memory
  pair_em_ichunk   csrc/pair_em_ichunk.cu  one block per pair, rows streamed
                   (_em_kernel_ichunk)     through shared memory per chunk

pick_gather_kernel(n_ind) is the ladder of ngsld_tpu/compute.py:99-117 with
the card's shared memory in the place of the TPU's VMEM. LAUNCHES,
LAUNCHES_ROWS and LAUNCHES_ICHUNK count kernel launches, nothing else.
"""

from __future__ import annotations

import torch

from ..ops.em import pair_em
from .build import smem_limits

LAUNCHES = 0          # pair_em_gather
LAUNCHES_ROWS = 0     # pair_em_rows
LAUNCHES_ICHUNK = 0   # pair_em_ichunk

# individuals per staged chunk of pair_em_ichunk: 2 buffers x 2 rows x
# 12 bytes x 1,024 = 48 KB of shared memory in f32, four blocks an SM
I_CHUNK = 1024
# shared memory the rows kernel keeps for its reductions (static)
_ROWS_RESERVED = 1024


def _pair_em_ref(gn, sidx, maf, ignore_miss_data, i_chunk=None):
    s1, s2 = sidx[0].long(), sidx[1].long()
    f, n_iter, n_used = pair_em(
        gn.index_select(0, s1).double(), gn.index_select(0, s2).double(),
        maf.index_select(0, s1).double(), maf.index_select(0, s2).double(),
        ignore_miss_data, i_chunk=i_chunk)
    return f.to(gn.dtype), n_iter, n_used


def pair_em_gather_ref(gn: torch.Tensor, sidx: torch.Tensor,
                       maf: torch.Tensor, ignore_miss_data: bool):
    """Plain twin: index_select of both sites' rows, then ops.em.pair_em.

    As in the kernel, the EM runs in f64 whatever the table dtype, and f
    comes back in the table dtype: an f32 EM stops one iteration away from
    the f64 reference wherever eps lands within f32 rounding of EPSILON."""
    return _pair_em_ref(gn, sidx, maf, ignore_miss_data)


def pair_em_rows_ref(gn: torch.Tensor, sidx: torch.Tensor,
                     maf: torch.Tensor, ignore_miss_data: bool):
    """Plain version of pair_em_rows: the whole row summed at once, in
    f64."""
    return _pair_em_ref(gn, sidx, maf, ignore_miss_data)


def pair_em_ichunk_ref(gn: torch.Tensor, sidx: torch.Tensor,
                       maf: torch.Tensor, ignore_miss_data: bool,
                       i_chunk: int = I_CHUNK):
    """Plain version of pair_em_ichunk: the per-individual terms added up
    chunk by chunk in index order, in f64 (the last chunk may be partial)."""
    return _pair_em_ref(gn, sidx, maf, ignore_miss_data, i_chunk=int(i_chunk))


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
    """Dynamic shared memory pair_em_rows needs: both rows of a pair."""
    return 2 * 3 * n_ind * itemsize


def pick_gather_kernel(n_ind: int, itemsize: int = 4,
                       device: torch.device | str = "cpu") -> str:
    """Which gather kernel runs a cohort of n_ind: "gather", "rows" or
    "ichunk".

    The warp-per-pair kernel re-reads a pair's two rows every iteration and
    counts on L1 for them, so it keeps cohorts whose rows fit the shared
    memory/L1 a block has without opting in (2,048 individuals in f32 on an
    H100). Up to the opt-in limit the rows stay resident in shared memory
    (pair_em_rows; 9,642 individuals in f32). Beyond that they stream
    (pair_em_ichunk). These are the kernels' design limits, not measured
    crossovers."""
    per_block, optin = smem_limits(device)
    need = rows_smem_bytes(n_ind, itemsize)
    if need <= per_block:
        return "gather"
    if need <= optin - _ROWS_RESERVED:
        return "rows"
    return "ichunk"


def _empty(gn, sidx):
    P = sidx.shape[1]
    return (torch.empty((P, 4), dtype=gn.dtype, device=gn.device),
            torch.empty(P, dtype=torch.int32, device=gn.device),
            torch.empty(P, dtype=torch.int32, device=gn.device))


def _launch(lib_name, fn_stem, gn, sidx, maf, ignore_miss_data, extra=()):
    """Allocate the outputs and launch one of the three kernels on P > 0
    pairs (all share the argument list; `extra` goes between I and
    ignore_miss)."""
    from .build import get_library
    lib = get_library(lib_name)
    gn, sidx, maf = gn.contiguous(), sidx.contiguous(), maf.contiguous()
    P, I = sidx.shape[1], gn.shape[1]
    f, n_iter, n_used = _empty(gn, sidx)
    fn = getattr(lib, fn_stem + ("_f32" if gn.dtype == torch.float32
                                 else "_f64"))
    with torch.cuda.device(gn.device):
        stream = torch.cuda.current_stream(gn.device).cuda_stream
        err = fn(gn.data_ptr(), sidx.data_ptr(), maf.data_ptr(), P, I, *extra,
                 int(bool(ignore_miss_data)), f.data_ptr(), n_iter.data_ptr(),
                 n_used.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"{lib_name} CUDA kernel launch failed: cudaError {err}")
    return f, n_iter, n_used


def _device_kind(gn, name):
    """"cpu" or "cuda"; any other device raises (there is no fallback)."""
    if gn.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {gn.device}")
    return gn.device.type


def pair_em_gather(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                   ignore_miss_data: bool):
    """EM for P gathered pairs -> (f (P, 4), n_iter (P,) int32,
    n_used (P,) int32), in gn's dtype. One warp per pair."""
    global LAUNCHES
    _check(gn, sidx, maf)
    if _device_kind(gn, "pair-EM") == "cpu":
        return pair_em_gather_ref(gn, sidx, maf, ignore_miss_data)
    if sidx.shape[1] == 0:
        return _empty(gn, sidx)
    out = _launch("pair_em", "ngsld_pair_em", gn, sidx, maf,
                  ignore_miss_data)
    LAUNCHES += 1
    return out


def pair_em_rows(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                 ignore_miss_data: bool):
    """pair_em_gather's function with both rows of a pair resident in
    shared memory (one block per pair). Raises ValueError for a cohort
    whose rows exceed the device's opt-in shared memory."""
    global LAUNCHES_ROWS
    _check(gn, sidx, maf)
    if _device_kind(gn, "pair-EM rows") == "cpu":
        return pair_em_rows_ref(gn, sidx, maf, ignore_miss_data)
    need = rows_smem_bytes(gn.shape[1], gn.element_size()) + _ROWS_RESERVED
    limit = smem_limits(gn.device)[1]
    if need > limit:
        raise ValueError(
            f"pair_em_rows: {gn.shape[1]} individuals need {need} bytes of "
            f"shared memory, the device allows {limit}; use pair_em_ichunk")
    if sidx.shape[1] == 0:
        return _empty(gn, sidx)
    out = _launch("pair_em_rows", "ngsld_pair_em_rows", gn, sidx, maf,
                  ignore_miss_data)
    LAUNCHES_ROWS += 1
    return out


def pair_em_ichunk(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                   ignore_miss_data: bool, i_chunk: int = I_CHUNK):
    """pair_em_gather's function with the rows streamed through shared
    memory in chunks of i_chunk individuals inside every iteration (one
    block per pair). Any cohort size."""
    global LAUNCHES_ICHUNK
    _check(gn, sidx, maf)
    i_chunk = int(i_chunk)
    if i_chunk < 1:
        raise ValueError(f"i_chunk must be positive, got {i_chunk}")
    if _device_kind(gn, "pair-EM ichunk") == "cpu":
        return pair_em_ichunk_ref(gn, sidx, maf, ignore_miss_data, i_chunk)
    need = 2 * rows_smem_bytes(i_chunk, gn.element_size()) + _ROWS_RESERVED
    limit = smem_limits(gn.device)[1]
    if need > limit:
        raise ValueError(
            f"pair_em_ichunk: i_chunk {i_chunk} needs {need} bytes of shared "
            f"memory, the device allows {limit}")
    if sidx.shape[1] == 0:
        return _empty(gn, sidx)
    out = _launch("pair_em_ichunk", "ngsld_pair_em_ichunk", gn, sidx, maf,
                  ignore_miss_data, extra=(i_chunk,))
    LAUNCHES_ICHUNK += 1
    return out


GATHER_KERNELS = {"gather": pair_em_gather, "rows": pair_em_rows,
                  "ichunk": pair_em_ichunk}
