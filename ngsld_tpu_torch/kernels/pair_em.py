"""Gathered-pair EM: the CUDA kernel's wrapper and its plain twin.

pair_em_gather runs the EM for the pairs sidx (2, P) straight from the
device-resident site table: on a CUDA tensor it launches
csrc/pair_em.cu (the port of ngsld_tpu/kernels/pallas_em.py::_em_kernel)
or raises; on a CPU tensor it runs pair_em_gather_ref, the plain
PyTorch version. LAUNCHES counts kernel launches, nothing else.
"""

from __future__ import annotations

import torch

from ..ops.em import pair_em

LAUNCHES = 0


def pair_em_gather_ref(gn: torch.Tensor, sidx: torch.Tensor,
                       maf: torch.Tensor, ignore_miss_data: bool):
    """Plain twin: index_select of both sites' rows, then ops.em.pair_em.

    As in the kernel, the EM runs in f64 whatever the table dtype, and f
    comes back in the table dtype: an f32 EM stops one iteration away from
    the f64 reference wherever eps lands within f32 rounding of EPSILON."""
    s1, s2 = sidx[0].long(), sidx[1].long()
    f, n_iter, n_used = pair_em(
        gn.index_select(0, s1).double(), gn.index_select(0, s2).double(),
        maf.index_select(0, s1).double(), maf.index_select(0, s2).double(),
        ignore_miss_data)
    return f.to(gn.dtype), n_iter, n_used


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


def pair_em_gather(gn: torch.Tensor, sidx: torch.Tensor, maf: torch.Tensor,
                   ignore_miss_data: bool):
    """EM for P gathered pairs -> (f (P, 4), n_iter (P,) int32,
    n_used (P,) int32), in gn's dtype."""
    global LAUNCHES
    _check(gn, sidx, maf)
    if gn.device.type == "cpu":
        return pair_em_gather_ref(gn, sidx, maf, ignore_miss_data)
    if gn.device.type != "cuda":
        raise ValueError(f"no pair-EM kernel for device {gn.device}")
    from .build import get_library
    lib = get_library("pair_em")
    gn, sidx, maf = gn.contiguous(), sidx.contiguous(), maf.contiguous()
    P, I = sidx.shape[1], gn.shape[1]
    f = torch.empty((P, 4), dtype=gn.dtype, device=gn.device)
    n_iter = torch.empty(P, dtype=torch.int32, device=gn.device)
    n_used = torch.empty(P, dtype=torch.int32, device=gn.device)
    if P == 0:
        return f, n_iter, n_used
    fn = (lib.ngsld_pair_em_f32 if gn.dtype == torch.float32
          else lib.ngsld_pair_em_f64)
    with torch.cuda.device(gn.device):
        stream = torch.cuda.current_stream(gn.device).cuda_stream
        err = fn(gn.data_ptr(), sidx.data_ptr(), maf.data_ptr(), P, I,
                 int(bool(ignore_miss_data)), f.data_ptr(), n_iter.data_ptr(),
                 n_used.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pair_em CUDA kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return f, n_iter, n_used
