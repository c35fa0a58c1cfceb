"""Narrowing and checking of the binary GL loader's slabs: the wrapper of
csrc/gl_narrow.cu and its plain version.

narrow_check(raw, dtype, in_log, flag) takes a slab of records as the
binary GENO file holds them, (k, m, 3) float64, and returns them in the
table's dtype: float32 rounded to nearest (numpy's astype), or raw itself
for float64, which is only checked. It ORs 1 into flag, a (1,) int32
tensor on raw's device, when a record in that dtype holds a NaN or a
+inf, or in log scale is three -infs, or in linear scale holds a
negative: the records the reference's post_prob turns into a NaN
(read_data.cpp:42-45). The caller reads the flag after a synchronisation
and raises the reference's "NaN found!" error.

On a CUDA tensor it launches the kernel on the current stream, without
synchronising, or raises; on a CPU tensor it runs the plain version.
LAUNCHES counts the kernel's launches (one a slab on the main path).
"""

from __future__ import annotations

import torch

LAUNCHES = 0


def narrow_check_ref(raw: torch.Tensor, dtype: torch.dtype, in_log: bool,
                     flag: torch.Tensor) -> torch.Tensor:
    """The plain version of narrow_check."""
    out = raw.to(dtype)
    bad = out.isnan().any() | out.isposinf().any()
    if in_log:
        bad |= out.isneginf().all(dim=-1).any()
    else:
        bad |= (out < 0).any()
    flag |= bad.to(torch.int32)
    return out


def narrow_check(raw: torch.Tensor, dtype: torch.dtype, in_log: bool,
                 flag: torch.Tensor) -> torch.Tensor:
    """raw (..., 3) float64 records -> the records in dtype (float32 or
    float64), flag |= 1 on a bad record (module docstring). On the card
    raw must start on 16 bytes (a tensor of its own)."""
    global LAUNCHES
    if raw.dtype != torch.float64 or raw.shape[-1] != 3:
        raise ValueError(f"narrow_check: records (..., 3) float64, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"narrow_check: no {dtype} tables")
    if flag.dtype != torch.int32 or flag.shape != (1,) or \
            flag.device != raw.device:
        raise ValueError("narrow_check: flag must be (1,) int32 on the "
                         "records' device")
    if raw.device.type == "cpu":
        return narrow_check_ref(raw, dtype, in_log, flag)
    if raw.device.type != "cuda":
        raise ValueError(f"no gl_narrow kernel for device {raw.device}")
    raw = raw.contiguous()
    if raw.data_ptr() % 16:
        raise ValueError("narrow_check: the kernel reads 16-byte aligned "
                         "records (a tensor of their own, not a view)")
    from .build import get_library
    n_rec = raw.numel() // 3
    f64 = dtype == torch.float64
    out = raw if f64 else torch.empty(raw.shape, dtype=dtype,
                                      device=raw.device)
    if n_rec == 0:
        return out
    lib = get_library("gl_narrow")
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        if f64:
            err = lib.ngsld_gl_check_f64(raw.data_ptr(), n_rec, int(in_log),
                                         flag.data_ptr(), stream)
        else:
            err = lib.ngsld_gl_narrow_f32(raw.data_ptr(), out.data_ptr(),
                                          n_rec, int(in_log),
                                          flag.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gl_narrow CUDA kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
