"""The yardstick's table of peaks and the EM kernels' needed work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit; a card set below it runs slower, so a run reports the card's
power limit beside every share): 67 TFLOP/s float32 and 34 TFLOP/s
float64 outside the tensor cores, 3.35 TB/s of HBM3."""

from __future__ import annotations

PEAKS = {
    "H100": {"f32": 67e12, "f64": 34e12, "bytes_per_s": 3.35e12},
}
# float operations of one EM update of one (pair, individual): the
# per-individual denominator (16 products of f_k f_h and two GL factors,
# summed), the four numerators and their division, as the kernels'
# shared body (ngsld_tpu_torch/csrc/em_core.cuh) writes it
EM_FLOPS = 40


def peaks(device_kind: str):
    for key, p in PEAKS.items():
        if key in device_kind:
            return p
    return None


def em_work(counters: dict, n_sites: int, n_ind: int, precision: str):
    """(flops, bytes) the EM of one job needs: one update a pair and an
    iteration up to its stop (the port counts em_iterations as the sum of
    0-based stop iterations, so a pair ran em_iteration + 1 updates), and
    the GL table read once, each pair's two site indices in and its four
    frequencies, stop iteration and sample size out."""
    pairs = counters.get("pairs_emitted", 0)
    updates = counters.get("em_iterations", 0) + pairs
    item = 4 if precision == "f32" else 8
    flops = updates * n_ind * EM_FLOPS
    nbytes = n_sites * n_ind * 3 * item + pairs * (8 + 4 * item + 8)
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float, device_kind: str,
                  precision: str):
    p = peaks(device_kind)
    if p is None:
        return None
    return max(flops / p[precision], nbytes / p["bytes_per_s"])
