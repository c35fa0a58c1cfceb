"""Host helpers of the block sweep, copied from ngsld_tpu/engine_block.py
(:37-123): the plan prefetch thread and the NumPy derive of the stat
columns from a block's (r2p, hap freqs) pull."""

from __future__ import annotations

import queue
import threading

import numpy as np


def _prefetch_blocks(gen, depth: int = 4):
    """Run a generator in a daemon thread, yielding through a bounded queue.

    Plan construction (plan.band) is a multi-second NumPy pass at large
    n_sites; the big ops release the GIL, so producing blocks concurrently
    hides the plan behind device compute. Closing the returned generator
    stops the producer promptly (GracefulStop path)."""
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def produce():
        try:
            for item in gen:
                while True:
                    if stop.is_set():
                        return
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
            q.put(_END)
        except BaseException as e:  # surface plan errors on the consumer
            q.put((_ERR, e))

    t = threading.Thread(target=produce, daemon=True,
                         name="ngsld-plan-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()


def _stats_host(f):
    """NumPy mirror of ops.stats.ld_stats: same op order, same dtype as the
    EM output, so host-derived stats match device-derived ones bitwise
    (ngsLD.cpp:296-306 semantics, incl. the C min() NaN asymmetry)."""
    maf0 = 1 - (f[:, 0] + f[:, 1])
    maf1 = 1 - (f[:, 0] + f[:, 2])
    D = f[:, 0] * f[:, 3] - f[:, 1] * f[:, 2]

    def c_min(a, b):
        return np.where(a <= b, a, b)

    with np.errstate(all="ignore"):
        neg = -c_min(maf0 * maf1, (1 - maf0) * (1 - maf1))
        pos = c_min(maf0 * (1 - maf1), (1 - maf0) * maf1)
        Dp = D / np.where(D < 0, neg, pos)
        rr = D / np.sqrt(maf0 * maf1 * (1 - maf0) * (1 - maf1))
        return maf0, maf1, D, Dp, rr * rr


def _chi2_host(f):
    """NumPy mirror of ops.stats.chi2_stat: float32 accumulator, terms in
    the EM dtype (the reference computes chi2 in float, ngsLD.cpp:328-333)."""
    f32 = np.float32
    freq_A = (f[:, 0] + f[:, 1]).astype(f32)
    freq_B = (f[:, 0] + f[:, 2]).astype(f32)
    exp_hap = np.stack([freq_A * freq_B, freq_A * (1 - freq_B),
                        (1 - freq_A) * freq_B, (1 - freq_A) * (1 - freq_B)],
                       axis=1)
    with np.errstate(all="ignore"):
        diff = f - exp_hap.astype(f.dtype)
        terms = (diff * diff) / exp_hap.astype(f.dtype)
        chi2 = np.zeros(f.shape[0], f32)
        for i in range(4):  # sequential float32 rounding, like the reference
            chi2 = (chi2.astype(f.dtype) + terms[:, i]).astype(f32)
    return chi2


def _unpack(fmat, imat, extend_out=True):
    r2p, f = fmat[:, 0], fmat[:, 1:5]
    hmaf0, hmaf1, D, Dp, r2 = _stats_host(f)
    chi2 = _chi2_host(f) if extend_out \
        else np.zeros(len(f), np.float32)  # column not printed
    return (r2p, f, imat[:, 0], imat[:, 1], hmaf0, hmaf1, D, Dp, r2, chi2)
