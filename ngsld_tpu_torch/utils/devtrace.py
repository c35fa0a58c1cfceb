"""Device busy time of a profiled call, from its Chrome trace.

Busy time is the union of the intervals of the device's own events
(kernels, memcpys, memsets), so an operator and the kernel it launched
are not counted twice, and neither are overlapping kernels on two
streams. `key_averages()` sums would count both.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace_events):
    """Chrome-trace events -> (busy_us, {cat: summed_us}, {kernel: summed_us}).

    busy_us is the length of the union of every device event's [ts,
    ts + dur) interval; the per-category and per-kernel sums are plain
    sums (they may overlap)."""
    spans, by_cat, by_kernel = [], {}, {}
    for ev in trace_events:
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        t0, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        if cat == "kernel":
            by_kernel[ev["name"]] = by_kernel.get(ev["name"], 0.0) + dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy, by_cat, by_kernel


def profile_busy(fn):
    """Run fn() under torch.profiler (CPU + CUDA activity) -> (result,
    wall_s, busy_s, by_cat, by_kernel). wall_s is the host clock around
    fn alone; the times by category and kernel are in seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    busy, by_cat, by_kernel = device_busy(events)
    return (res, wall, busy / 1e6, {k: v / 1e6 for k, v in by_cat.items()},
            {k: v / 1e6 for k, v in by_kernel.items()})
