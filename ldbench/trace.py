"""One job under torch.profiler: device busy time, time by device
operation, and the idle gaps labelled by what the host was doing.

Busy time is the union of the device events' [ts, ts + dur) intervals
(kernels, copies, memsets), so overlapping events count once: a frozen
copy of the arithmetic of ngsld_tpu_torch/utils/devtrace.py."""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


def device_spans(events):
    spans, by_name = [], {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        t0, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + dur
    return sorted(spans), by_name


def busy_union(spans):
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def idle_gaps(spans, t_lo, t_hi):
    """The intervals of [t_lo, t_hi) that no device event covers."""
    gaps, end = [], t_lo
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t_hi > end:
        gaps.append((end, t_hi))
    return gaps


SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize")


def label_gap(gap, host_events):
    """The host event that overlaps the gap longest, by name. A thread
    that waits in a synchronize call names no work: a gap under only such
    a wait, or under no traced host event, is host work outside torch
    (Python, NumPy, the port's native formatter, file reads)."""
    g0, g1 = gap
    best, name, waiting = 0.0, None, None
    for ev in host_events:
        t0 = float(ev["ts"])
        ov = min(g1, t0 + float(ev.get("dur", 0.0))) - max(g0, t0)
        if ov <= 0:
            continue
        if ev["name"] in SYNC_CALLS:
            waiting = ev["name"]
        elif ov > best:
            best, name = ov, ev["name"]
    if name is not None and best >= 0.5 * (g1 - g0):
        return name
    return "host work outside torch ops" + (
        f" (a thread in {waiting})" if waiting else "")


def profile_job(run_job, tmp_dir: str):
    """run_job() under the profiler -> (result, report) with busy_s,
    wall_s, by_name (seconds a device operation, summed), breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run_job()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(tmp_dir, "profile.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    spans, by_name = device_spans(events)
    busy = busy_union(spans)
    host = [ev for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in HOST_CATS]
    t_lo = min([float(ev["ts"]) for ev in host] + [s[0] for s in spans],
               default=0.0)
    gaps = idle_gaps(spans, t_lo, t_lo + wall * 1e6)
    top = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    report = dict(
        busy_s=busy / 1e6, wall_s=wall,
        by_name={k: v / 1e6 for k, v in by_name.items()},
        breakdown={"device_ops": [[k[:160], v / 1e6] for k, v in ops],
                   "idle_gaps": [[label_gap(g, host)[:160],
                                  (g[1] - g[0]) / 1e6] for g in top]})
    return res, report
