"""What a run on the card can say about itself: device busy time of a
profiled call, the lane efficiency of a strip-EM or gather-EM launch, and
the instructions of a compiled kernel's inner loop.

Busy time is the union of the intervals of the device's own events
(kernels, memcpys, memsets), so an operator and the kernel it launched
are not counted twice, and neither are overlapping kernels on two
streams. `key_averages()` sums would count both.

Lane efficiency is read from the kernel's own n_iter: the (cell,
individual, iteration) updates the data needs over the lane-updates a
thread layout executes while lanes wait for their warp's (or block's)
slowest cell. The instruction counts come from `cuobjdump -sass` of a
built library (the profilers that would measure either do not run
everywhere).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
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


def lane_efficiency(n_iter, live, n_ind, rows=8, cols=32, cap=100,
                    round_iters=None):
    """Needed over executed EM updates of one strip_em launch.

    n_iter, live: (n, TA, TB) tensors, the kernel's stop iterations and the
    live-cell mask; a live cell that stopped at 0-based iteration k ran
    min(k + 1, cap) updates of n_ind individuals each, a dead cell none.
    Three thread layouts, each as needed / executed (1.0 when nothing
    runs):
      "warp":  one thread a cell, a warp = 32 consecutive partners of one
               anchor, every lane busy until the warp's longest cell stops;
      "block": rows x cols cells, one thread a cell, every lane busy until
               the block's longest cell stops;
      "repacked" (with round_iters = K): a block of rows x cols threads
               seats its running cells again every K iterations, in stable
               order, G lanes a cell (G the largest power of two, at most
               32, with cells x G <= threads), so an iteration of a warp
               takes 1 / G of a one-thread iteration; a warp leaves a round
               once all its cells have stopped. Executed counts the lanes
               of the warps still in the round.
    Returns {"needed": evals, "warp": .., "block": .., "repacked": ..}."""
    import torch
    n, ta, tb = n_iter.shape
    u = torch.where(live.bool(),
                    (n_iter.to(torch.int64) + 1).clamp(max=cap),
                    torch.zeros((), dtype=torch.int64, device=n_iter.device))
    needed = int(u.sum())

    def share(executed):
        return needed / executed if executed else 1.0

    out = {"needed": needed * n_ind,
           "warp": share(32 * int(u.reshape(n, ta, tb // 32, 32)
                                  .amax(dim=-1).sum()))}
    blocks = u.reshape(n, ta // rows, rows, tb // cols, cols) \
        .permute(0, 1, 3, 2, 4).reshape(-1, rows * cols)
    out["block"] = share(rows * cols * int(blocks.amax(dim=1).sum()))
    if round_iters:
        threads = rows * cols
        n_warps = threads // 32
        base = torch.arange(blocks.shape[0], device=u.device)[:, None] \
            * n_warps
        executed = 0.0
        for r0 in range(0, int(blocks.max()), round_iters):
            run = blocks > r0
            n_run = run.sum(dim=1, keepdim=True).clamp(min=1)
            # lanes a cell: the largest power of two <= min(32, threads/n)
            g = 2 ** torch.floor(torch.log2(
                (threads / n_run).clamp(max=32.0))).to(torch.int64)
            seat = base + (run.cumsum(dim=1) - 1) // (32 // g)   # its warp
            for it in range(r0, r0 + round_iters):
                act = blocks > it
                busy = torch.zeros(blocks.shape[0] * n_warps,
                                   dtype=torch.bool, device=u.device)
                busy[seat[act]] = True
                # a busy warp: 32 lanes for 1 / G of an iteration
                executed += float((busy.reshape(-1, n_warps).sum(dim=1)
                                   * 32.0 / g[:, 0]).sum())
        out["repacked"] = share(executed)
    return out


def gather_lane_use(n_iter, n_ind, group, n_groups, cap=100,
                    warps_per_block=4):
    """Needed over executed EM updates of one gather-EM launch, from its
    n_iter (P,), every pair live: a pair that stopped at 0-based iteration
    k ran min(k + 1, cap) updates of n_ind individuals. Two layouts:
      "warp":  one warp a pair (32 lanes over the individuals, ceil(I / 32)
               trips an iteration), blocks of warps_per_block consecutive
               pairs that keep their slot until their slowest pair stops;
      "queue": lane groups of `group` lanes a pair (ceil(I / G) trips an
               iteration), n_groups persistent groups, 32 / G to a warp,
               fed from a pair queue in index order: every group takes a
               pair at the start, and a group whose pair stops takes the
               next from the queue and starts it at the next step. A warp
               runs until its last group is done; executed counts all 32
               lanes of a running warp.
    All warps are taken to step at one rate. Returns {"needed": evals,
    "warp": .., "queue": ..} (1.0 when nothing runs)."""
    import heapq

    import numpy as np
    u = np.minimum(np.asarray(n_iter, dtype=np.int64) + 1, cap)
    P = len(u)
    needed = int(u.sum()) * n_ind

    def share(executed):
        return needed / executed if executed else 1.0

    out = {"needed": needed}
    pad = -P % warps_per_block
    blocks = np.concatenate([u, np.zeros(pad, np.int64)]).reshape(
        -1, warps_per_block)
    out["warp"] = share(warps_per_block * 32 * -(-n_ind // 32)
                        * int(blocks.max(axis=1).sum()))
    n_groups = max(1, min(n_groups, P))
    n_groups += -n_groups % (32 // group)   # whole warps
    end = np.zeros(n_groups, np.int64)      # when a group runs out of work
    heap = [(int(u[g]), g) for g in range(min(n_groups, P))]
    heapq.heapify(heap)
    nxt = len(heap)
    while heap:
        t, g = heapq.heappop(heap)
        end[g] = t
        if nxt < P:
            heapq.heappush(heap, (t + int(u[nxt]), g))
            nxt += 1
    steps = end.reshape(-1, 32 // group).max(axis=1)
    out["queue"] = share(32 * -(-n_ind // group) * int(steps.sum()))
    return out


# SASS opcode roots by class; anything else counts as "other"
_SASS_CLASSES = {
    "fp64": ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX"),
    "cvt": ("F2F", "F2I", "I2F", "I2FP", "F2FP", "FRND"),
    "mufu": ("MUFU",),
    "lds": ("LDS", "LDSM"),
    "ldg": ("LDG", "LD", "LDGSTS"),
    "st": ("STS", "STG", "ST"),
    "int": ("IMAD", "IADD3", "IADD", "LEA", "LOP3", "SHF", "ISETP", "MOV",
            "IMNMX", "VIADD", "VIMNMX", "SEL", "IABS", "PRMT", "SGXT",
            "UIADD3", "UMOV", "ULDC", "UIMAD", "ULEA", "USHF", "ULOP3",
            "UISETP", "R2UR", "S2R", "S2UR", "POPC", "FLO", "CS2R", "LDC",
            "USEL", "PLOP3", "UPLOP3", "P2R", "R2P"),
    "fp32": ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "FCHK"),
    "ctrl": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
             "BAR", "NOP", "YIELD", "BMOV", "BREAK", "DEPBAR", "LDGDEPBAR",
             "VOTE", "VOTEU", "SHFL"),
}
_SASS_CLASS_OF = {op: c for c, ops in _SASS_CLASSES.items() for op in ops}
_SASS_INSTR = re.compile(
    r"^\s*/\*([0-9a-fA-F]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
    r"([.\w]*)\s*(.*?)\s*;")


def sass_inner_loop(sass_text, name_parts):
    """Instruction counts of the arithmetic inner loop of one function in
    `cuobjdump -sass` output.

    The function is the first whose (mangled) name holds every string of
    name_parts. Its loops are the backward branches (a BRA to an address
    at or before itself); the inner loop is the innermost one (it holds no
    other) with the most double-precision instructions among those that
    hold a division (among all when none does: a loop over the warps'
    partial sums can hold more DADDs than the EM loop), or the whole
    function when it has no loop. Returns {"function", "loop": [first,
    last address] or None, "n_instr", one count per class of
    _SASS_CLASSES plus "other", "terms"}: "terms" is the number of
    MUFU.RCP64H in the loop, one for each double-precision division or
    reciprocal, which is the number of EM terms the compiler unrolled into
    one trip (at least 1). None when no function matches."""
    funcs, name = {}, None
    for line in sass_text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
            continue
        m = _SASS_INSTR.match(line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2),
                                m.group(3), m.group(4)))
    for name, instrs in funcs.items():
        if all(p in name for p in name_parts):
            break
    else:
        return None
    loops = []
    for addr, op, _, operands in instrs:
        m = re.search(r"0x([0-9a-fA-F]+)", operands)
        if op == "BRA" and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]

    def count(lo, hi):
        c = dict.fromkeys([*_SASS_CLASSES, "other"], 0)
        terms = 0
        for addr, op, mods, _ in instrs:
            if lo <= addr <= hi:
                c[_SASS_CLASS_OF.get(op, "other")] += 1
                terms += op == "MUFU" and "RCP64H" in mods
        return c, terms

    best, loop = None, None
    for lp in inner:
        c, terms = count(*lp)
        if best is None or (terms > 0, c["fp64"]) > (best[1] > 0,
                                                     best[0]["fp64"]):
            best, loop = (c, terms), lp
    if best is None:
        best = count(0, float("inf"))
    c, terms = best
    return {"function": name, "loop": list(loop) if loop else None,
            "n_instr": sum(c.values()), **c, "terms": max(terms, 1)}


def cuobjdump(lib_path, *flags):
    """Output of the toolkit's cuobjdump (found beside nvcc) on a built
    library; raises RuntimeError when the tool is missing or fails."""
    from ..kernels.build import find_nvcc
    nvcc = find_nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None
    if not tool or not os.path.isfile(tool):
        raise RuntimeError("cuobjdump not found beside nvcc")
    r = subprocess.run([tool, *flags, lib_path], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({r.returncode}): {r.stderr}")
    return r.stdout


def kernel_registers(res_usage_text, name_parts):
    """Registers a thread of the matching function, from `cuobjdump
    -res-usage` output; None when it is not listed."""
    for m in re.finditer(r"Function\s+(\S+?):\s*\n\s*REG:(\d+)",
                         res_usage_text):
        if all(p in m.group(1) for p in name_parts):
            return int(m.group(2))
    return None
