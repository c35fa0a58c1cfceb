"""One benchmark run of a cell: set-up, a window of whole LD jobs back to
back through the port's CLI entry, the check of the rows against the
plain reference, and one JSON line.

    python3 ldbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (setup_s): importing torch and the port, CUDA, the kernels'
libraries from the port's build cache (ngsld_tpu_torch/.build/, built by
the first run in a checkout), the cell's input files made from --seed,
and one warm-up job with the cell's flags on the first warm_sites sites.
The window starts with the first job and ends with the last job that
started before --seconds had passed; every job in it runs to its end.
--trace 1 reads the per-layer metrics from the window's jobs and one more
job under torch.profiler after the window. The last lines on stderr and
the last key of the result line are the numbers compared, each beside
its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from ldbench import check, guard, inputs, jobs, manifest  # noqa: E402


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _fail(msg: str) -> int:
    sys.stderr.write(msg.rstrip() + "\n")
    return 1


def run_cell(args, cell: dict, bench: dict, *, device: str,
             device_kind: str) -> dict:
    """Set-up, window, check -> the result dict (without 'device')."""
    import torch
    conf = cell["config"]
    tmp_root = tempfile.gettempdir()
    t_data0 = time.perf_counter()
    data = inputs.CellInputs(args.seed, cell["n_sites"], conf["n_ind"],
                             conf["generator"], cell["format"],
                             warm_sites=cell["warm_sites"],
                             tmp_root=tmp_root)
    try:
        t_inputs = time.perf_counter()
        flags = cell["flags"] + ["--precision", conf["precision"]]
        jobs.JobRunner(jobs.argv_for(data.warm, flags, args.seed),
                       data.dir).run()
        runner = jobs.JobRunner(jobs.argv_for(data.job, flags, args.seed),
                                data.dir)
        setup_s = time.perf_counter() - T0
        sys.stderr.write(
            f"setup_s {setup_s!r}: imports and device "
            f"{t_data0 - T0:.3f} s, inputs {t_inputs - t_data0:.3f} s, "
            f"warm-up job {time.perf_counter() - t_inputs:.3f} s\n")

        kept, timings, secs, failed = [], [], [], 0
        t_start = time.perf_counter()
        deadline = t_start + args.seconds
        while True:
            try:
                rows, dt, tim = runner.run()
            except Exception:  # a job that raises ends the window
                traceback.print_exc()
                failed += 1
                break
            kept.append(rows)
            timings.append(tim)
            secs.append(dt)
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t_start
        if secs:
            sys.stderr.write(
                f"window {window_s:.3f} s: {len(secs)} jobs of "
                f"{min(secs):.3f} / {float(np.median(secs)):.3f} / "
                f"{max(secs):.3f} s (least / median / most)\n")
        peak = (torch.cuda.max_memory_allocated()
                if device == "cuda" else 0)

        counts = [r.count(b"\n") - 1 for r in kept]
        result = dict(attempted=len(kept) + failed, failed=failed,
                      memory_peak_bytes=peak)
        pick = int(np.random.default_rng(
            [args.seed & (2**63 - 1), 13]).integers(len(kept))) \
            if kept else None
        rows = kept[pick] if kept else None
        kept.clear()
        if device == "cuda":
            torch.cuda.empty_cache()

        if args.trace:
            holder = {}

            def job():
                holder["rows"], holder["dt"], holder["tim"] = runner.run()
            from ldbench import trace
            _, prof = trace.profile_job(job, data.dir)
            prof["timings"] = holder["tim"]
            run = SimpleNamespace(jobs=timings, job_seconds=secs,
                                  profile=prof, cell=cell,
                                  device_kind=device_kind)
            metrics = {}
            for m in manifest.metrics_for(args.workload, bench, True):
                v = manifest.reader(m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            result["metrics"] = metrics
            result["breakdown"] = prof["breakdown"]
            result["busy_s"] = prof["busy_s"]
            result["window_s"] = prof["wall_s"]
            del holder
        else:
            rate = sum(counts) / window_s
            units = {m["name"]: m["unit"] for m in
                     manifest.metrics_for(args.workload, bench, False)}
            result["metrics"] = {
                "pairs_per_s": {"value": rate, "unit": units["pairs_per_s"]},
                "setup_s": {"value": setup_s, "unit": units["setup_s"]}}

        if rows is None:
            result["checks"] = {}
            result["correct"] = False
            return result
        nums = check.check_job(rows, cell, data.job, data.labels,
                               data.contig, data.pos, args.seed,
                               device=device)
        # every job of the window ran the same input: each wrote as many
        # rows as the one compared
        nums["pairs_off"] += sum(abs(c - nums["rows"]) for c in counts)
        limits = cell["limits"]
        result["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                            for k in limits}
        result["correct"] = failed == 0 and all(
            nums[k] <= limits[k] for k in limits)
        result["compared"] = {"rows": nums["rows"],
                              "sampled_pairs": nums["compared"]}
        return result
    finally:
        data.close()


def main(argv=None, *, require_card: bool = True) -> int:
    args = _parser().parse_args(argv)
    bad = guard.forbidden_modules()
    if bad:
        return _fail(f"forbidden modules loaded at start: {bad}")
    bench = manifest.load_benchmark()
    cell = manifest.cell(args.workload, bench)
    import torch
    chips = int(cell["chips"])
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        device, kind = "cuda", torch.cuda.get_device_name(0)
    elif require_card:
        return _fail(f"{args.workload} needs {chips} CUDA device(s); "
                     f"torch.cuda.is_available() = "
                     f"{torch.cuda.is_available()}, device_count() = "
                     f"{torch.cuda.device_count()}")
    else:
        device, kind = "cpu", "cpu"
    import ngsld_tpu_torch  # noqa: F401  (no program: fail before any input)
    res = run_cell(args, cell, bench, device=device, device_kind=kind)
    bad = guard.forbidden_modules()
    if bad:
        return _fail(f"forbidden modules loaded by the run: {bad}")
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": res.pop("memory_peak_bytes"),
           "power_limit_w": _power_limit() if device == "cuda" else None}
    if args.trace:
        dev["busy_s"] = res.pop("busy_s")
        dev["window_s"] = res.pop("window_s")
    checks = res.pop("checks")
    out = {"correct": res.pop("correct"), "attempted": res.pop("attempted"),
           "failed": res.pop("failed"), "metrics": res.pop("metrics"),
           "device": dev, **res, "checks": checks}
    for k, v in checks.items():
        sys.stderr.write(f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                         "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
