"""Per-layer metric readers, one module a metric, each with
read(run) -> value or None. `run` carries the window's jobs (each job's
timings JSON: phases, stages, counters of the port's RunLog), their host
seconds, the profiled job's report (trace.profile_job, with its own
timings) in a traced run, the cell, and the device's name. A reader that
finds nothing to read returns None and the metric stays off the line."""

from __future__ import annotations


def mean_stage(run, key: str):
    """Mean seconds a job of the stage `key` (a RunLog count_time bucket),
    over the window's jobs; None if no job recorded it."""
    vals = [j["stages"][key] for j in run.jobs if key in j["stages"]]
    return sum(vals) / len(run.jobs) if vals else None


def mean_phases(run, names):
    """Mean seconds a job of the RunLog phases `names`, summed."""
    vals = [sum(j["phases"][n] for n in names if n in j["phases"])
            for j in run.jobs if any(n in j["phases"] for n in names)]
    return sum(vals) / len(run.jobs) if vals else None


def em_kernel_seconds(run):
    """Device seconds of the EM kernels (pair_em*.cu, strip_em*.cu) in
    the profiled job; None without a profile or without such a kernel."""
    if run.profile is None:
        return None
    s = sum(v for k, v in run.profile["by_name"].items()
            if "pair_em" in k or "strip_em" in k)
    return s or None
