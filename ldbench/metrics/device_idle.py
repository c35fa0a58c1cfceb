"""device_idle: the share of the profiled job's wall, in %, in which no
kernel, copy or memset ran on the device (the busy union, trace.py)."""


def read(run):
    if run.profile is None or run.profile["wall_s"] <= 0:
        return None
    p = run.profile
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
