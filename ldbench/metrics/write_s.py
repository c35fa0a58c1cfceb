"""write_s: seconds a job in the emit's write stage (rows to the
output)."""

from . import mean_stage


def read(run):
    return mean_stage(run, "sweep: write")
