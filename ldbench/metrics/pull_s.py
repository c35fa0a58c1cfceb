"""pull_s: seconds a job the emit pipeline waited for a device step's
results (compute.py; dispatch in engine_block.py)."""

from . import mean_stage


def read(run):
    return mean_stage(run, "sweep: result pull")
