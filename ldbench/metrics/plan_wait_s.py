"""plan_wait_s: seconds a job the sweep waited on the pair plan
(plan/band.py, plan/strips.py)."""

from . import mean_stage


def read(run):
    return mean_stage(run, "sweep: plan wait")
