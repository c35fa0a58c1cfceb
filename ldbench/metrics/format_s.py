"""format_s: seconds a job in the emit's format stage (hostcols.py,
native/, io/writer.py), refine included where a job has any."""

from . import mean_stage


def read(run):
    return mean_stage(run, "sweep: format")
