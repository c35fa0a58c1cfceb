"""ingest_wait_s: seconds a job the gather sweep waited on the overlap
ingest (loaders._OverlapIngest) for its sites."""

from . import mean_stage


def read(run):
    return mean_stage(run, "sweep: ingest wait")
