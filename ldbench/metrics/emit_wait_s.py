"""emit_wait_s: seconds a job the sweep's main thread waited on the emit
(hostcols.py, native/, io/writer.py): its blocked hand-offs of results to
the emit threads and its final drain of them (stage `sweep: emit
wait`)."""

from . import mean_stage


def read(run):
    return mean_stage(run, "sweep: emit wait")
