"""load_s: seconds a job in the input loaders (loaders.py): the phases
that read and upload the GL table and are not hidden under the sweep,
including the strip sweep's wait for an overlapped ingest to finish."""

from . import mean_phases

PHASES = ("Reading data from file", "  gl stream+upload", "  gl upload",
          "  gl ingest join (strip tables)")


def read(run):
    return mean_phases(run, PHASES)
