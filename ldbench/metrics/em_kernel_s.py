"""em_kernel_s: device seconds of the EM kernels (pair_em*.cu,
strip_em*.cu) in the traced run's profiled job."""

from . import em_kernel_seconds


def read(run):
    return em_kernel_seconds(run)
