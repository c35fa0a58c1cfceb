"""em_roofline: the EM kernels' share of their roofline, in %: the least
time the card could take for the EM the profiled job needed (the larger
of its operations over the peak rate in the cell's precision and its
bytes once over the memory bandwidth; roofline.py) over the EM kernels'
device seconds."""

from .. import roofline
from . import em_kernel_seconds


def read(run):
    t = em_kernel_seconds(run)
    if t is None:
        return None
    c = run.cell
    flops, nbytes = roofline.em_work(run.profile["timings"]["counters"],
                                     c["n_sites"], c["config"]["n_ind"],
                                     c["config"]["precision"])
    bound = roofline.bound_seconds(flops, nbytes, run.device_kind,
                                   c["config"]["precision"])
    return None if bound is None or not flops else 100.0 * bound / t
