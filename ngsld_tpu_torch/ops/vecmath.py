"""The first call of MKL's vector math in a process, made on one thread.

On CPU tensors torch's exp, log and sqrt call MKL's vector math library,
a chunk of at least 2,048 elements on each thread of the OpenMP team. MKL
sets that library up on its first call in a process, and when that first
call runs on several threads at once, a thread that comes in while it is
being set up can compute its chunk at a lower accuracy: up to 1.5e-4
relative for exp and 3.1e-4 for sqrt, where every other chunk is within
6e-8 (probes/vecmath_first_call.py: a new process's first call over
65,536 floats on 8 threads, 8 processes at a time: 49 of 400 had such a
chunk for exp, 50 of 400 for sqrt; none of 400 whose first call was on 8
floats, and none of 400 whose sqrt came after a first exp and log on 8
floats, so the set-up is the library's, not each function's). The port's
f32 MAF then came out low on that chunk's sites (chrSIM_7:2335 of the CLI
tests' fixture: 0.270738 where every other run prints 0.270740), and two
runs of one command printed other bytes. Calls after the first are exact
to the library's high-accuracy mode, whatever the team. ready() makes the
process's first exp, log and sqrt, in f32 and f64, on a tensor below the
grain, which torch runs on the calling thread alone: every function the
port calls on large CPU tensors, so that no one of them leans on another
having set the library up. The package calls it once, when imported.
"""

from __future__ import annotations

import torch

# elements of the first calls: below torch's grain for these ops (2,048),
# so they run on the calling thread
_WARM = 8


def ready() -> None:
    """Make the process's first exp, log and sqrt of MKL's vector math
    (f32 and f64) on this thread."""
    for dt in (torch.float32, torch.float64):
        x = torch.ones(_WARM, dtype=dt)
        torch.log(torch.exp(x))
        torch.sqrt(x)
