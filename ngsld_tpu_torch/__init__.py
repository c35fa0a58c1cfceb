"""ngsld_tpu_torch — PyTorch/CUDA port of the ngsld_tpu engine.

The gathered-pair sweep and the dense strip sweep, each with its EM in
hand-written CUDA kernels for Hopper (csrc/), and the site-sharded ring
sweep (--ring), whose steps drive the same kernels (engine_ring,
parallel/ring); each on one device or on several, one process a device
over torch.distributed (parallel/mesh). The package stands alone: it keeps
its own copy of every host module it uses (readers, the pair plan, refine,
the native formatter, checkpointing, the CLI parser), imports torch, and
imports neither jax nor anything of ngsld_tpu.
"""

__version__ = "0.1.0"

from .utils.logging import PROCESS

with PROCESS.span("init: import"):
    from .ops import vecmath

    # the process's first vector-math calls, on one thread (ops/vecmath.py)
    vecmath.ready()
