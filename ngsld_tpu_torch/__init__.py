"""ngsld_tpu_torch — PyTorch/CUDA port of the ngsld_tpu engine.

The default single-device run: the gathered-pair sweep and the dense strip
sweep, each with its EM in a hand-written CUDA kernel for Hopper
(csrc/pair_em.cu, csrc/strip_em.cu). The package stands alone: it keeps
its own copy of every host module it uses (readers, the pair plan, refine,
the native formatter, checkpointing, the CLI parser), imports torch, and
imports neither jax nor anything of ngsld_tpu.
"""

__version__ = "0.1.0"
