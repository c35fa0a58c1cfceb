"""ngsld_tpu_torch — PyTorch/CUDA port of the ngsld_tpu engine.

The gathered-pair sweep of the default single-device run, with the pair EM
in a hand-written CUDA kernel for Hopper (csrc/pair_em.cu). Host-side code
that never touched JAX (readers, the pair plan, refine, the native
formatter, checkpointing) is reused from ngsld_tpu unchanged; this package
imports torch and never jax.
"""

__version__ = "0.1.0"
