"""The import check: no loaded module may be JAX or the JAX package.
Top-level names (the part before the first dot) compare whole, so the
port, ngsld_tpu_torch, is not the JAX package, ngsld_tpu."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ngsld_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))
