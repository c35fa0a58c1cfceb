"""ngsld CLI on the torch engine: the flags of ngsld_tpu.cli, unchanged.

    python -m ngsld_tpu_torch.cli --geno data.beagle.gz --probs \
        --n_ind 24 --n_sites 10000 --pos data.pos --max_kb_dist 10 \
        --min_maf 0.05 --extend_out

--engine strict runs ngsld_tpu.strict (the bit-exact CPU oracle); auto and
jax run the torch engine (engine.run_torch).
"""

from __future__ import annotations

import sys

from ngsld_tpu.cli import params_from_args
from ngsld_tpu.config import ConfigError
from ngsld_tpu.strict import StrictError


def main(argv=None) -> int:
    try:
        pars = params_from_args(sys.argv[1:] if argv is None else argv)
    except ConfigError as e:
        sys.stderr.write(f"\n=====\nERROR: {e}\n=====\n\n")
        return 1
    try:
        if pars.engine == "strict":
            from ngsld_tpu import strict
            strict.run(pars)
        else:
            from .engine import run_torch
            run_torch(pars)
    except StrictError as e:
        sys.stderr.write(f"\n=====\n{e}\n=====\n\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
