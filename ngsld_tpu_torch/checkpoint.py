"""Checkpoint/resume state for the block engine
(ngsld_tpu/checkpoint.py::_Checkpoint).

The reference has no checkpointing at all (SURVEY.md §5: a killed run
restarts). _Checkpoint keeps per-block TSV shards plus a manifest that
pins a config fingerprint, so shards from a different run config are
never silently reused. The ring engine's spill (_RingSpill there) comes
with the ring sweep.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import TYPE_CHECKING

from . import strict
from .config import Params

if TYPE_CHECKING:   # annotation-only (from __future__ import annotations)
    from .utils.logging import RunLog


def _config_fingerprint(pars: Params, extra: dict = None) -> str:
    """Identifies a run for checkpoint compatibility: anything that changes
    the pair plan or the numbers invalidates existing shards."""
    key = {k: getattr(pars, k) for k in (
        "in_geno", "in_probs", "in_logscale", "n_ind", "n_sites", "in_pos",
        "in_pos_header", "max_kb_dist", "max_snp_dist", "min_maf",
        "ignore_miss_data", "call_geno", "N_thresh", "call_thresh",
        "rnd_sample", "extend_out", "precision", "chunk_pairs")}
    if pars.rnd_sample < 1.0:
        # the seed shapes the pair plan only when sampling; with the default
        # time-based seed and no sampling, resume must still work
        key["seed"] = pars.seed
    if extra:
        key.update(extra)
    return hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


class _Checkpoint:
    """Per-block output shards: part_NNNNNN.tsv written atomically; a
    manifest pins the config fingerprint. Completed blocks are skipped on
    resume; the final output is the in-order concatenation."""

    def __init__(self, cdir: str, pars: Params, log: RunLog, extra: dict = None):
        self.dir = cdir
        self.log = log
        os.makedirs(cdir, exist_ok=True)
        fp = _config_fingerprint(pars, extra)
        mpath = os.path.join(cdir, "MANIFEST.json")
        if os.path.exists(mpath):
            with open(mpath) as fh:
                man = json.load(fh)
            if man.get("fingerprint") != fp:
                raise strict.StrictError(
                    "checkpoint", f"checkpoint dir {cdir} belongs to a "
                    "different run configuration; remove it or change --checkpoint")
        else:
            tmp = mpath + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"fingerprint": fp}, fh)
            os.replace(tmp, mpath)  # never leave a truncated manifest

    def path(self, i: int) -> str:
        return os.path.join(self.dir, f"part_{i:06d}.tsv")

    def done(self, i: int) -> bool:
        return os.path.exists(self.path(i))

    def open_block(self, i: int):
        return open(self.path(i) + ".tmp", "wb")

    def commit_block(self, i: int) -> None:
        os.replace(self.path(i) + ".tmp", self.path(i))

    def concatenate(self, out_fh, n_blocks: int) -> None:
        binary = not hasattr(out_fh, "encoding")
        for i in range(n_blocks):
            with open(self.path(i), "rb") as fh:
                while True:
                    chunk = fh.read(1 << 20)
                    if not chunk:
                        break
                    out_fh.write(chunk if binary else chunk.decode())
