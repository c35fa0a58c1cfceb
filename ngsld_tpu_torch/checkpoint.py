"""Checkpoint/resume state for the torch engines (ngsld_tpu/checkpoint.py).

The reference has no checkpointing at all (SURVEY.md §5: a killed run
restarts). Here:
  * _Checkpoint: block engine, per-block TSV shards + manifest
  * _RingSpill:  ring engine, (sub-ring, step)-granular structured .npy
    spill that doubles as the emission buffer
Both pin a config fingerprint so shards from a different run config are
never silently reused.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import TYPE_CHECKING

import numpy as np

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


_RING_COLS = ("r2p", "f", "n_iter", "n_used", "hmaf1", "hmaf2",
              "D", "Dp", "r2", "chi2")


class _RingSpill:
    """Ring-mode emission spill + (--checkpoint) resume state.

    Every completed (sub-ring, ring step) writes each RESIDENT block's
    compacted surviving rows (the step tile after band / triangle / MAF /
    sampling masking) as one structured .npy per block, then commits the
    step with an atomic .done marker. Host memory during the sweep is
    O(one step's rows); the end-of-sweep emit is a bounded-memory merge
    over the spill (engine_ring._run_torch_ring), not an in-RAM
    accumulation.

    With --checkpoint the spill dir IS the checkpoint: completed steps
    (markers present) skip compute on resume and their tiles feed the merge
    straight from disk. Without --checkpoint the spill lives in a
    TemporaryDirectory. The file names carry the writing process (p00000
    on one device) as the reference's multi-host layout does, so a spill
    directory reads the same in both packages."""

    def __init__(self, cdir: str, pars: Params, extra: dict, proc: int,
                 persistent: bool):
        self.dir = cdir
        self.proc = proc
        self.persistent = persistent
        os.makedirs(cdir, exist_ok=True)
        if not persistent:
            return
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
            # atomic: a crash must never leave a truncated manifest behind
            tmp = mpath + f".tmp{proc}"
            with open(tmp, "w") as fh:
                json.dump({"fingerprint": fp, "mode": "ring"}, fh)
            os.replace(tmp, mpath)

    def _stem(self, si: int, t: int) -> str:
        return os.path.join(
            self.dir, f"ring_p{self.proc:05d}_s{si:04d}_t{t:04d}")

    def tile_path(self, si: int, t: int, i: int) -> str:
        return f"{self._stem(si, t)}_b{i:05d}.npy"

    def done(self, si: int, t: int) -> bool:
        return os.path.exists(self._stem(si, t) + ".done")

    @staticmethod
    def pack(cols: dict) -> np.ndarray:
        """{col: ndarray} -> one structured record array (rows stay in the
        tile's row-major (a, pj) order). Stat fields are whichever of
        _RING_COLS the caller provides: the compacted engine spills only
        (r2p, f, n_iter, n_used) and derives the rest at merge time."""
        n = len(cols["a"])
        keys = [k for k in _RING_COLS if k in cols]
        fields = [("a", cols["a"].dtype), ("pj", cols["pj"].dtype)]
        for k in keys:
            v = cols[k]
            fields.append((k, v.dtype, v.shape[1:]) if v.ndim > 1
                          else (k, v.dtype))
        rec = np.empty(n, dtype=np.dtype(fields))
        rec["a"], rec["pj"] = cols["a"], cols["pj"]
        for k in keys:
            rec[k] = cols[k]
        return rec

    def save_step(self, si: int, t: int, blocks: dict) -> None:
        """blocks: {resident block index -> {col: ndarray} or None}.
        Tiles write atomically; the .done marker commits the step last.

        Any tile files already present for this (si, t) are stale (left by
        a crashed, uncommitted attempt) and are removed first, so the merge
        glob never mixes them in. A stale .done marker is WITHDRAWN before
        the rewrite touches any tile: a crash mid-rewrite must leave the
        step uncommitted, never a live marker over missing/partial
        tiles."""
        import glob as _g
        marker = self._stem(si, t) + ".done"
        if os.path.exists(marker):
            os.unlink(marker)
        for stale in _g.glob(self._stem(si, t) + "_b*.npy"):
            os.unlink(stale)
        for i, cols in blocks.items():
            if cols is None:
                continue
            p = self.tile_path(si, t, i)
            with open(p + ".tmp", "wb") as fh:
                np.save(fh, self.pack(cols))
            os.replace(p + ".tmp", p)
        with open(marker + ".tmp", "w"):
            pass
        os.replace(marker + ".tmp", marker)

    def block_tiles(self, i: int) -> list:
        """All committed spill tiles of resident block i, (si, t)-sorted
        (merge order is re-established by the (a, pj) lexsort anyway)."""
        import glob as _g
        pat = os.path.join(self.dir,
                           f"ring_p{self.proc:05d}_s*_t*_b{i:05d}.npy")
        return sorted(_g.glob(pat))


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

    def done_set(self) -> set:
        """The blocks committed so far, by index (one listing of the dir):
        what a multi-device run's rank 0 sends every rank at resume."""
        return {int(p[5:11]) for p in os.listdir(self.dir)
                if p.startswith("part_") and p.endswith(".tsv")}

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
