"""One LD job through the port's own entry: cli.params_from_args on the
job's argv, then engine.run_torch with the harness's sink as the output
(what cli.main does, without its error printing)."""

from __future__ import annotations

import json
import os
import time

import torch

from .sink import RowSink


def argv_for(job: dict, flags: list, seed: int) -> list:
    argv = ["--geno", job["geno"], "--n_ind", str(job["n_ind"]),
            "--n_sites", str(job["n_sites"]), "--pos", job["pos"], *flags]
    if job["format"] == "beagle":
        argv.append("--probs")
    else:
        argv.append("--log_scale")
    if "--rnd_sample" in flags:
        argv += ["--seed", str(seed)]
    return argv


class JobRunner:
    """Runs jobs over fixed argv; each job's timings JSON goes to its own
    file under tmp_dir and is read back once the job has ended."""

    def __init__(self, argv: list, tmp_dir: str):
        from ngsld_tpu_torch.cli import params_from_args
        from ngsld_tpu_torch.engine import run_torch
        self._params, self._run = params_from_args, run_torch
        self.argv, self.tmp_dir = argv, tmp_dir
        self.sink = RowSink()
        self.n = 0

    def run(self):
        """-> (rows, seconds, timings). The host clock stops after the
        device has finished: the port pulls every result before it
        returns."""
        path = os.path.join(self.tmp_dir, f"timings.{self.n}.json")
        self.n += 1
        os.environ["NGSLD_TIMINGS_JSON"] = path
        t0 = time.perf_counter()
        self._run(self._params(self.argv), out_fh=self.sink)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with open(path) as fh:
            timings = json.load(fh)
        os.unlink(path)
        return self.sink.take(), dt, timings
