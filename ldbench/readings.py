"""The readings a cell's limits are set from, on the card at the cell's
own size: for each seed, one job of the program through the timed path's
entry (the run's own job runner) compared with the reference, and with
--control the reference in bfloat16 put in the program's place.

    python3 ldbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control] [--out FILE]

One JSON line a seed and side: the numbers check.py compares. Not part
of a benchmark run."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from ldbench import check, inputs, jobs, manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = manifest.load_benchmark()
    cell = manifest.cell(a.workload, bench)
    conf = cell["config"]
    flags = cell["flags"] + ["--precision", conf["precision"]]
    out = open(a.out, "a") if a.out else None
    try:
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            data = inputs.CellInputs(seed, cell["n_sites"], conf["n_ind"],
                                     conf["generator"], cell["format"],
                                     tmp_root=tempfile.gettempdir())
            try:
                lines = []
                if a.program:
                    runner = jobs.JobRunner(
                        jobs.argv_for(data.job, flags, seed), data.dir)
                    rows, dt, tim = runner.run()
                    nums = check.check_job(rows, cell, data.job, data.labels,
                                           data.contig, data.pos, seed,
                                           device=device)
                    del rows
                    lines.append(dict(side="program", job_s=dt,
                                      counters=tim["counters"], **nums))
                if a.control:
                    nums = check.control_job(cell, data.job, data.contig,
                                             data.pos, seed, device=device)
                    lines.append(dict(side="control", **nums))
            finally:
                data.close()
            for ln in lines:
                ln = dict(workload=a.workload, seed=seed,
                          seconds=time.perf_counter() - t0, **ln)
                print(json.dumps(ln), flush=True)
                if out:
                    out.write(json.dumps(ln) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
