#!/usr/bin/env python3
"""Probe (not part of the port): the accuracy of the first call of MKL's
vector math in a process, which torch's exp, log and sqrt make on CPU
tensors, one chunk of the tensor a thread of the OpenMP team.

Each trial is a new process that first calls the kind's warm functions on
8 floats each (below the ops' grain, so on the calling thread alone, as
ngsld_tpu_torch/ops/vecmath.py does), and then its measured function over
65,536 floats (8 chunks of 8,192 on 8 threads), held against numpy's in
f64: a chunk whose largest relative error passes 1e-7 is bad (the
library's high-accuracy mode stays within 6e-8). A kind is written
WARM:MEASURED, "-" for no warm call:

  -:exp          the process's first exp is the large one (F4's fault)
  exp:exp        the repair for exp alone
  -:sqrt         whether sqrt's first call shows the fault too
  exp,log:sqrt   whether a first exp and log set up the library for sqrt
                 (the library's set-up is process-wide) or not (one
                 function at a time)
  exp,log,sqrt:sqrt  what ops/vecmath.ready() does now

Trials run --jobs at a time, the kinds in turns, so that all see the same
load. Run from the root of the repo on the CPU:

    python3 probes/vecmath_first_call.py --trials 400 --jobs 8

It prints, for each kind, the trials, the bad ones, and each bad trial's
chunk errors. No result is the port's: it describes the CPU build of
torch this is run with (torch.__config__.parallel_info() is printed).
"""

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

KINDS = ("-:exp", "exp:exp", "-:sqrt", "exp,log:sqrt", "exp,log,sqrt:sqrt")

TRIAL = """
import sys
import numpy as np
rng = np.random.default_rng(int(sys.argv[1]))
warm, op = sys.argv[2].split(":")
lo, hi = {"exp": (-12, 0), "log": (1e-6, 0.5), "sqrt": (1e-6, 1)}[op]
a = rng.uniform(lo, hi, 65536).astype(np.float32)
import torch
for w in warm.split(","):
    if w != "-":
        getattr(torch, w)(torch.full((8,), 0.5))
y = getattr(torch, op)(torch.from_numpy(a))
ref = getattr(np, op)(a.astype(np.float64))
rel = np.abs(y.double().numpy() - ref) / np.abs(ref)
print(" ".join("%.3e" % rel[i * 8192:(i + 1) * 8192].max() for i in range(8)))
"""


def trial(args):
    seed, kind = args
    out = subprocess.run([sys.executable, "-c", TRIAL, str(seed), kind],
                         capture_output=True, text=True, check=True).stdout
    return kind, [float(v) for v in out.split()]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=400)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--kinds", default=";".join(KINDS),
                    help="kinds WARM:MEASURED, ';'-separated")
    opts = ap.parse_args()
    kinds = opts.kinds.split(";")
    import torch
    print(torch.__version__, torch.__config__.parallel_info().splitlines()[1:6])
    work = [(k // len(kinds), kinds[k % len(kinds)])
            for k in range(len(kinds) * opts.trials)]
    seen = {kind: [] for kind in kinds}
    with ThreadPoolExecutor(opts.jobs) as ex:
        for kind, errs in ex.map(trial, work):
            seen[kind].append(errs)
    for kind, rows in seen.items():
        bad = [r for r in rows if max(r) > 1e-7]
        print(f"{kind}: {len(rows)} trials, {len(bad)} with a bad chunk"
              + "".join(f"\n  {' '.join('%.1e' % e for e in r)}"
                        for r in bad))


if __name__ == "__main__":
    main()
