"""ldbench: the benchmark of the PyTorch/CUDA port (ngsld_tpu_torch).

One run drives whole LD jobs through the port's CLI entry
(cli.params_from_args, then engine.run_torch) in-process, back to back
for a fixed window, and reports LD rows written per second, the set-up
time, per-layer readings from the port's timings JSON and the profiler,
and whether the rows are correct against the plain reference in
ldbench/reference/. Everything a cell needs is found by name: the
configuration in configs/, the cell in workloads/, each per-layer metric's
reader in metrics/.

    python3 ldbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""
