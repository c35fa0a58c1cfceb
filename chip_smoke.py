#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ngsld_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result and seconds on its own line:
  1. environment: card name and power limit (nvidia-smi), torch/CUDA/nvcc
     versions, whether the native host library loaded
  2. build: the CUDA kernels from csrc/, timed
  3. kernel vs plain on the card: pair_em_gather against its plain PyTorch
     twin (f to f's rounding, nIter and n_used exact) at the main path's
     524,288-pair block x 100 individuals (f32 and f64, --ignore_miss_data
     off and on, x = 0 pairs included), at I = 37 and I = 1,200; kernel
     and plain times at 524,288 x 100
  4. the slice vs the strict oracle: the port's CLI on the card against
     --engine strict, 24 x 2,000 fixture, four flag variants
  5. real size: 25,000 sites x 100 individuals, --max_kb_dist 100
     --extend_out, through the port's CLI; row count against the host
     plan, kernel launches against the block count, a row sample against
     strict recomputes; wall, stage split and pairs/s
  6. device idle share: the phase 5 run under torch.profiler; busy time
     is the union of the trace's device intervals

Then one JSON line of per-kernel results and, last, the `ok` line. Any
failure exits non-zero without those lines; so does a machine without a
CUDA device. JAX is blocked from import for the whole run: the port and
the host modules it reuses from ngsld_tpu never import it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

sys.modules["jax"] = None   # any `import jax` below raises ImportError

import numpy as np  # noqa: E402

MAIN_P, MAIN_I = 524_288, 100     # the default --chunk_pairs block, I = 100
REAL_S, REAL_I = 25_000, 100     # README's 25k row: ~4.5M pairs at kb100
ENGINE_TAG = "(torch, cuda"        # the engine's device in its config echo
F32_TOL, F64_TOL = 1e-6, 1e-12   # kernel vs twin: f's output rounding


def _phase(results, name, fn):
    """Run one phase; print PASS/FAIL and its seconds; record failure."""
    t0 = time.perf_counter()
    try:
        out = fn()
        ok = True
    except Exception:
        traceback.print_exc()
        out, ok = None, False
    dt = time.perf_counter() - t0
    print(f"[phase] {name}: {'PASS' if ok else 'FAIL'} ({dt:.3f} s)",
          flush=True)
    results.append(ok)
    return out


def _run(cmd):
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (r.stdout or r.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


# ---------------------------------------------------------------- phase 1

def phase_env():
    import torch
    from ngsld_tpu.native import get_lib
    from ngsld_tpu_torch.kernels.build import find_nvcc
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi)
    nvcc = find_nvcc()
    nv = _run([nvcc, "--version"]).splitlines()[-1] if nvcc else "not found"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}, nvcc {nv}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    native = get_lib() is not None
    print(f"native host library loaded: {native}"
          + ("" if native else " (pure-Python host formatter: walls below "
             "measure it, not the native path)"))
    return smi


# ---------------------------------------------------------------- phase 2

def phase_build():
    from ngsld_tpu_torch.kernels.build import build_library, get_library
    t0 = time.perf_counter()
    so = build_library()
    get_library()
    print(f"built {os.path.relpath(so)} in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------- phase 3

def _table(n_ind, n_sites, n_pairs, seed, dtype, device):
    """Site table + banded pairs, built as tests/test_pallas_em.py:9-17
    builds its inputs (simulate, normalise, MAF = mean E[G] / 2)."""
    import torch
    from ngsld_tpu.utils.simulate import simulate
    sim = simulate(n_ind=n_ind, n_sites=n_sites, seed=seed,
                   all_missing_site_rate=0.02)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = eg.mean(axis=1) / 2
    rng = np.random.default_rng(seed)
    s1 = np.sort(rng.integers(0, n_sites - 1, n_pairs))
    s2 = np.minimum(s1 + rng.integers(1, 256, n_pairs), n_sites - 1)
    gn_d = torch.from_numpy(gl).to(device=device, dtype=dtype).contiguous()
    maf_d = torch.from_numpy(maf).to(device=device, dtype=dtype)
    sidx = torch.from_numpy(np.stack([s1, s2]).astype(np.int32)).to(device)
    return gn_d, sidx, maf_d


def _check(kern, plain, tol, label):
    """Kernel vs plain twin. Both run the EM in f64 (the twin upcasts), so
    they agree to the rounding of f's dtype: f within `tol` (NaN where
    both are NaN), n_used and nIter exact on every pair, and x = 0 pairs
    frozen at nIter 0 with NaN f in both."""
    fk, itk, nuk = (t.cpu().numpy() for t in kern)
    fp, itp, nup = (t.cpu().numpy() for t in plain)
    if not np.array_equal(nuk, nup):
        raise AssertionError(f"{label}: n_used differs on "
                             f"{int((nuk != nup).sum())} pairs")
    if not np.array_equal(itk, itp):
        raise AssertionError(f"{label}: nIter differs on "
                             f"{int((itk != itp).sum())} of {len(itp)} pairs")
    nan_k, nan_p = np.isnan(fk), np.isnan(fp)
    if not np.array_equal(nan_k, nan_p):
        raise AssertionError(f"{label}: NaN positions differ on "
                             f"{int((nan_k != nan_p).sum())} values")
    err = float(np.max(np.abs(np.where(nan_k, 0, fk) - np.where(nan_p, 0,
                                                                    fp))))
    if not err <= tol:
        raise AssertionError(f"{label}: max |f_kernel - f_plain| {err} > {tol}")
    x0 = nup == 0
    if x0.any():
        for name, f, it in (("kernel", fk, itk), ("plain", fp, itp)):
            if not (np.isnan(f[x0]).all() and (it[x0] == 0).all()):
                raise AssertionError(f"{label}: x = 0 pairs not frozen at "
                                     f"nIter 0 with NaN f ({name})")
    print(f"  {label}: max|df| {err:.3e} (tol {tol:g}), nIter and n_used "
          f"exact, x=0 pairs {int(x0.sum())}")
    return err, int(x0.sum())


def _time(fn, reps=3):
    """Best of `reps` after a warm-up: CUDA events around the call, then a
    pulled scalar that depends on the outputs (proves the work ran)."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = fn()
        e1.record()
        chk = res[0].nan_to_num().sum() + res[1].sum()
        float(chk.item())
        best = min(best, e0.elapsed_time(e1))
    return best, out


def phase_kernel(card):
    import torch
    from ngsld_tpu_torch.kernels.pair_em import (pair_em_gather,
                                                 pair_em_gather_ref)
    dev = torch.device("cuda", 0)
    report = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        tag = "f32" if dtype == torch.float32 else "f64"
        gn, sidx, maf = _table(MAIN_I, 20_000, MAIN_P, 5, dtype, dev)
        for ign in (False, True):
            label = f"{tag} P={MAIN_P} I={MAIN_I} ignore_miss={ign}"
            if not ign:
                ms_k, kern = _time(lambda: pair_em_gather(gn, sidx, maf, ign))
                ms_p, plain = _time(
                    lambda: pair_em_gather_ref(gn, sidx, maf, ign))
            else:
                kern = pair_em_gather(gn, sidx, maf, ign)
                plain = pair_em_gather_ref(gn, sidx, maf, ign)
            err, n_x0 = _check(kern, plain, tol, label)
            if ign and n_x0 == 0:
                raise AssertionError(f"{label}: no x = 0 pairs in the case")
            if not ign:
                evals = int(kern[1].to(torch.int64).sum()) * MAIN_I
                report[tag] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err,
                                   evals_per_s=evals / (ms_k / 1e3))
                print(f"  {label}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms"
                      f", counted evals/s {evals / (ms_k / 1e3):.4e} "
                      f"[{card}]")
        del gn, sidx, maf
    for n_ind, n_pairs in ((37, 65_536), (1_200, 16_384)):
        gn, sidx, maf = _table(n_ind, 4_000, n_pairs, n_ind, torch.float32,
                               dev)
        for ign in (False, True):
            _check(pair_em_gather(gn, sidx, maf, ign),
                   pair_em_gather_ref(gn, sidx, maf, ign), F32_TOL,
                   f"f32 P={n_pairs} I={n_ind} ignore_miss={ign}")
    torch.cuda.synchronize()
    return report


# ---------------------------------------------------------------- phase 4

def _cli(argv):
    """The port's CLI in-process; returns (rc, captured stderr)."""
    from ngsld_tpu_torch.cli import main
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def phase_slice(tmp):
    from ngsld_tpu.utils.simulate import simulate, write_all
    from ngsld_tpu_torch.kernels import pair_em as kmod
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    files = write_all(simulate(n_ind=24, n_sites=2000, seed=7),
                      os.path.join(tmp, "slice"))
    common = ["--n_ind", "24", "--n_sites", "2000", "--pos", files["pos"],
              "--max_kb_dist", "10", "--min_maf", "0.05", "--extend_out"]
    beagle = ["--geno", files["beagle"], "--probs"]
    variants = {
        "default": beagle,
        "ignore_miss_data": beagle + ["--ignore_miss_data"],
        "rnd_sample": beagle + ["--rnd_sample", "0.5", "--seed", "12345"],
        "binary": ["--geno", files["glf"], "--log_scale"],
    }
    for name, inp in variants.items():
        r_out = os.path.join(tmp, f"port_{name}.ld")
        s_out = os.path.join(tmp, f"strict_{name}.ld")
        n0 = kmod.LAUNCHES
        t0 = time.perf_counter()
        rc, err = _cli(inp + common + ["--out", r_out])
        t_port = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: port rc {rc}\n{err}")
        if ENGINE_TAG not in err:
            raise AssertionError(f"{name}: engine did not report a cuda "
                                 f"device:\n{err[:2000]}")
        if kmod.LAUNCHES <= n0:
            raise AssertionError(f"{name}: no kernel launch")
        t0 = time.perf_counter()
        rc, err = _cli(inp + common + ["--engine", "strict", "--out", s_out])
        t_strict = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: strict rc {rc}\n{err}")
        with open(s_out) as fh:
            s_lines = fh.read().splitlines()
        with open(r_out) as fh:
            r_lines = fh.read().splitlines()
        cmp_vs_strict(s_lines, r_lines, 1000)
        print(f"  {name}: {len(r_lines) - 1} rows, pair set byte-exact, "
              f"f32 contract held; launches +{kmod.LAUNCHES - n0}; port "
              f"{t_port:.3f} s, strict {t_strict:.3f} s")


# ---------------------------------------------------------------- phase 5

class _CountingStdout:
    """Stands in for sys.stdout: counts the rows the CLI prints and keeps
    the header plus every `keep_every`-th row for a spot check."""

    def __init__(self, keep_every):
        self.buffer = self
        self.keep_every = keep_every
        self.n_lines = 0
        self.n_bytes = 0
        self.kept = []
        self._tail = b""

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        self.n_bytes += len(data)
        buf = self._tail + data
        lines = buf.split(b"\n")
        self._tail = lines.pop()
        for ln in lines:
            if self.n_lines % self.keep_every == 0:
                self.kept.append(ln.decode())
            self.n_lines += 1
        return len(data)

    def flush(self):
        pass


def phase_real(tmp, card):
    from ngsld_tpu.cli import params_from_args
    from ngsld_tpu.io.writer import RowWriter
    from ngsld_tpu.plan.band import iter_pair_blocks
    from ngsld_tpu.refine import StrictRefiner
    from ngsld_tpu.strict import read_pos
    from ngsld_tpu.utils.simulate import simulate, write_beagle, write_pos
    from ngsld_tpu_torch.kernels import pair_em as kmod
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict

    n_ind, n_sites = REAL_I, REAL_S
    t0 = time.perf_counter()
    # the 25k fixture of bench.py (_fixture_25k: contig_kb=500), as beagle
    sim = simulate(n_ind=n_ind, n_sites=n_sites, seed=17, contig_kb=500.0)
    d = os.path.join(tmp, "real")
    os.makedirs(d, exist_ok=True)
    geno, pos = os.path.join(d, "sim.beagle.gz"), os.path.join(d, "sim.pos")
    write_beagle(sim, geno)
    write_pos(sim, pos)
    print(f"  fixture written in {time.perf_counter() - t0:.3f} s")
    argv = ["--geno", geno, "--probs", "--n_ind", str(n_ind), "--n_sites",
            str(n_sites), "--pos", pos, "--max_kb_dist", "100",
            "--extend_out", "--verbose", "2"]

    # the host plan the run must emit (min_maf 0: the MAF filter passes all)
    pars = params_from_args(argv)
    pos_dist, _ = read_pos(pos, False, n_sites)
    n_pairs = n_blocks = 0
    for blk in iter_pair_blocks(pars, np.zeros(n_sites), pos_dist,
                                block_pairs=pars.chunk_pairs):
        n_pairs += len(blk.s1)
        n_blocks += 1
    print(f"  plan: {n_pairs} pairs in {n_blocks} blocks")

    timings = os.path.join(tmp, "timings.json")
    os.environ["NGSLD_TIMINGS_JSON"] = timings
    sink = _CountingStdout(keep_every=max(1, n_pairs // 1000))
    real_stdout = sys.stdout
    kmod.LAUNCHES = 0            # the main path's count starts here
    t0 = time.perf_counter()
    try:
        sys.stdout = sink
        rc, err = _cli(argv)   # its rows are on the host: no sync needed
    finally:
        sys.stdout = real_stdout
        os.environ.pop("NGSLD_TIMINGS_JSON", None)
    wall = time.perf_counter() - t0
    launches = kmod.LAUNCHES     # ... and is read here
    if rc != 0:
        raise AssertionError(f"real-size run rc {rc}\n{err[-4000:]}")
    if sink._tail:
        raise AssertionError("output does not end with a newline")
    if sink.n_lines != 1 + n_pairs:
        raise AssertionError(f"{sink.n_lines} lines, expected 1 + {n_pairs}")
    if launches != n_blocks:
        raise AssertionError(f"{launches} kernel launches for {n_blocks} "
                             "blocks")

    # spot check: ~1000 evenly spaced rows against strict recomputes
    labels = [f"{c}:{p}" for c, p in zip(sim.chrom, sim.pos)]
    site = {lab: i for i, lab in enumerate(labels)}
    rows = sink.kept[1:]
    s1 = np.array([site[r.split("\t")[0]] for r in rows], np.int64)
    s2 = np.array([site[r.split("\t")[1]] for r in rows], np.int64)
    chrom = np.array(sim.chrom)
    dist = np.where(chrom[s1] == chrom[s2],
                    (sim.pos[s2] - sim.pos[s1]).astype(np.float64), np.inf)
    ref = StrictRefiner(pars).refine_columns(s1, s2)
    data = RowWriter(None, labels, True).format_block(
        s1, s2, dist, ref["r2p"], ref["D"], ref["Dp"], ref["r2"],
        n_used=ref["n_used"], maf1=ref["maf1"], maf2=ref["maf2"],
        hap=ref["f"], hmaf1=ref["hmaf1"], hmaf2=ref["hmaf2"],
        chi2=ref["chi2"], n_iter=ref["n_iter"])
    s_lines = [sink.kept[0]] + data.decode().splitlines()
    cmp_vs_strict(s_lines, sink.kept, 100)

    with open(timings) as fh:
        tim = json.load(fh)
    print(f"  {sink.n_lines - 1} rows ({sink.n_bytes} bytes), {launches} "
          f"launches = blocks, {len(rows)} sampled rows within the f32 "
          "contract of strict")
    print(f"  wall {wall:.3f} s, {n_pairs / wall:.4e} pairs/s [{card}]")
    print("  phases: " + json.dumps(tim["phases"]))
    print("  stages: " + json.dumps(tim["stages"]))
    print("  counters: " + json.dumps(tim["counters"]))
    return dict(launches=launches, wall=wall, pairs=n_pairs, argv=argv)


# ---------------------------------------------------------------- phase 6

def phase_idle(tmp, card, real):
    """The phase 5 run again, under torch.profiler, rows to a file:
    device busy time = the union of the trace's kernel/memcpy/memset
    intervals, idle share = 1 - busy / wall."""
    from ngsld_tpu_torch.utils.devtrace import profile_busy
    argv = real["argv"]
    argv = argv[:argv.index("--verbose")] + [
        "--verbose", "0", "--out", os.path.join(tmp, "real", "prof.ld")]
    (rc, err), wall, busy, by_cat, by_kernel = profile_busy(
        lambda: _cli(argv))
    if rc != 0:
        raise AssertionError(f"profiled run rc {rc}\n{err[-4000:]}")
    em = sum(v for k, v in by_kernel.items() if "pair_em_kernel" in k)
    if not em > 0:
        raise AssertionError("no pair_em_kernel interval in the trace")
    print(f"  wall {wall:.3f} s, device busy {busy:.6f} s (union of "
          f"intervals), idle share {1 - busy / wall:.6f} [{card}]")
    print("  device s by category: " + json.dumps(by_cat))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print("  top kernels (s): " + json.dumps(dict(top)))
    return dict(wall=wall, busy=busy)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    results = []
    with tempfile.TemporaryDirectory(prefix="ngsld_chip_smoke_") as tmp:
        card = _phase(results, "1 environment", phase_env)
        _phase(results, "2 build", phase_build)
        rep = _phase(results, "3 kernel vs plain", lambda: phase_kernel(card))
        _phase(results, "4 slice vs strict", lambda: phase_slice(tmp))
        real = _phase(results, "5 real size", lambda: phase_real(tmp, card))
        if real is not None:
            _phase(results, "6 device idle share",
                   lambda: phase_idle(tmp, card, real))
    if not all(results):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    f32 = rep["f32"]
    print(json.dumps({"kernels": [{
        "name": "pair_em_gather", "route": "cuda",
        "source": "ngsld_tpu_torch/csrc/pair_em.cu",
        "replaces": "ngsld_tpu/kernels/pallas_em.py:57",
        "launches": real["launches"], "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
