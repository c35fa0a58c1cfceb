"""The port's CLI end to end on the CPU (asked for with NGSLD_PLATFORM=cpu;
f64, the kernels' plain versions): against --engine strict under the f64
column contract on the matrix of tests/test_engine.py:77-101, against the
JAX engine (run_jax, CPU f64), through a checkpoint kill-and-resume,
without the native library, with JAX and the JAX package blocked from
import, refusing the options the port does not implement yet, and
refusing to run on the CPU unasked."""

import glob
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from ngsld_tpu import strict
from ngsld_tpu.cli import params_from_args
from ngsld_tpu.engine import run_jax
from ngsld_tpu.utils.simulate import simulate, write_all
from ngsld_tpu_torch import engine_block
from ngsld_tpu_torch.cli import main
from ngsld_tpu_torch.engine import run_torch
from ngsld_tpu_torch.utils.conformance import cmp_vs_strict, compare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fixdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fix"))
    sim = simulate(n_ind=10, n_sites=250, seed=21, all_missing_site_rate=0.02,
                   mono_rate=0.05)
    return write_all(sim, d)


def _argv(paths, extra, geno="beagle"):
    inp = {"beagle": ["--geno", paths["beagle"], "--probs"],
           "geno_text": ["--geno", paths["geno_text"]],
           "glf": ["--geno", paths["glf"], "--log_scale"]}[geno]
    return inp + ["--n_ind", "10", "--n_sites", "250", "--pos", paths["pos"],
                  "--extend_out", "--verbose", "0"] + extra


def _run_cli(argv, out):
    assert main(argv + ["--out", str(out)]) == 0
    with open(out) as fh:
        return fh.read().splitlines()


@pytest.mark.parametrize("extra,geno", [
    (["--max_kb_dist", "10", "--min_maf", "0.05"], "beagle"),
    (["--max_kb_dist", "10", "--min_maf", "0.05", "--ignore_miss_data"],
     "beagle"),
    (["--max_kb_dist", "10", "--min_maf", "0.05", "--call_geno"], "beagle"),
    (["--max_kb_dist", "10", "--min_maf", "0.05", "--call_geno",
      "--N_thresh", "0.3", "--call_thresh", "0.9"], "beagle"),
    (["--max_kb_dist", "5", "--min_maf", "0.0"], "beagle"),
    (["--max_kb_dist", "10", "--min_maf", "0.05", "--rnd_sample", "0.5",
      "--seed", "12345"], "beagle"),
    (["--max_kb_dist", "10", "--min_maf", "0.05", "--chunk_pairs", "64"],
     "beagle"),
    (["--max_kb_dist", "10", "--min_maf", "0.05"], "geno_text"),
    (["--max_kb_dist", "10", "--min_maf", "0.05"], "glf"),
], ids=["default", "ignore_miss", "call_geno", "call_thresh", "kb5_maf0",
        "rnd_sample", "multi_block", "genotype_input", "binary_input"])
def test_cli_matches_strict(fixdir, tmp_path, extra, geno):
    argv = _argv(fixdir, extra, geno)
    t_rows = _run_cli(argv, tmp_path / "t.ld")
    s_rows = _run_cli(argv + ["--engine", "strict"], tmp_path / "s.ld")
    assert len(s_rows) > 1
    compare(s_rows, t_rows)


@pytest.mark.parametrize("extra", [
    ["--max_kb_dist", "10", "--min_maf", "0.05", "--ignore_miss_data"],
    ["--max_kb_dist", "5", "--min_maf", "0.0", "--chunk_pairs", "100"],
])
def test_matches_jax_engine(fixdir, extra):
    argv = _argv(fixdir, extra + ["--precision", "f64"])
    j, t = io.BytesIO(), io.BytesIO()
    run_jax(params_from_args(argv), out_fh=j)
    run_torch(params_from_args(argv), out_fh=t)
    j_rows = j.getvalue().decode().splitlines()
    t_rows = t.getvalue().decode().splitlines()
    assert len(j_rows) > 100
    compare(j_rows, t_rows)


def test_cli_f32_matches_strict_on_the_slice(tmp_path_factory, tmp_path):
    """--precision f32 (the card's default) on the chip smoke's 24 x 2,000
    slice, under the f32 column contract: the EM must run in f64 arithmetic
    even on f32 tables, or pair chrSIM_34:1341 / chrSIM_34:7350 stops one
    iteration late and its D' leaves the contract."""
    paths = write_all(simulate(n_ind=24, n_sites=2000, seed=7),
                      str(tmp_path_factory.mktemp("slice")))
    argv = ["--geno", paths["beagle"], "--probs", "--n_ind", "24",
            "--n_sites", "2000", "--pos", paths["pos"], "--max_kb_dist", "10",
            "--min_maf", "0.05", "--extend_out", "--verbose", "0"]
    t_rows = _run_cli(argv + ["--precision", "f32"], tmp_path / "t.ld")
    s_rows = _run_cli(argv + ["--engine", "strict"], tmp_path / "s.ld")
    cmp_vs_strict(s_rows, t_rows, 1000)


def test_checkpoint_kill_and_resume(fixdir, tmp_path, monkeypatch):
    argv = _argv(fixdir, ["--max_kb_dist", "10", "--min_maf", "0.05",
                          "--chunk_pairs", "128"])
    plain = io.BytesIO()
    run_torch(params_from_args(argv), out_fh=plain)

    cdir = tmp_path / "ck"
    real = engine_block.compute.compute_block
    calls = []

    def dies_at_block_3(*a, **k):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("killed")
        return real(*a, **k)

    monkeypatch.setattr(engine_block.compute, "compute_block",
                        dies_at_block_3)
    with pytest.raises(RuntimeError, match="killed"):
        run_torch(params_from_args(argv + ["--checkpoint", str(cdir)]),
                  out_fh=io.BytesIO())
    done = sorted(p for p in os.listdir(cdir) if p.startswith("part_"))
    assert done == [f"part_{i:06d}.tsv" for i in range(3)]

    monkeypatch.setattr(engine_block.compute, "compute_block", real)
    resumed = io.BytesIO()
    from ngsld_tpu_torch.utils.logging import RunLog
    counts = {}
    orig_summary = RunLog.summary

    def keep_counters(self):
        counts.update(self.counters)
        orig_summary(self)

    monkeypatch.setattr(RunLog, "summary", keep_counters)
    run_torch(params_from_args(argv + ["--checkpoint", str(cdir)]),
              out_fh=resumed)
    assert counts["blocks_resumed"] == 3
    assert resumed.getvalue() == plain.getvalue()


@pytest.mark.parametrize("strip,ext", [("0", []), ("0", ["--extend_out"]),
                                       ("1", ["--extend_out"])],
                         ids=["gather", "gather_extend", "strip_extend"])
def test_block_engine_without_the_native_library(fixdir, monkeypatch,
                                                 strip, ext):
    """The block engine with the native library unavailable to it and to
    RowWriter (get_lib gives None where they look it up) formats its rows
    with RowWriter.format_block, the degenerate pairs' repaired values
    written in: byte-equal to the run with the library."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", strip)
    # the strip EM's plain version runs many small tensor ops: more threads
    # only fight the other test workers for the cores
    n_threads = torch.get_num_threads()
    torch.set_num_threads(min(n_threads, 2))
    try:
        _without_native_library(fixdir, monkeypatch, ext)
    finally:
        torch.set_num_threads(n_threads)


def _without_native_library(fixdir, monkeypatch, ext):
    from ngsld_tpu_torch import native
    from ngsld_tpu_torch.io.writer import RowWriter
    from ngsld_tpu_torch.utils.logging import RunLog
    counts, calls = {}, []
    orig_summary, orig_format = RunLog.summary, RowWriter.format_block

    def keep_counters(self):
        counts.update(self.counters)
        orig_summary(self)

    def counted_format(self, *a, **k):
        calls.append(len(a[0]))
        return orig_format(self, *a, **k)

    monkeypatch.setattr(RunLog, "summary", keep_counters)
    monkeypatch.setattr(RowWriter, "format_block", counted_format)
    argv = [a for a in _argv(fixdir, [
        "--max_kb_dist", "10", "--min_maf", "0.05", "--precision", "f32",
        "--chunk_pairs", "300"]) if a != "--extend_out"] + ext
    with_lib = io.BytesIO()
    run_torch(params_from_args(argv), out_fh=with_lib)
    assert not calls
    with monkeypatch.context() as mp:
        mp.setattr(native, "get_lib", lambda: None)
        mp.setattr(engine_block, "get_lib", lambda: None)
        without = io.BytesIO()
        run_torch(params_from_args(argv), out_fh=without)
    assert sum(calls) == counts["pairs_emitted"] > 100
    assert counts["pairs_refined"] > 0 and counts["pairs_rederived"] > 0
    assert without.getvalue() == with_lib.getvalue()


@pytest.mark.parametrize("mode", ["0", "1", "ring"],
                         ids=["gather", "strip", "ring"])
def test_cli_runs_with_jax_blocked(fixdir, tmp_path, monkeypatch, mode):
    """The port's CLI in a process where neither jax nor the JAX package
    can be imported, through the gather sweep, the strip sweep and the
    ring sweep."""
    ring = []
    if mode == "ring":
        ring = ["--ring", "--ring_sub", "2"]
    else:
        monkeypatch.setenv("NGSLD_BLOCK_STRIP", mode)
    argv = _argv(fixdir, ["--max_kb_dist", "10", "--min_maf", "0.05",
                          "--precision", "f32"] + ring)
    in_proc = _run_cli(argv, tmp_path / "a.ld")
    out = tmp_path / "b.ld"
    code = ("import sys\n"
            "sys.modules['jax'] = None; sys.modules['ngsld_tpu'] = None\n"
            "from ngsld_tpu_torch.cli import main\n"
            f"rc = main({argv + ['--out', str(out)]!r})\n"
            "for name in ('jax', 'ngsld_tpu'):\n"
            "    assert sys.modules[name] is None and not [m for m in "
            "sys.modules if m.startswith(name + '.')], name + ' imported'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    with open(out) as fh:
        rows = fh.read().splitlines()
    assert rows == in_proc and len(rows) > 100


# torch runs exp, log and sqrt on CPU tensors in chunks of this many
# elements a thread (MKL's vector math); a call on fewer runs on the
# calling thread
_VECTOR_MATH_GRAIN = 2048


def test_first_vector_math_call_runs_on_one_thread(fixdir, tmp_path):
    """F4's guard. On CPU tensors torch's exp, log and sqrt call MKL's
    vector math, a chunk of at least _VECTOR_MATH_GRAIN elements a
    thread; the process's first such call, run on several threads at
    once, can compute one thread's chunk at a lower accuracy
    (ops/vecmath.py), and the port's MAF then came out low on that
    chunk's sites, so that test_cli_runs_with_jax_blocked's new process
    printed other bytes now and then. Here a new process runs the CLI
    with every exp, log and sqrt on a CPU tensor recorded: the first of
    each function and dtype must run below the grain, on the calling
    thread alone. Without the first calls that the package makes when
    imported (ops/vecmath.ready), the first exp was preprocess's over the
    whole 250 x 10 x 3 table."""
    rec = tmp_path / "first.json"
    argv = _argv(fixdir, ["--max_kb_dist", "10", "--min_maf", "0.05",
                          "--precision", "f32"])
    code = ("import json, sys, torch\n"
            "first = {}\n"
            "def recorded(name, fn):\n"
            "    def call(x, *a, **k):\n"
            "        if isinstance(x, torch.Tensor) and x.device.type == "
            "'cpu':\n"
            "            first.setdefault(f'{name} {x.dtype}', x.numel())\n"
            "        return fn(x, *a, **k)\n"
            "    return call\n"
            "torch.exp = recorded('exp', torch.exp)\n"
            "torch.log = recorded('log', torch.log)\n"
            "torch.sqrt = recorded('sqrt', torch.sqrt)\n"
            "from ngsld_tpu_torch.cli import main\n"
            f"rc = main({argv + ['--out', str(tmp_path / 'x.ld')]!r})\n"
            f"json.dump(first, open({str(rec)!r}, 'w'))\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO, NGSLD_BLOCK_STRIP="0")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    with open(rec) as fh:
        first = json.load(fh)
    assert {"exp torch.float32", "log torch.float32",
            "sqrt torch.float32"} <= set(first), first
    assert all(n < _VECTOR_MATH_GRAIN for n in first.values()), first


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = glob.glob(os.path.join(REPO, "ngsld_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 25
    pat = re.compile(r"^\s*(import|from)\s+(jax|ngsld_tpu)(\.|\s|$)", re.M)
    bad = []
    for path in files:
        with open(path) as fh:
            bad += [(os.path.relpath(path, REPO), m.group(0).strip())
                    for m in pat.finditer(fh.read())]
    assert bad == []
    # the pattern does find such imports where they exist
    assert pat.search("    from ngsld_tpu.strict import StrictError\n")
    assert pat.search("import jax\n") and pat.search("import jax.numpy\n")
    assert not pat.search("from ngsld_tpu_torch.cli import main\n")


def test_cli_refuses_the_cpu_unless_asked(fixdir, tmp_path, monkeypatch,
                                          capsys):
    """Without NGSLD_PLATFORM=cpu and without a CUDA device the engine
    refuses to run and prints no rows."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine would run on it")
    monkeypatch.delenv("NGSLD_PLATFORM")
    out = tmp_path / "x.ld"
    argv = _argv(fixdir, ["--max_kb_dist", "10"])
    assert main(argv + ["--out", str(out)]) == 1
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and "NGSLD_PLATFORM=cpu" in cap.err
    assert cap.out == "" and not os.path.exists(out)
    # rows to stdout: still none
    assert main(argv) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("extra,env,flag", [
    (["--shard", "2"], {}, "shard"),
    (["--shard_ind", "2"], {}, "shard"),
    (["--ring", "--shard", "2"], {}, "ring"),
])
def test_unported_options_are_refused(fixdir, tmp_path, monkeypatch, extra,
                                      env, flag):
    """--shard 2 and --shard_ind 2 were refused until the block engine ran
    on several devices, and --ring --shard 2 until the ring did: now each
    starts its second rank and prints the rows of its one-device run."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = _argv(fixdir, ["--max_kb_dist", "10"] + extra)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))   # the two ranks share these
    try:
        rows = _run_cli(argv, tmp_path / "x.ld")
    finally:
        torch.set_num_threads(n)
    one = _run_cli(_argv(fixdir, ["--max_kb_dist", "10"]
                         + (["--ring"] if flag == "ring" else [])),
                   tmp_path / "1.ld")
    assert len(rows) > 100
    if "--shard_ind" in extra:
        compare(one, rows)     # the cohort's sums add up in another order
    else:
        assert rows == one


def test_strict_engine_through_the_port_cli(fixdir, tmp_path):
    argv = _argv(fixdir, ["--max_kb_dist", "5", "--engine", "strict"])
    ported = _run_cli(argv, tmp_path / "p.ld")
    ref = io.StringIO()
    strict.run(params_from_args(argv), out_fh=ref)
    assert ported == ref.getvalue().splitlines()
