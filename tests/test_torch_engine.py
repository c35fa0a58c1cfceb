"""The port's CLI end to end on the CPU (asked for with NGSLD_PLATFORM=cpu;
f64, the kernels' plain versions): against --engine strict under the f64
column contract on the matrix of tests/test_engine.py:77-101, against the
JAX engine (run_jax, CPU f64), through a checkpoint kill-and-resume, with
JAX and the JAX package blocked from import, refusing the options the
port does not implement yet, and refusing to run on the CPU unasked."""

import glob
import io
import os
import re
import subprocess
import sys

import pytest

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
def test_unported_options_are_refused(fixdir, tmp_path, monkeypatch, capsys,
                                      extra, env, flag):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = _argv(fixdir, ["--max_kb_dist", "10"] + extra)
    assert main(argv + ["--out", str(tmp_path / "x.ld")]) == 1
    err = capsys.readouterr().err
    assert flag in err and "not" in err


def test_strict_engine_through_the_port_cli(fixdir, tmp_path):
    argv = _argv(fixdir, ["--max_kb_dist", "5", "--engine", "strict"])
    ported = _run_cli(argv, tmp_path / "p.ld")
    ref = io.StringIO()
    strict.run(params_from_args(argv), out_fh=ref)
    assert ported == ref.getvalue().splitlines()
