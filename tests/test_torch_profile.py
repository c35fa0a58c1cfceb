"""--profile DIR on the port's engine, on the CPU (NGSLD_PLATFORM=cpu).

Each sweep that the single-device engine runs (gather, strip, the ring,
and the ring auto-routed to the block engine) writes one Chrome trace
into DIR, under torch.profiler's tensorboard_trace_handler naming, that
parses and holds the run's torch operators; its rows are byte-equal to
the same run without the flag. A run that fails after the profiler
started still leaves one closed trace, exits 1 and prints no rows.
"""

import json
import os
import socket

import pytest
import torch

from ngsld_tpu_torch.cli import main
from ngsld_tpu_torch.utils.simulate import simulate, write_all


@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    monkeypatch.setenv("NGSLD_RING_AUTOROUTE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fx"))
    return write_all(simulate(n_ind=8, n_sites=150, seed=4, contig_kb=10.0),
                     d)


def _argv(fix, *extra):
    return ["--geno", fix["beagle"], "--probs", "--n_ind", "8", "--n_sites",
            "150", "--pos", fix["pos"], "--extend_out", *extra]


def _trace(trace_dir):
    """The one trace in trace_dir, parsed: (file name, events)."""
    files = os.listdir(trace_dir)
    assert len(files) == 1, files
    assert files[0].endswith(".pt.trace.json")
    with open(os.path.join(trace_dir, files[0])) as fh:
        return files[0], json.load(fh)["traceEvents"]


@pytest.mark.parametrize("extra,env,phase", [
    (["--max_kb_dist", "10"], {"NGSLD_BLOCK_STRIP": "0"},
     "==> compute: banded pair sweep"),
    (["--max_kb_dist", "10", "--precision", "f32"],
     {"NGSLD_BLOCK_STRIP": "1"}, "==> strip tables (device)"),
    (["--max_kb_dist", "0", "--ring", "--ring_sub", "2"], {},
     "==> compute: ring sweep"),
    (["--max_kb_dist", "1", "--ring"], {"NGSLD_RING_AUTOROUTE": "1"},
     "==> --ring auto-route"),
], ids=["gather", "strip", "ring", "ring_autoroute"])
def test_profile_writes_one_trace_and_the_same_rows(
        fix, tmp_path, capfd, monkeypatch, extra, env, phase):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = _argv(fix, *extra, "--verbose", "1")
    plain, traced = tmp_path / "plain.ld", tmp_path / "traced.ld"
    assert main(argv + ["--out", str(plain)]) == 0
    trace_dir = tmp_path / "trace"
    assert main(argv + ["--out", str(traced), "--profile",
                        str(trace_dir)]) == 0
    err = capfd.readouterr().err
    # the sweep asked for ran both times
    assert err.count(phase) == 2
    rows = plain.read_bytes()
    assert traced.read_bytes() == rows and rows.count(b"\n") > 100
    name, events = _trace(trace_dir)
    assert name.startswith(f"{socket.gethostname()}_{os.getpid()}.")
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert len(ops) > 100
    # CPU activity only: the CPU asked for, no CUDA activity recorded
    assert not [e for e in events if e.get("cat") == "kernel"]


def test_failed_run_still_closes_its_trace(fix, tmp_path, capfd):
    """A POS file one line short fails inside the run, after the profiler
    started: exit 1, no rows, one trace that parses."""
    with open(fix["pos"]) as fh:
        lines = fh.readlines()
    short = tmp_path / "short.pos"
    short.write_text("".join(lines[:-1]))
    argv = _argv(dict(fix, pos=str(short)), "--max_kb_dist", "10",
                 "--verbose", "0")
    out, trace_dir = tmp_path / "x.ld", tmp_path / "trace"
    assert main(argv + ["--out", str(out), "--profile", str(trace_dir)]) == 1
    cap = capfd.readouterr()
    assert "POS file" in cap.err and cap.out == ""
    assert not out.exists() or out.read_bytes() == b""
    _trace(trace_dir)
