"""The port's ring across devices through its CLI on the CPU: ranks are
processes over gloo (NGSLD_PLATFORM=cpu), started by the CLI itself or,
for the two simulated nodes, as launched processes (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT as torchrun sets them).

  * --ring --shard 2 (with --checkpoint and --profile) and --ring --shard 4
    --ring_sub 2 --rnd_sample 0.5 --ignore_miss_data are byte-equal to
    --ring --shard 1 on the same flags, in f64; their pair sets are
    strict's and their values inside `compare`;
  * --ring --shard 2 --shard_ind 2 against run_jax on the same flags
    (tests/test_parallel.py:443) under `compare`;
  * a resume where one rank committed fewer steps than the other is
    byte-equal (tests/test_multihost.py:185);
  * two nodes write OUT.part00000 and OUT.part00001, which tools.merge
    joins byte-equal to the one-node file;
  * the narrow-band auto-route on two ranks runs the block engine on the
    mesh; a failed rank fails the run and is named; --shard_ind that does
    not divide --n_ind is refused; a spawned rank imports neither jax nor
    the JAX package.

The JAX package is imported inside the tests, so that the ranks this file
spawns stay free of it."""

import io
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from ngsld_tpu_torch import strict
from ngsld_tpu_torch.cli import main, params_from_args
from ngsld_tpu_torch.parallel import mesh as tmesh
from ngsld_tpu_torch.utils.conformance import compare
from ngsld_tpu_torch.utils.simulate import simulate, write_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_and_two_threads(monkeypatch):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    # tests/conftest.py turns the auto-route off for every test; the
    # auto-route test turns it back on
    monkeypatch.setenv("NGSLD_RING_AUTOROUTE", "0")
    # the ranks share this process's threads: the 2-thread cap of the heavy
    # test files keeps 6 workers x N ranks off each other's cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return write_all(simulate(n_ind=8, n_sites=150, seed=41),
                     str(tmp_path_factory.mktemp("fix")))


def _argv(fx, *extra):
    # all pairs: every sub-ring holds rows on every step
    return ["--geno", fx["beagle"], "--probs", "--n_ind", "8", "--n_sites",
            "150", "--pos", fx["pos"], "--max_kb_dist", "0", "--min_maf",
            "0.05", "--extend_out", "--precision", "f64", "--verbose", "0",
            "--ring", *extra]


def _run(argv, out):
    """The CLI in this process (rank 0): its rows, and the timings JSON of
    every rank that wrote one."""
    tj = f"{out}.json"
    os.environ["NGSLD_TIMINGS_JSON"] = tj
    try:
        assert main(argv + ["--out", str(out)]) == 0
    finally:
        del os.environ["NGSLD_TIMINGS_JSON"]
    js = []
    for r in range(8):
        path = tj + (f".rank{r}" if r else "")
        if os.path.exists(path):
            with open(path) as fh:
                js.append(json.load(fh))
    return out.read_bytes(), js


def _strict(argv, out):
    """The same run through --engine strict (the ring's flags dropped)."""
    keep = []
    it = iter(argv)
    for a in it:
        if a == "--ring_sub":
            next(it)
        elif a != "--ring":
            keep.append(a)
    strict.run(params_from_args(keep + ["--engine", "strict", "--out",
                                        str(out)]))
    return out.read_text().splitlines()


def _pairs(rows):
    return [r.split("\t")[:2] for r in rows]


def _held_to_strict(rows: bytes, argv, tmp_path):
    """The pair set byte-equal to strict's, values inside `compare`."""
    s_rows = _strict(argv, tmp_path / "strict.ld")
    r_rows = rows.decode().splitlines()
    assert _pairs(r_rows) == _pairs(s_rows) and len(s_rows) > 1000
    compare(s_rows, r_rows)


@pytest.fixture(scope="module")
def helper_module(tmp_path_factory):
    """A module the spawned ranks can import (it imports neither jax nor
    the JAX package): `failing` dies at its first gathered piece,
    `recording` saves the rank's jax / ngsld_tpu modules after its run."""
    d = tmp_path_factory.mktemp("helper")
    (d / "ngsld_ring_helper.py").write_text(textwrap.dedent("""
        import json
        import os
        import sys

        from ngsld_tpu_torch.parallel import mesh


        def failing(rank, world, port, job):
            from ngsld_tpu_torch import compute

            def dies(*a, **k):
                raise RuntimeError("rank %d fails" % rank)
            compute.compute_block = dies
            mesh._rank_entry(rank, world, port, job)


        def recording(rank, world, port, job):
            mesh._rank_entry(rank, world, port, job)
            bad = [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "ngsld_tpu")]
            with open(os.environ["NGSLD_TEST_MODULES"] + str(rank),
                      "w") as fh:
                json.dump(bad, fh)
        """))
    return str(d)


def _use_entry(monkeypatch, helper_module, name):
    monkeypatch.syspath_prepend(helper_module)
    monkeypatch.setenv("PYTHONPATH", helper_module + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    import ngsld_ring_helper
    monkeypatch.setattr(tmesh, "_rank_entry",
                        getattr(ngsld_ring_helper, name))


@pytest.fixture(scope="module")
def module_env():
    """The autouse fixture's CPU request, for the module's own fixtures
    (they run before it)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NGSLD_PLATFORM", "cpu")
    mp.setenv("NGSLD_RING_AUTOROUTE", "0")
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def one(fx, tmp_path_factory, module_env):
    """--ring --shard 1 (the one-device ring) on the shared flags."""
    d = tmp_path_factory.mktemp("one")
    rows, _ = _run(_argv(fx, "--ring_sub", "3"), d / "one.ld")
    return rows


@pytest.fixture(scope="module")
def two(fx, tmp_path_factory, helper_module, module_env):
    """--ring --shard 2 --checkpoint --profile, the started rank recording
    its modules: (rows, timings JSONs, checkpoint dir, trace dir,
    modules file stem)."""
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("two")
    try:
        _use_entry(mp, helper_module, "recording")
        mp.setenv("NGSLD_TEST_MODULES", str(d / "mods"))
        rows, js = _run(_argv(fx, "--ring_sub", "3", "--shard", "2",
                              "--checkpoint", str(d / "ck"), "--profile",
                              str(d / "trace")), d / "two.ld")
    finally:
        mp.undo()
    return dict(rows=rows, js=js, ck=d / "ck", trace=d / "trace",
                mods=str(d / "mods"))


def test_ring_shard2_is_byte_equal_to_shard1(fx, one, two, tmp_path):
    """--ring --shard 2 against --ring --shard 1, f64: byte-equal rows, the
    pair set of strict and values inside `compare`; each rank exchanged
    its visiting sub-blocks (counted with their bytes), wrote one
    --profile trace and its own spill files; the started rank imported
    neither jax nor ngsld_tpu."""
    assert two["rows"] == one
    _held_to_strict(one, _argv(fx), tmp_path)
    assert len(two["js"]) == 2
    for r, j in enumerate(two["js"]):
        c = j["counters"]
        assert c["ring_exchanges"] == c["ring_steps"] > 0
        assert c["ring_exchange_bytes"] > 0
        assert "mesh: ring exchange" in j["stages"]
        assert any(p.startswith(f"ring_p{r:05d}_") for p in
                   os.listdir(two["ck"]))
    assert len([p for p in os.listdir(two["trace"])
                if p.endswith(".pt.trace.json")]) == 2
    with open(two["mods"] + "1") as fh:
        assert json.load(fh) == []


def test_ring_resume_with_ranks_at_different_steps(fx, one, two):
    """Rank 1 lost its last committed steps (markers and tiles), rank 0
    kept all: both resume at rank 1's first missing step (the least over
    the ranks), and the output is byte-equal."""
    ck = two["ck"]
    lost = sorted(p for p in os.listdir(ck)
                  if p.startswith("ring_p00001_s0002_"))
    assert lost and any(p.endswith(".done") for p in lost)
    for p in lost:
        os.remove(ck / p)
    rows, js = _run(_argv(fx, "--ring_sub", "3", "--shard", "2",
                          "--checkpoint", str(ck)), ck.parent / "again.ld")
    assert rows == one
    steps = two["js"][0]["counters"]["ring_steps"]
    for j in js:
        c = j["counters"]
        assert c["ring_steps"] == 2                # sub-ring 2's two steps
        assert c["ring_steps_resumed"] == steps - 2


def test_ring_shard4_sampled_is_byte_equal_to_shard1(fx, tmp_path):
    """--ring --shard 4 --ring_sub 2 --rnd_sample 0.5 --ignore_miss_data
    against --ring --shard 1 on the same flags, f64: byte-equal; the pair
    set of strict, values inside `compare`."""
    flags = ("--ring_sub", "2", "--rnd_sample", "0.5", "--seed", "5",
             "--ignore_miss_data")
    base, _ = _run(_argv(fx, *flags), tmp_path / "one.ld")
    rows, js = _run(_argv(fx, *flags, "--shard", "4"), tmp_path / "four.ld")
    assert rows == base and len(js) == 4
    assert all(j["counters"]["ring_exchanges"] > 0 for j in js)
    _held_to_strict(rows, _argv(fx, *flags), tmp_path)


def test_ring_shard_ind_matches_run_jax(fx, tmp_path):
    """--ring --shard 2 --shard_ind 2 --ring_sub 2 against run_jax on the
    same flags (the JAX package's 2-D ring on 4 of its 8 virtual devices):
    the same pairs in the same order, values under `compare`; the 'ind'
    all-reduces ran on every rank."""
    from ngsld_tpu.cli import params_from_args as j_params
    from ngsld_tpu.engine import run_jax
    argv = _argv(fx, "--ring_sub", "2", "--shard", "2", "--shard_ind", "2",
                 "--ignore_miss_data")
    rows, js = _run(argv, tmp_path / "t.ld")
    j = io.BytesIO()
    run_jax(j_params(argv), out_fh=j)
    j_rows = j.getvalue().decode().splitlines()
    rows = rows.decode().splitlines()
    assert _pairs(rows) == _pairs(j_rows) and len(rows) > 1000
    compare(j_rows, rows)
    assert len(js) == 4
    assert all(x["counters"]["ind_allreduces"] > 0 for x in js)


def test_two_nodes_write_parts_that_merge(fx, one, tmp_path):
    """Two launched processes, each a node of one rank (LOCAL_WORLD_SIZE
    1 < WORLD_SIZE 2): each writes its block's part, only part 00000
    with the header, and tools.merge joins them byte-equal to the
    one-node output."""
    from ngsld_tpu_torch.tools import merge
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    out = tmp_path / "nodes.ld"
    procs = []
    for r in (0, 1):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ngsld_tpu_torch.cli",
             *_argv(fx, "--ring_sub", "3", "--shard", "2", "--verbose",
                    "1"), "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    errs = [p.communicate(timeout=120)[1].decode() for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs
    assert "each site block's first rank writes" in errs[0]
    parts = merge.discover_parts(str(out))
    assert [os.path.basename(p) for p in parts] == [
        "nodes.ld.part00000", "nodes.ld.part00001"]
    assert not out.exists()
    with open(parts[1], "rb") as fh:
        assert not fh.readline().startswith(b"site1\t")
    assert merge.main(["--out", str(tmp_path / "merged.ld"),
                       str(out)]) == 0
    assert (tmp_path / "merged.ld").read_bytes() == one


def test_ring_autoroute_on_two_ranks(tmp_path, monkeypatch, capfd):
    """A band inside one ring step's sub-block, on two ranks: every rank
    takes the auto-route and the block engine runs on the same mesh
    (both ranks walk its plan), byte-equal to the block engine alone."""
    monkeypatch.setenv("NGSLD_RING_AUTOROUTE", "1")
    files = write_all(simulate(n_ind=8, n_sites=256, seed=88,
                               contig_kb=10.0), str(tmp_path / "fx"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "8",
            "--n_sites", "256", "--pos", files["pos"], "--max_kb_dist",
            "1", "--extend_out", "--precision", "f64"]
    block, _ = _run(argv + ["--verbose", "0"], tmp_path / "block.ld")
    capfd.readouterr()
    rows, js = _run(argv + ["--ring", "--shard", "2", "--verbose", "1"],
                    tmp_path / "ring.ld")
    err = capfd.readouterr().err
    assert "--ring auto-route" in err and "2 sites x 1 'ind'" in err
    assert rows == block and len(js) == 2
    for j in js:
        assert j["counters"]["plan_ranks_agree"] == 2
        assert "ring_steps" not in j["counters"]


def test_a_failed_ring_rank_fails_the_run(fx, tmp_path, monkeypatch,
                                          helper_module, capfd):
    """Rank 1's gather stepper raises at its first piece: the run exits 1
    within seconds, naming the rank, with the header at most."""
    _use_entry(monkeypatch, helper_module, "failing")
    out = tmp_path / "x.ld"
    t0 = time.perf_counter()
    rc = main(_argv(fx, "--ring_sub", "3", "--shard", "2", "--out",
                    str(out)))
    took = time.perf_counter() - t0
    err = capfd.readouterr().err
    assert rc == 1 and took < 60
    assert "rank 1 failed: RuntimeError: rank 1 fails" in err
    assert not out.exists() or len(out.read_text().splitlines()) <= 1


def test_shard_ind_must_divide_n_ind(fx, tmp_path, capfd):
    """--ring --shard_ind 3 with 8 individuals: refused before any rank
    starts, with no rows; the driver refuses it too, with the
    reference's message (ngsld_tpu/engine_ring.py:90-93)."""
    from ngsld_tpu_torch.engine_ring import _run_torch_ring
    out = tmp_path / "x.ld"
    assert main(_argv(fx, "--shard_ind", "3", "--out", str(out))) == 1
    assert "--shard_ind must divide --n_ind" in capfd.readouterr().err
    assert not out.exists()
    pars = params_from_args(_argv(fx))
    m = tmesh.Mesh(0, 3, 1, 3, torch.device("cpu"), "gloo", False)
    with pytest.raises(strict.StrictError,
                       match="--shard_ind must divide --n_ind"):
        _run_torch_ring(pars, io.BytesIO(), None, "f64",
                        torch.device("cpu"), m)
