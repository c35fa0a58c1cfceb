"""The port's block engine on several devices (--shard, --shard_ind) on the
CPU: ranks are processes over gloo (NGSLD_PLATFORM=cpu).

  * the --shard_ind steps at 2 x 2 ranks (and the strip step at 1 x 2)
    against ngsld_tpu.parallel.sweep.sweep_step and
    ngsld_tpu.parallel.strip_ind.strip_compute_ind_fn on the same numpy
    inputs, the JAX side on the 8 virtual CPU devices of tests/conftest.py;
  * the CLI: --shard 2 byte-equal to --shard 1, --shard 2 --shard_ind 2
    against run_jax under `compare`, the strip sweep on both meshes against
    --shard 1 under the f32 contract, a checkpointed --shard 2 run resumed;
  * a rank that fails fails the run; the ranks import neither jax nor the
    JAX package (the ring on several devices: test_torch_ringmesh*.py).

The JAX package is imported inside the tests, so that the ranks this file
spawns (they import it for _child) stay free of it."""

import datetime
import io
import json
import os
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ngsld_tpu_torch.cli import main, params_from_args
from ngsld_tpu_torch.compute import split_bounds, strip_shares
from ngsld_tpu_torch.kernels.strip_em import strip_em_compact, strip_tables
from ngsld_tpu_torch.parallel import mesh as tmesh
from ngsld_tpu_torch.parallel.strip_ind import strip_compute_ind
from ngsld_tpu_torch.parallel.sweep import sweep_step
from ngsld_tpu_torch.plan.strips import TA, TB, strip_plan
from ngsld_tpu_torch.utils.conformance import cmp_vs_strict, compare
from ngsld_tpu_torch.utils.simulate import simulate, write_all


@pytest.fixture(autouse=True)
def cpu_and_two_threads(monkeypatch):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    # the ranks share this process's threads: the 2-thread cap of the heavy
    # test files keeps 6 workers x N ranks off each other's cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------- inputs of the --shard_ind steps

P_SW, I_SW = 16, 12            # sweep_step: pairs, individuals
S_ST, I_ST = 384, 16           # strip step: sites (3 anchor tiles), cohort
SWEEP_CASES = ("plain", "missing", "lockstep")
STRIP_CASES = ("plain", "x0")


def _sweep_case(name):
    """(gn1, gn2, eg1, eg2, maf1, maf2) f64 numpy and --ignore_miss_data.
    "lockstep": pairs 0-3 have site 2 missing at every individual of the
    second 'ind' slice, so the two ranks of a row hold very different
    local sums; pair 4 has both sites missing everywhere (x = 0)."""
    rng = np.random.default_rng(SWEEP_CASES.index(name) + 11)
    gl = rng.dirichlet(np.ones(3), size=(2 * P_SW, I_SW))
    if name == "missing":
        gl[rng.random((2 * P_SW, I_SW)) < 0.2] = 1.0 / 3.0
    if name == "lockstep":
        gl[P_SW:P_SW + 4, I_SW // 2:] = 1.0 / 3.0
        gl[4] = gl[P_SW + 4] = 1.0 / 3.0
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = eg.mean(axis=1) / 2
    return ((gl[:P_SW], gl[P_SW:], eg[:P_SW], eg[P_SW:], maf[:P_SW],
             maf[P_SW:]), name != "plain")


def _strip_case(name):
    """f32 strip tables of a simulated panel (individual axis padded to
    8 x shard_ind), all pairs of its 384 sites: 6 tiles, the diagonal ones
    half live and the others full, so a batch runs whole planes until half
    its cells stop and the rest gathered; a shuffled sel of 70% of the
    live cells, and --ignore_miss_data. "x0": site 5 missing everywhere,
    so every cell with it has n_used 0; a lower iteration cap keeps the
    reference's step short there (both sides get it)."""
    sim = simulate(n_ind=I_ST, n_sites=S_ST, seed=31 + len(name),
                   all_missing_site_rate=0.02)
    gl = (sim.gl / sim.gl.sum(axis=2, keepdims=True)).astype(np.float32)
    if name == "x0":
        gl[5] = 1.0 / 3.0
    eg = gl[..., 1] + 2 * gl[..., 2]
    tabs = [t.numpy() for t in strip_tables(
        torch.from_numpy(gl), torch.from_numpy(eg), I_ST, i_align=16)]
    maf = (eg.mean(axis=1) / 2).astype(np.float32)
    lo = np.arange(1, S_ST + 1, dtype=np.int32)
    hi = np.full(S_ST, S_ST, np.int32)
    ok = np.ones(S_ST, np.float32)
    ta, tb, _, _ = strip_plan(hi.astype(np.int64), ok, S_ST, TA, TB)
    live = []
    for t, (k, j) in enumerate(zip(ta, tb)):
        a = k * TA + np.arange(TA)[:, None]
        b = j * TB + np.arange(TB)[None, :]
        live.append(t * TA * TB + np.flatnonzero((b >= lo[a]) & (b < hi[a])))
    live = np.concatenate(live)
    rng = np.random.default_rng(7)
    sel = rng.permutation(live)[:int(0.7 * len(live))].astype(np.int32)
    if name == "x0":
        # and every live cell with site 5 as its anchor in tile (0, 0)
        a5 = live[(live < TA * TB) & (live // TB == 5)]
        sel = rng.permutation(np.union1d(sel, a5)).astype(np.int32)
    return dict(tabs=tabs, maf=maf, lo=lo, hi=hi, ok=ok, ta=ta, tb=tb,
                sel=sel, cap=40 if name == "x0" else 100), name == "x0"


# -------------------------------------- the port's steps on 2 x 2 ranks

def _port_side(rank, world, store, out_dir):
    """Rank `rank` of a 2 x 2 mesh: every --shard_ind case, its results
    and all-reduce counts saved for the test."""
    torch.set_num_threads(1)
    m = tmesh.connect(rank, world, 2, 2, torch.device("cpu"), world, store)
    t = torch.from_numpy
    res = {}
    try:
        for name in SWEEP_CASES:
            arrs, ign = _sweep_case(name)
            b = split_bounds(P_SW, 2)
            rows = slice(b[m.pi], b[m.pi + 1])
            cols = slice(m.ii * I_SW // 2, (m.ii + 1) * I_SW // 2)
            gn1, gn2, eg1, eg2, m1, m2 = arrs
            n0 = m.allreduces
            out = sweep_step(t(gn1[rows, cols]), t(gn2[rows, cols]),
                             t(eg1[rows, cols]), t(eg2[rows, cols]),
                             t(m1[rows]), t(m2[rows]), ign, m)
            res["sweep", name] = [x.numpy() for x in out] + [
                m.allreduces - n0]
        for name in STRIP_CASES:
            c, ign = _strip_case(name)
            ga, gb, ea, eb = c["tabs"]
            ipl = ga.shape[2] // 2
            cut = slice(m.ii * ipl, (m.ii + 1) * ipl)
            loc = [t(np.ascontiguousarray(x)) for x in (
                ga[:, :, cut], gb[:, cut], ea[:, cut], eb[cut])]
            for rows in (2, 1):      # a 2 x 2 mesh, and each row as 1 x 2
                t0, t1, pos, sel = strip_shares(len(c["ta"]), c["sel"],
                                                rows)[m.pi if rows == 2
                                                      else 0]
                fm, im = strip_compute_ind(
                    *loc, t(c["maf"]), t(c["maf"]), t(c["lo"]), t(c["hi"]),
                    t(c["ok"]), t(c["ok"]), t(c["ta"][t0:t1]),
                    t(c["tb"][t0:t1]), t(sel), n_ind=I_ST,
                    i_start=m.ii * ipl, mesh=m, ignore_miss=ign,
                    iter_cap=c["cap"])
                res["strip", name, rows] = (fm.numpy(), im.numpy(), pos)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        tmesh.teardown()


def _child(rank, world, port, out_dir):
    store = dist.TCPStore(tmesh.HOST, port, world, False,
                          timeout=datetime.timedelta(seconds=120))
    _port_side(rank, world, store, out_dir)


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    """One 4-rank world (this process is rank 0) for every case."""
    import torch.multiprocessing as mp
    out = str(tmp_path_factory.mktemp("ranks"))
    store = dist.TCPStore(tmesh.HOST, 0, 4, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=120))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, 4, store.port, out))
             for r in (1, 2, 3)]
    for p in procs:
        p.start()
    n = torch.get_num_threads()
    try:
        _port_side(0, 4, store, out)
    finally:
        torch.set_num_threads(n)
        for p in procs:
            p.join(120)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]


# ----------------------------------------------------------- sweep_step

@pytest.mark.parametrize("name", SWEEP_CASES)
def test_sweep_step_matches_jax(port_side, name):
    """2 x 2 ranks against the reference's sweep_step on make_mesh(2, 2),
    f64: f and r2p within 1e-12, n_used and nIter exact; both ranks of a
    row return the same values (lockstep), and the step took 2 + (the
    row's iterations) all-reduces."""
    import jax
    from ngsld_tpu.parallel.mesh import make_mesh
    from ngsld_tpu.parallel.sweep import sweep_step as j_sweep_step
    arrs, ign = _sweep_case(name)
    with jax.enable_x64(True):
        step = j_sweep_step(make_mesh(2, 2, devices=jax.devices()[:4]),
                            ign, extend_out=False)
        j = [np.asarray(x) for x in step(*[jax.numpy.asarray(a)
                                          for a in arrs])]
    j_r2p, j_f, j_it, j_nu = j[0], j[1], j[2], j[3]
    pieces = []
    for p in range(2):
        a, b = port_side[2 * p]["sweep", name], port_side[2 * p + 1][
            "sweep", name]
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
        iters = 100 if (a[2] == 100).any() else int(a[2].max()) + 1
        assert a[4] == b[4] == 2 + iters
        pieces.append(a)
    r2p, f, it, nu = (np.concatenate([pc[k] for pc in pieces])
                      for k in range(4))
    np.testing.assert_allclose(f, j_f, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r2p, j_r2p, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(nu, j_nu)
    np.testing.assert_array_equal(it, j_it)
    if name == "lockstep":
        assert nu[4] == 0 and it[4] == 0 and np.isnan(f[4]).all()
        assert (nu[:4] == I_SW // 2).all()


# ------------------------------------------------------------ strip step

@pytest.mark.parametrize("rows", [1, 2], ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", STRIP_CASES)
def test_strip_step_matches_jax(port_side, name, rows):
    """The strip step for --shard_ind at 1 x 2 and 2 x 2 against the
    reference's strip_compute_ind_fn, called directly in f32 (its engine
    test runs in f64 and never reaches it). The reference's contract: f
    within 3e-5, r2p within 2e-5, n_used exact, nIter within 1 on more than
    95% of cells. x = 0 cells: the port freezes them at nIter 0 with NaN
    frequencies, as its one-device strip step and strict do; the reference
    step's jnp.max fold keeps the NaN and runs them to the cap (40 in this
    case, on both sides)."""
    import jax
    from ngsld_tpu.parallel.strip_ind import strip_compute_ind_fn
    c, ign = _strip_case(name)
    # the reference's step traces only in 32-bit mode (its dynamic_slice
    # indices mix int32 and int64 under x64, which an f64 run_jax earlier
    # in the same process leaves on)
    with jax.enable_x64(False):
        fn, _ = strip_compute_ind_fn(rows, 2, I_ST, ign, True, c["cap"])
        ja = [jax.numpy.asarray(x) for x in (
            *c["tabs"], c["maf"], c["maf"], c["lo"], c["hi"], c["ok"],
            c["ok"], c["ta"], c["tb"], c["sel"])]
        j_fm, j_im = (np.asarray(x) for x in fn(*ja))
    # the port: each row's first rank's piece, at its places in sel
    C = len(c["sel"])
    fm = np.full((C, 5), np.nan, np.float32)
    im = np.zeros((C,) + j_im.shape[1:], j_im.dtype)
    for p in range(rows):
        pfm, pim, pos = port_side[2 * p]["strip", name, rows]
        qfm, qim, _ = port_side[2 * p + 1]["strip", name, rows]
        np.testing.assert_array_equal(pfm, qfm)    # the row agrees
        np.testing.assert_array_equal(pim, qim)
        fm[pos], im[pos] = pfm, pim
    assert C > 40000 and j_fm.shape == fm.shape and j_im.shape == im.shape
    it, j_it = im[:, 0].astype(int), j_im[:, 0].astype(int)
    x0 = (im[:, 1] == 0) if ign else np.zeros(C, bool)
    np.testing.assert_allclose(fm[:, 0], j_fm[:, 0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(fm[:, 1:], j_fm[:, 1:], rtol=0, atol=3e-5)
    if ign:
        np.testing.assert_array_equal(im[:, 1], j_im[:, 1])
    close = np.abs(it - j_it)[~x0] <= 1
    assert close.mean() > 0.95
    if name == "x0":
        assert x0.sum() >= 90
        assert (it[x0] == 0).all() and np.isnan(fm[x0, 1:]).all()
        assert (j_it[x0] == c["cap"]).all()     # the reference's fold
        # the port's one-device strip step (strict's fold) agrees
        t = torch.from_numpy
        one_fm, one_im = strip_em_compact(
            *[t(x) for x in c["tabs"]], t(c["maf"]), t(c["maf"]),
            t(c["lo"]), t(c["hi"]), t(c["ok"]), t(c["ok"]), t(c["ta"]),
            t(c["tb"]), t(c["sel"]), n_ind=I_ST, ignore_miss=True,
            iter_cap=c["cap"])
        assert (one_im.numpy()[x0, 0] == 0).all()
        np.testing.assert_array_equal(one_im.numpy()[:, 1], im[:, 1])


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def fixdir(tmp_path_factory):
    sim = simulate(n_ind=16, n_sites=200, seed=61, contig_kb=5.0)
    return write_all(sim, str(tmp_path_factory.mktemp("fix")))


def _argv(fx, extra=()):
    return ["--geno", fx["beagle"], "--probs", "--n_ind", "16", "--n_sites",
            "200", "--pos", fx["pos"], "--max_kb_dist", "3", "--extend_out",
            "--chunk_pairs", "250", "--verbose", "0"] + list(extra)


def _run(argv, out, capfd=None):
    """The port's CLI in this process (rank 0): its rows, and the timings
    JSON of rank 0 and rank 1."""
    tj = f"{out}.json"
    os.environ["NGSLD_TIMINGS_JSON"] = tj
    try:
        assert main(argv + ["--out", str(out)]) == 0
    finally:
        del os.environ["NGSLD_TIMINGS_JSON"]
    with open(out) as fh:
        rows = fh.read().splitlines()
    js = []
    for path in (tj, tj + ".rank1"):
        if os.path.exists(path):
            with open(path) as fh:
                js.append(json.load(fh))
    return rows, js


@pytest.fixture(scope="module")
def helper_module(tmp_path_factory):
    """A module the spawned ranks can import (it imports neither jax nor
    the JAX package): `failing` dies at its first block, `recording` saves
    the rank's jax / ngsld_tpu modules after its run."""
    d = tmp_path_factory.mktemp("helper")
    (d / "ngsld_rank_helper.py").write_text(textwrap.dedent("""
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
    import ngsld_rank_helper
    monkeypatch.setattr(tmesh, "_rank_entry",
                        getattr(ngsld_rank_helper, name))


def test_cli_shard2_is_byte_equal_to_shard1(fixdir, tmp_path, monkeypatch,
                                            helper_module, capfd):
    """The gather sweep in f64, --shard 2 against --shard 1 (the JAX
    package's test_run_jax_sharded_matches_single): byte-equal rows; both
    ranks walked the same plan (the digest of every block's pairs, compared
    at the end) and each ran the ladder's rung on its piece; each rank
    wrote its own --profile trace; the started rank imported neither jax
    nor ngsld_tpu."""
    base, _ = _run(_argv(fixdir, ["--precision", "f64"]), tmp_path / "a.ld")
    _use_entry(monkeypatch, helper_module, "recording")
    monkeypatch.setenv("NGSLD_TEST_MODULES", str(tmp_path / "mods"))
    trace_dir = tmp_path / "trace"
    rows, js = _run(_argv(fixdir, ["--precision", "f64", "--shard", "2",
                                   "--verbose", "2", "--profile",
                                   str(trace_dir)]), tmp_path / "b.ld")
    err = capfd.readouterr().err
    assert rows == base and len(rows) > 300
    # one trace a rank, the names apart by pid
    assert len([p for p in os.listdir(trace_dir)
                if p.endswith(".pt.trace.json")]) == 2
    assert "pair plan: the same" in err and "on all 2 ranks" in err
    assert "device collectives over gloo" in err
    n_blocks = js[0]["counters"]["blocks_computed"]
    for j in js:
        assert j["counters"]["plan_ranks_agree"] == 2
        assert j["counters"]["blocks_computed"] == n_blocks > 1
        assert j["counters"]["rung_rows"] == n_blocks
    with open(tmp_path / "mods1") as fh:
        assert json.load(fh) == []


def test_cli_shard_ind_matches_run_jax(fixdir, tmp_path):
    """--shard 2 --shard_ind 2 (gather sweep, f64, --ignore_miss_data)
    against run_jax under the same flags on the 8 virtual CPU devices:
    the same pairs in the same order, values under `compare`."""
    from ngsld_tpu.cli import params_from_args as j_params
    from ngsld_tpu.engine import run_jax
    argv = _argv(fixdir, ["--precision", "f64", "--ignore_miss_data",
                          "--shard", "2", "--shard_ind", "2"])
    rows, js = _run(argv, tmp_path / "t.ld")
    j = io.BytesIO()
    run_jax(j_params(argv), out_fh=j)
    j_rows = j.getvalue().decode().splitlines()
    assert len(rows) == len(j_rows) > 300
    assert [r.split("\t")[:3] for r in rows] == \
        [r.split("\t")[:3] for r in j_rows]
    compare(j_rows, rows)
    c = js[0]["counters"]
    assert c["ind_blocks"] == c["blocks_computed"] and c["ind_allreduces"] > 0


@pytest.fixture(scope="module")
def strip_base(fixdir, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("NGSLD_PLATFORM", "cpu")
    mp.setenv("NGSLD_BLOCK_STRIP", "1")
    try:
        rows, _ = _run(_argv(fixdir, ["--precision", "f32"]),
                       tmp_path_factory.mktemp("strip") / "s1.ld")
    finally:
        mp.undo()
    return rows


@pytest.mark.parametrize("mesh", [["--shard", "2"],
                                  ["--shard", "2", "--shard_ind", "2"]],
                         ids=["2x1", "2x2"])
def test_cli_strip_sweep_on_a_mesh(fixdir, tmp_path, monkeypatch, capfd,
                                   strip_base, mesh):
    """The strip sweep (--precision f32, NGSLD_BLOCK_STRIP=1) on 2 x 1 and
    2 x 2 ranks against the port's one-device run: the same pairs in the
    same order, values under the f32 contract (cmp_vs_strict). On 2 x 2
    the strip step for --shard_ind ran on every chunk."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    rows, js = _run(_argv(fixdir, ["--precision", "f32", "--verbose", "2"]
                          + mesh), tmp_path / "s.ld")
    err = capfd.readouterr().err
    assert len(rows) == len(strip_base) > 300
    cmp_vs_strict(strip_base, rows, 0)
    assert "==> strip sweep:" in err
    c = js[0]["counters"]
    if len(mesh) > 2:
        assert "('pairs', 'ind') mesh" in err
        assert c["ind_strip_chunks"] == c["blocks_computed"] > 0
        assert c["ind_allreduces"] > 2 * c["blocks_computed"]
    else:
        assert "ind_strip_chunks" not in c


def test_cli_shard2_checkpoint_resume(fixdir, tmp_path):
    """A --shard 2 --checkpoint run that lost one block's part file:
    rank 0 sends the done set, both ranks skip the same blocks, and the
    resumed output is byte-equal."""
    cdir = tmp_path / "ck"
    argv = _argv(fixdir, ["--precision", "f64", "--shard", "2",
                          "--chunk_pairs", "150", "--checkpoint", str(cdir)])
    first, _ = _run(argv, tmp_path / "a.ld")
    parts = sorted(p for p in os.listdir(cdir) if p.startswith("part_"))
    assert len(parts) > 3
    os.unlink(cdir / parts[2])
    again, js = _run(argv, tmp_path / "b.ld")
    assert again == first
    for j in js:
        assert j["counters"]["blocks_resumed"] == len(parts) - 1
        assert j["counters"]["blocks_computed"] == 1


def test_a_failed_rank_fails_the_run(fixdir, tmp_path, monkeypatch,
                                     helper_module, capfd):
    """Rank 1 raises at its first block: the run exits 1 within seconds
    with no rows (the header at most), naming the rank."""
    _use_entry(monkeypatch, helper_module, "failing")
    out = tmp_path / "x.ld"
    t0 = time.perf_counter()
    rc = main(_argv(fixdir, ["--shard", "2", "--out", str(out)]))
    took = time.perf_counter() - t0
    err = capfd.readouterr().err
    assert rc == 1 and took < 60
    assert "rank 1 failed: RuntimeError: rank 1 fails" in err
    assert not out.exists() or len(out.read_text().splitlines()) <= 1


def test_launched_world_must_match_the_flags(fixdir, tmp_path, monkeypatch,
                                             capfd):
    """Under a launcher (RANK / WORLD_SIZE set) the world size must be
    --shard x --shard_ind, and --shard 0 takes what --shard_ind leaves."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "4"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    assert main(_argv(fixdir, ["--shard", "2"])) == 1
    assert "!= the launched world of 4 ranks" in capfd.readouterr().err
    pars = params_from_args(_argv(fixdir, ["--shard", "0", "--shard_ind",
                                           "2"]))
    from ngsld_tpu_torch.engine import _resolve_shards
    assert _resolve_shards(pars, torch.device("cpu"),
                           tmesh.launched()) == 4 and pars.shard == 2
