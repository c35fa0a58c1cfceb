"""The port's overlap ingest (loaders._OverlapIngest, engaged by
engine_block._overlap_engaged) on the CPU: binary input uploaded and
preprocessed slab by slab under the block sweep, each block dispatched
once its sites are in.

Held against the same run without it (NGSLD_OVERLAP_UPLOAD=0; rows byte-
equal in f64 and f32, through the gather and the strip sweep), against
the JAX package's run_jax with its own overlap (f64, under `compare`, as
tests/test_engine.py:216 holds the reference's overlap), the reference's
error surface (a NaN three values before the end of the file: the
StrictError "NaN found" and an empty output, or nothing written under
--checkpoint; tests/test_engine.py:247), the reference's gate, the
coverage gating with a slow reader, and a --checkpoint kill and resume.
NGSLD_SLAB_BYTES=4000 makes slabs of 20 sites of the 300 x 8 fixture."""

import io
import json
import os
import time

import numpy as np
import pytest
import torch

from ngsld_tpu.config import Params as JParams
from ngsld_tpu.engine import run_jax
from ngsld_tpu_torch import engine_block, loaders, strict
from ngsld_tpu_torch.cli import main, params_from_args
from ngsld_tpu_torch.engine import run_torch
from ngsld_tpu_torch.utils.conformance import compare
from ngsld_tpu_torch.utils.simulate import simulate, write_all

N_IND, N_SITES = 8, 300


@pytest.fixture(autouse=True)
def cpu_and_small_slabs(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")
    monkeypatch.delenv("NGSLD_OVERLAP_UPLOAD", raising=False)
    # small tensors: more threads only fight the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("overlap")
    sim = simulate(n_ind=N_IND, n_sites=N_SITES, seed=33, mono_rate=0.05)
    return write_all(sim, str(d))


def _argv(files, extra=(), geno="glf"):
    inp = {"glf": ["--geno", files["glf"], "--log_scale"],
           "beagle": ["--geno", files["beagle"], "--probs"]}[geno]
    return inp + ["--n_ind", str(N_IND), "--n_sites", str(N_SITES),
                  "--pos", files["pos"], "--max_kb_dist", "5",
                  "--extend_out", "--verbose", "0", *extra]


def _timed_run(argv, tmp_path, out_fh=None, name="t"):
    """run_torch into out_fh (a BytesIO by default, which can seek);
    returns (bytes written, the timings JSON)."""
    tj = tmp_path / f"{name}.json"
    os.environ["NGSLD_TIMINGS_JSON"] = str(tj)
    try:
        sink = io.BytesIO() if out_fh is None else out_fh
        run_torch(params_from_args(argv), out_fh=sink)
    finally:
        del os.environ["NGSLD_TIMINGS_JSON"]
    with open(tj) as fh:
        tim = json.load(fh)
    return (sink.getvalue() if out_fh is None else None), tim


@pytest.mark.parametrize("prec,strip", [("f64", None), ("f32", None),
                                        ("f32", "1")],
                         ids=["f64_gather", "f32_gather", "f32_strip"])
def test_overlap_rows_equal_the_run_without(files, tmp_path, monkeypatch,
                                            prec, strip):
    if strip:
        monkeypatch.setenv("NGSLD_BLOCK_STRIP", strip)
    argv = _argv(files, ["--precision", prec, "--chunk_pairs", "256"])
    ov, tim = _timed_run(argv, tmp_path, name="ov")
    assert tim["counters"]["overlap_ingest"] == 1
    assert tim["counters"]["ingest_slabs"] == 15
    assert tim["counters"]["gl_streamed"] == 1
    assert (("  gl ingest join (strip tables)" in tim["phases"])
            == bool(strip))
    assert ("sweep: ingest wait" in tim["stages"]) != bool(strip)
    # several gather blocks, each gated on its own sites
    assert tim["counters"]["blocks_computed"] > (0 if strip else 1)
    monkeypatch.setenv("NGSLD_OVERLAP_UPLOAD", "0")
    plain, tim0 = _timed_run(argv, tmp_path, name="plain")
    assert "overlap_ingest" not in tim0["counters"]
    assert "  gl stream+upload" in tim0["phases"]
    assert ov == plain and ov.count(b"\n") > N_SITES


def test_overlap_matches_the_jax_packages_overlap(files, monkeypatch):
    """Both packages with their overlap ingest (f64, many slabs), under
    the f64 column contract."""
    base = dict(in_geno=files["glf"], in_probs=True, in_logscale=True,
                n_ind=N_IND, n_sites=N_SITES, in_pos=files["pos"],
                max_kb_dist=5, extend_out=True, precision="f64")
    made = []
    real = engine_block._OverlapIngest

    class Counted(real):
        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(engine_block, "_OverlapIngest", Counted)
    j, t = io.BytesIO(), io.BytesIO()
    run_jax(JParams(**base).finalize(), out_fh=j)
    run_torch(JParams(**base).finalize(), out_fh=t)
    assert made == [1]
    j_rows = j.getvalue().decode().splitlines()
    t_rows = t.getvalue().decode().splitlines()
    assert len(j_rows) > N_SITES
    compare(j_rows, t_rows)


class _PeakBytes(io.BytesIO):
    """A seekable sink that remembers the most bytes it ever held."""
    peak = 0

    def write(self, data):
        n = super().write(data)
        self.peak = max(self.peak, self.tell())
        return n


@pytest.mark.parametrize("sink", ["out", "checkpoint"])
def test_nan_near_the_end_leaves_no_output(files, tmp_path, sink):
    """A NaN three values before EOF surfaces after the first blocks'
    rows went out: the run raises the reference's StrictError and leaves
    the output empty (truncated, or under --checkpoint never written)."""
    raw = np.fromfile(files["glf"], np.float64)
    raw[len(raw) - 3] = np.nan
    bad = tmp_path / "bad.glf"
    raw.tofile(bad)
    argv = _argv(dict(files, glf=str(bad)), ["--chunk_pairs", "64"])
    if sink == "checkpoint":
        argv += ["--checkpoint", str(tmp_path / "ck")]
    out = _PeakBytes()
    with pytest.raises(strict.StrictError, match="NaN found"):
        run_torch(params_from_args(argv), out_fh=out)
    assert out.getvalue() == b""
    if sink == "out":
        # rows were written before the error surfaced, then truncated
        assert out.peak > len(strict.header_line(True))
        path = tmp_path / "bad.ld"
        assert main(argv + ["--out", str(path)]) == 1
        assert path.exists() and path.stat().st_size == 0
    else:
        assert out.peak == 0
        parts = [p for p in os.listdir(tmp_path / "ck")
                 if p.startswith("part_")]
        assert parts   # blocks were committed before the error


class _NoSeek:
    """stdout's stand-in: writes, no seek."""

    def __init__(self):
        self.n = 0

    def write(self, data):
        self.n += len(data)
        return len(data)

    def seekable(self):
        return False


@pytest.mark.parametrize("case,engaged", [
    ("binary", True),
    ("checkpoint_no_seek", True),
    ("gz_text", False),
    ("min_maf", False),
    ("no_seek", False),
    ("knob_0", False),
    ("verbose_7", False),
    ("shard_2", False),
])
def test_the_references_gate(files, tmp_path, monkeypatch, case, engaged):
    """engine_block._overlap_engaged is ngsld_tpu/engine_block.py:146-153:
    binary input, NGSLD_OVERLAP_UPLOAD not 0, min_maf <= 0, one device,
    verbose < 7, and a --checkpoint or a seekable output. Read from the
    run's counters."""
    extra, geno, out_fh = [], "glf", None
    if case == "checkpoint_no_seek":
        extra, out_fh = ["--checkpoint", str(tmp_path / "ck")], _NoSeek()
    elif case == "gz_text":
        geno = "beagle"
    elif case == "min_maf":
        extra = ["--min_maf", "0.05"]
    elif case == "no_seek":
        out_fh = _NoSeek()
    elif case == "knob_0":
        monkeypatch.setenv("NGSLD_OVERLAP_UPLOAD", "0")
    elif case == "verbose_7":
        extra = ["--verbose", "7"]
    argv = _argv(files, extra, geno)
    if case == "shard_2":
        # two ranks: rank 0 writes the timings of the loading rank
        tj = tmp_path / "t.json"
        monkeypatch.setenv("NGSLD_TIMINGS_JSON", str(tj))
        assert main(argv + ["--shard", "2", "--out",
                            str(tmp_path / "x.ld")]) == 0
        with open(tj) as fh:
            counters = json.load(fh)["counters"]
        assert counters["plan_ranks_agree"] == 2
    else:
        if out_fh is None:
            out_fh = io.BytesIO()
        _, tim = _timed_run(argv, tmp_path, out_fh)
        counters = tim["counters"]
    assert ("overlap_ingest" in counters) == engaged
    assert ("ingest_slabs" in counters) == engaged


def test_blocks_wait_for_their_sites(files, tmp_path, monkeypatch):
    """A reader slowed between slabs: the first block is dispatched while
    the ingest still lacks sites, no block before every one of its sites
    is in, and the rows are the run's without the slow reader."""
    argv = _argv(files, ["--chunk_pairs", "64"])
    fast, _ = _timed_run(argv, tmp_path, name="fast")

    real_slabs = loaders._SlabUploader.np_slabs

    def slow_slabs(self):
        for a in real_slabs(self):
            time.sleep(0.05)
            yield a

    made = []
    real_ingest = engine_block._OverlapIngest

    class Kept(real_ingest):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    seen = []   # (coverage, sites the block needs) at each dispatch
    real_compute = engine_block.compute.compute_block

    def watched(gn, eg, maf, sidx, *a, **k):
        with made[0]._cv:
            seen.append((made[0]._cov, int(sidx[1].max()) + 1))
        return real_compute(gn, eg, maf, sidx, *a, **k)

    monkeypatch.setattr(loaders._SlabUploader, "np_slabs", slow_slabs)
    monkeypatch.setattr(engine_block, "_OverlapIngest", Kept)
    monkeypatch.setattr(engine_block.compute, "compute_block", watched)
    slow, tim = _timed_run(argv, tmp_path, name="slow")
    assert len(seen) == tim["counters"]["blocks_computed"] > 3
    assert seen[0][0] < N_SITES
    assert all(cov >= need for cov, need in seen)
    assert tim["stages"]["sweep: ingest wait"] > 0
    assert slow == fast
    made[0]._thread.join(timeout=60)
    assert not made[0]._thread.is_alive()


def test_checkpoint_kill_and_resume_under_the_overlap(files, tmp_path,
                                                      monkeypatch):
    argv = _argv(files, ["--chunk_pairs", "64"])
    plain, _ = _timed_run(argv, tmp_path, name="plain")
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
    resumed, tim = _timed_run(argv + ["--checkpoint", str(cdir)], tmp_path,
                              name="resumed")
    assert tim["counters"]["overlap_ingest"] == 1
    assert tim["counters"]["blocks_resumed"] == 3
    assert resumed == plain


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("where", ["first", "last"])
def test_ingest_stops_at_the_bad_slab(files, where, prec):
    """A bad record in the fourth slab (sites 60-79), on its first or last
    site: the ingest raises the reference's NaN error with the first three
    slabs covered and no site of the fourth; a wait inside the coverage
    returns, one past it raises."""
    from ngsld_tpu_torch.ops.preprocess import preprocess
    from ngsld_tpu_torch.utils.logging import RunLog
    raw = np.fromfile(files["glf"], np.float64).reshape(N_SITES, N_IND, 3)
    raw[60 if where == "first" else 79, 0 if where == "first" else -1] = \
        -np.inf
    bad = files["glf"] + f".{where}.{prec}.bad"
    raw.tofile(bad)
    pars = params_from_args(_argv(dict(files, glf=bad)))
    np_dt, dt = ((np.float32, torch.float32) if prec == "f32"
                 else (np.float64, torch.float64))
    pre = lambda t: preprocess(t, call=False, N_thresh=0.0,  # noqa: E731
                               call_thresh=0.0, ignore_miss_data=False,
                               raw=True, in_log=True)
    loader = loaders._StreamedGLLoader(pars, np_dt, "cpu", stream_np=True)
    ingest = loaders._OverlapIngest(loader, pars, dt, pre, "cpu", RunLog(0))
    with pytest.raises(strict.StrictError, match="NaN found"):
        ingest.join_all()
    assert ingest.failed and ingest.n_slabs == 3 and ingest._cov == 60
    ingest.wait(60)
    with pytest.raises(strict.StrictError, match="NaN found"):
        ingest.wait(61)
    os.remove(bad)
