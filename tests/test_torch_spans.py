"""The port's spans (utils/logging.RunLog) on the CPU.

Spans nest per thread and record their thread and parent from any
thread, and many threads at once lose none; the timings JSON's phases, stages and counters are the sums of a
run's spans under the names they had as sums, on each loader path (the
gz-text loader, the binary loader, the binary reader under the overlap
ingest); the gz-text loader's parse slices on its pool's threads, and
their counters; the main thread's top-level spans cover the run; load_bytes is
the GENO file's size; the span list stops at its cap and counts what it
drops; record_function is entered only while a profiler runs, and a
span's start mapped through the JSON's clock lands on its profiler
event."""

import gzip
import io
import json
import os
import threading

import pytest
import torch

from ngsld_tpu_torch import loaders
from ngsld_tpu_torch.cli import params_from_args
from ngsld_tpu_torch.engine import run_torch
from ngsld_tpu_torch.utils import logging as runlog
from ngsld_tpu_torch.utils.logging import RunLog
from ngsld_tpu_torch.utils.simulate import simulate, write_all

N_IND, N_SITES = 8, 300

# stages that sum what another object timed (RunLog.count_time), not spans
SUMMED_ELSEWHERE = ("sweep: fmt/refine/", "mesh: ")

# the names each path's sums had before they were spans
PATHS = {
    "text": dict(
        geno="beagle", env={"NGSLD_OVERLAP_UPLOAD": "0"},
        phases={"Getting sites coordinates",
                "Preprocessing (call_geno, MAF, E[G]) on device",
                "  gl stream+upload", "  preprocess", "  maf to host",
                "compute: banded pair sweep"},
        stages={"sweep: plan wait", "sweep: dispatch", "sweep: result pull",
                "sweep: format", "sweep: fmt/tiers", "sweep: write"}),
    "binary": dict(
        geno="glf", env={"NGSLD_OVERLAP_UPLOAD": "0"},
        phases={"Getting sites coordinates",
                "Preprocessing (call_geno, MAF, E[G]) on device",
                "  gl stream+upload", "  preprocess", "  maf to host",
                "compute: banded pair sweep"},
        stages={"sweep: plan wait", "sweep: dispatch", "sweep: result pull",
                "sweep: format", "sweep: fmt/tiers", "sweep: write"}),
    "overlap": dict(
        geno="glf", env={},
        phases={"Getting sites coordinates", "compute: banded pair sweep"},
        stages={"sweep: plan wait", "sweep: ingest wait", "sweep: dispatch",
                "sweep: result pull", "sweep: format", "sweep: fmt/tiers",
                "sweep: write"}),
}


@pytest.fixture(autouse=True)
def cpu_and_small_slabs(monkeypatch):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")
    monkeypatch.delenv("NGSLD_OVERLAP_UPLOAD", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    sim = simulate(n_ind=N_IND, n_sites=N_SITES, seed=33, mono_rate=0.05)
    return write_all(sim, str(d))


def _job(files, tmp_path, geno="glf", extra=()):
    """One run into a seekable sink -> the timings JSON."""
    inp = {"glf": ["--geno", files["glf"], "--log_scale"],
           "beagle": ["--geno", files["beagle"], "--probs"]}[geno]
    argv = inp + ["--n_ind", str(N_IND), "--n_sites", str(N_SITES),
                  "--pos", files["pos"], "--max_kb_dist", "5",
                  "--chunk_pairs", "512", "--extend_out", "--verbose", "0",
                  *extra]
    path = tmp_path / "timings.json"
    os.environ["NGSLD_TIMINGS_JSON"] = str(path)
    try:
        run_torch(params_from_args(argv), out_fh=io.BytesIO())
    finally:
        del os.environ["NGSLD_TIMINGS_JSON"]
    with open(path) as fh:
        return json.load(fh)


def test_nested_spans_keep_their_thread_and_parent():
    log = RunLog(0)
    inner_open = threading.Event()
    go_on = threading.Event()

    def worker():
        with log.span("w: outer"):
            with log.span("w: inner"):
                inner_open.set()
                assert go_on.wait(10)

    t = threading.Thread(target=worker, name="spans-worker")
    t.start()
    assert inner_open.wait(10)
    with log.phase("main: outer", encloses=True):
        with log.span("main: inner"):
            go_on.set()
            t.join(10)
    assert not t.is_alive()
    rec = log.span_record()
    by = {s[0]: (i, s) for i, s in enumerate(rec["spans"])}
    for side, thread in (("w", "spans-worker"), ("main", "MainThread")):
        i_out, outer = by[f"{side}: outer"]
        _, inner = by[f"{side}: inner"]
        assert outer[1] == inner[1] == thread
        assert outer[2] == -1 and inner[2] == i_out
        assert outer[3] <= inner[3] <= inner[4] <= outer[4]
    assert [n for n, _ in log.timings] == ["main: outer"]
    assert set(log.time_counters) == {"w: outer", "w: inner", "main: inner"}


def test_spans_from_many_threads_lose_nothing():
    """More threads than cores open spans under a short switch interval:
    every span is kept once, under its own thread's parent, and each
    name's sum is its spans' total (a lost update would break both)."""
    import sys
    log = RunLog(0)
    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_spans):
                with log.span(f"outer {k % 2}"):
                    with log.span("inner"):
                        pass

        ts = [threading.Thread(target=work, args=(k,), name=f"w{k}")
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    spans = log.spans
    assert len(spans) == 2 * n_threads * n_spans
    for name, th, par, t0, t1 in spans:
        if name == "inner":
            assert spans[par][0].startswith("outer")
            assert spans[par][1] == th and spans[par][3] <= t0 <= t1
        else:
            assert par == -1
    for name, v in log.time_counters.items():
        total = sum(t1 - t0 for n, _, _, t0, t1 in spans if n == name)
        assert abs(total / 1e9 - v) < 1e-6, name


def _span_sums(tim):
    sums = {}
    for name, _, _, t0, t1 in tim["spans"]:
        sums[name] = sums.get(name, 0.0) + (t1 - t0) / 1e6
    return sums


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sums_are_the_spans_under_their_old_names(files, tmp_path,
                                                  monkeypatch, path):
    p = PATHS[path]
    for k, v in p["env"].items():
        monkeypatch.setenv(k, v)
    tim = _job(files, tmp_path, p["geno"])
    assert p["phases"] <= set(tim["phases"])
    assert p["stages"] <= set(tim["stages"])
    assert ("overlap_ingest" in tim["counters"]) == (path == "overlap")
    sums = _span_sums(tim)
    n = {}
    for s in tim["spans"]:
        n[s[0]] = n.get(s[0], 0) + 1
    for name, v in tim["stages"].items():
        if name.startswith(SUMMED_ELSEWHERE):
            continue
        assert abs(sums[name] - v) <= 5e-4 + n[name] * 1e-7, name
    for name, v in tim["phases"].items():
        # a phase name that repeats keeps its last span
        last = [s for s in tim["spans"] if s[0] == name][-1]
        assert abs((last[4] - last[3]) / 1e6 - v) <= 5e-4, name
    # where the work happens: the reader's, the uploader's or the
    # ingest's thread, the plan's prefetch thread, the emit threads
    threads = {s[0]: s[1] for s in tim["spans"]}
    reader = "ngsld-gltext-read" if path == "text" else "ngsld-gl-read"
    assert threads["load: read"] == reader
    # the binary reader only reads: its slabs are narrowed and checked by
    # their consumer (kernels/gl_narrow.py)
    if path == "text":
        assert threads["load: parse"] == reader
    else:
        assert "load: parse" not in threads
    if path == "overlap":
        assert threads["ingest: upload"] == "ngsld-ingest"
        assert {"ingest: slab wait", "ingest: preprocess",
                "ingest: maf pull"} <= set(threads)
    else:
        assert threads["load: upload"].endswith("-upload")
    assert threads["plan: block"] == "ngsld-plan-prefetch"
    assert threads["sweep: format"] == "ngsld-fmt"
    assert threads["sweep: emit wait"] == "MainThread"
    # the main thread's top-level spans cover the run
    top = sum(t1 - t0 for _, th, par, t0, t1 in tim["spans"]
              if th == "MainThread" and par == -1)
    assert top >= 0.95 * tim["clock"]["dump_us"]
    size = os.path.getsize(files["beagle" if path == "text" else "glf"])
    assert tim["counters"]["load_bytes"] == size
    proc = tim["process"]
    assert {"unix_ns", "perf_ns"} <= set(proc["clock"])
    assert "init: import" in {s[0] for s in proc["spans"]}


def _pieces(path, cap):
    """The pieces the text loader inflates a file in: at most cap bytes,
    the partial line at a piece's end carried into the next."""
    with gzip.open(path, "rb") as fh:
        body = fh.read()
    n, a = 0, 0
    while a < len(body):
        end = a + cap
        a = len(body) if end >= len(body) else body.rfind(b"\n", a, end) + 1
        n += 1
    return n


@pytest.mark.parametrize("slices", ["several", "one"])
def test_text_parse_spans_and_counters(files, tmp_path, monkeypatch, slices):
    """The gz-text loader: the reader thread opens `load: read` (the
    inflate) and `load: parse` (its wait for a piece's slices), the parse
    pool's threads `load: parse slice`. parse_threads is the pool's size;
    parse_slices counts the slices: more than one on a piece cut in
    several, one a piece where every piece parses in one (4000-byte
    pieces)."""
    monkeypatch.setenv("NGSLD_OVERLAP_UPLOAD", "0")
    cls = loaders._StreamedTextLoader
    if slices == "several":   # one piece of about 60 kB, four slices
        monkeypatch.delenv("NGSLD_SLAB_BYTES")
        monkeypatch.setattr(cls, "PARSE_THREADS", 4)
        monkeypatch.setattr(cls, "MIN_SLICE_BYTES", 1024)
    tim = _job(files, tmp_path, "beagle")
    threads = {}
    for name, th, *_ in tim["spans"]:
        threads.setdefault(name, set()).add(th)
    reader = {"ngsld-gltext-read"}
    assert threads["load: read"] == threads["load: parse"] == reader
    assert threads["load: parse slice"]
    assert all(th.startswith("ngsld-gltext-parse")
               for th in threads["load: parse slice"])
    c = tim["counters"]
    assert c["parse_threads"] == cls.PARSE_THREADS
    n_slice = sum(s[0] == "load: parse slice" for s in tim["spans"])
    assert c["parse_slices"] == n_slice
    if slices == "several":
        assert c["parse_slices"] == 4
    else:
        assert c["parse_slices"] == _pieces(files["beagle"], 4000) > 1


def test_the_span_list_stops_at_its_cap():
    log = RunLog(0)
    log.MAX_SPANS = 5
    for _ in range(8):
        with log.span("s"):
            with log.span("t"):
                pass
    rec = log.span_record()
    assert len(rec["spans"]) == 5
    assert rec["counters"]["spans_dropped"] == 11
    assert rec["spans"][1][2] == 0 and rec["spans"][4][2] == -1
    # the sums go on past the cap
    assert log.time_counters["s"] > 0 and len(log.time_counters) == 2


class _Recorded:
    """A stand-in for torch.profiler.record_function that keeps names."""
    names = []

    def __init__(self, name):
        self.names.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_record_function_only_under_a_profiler(files, tmp_path,
                                               monkeypatch):
    import torch.autograd.profiler as tap
    monkeypatch.setattr(torch.profiler, "record_function", _Recorded)
    monkeypatch.setattr(_Recorded, "names", [])
    tim = _job(files, tmp_path)
    assert _Recorded.names == [] and len(tim["spans"]) > 20
    monkeypatch.setattr(tap, "_is_profiler_enabled", True)
    assert runlog._profiling()
    _job(files, tmp_path)
    seen = set(_Recorded.names)
    assert {"sweep: dispatch", "sweep: emit wait",
            "Getting sites coordinates"} <= seen
    # an enclosing phase would win every idle gap's label
    assert "compute: banded pair sweep" not in seen


def test_a_spans_clock_lands_on_its_profiler_event(files, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    _job(files, tmp_path)    # the libraries are loaded before the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tim = _job(files, tmp_path)
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace) as fh:
        data = json.load(fh)
    base = int(data["baseTimeNanoseconds"])
    name = "Getting sites coordinates"
    ev = [e for e in data["traceEvents"] if e.get("name") == name
          and e.get("cat") == "user_annotation"]
    sp = [s for s in tim["spans"] if s[0] == name]
    assert len(ev) == len(sp) == 1
    at_trace = base + float(ev[0]["ts"]) * 1e3
    at_span = tim["clock"]["unix_ns"] + sp[0][3] * 1e3
    assert abs(at_trace - at_span) < 2e6
