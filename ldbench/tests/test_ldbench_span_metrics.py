"""The readers of the port's spans (emit_wait_s, load_gbps, port_init_s):
hand-computed values on a synthetic run, None where the spans are absent
(a program without them), their BENCHMARK.json entries, and a traced run
of each tiny cell on the CPU that reports all three."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from ldbench import manifest, run
from ldbench.metrics import emit_wait_s, load_gbps, port_init_s
from ldbench.tests._tiny import tiny_cell

NEW = ("emit_wait_s", "load_gbps", "port_init_s")
CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]


def _job(stages=None, counters=None, process=None):
    j = {"phases": {}, "stages": stages or {}, "counters": counters or {}}
    if process is not None:
        j["process"] = {"clock": {"unix_ns": 0, "perf_ns": 0},
                        "spans": process, "counters": {}}
    return j


def _run(*jobs):
    return types.SimpleNamespace(jobs=list(jobs))


def test_emit_wait_s_is_the_mean_a_job():
    r = _run(_job({"sweep: emit wait": 0.5}), _job({"sweep: emit wait": 1.0}),
             _job())
    assert np.isclose(emit_wait_s.read(r), 0.5)


def test_load_gbps_is_bytes_over_read_and_parse():
    r = _run(_job({"load: read": 0.2, "load: parse": 0.3,
                   "load: queue wait": 5.0}, {"load_bytes": 400_000_000}),
             _job({"load: read": 0.1, "load: parse": 0.4},
                  {"load_bytes": 600_000_000}))
    # 1e9 bytes over 1.0 s; the queue waits are not the reader's pace
    assert np.isclose(load_gbps.read(r), 1.0)


def test_port_init_s_sums_the_first_jobs_loads_without_the_builds():
    spans = [["init: import", "MainThread", -1, 0.0, 250_000.0],
             ["init: native build", "MainThread", -1, 300_000.0,
              5_300_000.0],
             ["init: native lib", "MainThread", -1, 5_300_000.0,
              5_310_000.0],
             ["init: kernel build", "MainThread", -1, 6e6, 26e6],
             ["init: kernel lib strip_em", "MainThread", -1, 26e6,
              26.04e6],
             ["init: kernel lib pair_em_rows", "MainThread", -1, 27e6,
              27.01e6]]
    later = spans + [["init: kernel lib pair_em", "MainThread", -1, 3e7,
                      3.1e7]]
    r = _run(_job(process=spans), _job(process=later))
    assert np.isclose(port_init_s.read(r), 0.25 + 0.01 + 0.04 + 0.01)


def test_each_reader_returns_none_without_its_spans():
    bare = _run(_job(), _job())
    assert emit_wait_s.read(bare) is None
    assert load_gbps.read(bare) is None
    assert port_init_s.read(bare) is None
    # bytes without the reader's spans, and a process without the loads
    assert load_gbps.read(_run(_job(counters={"load_bytes": 10}))) is None
    assert port_init_s.read(_run(_job(process=[
        ["init: kernel build", "MainThread", -1, 0.0, 1.0]]))) is None


def test_the_entries_name_existing_cells_and_readers():
    b = manifest.load_benchmark()
    per = {m["name"]: m for m in b["per_layer"]}
    assert [m["name"] for m in b["per_layer"]][-3:] == list(NEW)
    for name in NEW:
        m = per[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == CELLS
        assert callable(manifest.reader(name))
    assert per["emit_wait_s"]["layer"] == per["format_s"]["layer"]
    assert per["load_gbps"]["layer"] == per["load_s"]["layer"]
    assert per["port_init_s"]["moves"] == "setup_s"
    assert per["load_gbps"]["unit"] == "GB/s"


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_span_metrics(monkeypatch, capsys, name):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    bench, cell = tiny_cell(name)
    monkeypatch.setattr(manifest, "cell", lambda n, b: cell)
    rc = run.main(["--workload", name, "--seed", str(2**31 + 5),
                   "--seconds", "0.5", "--trace", "1"], require_card=False)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    for k in NEW:
        assert out["metrics"][k]["value"] > 0, k
