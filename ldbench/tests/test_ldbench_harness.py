"""The harness on the CPU: the manifest against the contract, the keys of
a run's last line, and the comparison failing a run whose timed path is
broken underneath (the look for a card skipped, tiny cells)."""

from __future__ import annotations

import json
import os
import re
import types

import numpy as np
import pytest

from ldbench import check, inputs, manifest, run
from ldbench.tests._tiny import tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]


def test_manifest_names_units_and_files():
    b = manifest.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["ldbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for c in b["configs"]:
        assert c["file"].startswith("ldbench/configs/")
        with open(os.path.join(manifest.ROOT, c["file"])) as fh:
            conf = json.load(fh)
        assert set(c["reduced"]) == set(conf["reduced"])
        assert conf["precision"] in ("f32", "f64")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"pairs_per_s", "setup_s"} <= e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert callable(manifest.reader(m["name"]))
    for w in b["workloads"]:
        cell = manifest.cell(w["name"], b)
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert set(cell["limits"]) >= {"pairs_off", "gap_freq",
                                       "gap_r2pear", "gap_ratio"}
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])


def _run(monkeypatch, capsys, name, faults=()):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    bench, cell = tiny_cell(name)
    monkeypatch.setattr(manifest, "cell", lambda n, b: cell)
    for target, attr, fn in faults:
        monkeypatch.setattr(target, attr, fn)
    rc = run.main(["--workload", name, "--seed", str(2**31 + 11),
                   "--seconds", "0.5", "--trace", "0"], require_card=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_last_line_keys(monkeypatch, capsys):
    out = _run(monkeypatch, capsys, "converge.snp128_rnd10")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    assert out["correct"] is True and out["failed"] == 0
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


def _compute_block_fault(kind):
    import torch
    from ngsld_tpu_torch import compute
    orig = compute.compute_block

    def broken(gn, eg, maf, sidx, ignore_miss_data):
        fmat, imat = orig(gn, eg, maf, sidx, ignore_miss_data)
        fmat = fmat.clone()
        if kind == "unchanged":
            # the EM step hands back its starting state
            m1, m2 = maf[sidx[0].long()], maf[sidx[1].long()]
            fmat[:, 1:5] = torch.stack(
                [(1 - m1) * (1 - m2), (1 - m1) * m2, m1 * (1 - m2), m1 * m2],
                dim=1).to(fmat.dtype)
            imat = torch.zeros_like(imat)
        else:
            # an answer altered where it is produced
            fmat[:, 1] += 0.01
            fmat[:, 2] -= 0.01
        return fmat, imat
    return broken


def _half_rows(fn):
    def broken(*a, **k):
        data = fn(*a, **k)
        if data is None:
            return None
        lines = bytes(data).split(b"\n")[:-1]
        return b"".join(ln + b"\n" for ln in lines[:len(lines) // 2])
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_rows"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, name,
                                            fault):
    from ngsld_tpu_torch import compute, engine_block
    from ngsld_tpu_torch.io import writer
    if fault == "half_rows":
        faults = [(engine_block, "format_rows_derive",
                   _half_rows(engine_block.format_rows_derive)),
                  (writer.RowWriter, "format_block",
                   _half_rows(writer.RowWriter.format_block))]
    else:
        faults = [(compute, "compute_block", _compute_block_fault(fault))]
    out = _run(monkeypatch, capsys, name, faults)
    assert out["correct"] is False
    failing = [k for k, v in out["checks"].items()
               if v["value"] > v["limit"]]
    want = {"half_rows": "pairs_off", "unchanged": "gap_freq",
            "altered": "gap_freq"}[fault]
    assert want in failing, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(tmp_path, name):
    """The control, the reference in bf16 put in the program's place,
    fails at least one of each cell's limits."""
    _, cell = tiny_cell(name, n_sites=400)
    conf = cell["config"]
    data = inputs.CellInputs(21, cell["n_sites"], conf["n_ind"],
                             conf["generator"], cell["format"],
                             tmp_root=str(tmp_path))
    try:
        nums = check.control_job(cell, data.job, data.contig, data.pos, 21)
    finally:
        data.close()
    assert any(nums[k] > v for k, v in cell["limits"].items()), nums


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    rc = run.main(["--workload", "converge.snp128_rnd10", "--seed", "7",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


def test_the_reader_of_a_stage_never_reports_a_stage_not_run():
    from ldbench.metrics import ingest_wait_s, load_s
    r = types.SimpleNamespace(jobs=[{"phases": {}, "stages": {},
                                     "counters": {}}])
    assert ingest_wait_s.read(r) is None and load_s.read(r) is None
    assert np.isclose(load_s.read(types.SimpleNamespace(jobs=[
        {"phases": {"  gl stream+upload": 2.0}, "stages": {}}])), 2.0)
