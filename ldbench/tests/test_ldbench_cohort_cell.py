"""The ultra-low-pass cohort cell (nipt_cn.decay1mb_rnd05) on the CPU at
256 individuals, where every site of the input has a read.

At the tiny cells' 16 individuals and 0.08x about 28% of sites have no
read: every individual's E[G] is equal there, the reference's two-pass
Pearson prints rounding noise for r2_ExpG where ngsLD and the port print
nan, and the comparison reads gap_r2pear 1.0 whatever the program does.
At 256 individuals a site goes without a read with probability
exp(-0.08 x 256), 1.3e-9, as at the cell's 141,431; so here the cell reads
`correct`, and each fault and the control fail for their own reason."""

from __future__ import annotations

import json

import numpy as np
import pytest

from ldbench import check, inputs, manifest, run
from ldbench.reference import readers
from ldbench.tests._tiny import tiny_cell
from ldbench.tests.test_ldbench_harness import (_compute_block_fault,
                                                _half_rows)

NAME = "nipt_cn.decay1mb_rnd05"
N_IND, N_SITES, WARM = 256, 200, 60


def _cell():
    return tiny_cell(NAME, n_sites=N_SITES, n_ind=N_IND, warm_sites=WARM)


def _run(monkeypatch, capsys, trace, faults=()):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    _, cell = _cell()
    monkeypatch.setattr(manifest, "cell", lambda n, b: cell)
    for target, attr, fn in faults:
        monkeypatch.setattr(target, attr, fn)
    rc = run.main(["--workload", NAME, "--seed", str(2**31 + 23),
                   "--seconds", "0.5", "--trace", str(trace)],
                  require_card=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_every_site_has_a_read(tmp_path):
    _, cell = _cell()
    conf = cell["config"]
    data = inputs.CellInputs(2**31 + 23, N_SITES, N_IND, conf["generator"],
                             cell["format"], tmp_root=str(tmp_path))
    try:
        lg = readers.read_rows(data.job, np.arange(N_SITES))
    finally:
        data.close()
    # an individual without reads has its three GLs equal
    read = (lg != lg[:, :, :1]).any(axis=2)
    assert read.any(axis=1).all()
    assert 0.85 < 1 - read.mean() < 0.96       # about exp(-0.08) lack one


def test_a_traced_run_is_correct_and_reports_its_metrics(monkeypatch,
                                                         capsys):
    out = _run(monkeypatch, capsys, 1)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    bench = manifest.load_benchmark()
    want = {m["name"] for m in manifest.metrics_for(NAME, bench, True)}
    # the card's kernel metrics read nothing on the CPU
    want -= {"em_kernel_s", "em_roofline"}
    assert want <= set(out["metrics"])
    for k in ("emit_wait_s", "load_gbps", "port_init_s"):
        assert out["metrics"][k]["value"] > 0, k


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_rows"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, fault):
    from ngsld_tpu_torch import compute, engine_block
    from ngsld_tpu_torch.io import writer
    if fault == "half_rows":
        faults = [(engine_block, "format_rows_derive",
                   _half_rows(engine_block.format_rows_derive)),
                  (writer.RowWriter, "format_block",
                   _half_rows(writer.RowWriter.format_block))]
    else:
        faults = [(compute, "compute_block", _compute_block_fault(fault))]
    out = _run(monkeypatch, capsys, 0, faults)
    assert out["correct"] is False
    failing = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    # the fault's own check, and no r2_ExpG gap where the fault leaves
    # r2_ExpG alone
    want = {"half_rows": "pairs_off", "unchanged": "gap_freq",
            "altered": "gap_freq"}[fault]
    assert want in failing, out["checks"]
    assert "gap_r2pear" not in failing, out["checks"]


def test_control_fails_the_limits(tmp_path):
    _, cell = _cell()
    conf = cell["config"]
    data = inputs.CellInputs(21, N_SITES, N_IND, conf["generator"],
                             cell["format"], tmp_root=str(tmp_path))
    try:
        nums = check.control_job(cell, data.job, data.contig, data.pos, 21)
    finally:
        data.close()
    failing = {k for k, v in cell["limits"].items() if nums[k] > v}
    assert failing and failing != {"gap_r2pear"}, nums
