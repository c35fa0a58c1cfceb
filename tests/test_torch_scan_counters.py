"""The block engine's counters of a sampled LD-decay scan on the CPU
(--max_kb_dist 0 --max_snp_dist 64 --rnd_sample 0.05, binary input):
plan_candidates, the plan's in-band candidates before its MAF skip and
sampling, against the band walk of the benchmark's plain reference
(ldbench/reference/pairs.py::band_ends); pairs_<rung> and
em_iterations_<rung> against the pairs each gather kernel was handed and
against pairs_emitted and em_iterations, with the ladder forced to split
the job's blocks between two rungs."""

import io
import json
import os

import numpy as np
import pytest
import torch

from ldbench.reference import pairs as ref_pairs
from ngsld_tpu_torch import compute, engine_block
from ngsld_tpu_torch.cli import params_from_args
from ngsld_tpu_torch.engine import run_torch
from ngsld_tpu_torch.kernels import pair_em as kmod
from ngsld_tpu_torch.utils.simulate import simulate, write_all

N_IND, N_SITES = 16, 2000
RUNGS = ("gather", "rows", "ichunk")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan")
    return write_all(simulate(n_ind=N_IND, n_sites=N_SITES, seed=41),
                     str(d))


@pytest.mark.parametrize("overlap", ["1", "0"])
def test_scan_counters_add_up(monkeypatch, tmp_path, files, overlap):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    monkeypatch.setenv("NGSLD_OVERLAP_UPLOAD", overlap)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))

    # blocks of about 2,048 pairs take the lane groups, the last, smaller
    # one the rows kernel (both as their plain versions on the CPU)
    def ladder(n_ind, itemsize, device, n_pairs):
        return "gather" if n_pairs >= 1024 else "rows"
    handed = dict.fromkeys(RUNGS, 0)

    def counted(rung):
        real = kmod.GATHER_KERNELS[rung]

        def run(gn, sidx, *a, **k):
            handed[rung] += sidx.shape[1]
            return real(gn, sidx, *a, **k)
        return run
    for rung in RUNGS:
        monkeypatch.setitem(kmod.GATHER_KERNELS, rung, counted(rung))
    monkeypatch.setattr(compute, "pick_gather_kernel", ladder)
    monkeypatch.setattr(engine_block, "pick_gather_kernel", ladder)

    argv = ["--geno", files["glf"], "--log_scale", "--n_ind", str(N_IND),
            "--n_sites", str(N_SITES), "--pos", files["pos"],
            "--max_kb_dist", "0", "--max_snp_dist", "64", "--rnd_sample",
            "0.05", "--seed", str(2**31 + 3), "--extend_out",
            "--chunk_pairs", "2048", "--verbose", "0"]
    path = tmp_path / "timings.json"
    monkeypatch.setenv("NGSLD_TIMINGS_JSON", str(path))
    try:
        run_torch(params_from_args(argv), out_fh=io.BytesIO())
    finally:
        torch.set_num_threads(n)
    with open(path) as fh:
        c = json.load(fh)["counters"]
    assert c.get("overlap_ingest", 0) == int(overlap == "1")

    contig, pos, _ = ref_pairs.read_pos(files["pos"])
    end = ref_pairs.band_ends(contig, pos, 0, 64)
    assert c["plan_candidates"] == int(
        np.maximum(end - np.arange(N_SITES), 0).sum())

    assert c["pairs_gather"] > 0 and c["pairs_rows"] > 0
    assert {r: c.get(f"pairs_{r}", 0) for r in RUNGS} == handed
    assert sum(c.get(f"pairs_{r}", 0) for r in RUNGS) == c["pairs_emitted"]
    assert sum(c.get(f"em_iterations_{r}", 0) for r in RUNGS) \
        == c["em_iterations"] > 0
    assert c["em_iterations_gather"] > 0 and c["em_iterations_rows"] > 0
    assert c["rung_gather"] + c["rung_rows"] == c["blocks_computed"]
