"""An ultra-low-pass biobank cohort (141,431 individuals at about 0.08x, as
in non-invasive prenatal testing data) on the CPU: the gather ladder's
route past the ichunk cluster's capacity; the port on a seeded
ultra-low-depth input held against ldbench's plain reference and against
the JAX package; the Pearson r2 step's span; and sites that no read
covers, held against the JAX package's strict and JAX engines.

The H100's shared memory stands in for the card's (kernels/build.py::
NOMINAL_SMEM), as in test_torch_gatherdesign.py; the streamed body itself
is held against its plain version on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldbench import check, inputs, jobs
from ngsld_tpu import cli as jcli
from ngsld_tpu import strict as jstrict
from ngsld_tpu.engine import run_jax
from ngsld_tpu.ops import preprocess as jpre
from ngsld_tpu_torch import compute, engine_block
from ngsld_tpu_torch.kernels import pair_em as kmod
from ngsld_tpu_torch.ops import preprocess as tpre
from ngsld_tpu_torch.utils.conformance import cmp_vs_strict

COHORT = 141_431          # Liu et al., Cell 2018: the NIPT cohort's size
N_IND = 1536              # the CPU runs' cohort
GEN = {"Ne": 10000, "mu": 1.2e-08, "r": 1.2e-08, "min_maf": 0.05,
       "mean_depth": 0.08, "err": 0.01}
# the cohort limits of ldbench's converge cells
LIMITS = {"pairs_off": 0, "gap_freq": 1e-3, "gap_r2pear": 1e-4,
          "gap_ratio": 1e-4, "gap_niter": 20}
# LD decay to 1 Mb with --rnd_sample raised from 0.05 to draw a few
# hundred of the 64 sites' 2,016 pairs
FLAGS = ["--max_kb_dist", "1000", "--rnd_sample", "0.15", "--extend_out"]


def _cap_threads():
    # the plain versions run many small tensor ops: more threads only
    # fight the other test workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    return n


@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    n = _cap_threads()
    yield
    torch.set_num_threads(n)


def _job(data, flags, seed, tmp):
    runner = jobs.JobRunner(jobs.argv_for(data.job, flags, seed), str(tmp))
    rows, _, timings = runner.run()
    return bytes(rows), timings


def _lines(path):
    return path.read_text().splitlines()


@pytest.fixture(scope="module")
def cohort_run(tmp_path_factory):
    """64 sites x 1,536 individuals at 0.08x (two of the streamed body's
    1,024-individual chunks), binary log-GL, made by the benchmark's
    generator (seed past 32 bits, as the benchmark's are), and the port's
    rows for FLAGS in f64 on the ichunk rung's plain version (the route
    the cohort takes on the card)."""
    tmp = tmp_path_factory.mktemp("cohort")
    seed = 2**31 + 977
    data = inputs.CellInputs(seed, 64, N_IND, GEN, "glf", tmp_root=str(tmp))
    n = _cap_threads()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("NGSLD_PLATFORM", "cpu")
            for mod in (compute, engine_block):
                mp.setattr(mod, "pick_gather_kernel", lambda *a: "ichunk")
            rows, tim = _job(data, FLAGS + ["--precision", "f64"], seed, tmp)
        yield seed, data, rows, tim, tmp
    finally:
        torch.set_num_threads(n)
        data.close()


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("itemsize", [4, 8])
def test_the_cohort_takes_the_streamed_ichunk_body(itemsize):
    """Past the cluster's capacity (77,120 individuals in f32, 38,560 in
    f64) no cluster holds a pair's rows, and every block, whatever its
    size, goes to the ichunk rung, which then streams."""
    assert kmod.ichunk_cluster(COHORT, itemsize) is None
    for n_pairs in (1, 1_632, 65_536, 96_400, 524_288):
        assert kmod.pick_gather_kernel(COHORT, itemsize, "cpu",
                                       n_pairs) == "ichunk"


# ---------------------------------- against the reference and the JAX package

def test_the_decay_flags_match_the_reference(cohort_run):
    """The reference's pair set, and every column within the cohort
    limits."""
    seed, data, rows, tim, _ = cohort_run
    nums = check.check_job(rows, {"flags": FLAGS}, data.job, data.labels,
                           data.contig, data.pos, seed)
    assert 200 <= nums["rows"] == nums["compared"] <= 400, nums
    for k, limit in LIMITS.items():
        assert nums[k] <= limit, (k, nums)
    c = tim["counters"]
    assert c["pairs_ichunk"] == nums["rows"]
    assert c["plan_candidates"] == 64 * 63 // 2
    # at 0.08x the EM's missing information is most of it: every pair
    # runs to the reference's cap of 100 iterations (n_iter counts from 0)
    assert c["em_iterations_ichunk"] >= 0.9 * 99 * nums["rows"]


def test_the_decay_flags_match_the_jax_package(cohort_run):
    """The JAX package's CLI on the same input and flags, at its card
    precision (f32: a block of it takes twice as long in f64 on the CPU),
    prints the same pairs in the same order, and each column within
    conformance.cmp_vs_strict's bounds."""
    seed, data, rows, _, tmp = cohort_run
    out = tmp / "jax.ld"
    argv = jobs.argv_for(data.job, FLAGS + ["--precision", "f32"], seed)
    run_jax(jcli.params_from_args(argv + ["--verbose", "0",
                                          "--out", str(out)]))
    port = rows.decode().splitlines()
    cmp_vs_strict(_lines(out), port, 200)


# ------------------------------------------------ the r2 step's records

def _spans(tim, name):
    return [s for s in tim["spans"] if s[0] == name]


def test_one_r2p_span_a_gather_block(tmp_path):
    """One `compute: r2p` span a block, on the thread that dispatches
    it."""
    seed = 2**31 + 976
    data = inputs.CellInputs(seed, 48, 40, GEN, "glf",
                             tmp_root=str(tmp_path))
    try:
        _, tim = _job(data, ["--max_kb_dist", "1000", "--rnd_sample", "0.2",
                             "--extend_out", "--precision", "f32",
                             "--chunk_pairs", "32"], seed, tmp_path)
    finally:
        data.close()
    c = tim["counters"]
    assert c["blocks_computed"] >= 3
    spans = _spans(tim, "compute: r2p")
    assert len(spans) == c["blocks_computed"]
    assert tim["stages"]["compute: r2p"] > 0
    dispatch = {s[1] for s in _spans(tim, "sweep: dispatch")}
    assert {s[1] for s in spans} == dispatch


def test_the_strip_sweep_records_no_r2p_span(tmp_path, monkeypatch):
    """The strip sweep computes r2 inside its tile kernel."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    seed = 2**31 + 978
    data = inputs.CellInputs(seed, 48, 40, GEN, "glf",
                             tmp_root=str(tmp_path))
    try:
        rows, tim = _job(data, ["--max_kb_dist", "1000", "--extend_out",
                                "--precision", "f32"], seed, tmp_path)
    finally:
        data.close()
    assert rows.count(b"\n") - 1 == 48 * 47 // 2
    assert not _spans(tim, "compute: r2p")
    assert "compute: r2p" not in tim["stages"]


def test_compute_block_outside_a_step_log_records_nothing():
    """compute_block called without step_log (tools, the graft entry)
    records nothing, and step_log is undone when its block ends."""
    from ngsld_tpu_torch.utils.logging import RunLog
    g = torch.rand(6, 9, 3, dtype=torch.float64)
    gn = g / g.sum(dim=2, keepdim=True)
    eg = gn[..., 1] + 2 * gn[..., 2]
    maf = eg.mean(dim=1) / 2
    sidx = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    log = RunLog(verbose=0)
    with compute.step_log(log):
        inside = compute.compute_block(gn, eg, maf, sidx, False)
    outside = compute.compute_block(gn, eg, maf, sidx, False)
    assert [s[0] for s in log.spans] == ["compute: r2p"]
    assert not log.counters
    assert torch.equal(inside[0], outside[0])


# ------------------------------------------------- sites with no reads

@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_sites_without_reads_print_as_ngsld(tmp_path, prec):
    """At 0.08x a 15-individual input (not a power of two) has sites that
    no read covers: every individual's E[G] is the same, and Pearson's
    r2 is 0/0. On the E[G] that the binary records' preprocessing gives,
    in the port as in the JAX package, ngsLD's one-pass correlation
    (ngsld_tpu.strict.pearson_r2_batch) is NaN for every pair that holds
    such a site. The port's CLI prints r2_ExpG NaN on exactly the rows
    where the JAX package's strict engine (ngsLD's arithmetic) prints it,
    and every row as that engine does. The JAX package's JAX engine does
    so in f64; in f32 it prints 0 on those rows, so there the port is held
    to it on the other rows."""
    S, n_ind, seed = 40, 15, 2**31 + 979
    data = inputs.CellInputs(seed, S, n_ind, GEN, "glf",
                             tmp_root=str(tmp_path))
    try:
        lg = np.fromfile(data.job["geno"], np.float64).reshape(S, n_ind, 3)
        _, _, eg = tpre.preprocess(torch.from_numpy(lg), False, 0.0, 0.0,
                                   False, raw=True)
        with jax.enable_x64(True):
            _, _, j_eg = jpre.preprocess(jnp.asarray(lg), False, 0.0, 0.0,
                                         False, raw=True)
            j_eg = np.asarray(j_eg)
        eg = eg.numpy()
        np.testing.assert_allclose(eg, j_eg, rtol=0, atol=1e-12)
        flat = np.flatnonzero((eg == eg[:, :1]).all(axis=1))
        assert 3 <= len(flat) <= S // 2
        s1, s2 = np.triu_indices(S, 1)
        touched = np.isin(s1, flat) | np.isin(s2, flat)
        r2 = jstrict.pearson_r2_batch(eg[s1], eg[s2])
        assert np.isnan(r2[touched]).all() and np.isfinite(r2[~touched]).all()

        argv = jobs.argv_for(data.job, ["--max_kb_dist", "1000",
                                        "--extend_out", "--verbose", "0"],
                             seed)
        t_out, s_out, j_out = (tmp_path / n for n in ("t.ld", "s.ld", "j.ld"))
        t_rows, _ = _job(data, ["--max_kb_dist", "1000", "--extend_out",
                                "--precision", prec], seed, tmp_path)
        t_out.write_bytes(t_rows)
        assert jcli.main(argv + ["--engine", "strict",
                                 "--out", str(s_out)]) == 0
        run_jax(jcli.params_from_args(argv + ["--precision", prec,
                                              "--out", str(j_out)]))
    finally:
        data.close()

    def r2_expg_nan(path):
        return np.array([np.isnan(float(r.split("\t")[3]))
                         for r in _lines(path)[1:]])

    # the rows come in pair order, (0, 1), (0, 2), ..., as triu_indices
    want = r2_expg_nan(s_out)
    np.testing.assert_array_equal(want, touched)
    np.testing.assert_array_equal(r2_expg_nan(t_out), want)
    cmp_vs_strict(_lines(s_out), _lines(t_out), S * (S - 1) // 2 - 1)
    j_rows, t_rows = _lines(j_out), _lines(t_out)
    if prec == "f64":
        np.testing.assert_array_equal(r2_expg_nan(j_out), want)
    else:
        assert not r2_expg_nan(j_out).any()
        keep = [0] + [1 + i for i in np.flatnonzero(~touched)]
        j_rows, t_rows = [j_rows[i] for i in keep], [t_rows[i] for i in keep]
    cmp_vs_strict(j_rows, t_rows, 100)
