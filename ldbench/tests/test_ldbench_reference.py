"""The benchmark's plain reference against the port's strict oracle at a
tiny size (the test may import the port; ldbench/reference/ may not),
and the frozen generator's determinism."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldbench import check, inputs
from ldbench.reference import em, pairs, readers, taus

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GEN = dict(Ne=10000, mu=1.2e-8, r=1.2e-8, min_maf=0.05, mean_depth=4.0,
           err=0.01)


def test_taus_matches_the_ports_copy():
    from ngsld_tpu_torch.gsl_rng import TausRNG, taus_uniforms
    seeds = np.array([0, 1, 7, 2**31 + 5, 123456789012], np.uint64)
    assert np.array_equal(taus.uniforms(seeds, 9), taus_uniforms(seeds, 9))
    for seed in (0, 12345, 2**31 + 77):
        rng = TausRNG(seed)
        want = [int(rng.uniform() * 1e15) for _ in range(50)]
        assert taus.master_child_seeds(seed, 50).tolist() == want


@pytest.mark.parametrize("flags", [
    dict(max_kb_dist=10, max_snp_dist=0, rnd_sample=1.0, seed=1),
    dict(max_kb_dist=0, max_snp_dist=16, rnd_sample=0.3, seed=2**31 + 9),
    dict(max_kb_dist=5, max_snp_dist=8, rnd_sample=0.5, seed=77),
    dict(max_kb_dist=0, max_snp_dist=0, rnd_sample=0.05, seed=3)])
def test_pair_set_matches_strict(tmp_path, flags):
    from ngsld_tpu_torch import strict
    from ngsld_tpu_torch.config import Params
    data = inputs.CellInputs(4, 300, 6, GEN, "glf", tmp_root=str(tmp_path))
    try:
        pars = Params(in_geno=data.job["geno"], n_ind=6, n_sites=300,
                      in_pos=data.job["pos"], **flags).finalize()
        pos_dist, _ = strict.read_pos(pars.in_pos, False, 300)
        want = strict.enumerate_pairs(pars, np.ones(300), pos_dist)
        s1, s2, dist = pairs.enumerate_pairs(data.contig, data.pos, **flags)
        assert list(zip(s1.tolist(), s2.tolist(), dist.tolist())) == \
            [(a, b, float(d)) for a, b, d in want]
    finally:
        data.close()


@pytest.mark.parametrize("fmt", ["glf", "beagle"])
def test_values_match_strict(tmp_path, fmt):
    from ngsld_tpu_torch import strict
    n_ind, n_sites = 12, 200
    data = inputs.CellInputs(8, n_sites, n_ind, GEN, fmt,
                             tmp_root=str(tmp_path))
    try:
        in_bin = fmt == "glf"
        lg_strict = strict.read_geno(data.job["geno"], in_bin, True, in_bin,
                                     n_ind, n_sites)
        lg = readers.read_rows(data.job, np.arange(n_sites))
        np.testing.assert_allclose(lg, lg_strict, rtol=0, atol=1e-12)
        maf = strict.est_maf_all(lg_strict, False)
        gn = strict.libm_exp(lg_strict)
        eg = gn[:, :, 1] + 2 * gn[:, :, 2]
        s1, s2, _ = pairs.enumerate_pairs(
            data.contig, data.pos, max_kb_dist=0, max_snp_dist=20,
            rnd_sample=1.0, seed=1)
        f, n_iter, _ = strict.pair_em_batch(gn[s1], gn[s2], maf[s1],
                                            maf[s2], False)
        r2p = strict.pearson_r2_batch(eg[s1], eg[s2])
        _, _, D, Dp, r2 = strict.ld_stats_batch(f)
        ref = em.pair_values(lg, s1, s2)
        np.testing.assert_allclose(ref["maf1"], maf[s1], rtol=0, atol=1e-13)
        np.testing.assert_allclose(ref["f"], f, rtol=0, atol=1e-10)
        np.testing.assert_allclose(ref["r2_ExpG"], r2p, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ref["D"], D, rtol=0, atol=1e-10)
        assert np.abs(ref["nIter"] - n_iter).max() <= 1
        assert (ref["nIter"] == n_iter).mean() > 0.99
        ok = np.abs(ref["den_r2"]) > 1e-6
        np.testing.assert_allclose(ref["r2"][ok], r2[ok], rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(ref["Dp"][ok], Dp[ok], rtol=1e-6,
                                   atol=1e-9)
    finally:
        data.close()


def test_generator_is_deterministic_per_seed(tmp_path):
    def files(seed, fmt):
        d = inputs.CellInputs(seed, 700, 9, GEN, fmt, warm_sites=150,
                              tmp_root=str(tmp_path))
        try:
            out = []
            for job in (d.job, d.warm):
                with open(job["geno"], "rb") as fh:
                    out.append(fh.read())
                with open(job["pos"], "rb") as fh:
                    out.append(fh.read())
            return out
        finally:
            d.close()
    a, b, c = files(5, "glf"), files(5, "glf"), files(6, "glf")
    assert a == b and a[0] != c[0]
    # the warm-up file is the cell's first sites
    assert a[0][:len(a[2])] == a[2] and len(a[2]) == 150 * 9 * 24
    assert a[1].startswith(a[3])
    t1, t2 = files(5, "beagle"), files(5, "beagle")
    import gzip
    assert gzip.decompress(t1[0]) == gzip.decompress(t2[0])
    rows = gzip.decompress(t1[0]).split(b"\n")
    assert len(rows) == 702 and len(rows[1].split(b"\t")) == 3 + 27
    # a large seed, past 32 bits, is a seed like any other
    assert files(2**31 + 3, "glf")[0] != a[0]


def test_generator_follows_the_population_model():
    m, n = 60, 20000
    pos = inputs.candidate_positions(9, n, m, GEN)
    h = inputs.haplotypes(9, pos, m, GEN)
    c = h.sum(axis=0)
    # every candidate segregates, derived counts by the 1/i spectrum
    assert c.min() >= 1 and c.max() <= m - 1
    a = (1.0 / np.arange(1, m)).sum()
    for i in (1, 2, 5):
        assert abs((c == i).mean() - 1 / (i * a)) < 0.15 / (i * a)
    # LD decays with distance: mean r2 of sites 1, 100 and 1000 apart
    x = (h - h.mean(axis=0)) / h.std(axis=0)
    r2 = [np.mean(((x[:, :-k] * x[:, k:]).mean(axis=0)) ** 2)
          for k in (1, 100, 1000)]
    assert r2[0] > 0.1 and r2[0] > 3 * r2[1] and r2[1] > r2[2]
    # the kept sites pass the filter, one contig, increasing positions
    pos, g = inputs.sample(9, 400, 30, GEN)
    f = g.mean(axis=1) / 2
    assert g.shape == (400, 30) and g.min() >= 0 and g.max() <= 2
    assert np.minimum(f, 1 - f).min() >= GEN["min_maf"]
    assert (np.diff(pos) > 0).all()


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import ldbench.reference.em, ldbench.reference."
            "pairs, ldbench.reference.readers, ldbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ngsld_tpu_torch', 'ngsld_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_control_is_far_from_the_reference(tmp_path):
    """bf16 arithmetic moves the frequencies by far more than f64's
    rounding: the control's gaps stand orders above the reference's
    own."""
    data = inputs.CellInputs(3, 300, 20, GEN, "glf", tmp_root=str(tmp_path))
    try:
        s1, s2, _ = pairs.enumerate_pairs(data.contig, data.pos,
                                          max_kb_dist=0, max_snp_dist=10,
                                          rnd_sample=1.0, seed=1)
        lg = readers.read_rows(data.job, np.arange(300))
        ref = em.pair_values(lg, s1, s2)
        ctl = em.pair_values(lg, s1, s2, dtype=torch.bfloat16)
        gaps, _ = check.compare_values(check.as_printed(ctl, True, 20), ref,
                                       True, 20)
        same, _ = check.compare_values(check.as_printed(ref, True, 20), ref,
                                       True, 20)
        assert gaps["gap_freq"] > 1e-3 and same["gap_freq"] <= 5e-7
        assert gaps["gap_niter"] > 10 and same["gap_niter"] == 0
    finally:
        data.close()
