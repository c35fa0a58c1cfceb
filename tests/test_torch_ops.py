"""Port ops (ngsld_tpu_torch.ops) vs their JAX counterparts on the CPU.

The same numpy inputs, made from a seed, go through both packages:
preprocess and pearson_r2 in f64 at atol 1e-12 with equal NaN/inf
positions; the plain pair EM in f64 at 1e-12 with n_iter/n_used exact,
and in f32 against the Pallas kernel in interpret mode under the kernel's
own contract (tests/test_pallas_em.py:35-42)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.ops import em as jem
from ngsld_tpu.ops import preprocess as jpre
from ngsld_tpu.ops import stats as jstats
from ngsld_tpu.utils.simulate import simulate
from ngsld_tpu_torch.ops import em as tem
from ngsld_tpu_torch.ops import preprocess as tpre
from ngsld_tpu_torch.ops import stats as tstats


@pytest.fixture(autouse=True, scope="module")
def _x64():
    # f64 comparisons, enabled as ngsld_tpu.engine.run_jax does for f64
    jax.config.update("jax_enable_x64", True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(a, b, atol=1e-12):
    """Equal NaN and +-inf positions, finite values within atol."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol)


def _gl_log(seed=21, n_ind=10, n_sites=120):
    """Log-normalised GLs with all-missing and monomorphic sites, as the
    engine reads them."""
    sim = simulate(n_ind=n_ind, n_sites=n_sites, seed=seed,
                   all_missing_site_rate=0.05, mono_rate=0.1)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    with np.errstate(divide="ignore"):
        return sim, np.log(gl)


def test_normalize_miss_expected_match_jax():
    sim, gl_log = _gl_log()
    raw = np.log(sim.gl) + 3.0          # unnormalised log records
    raw[0, 0] = -np.inf                 # an all -inf row stays -inf
    for x in (gl_log, raw):
        assert_same(tpre.normalize_gl(torch.from_numpy(x)),
                    jpre.normalize_gl(jnp.asarray(x)))
        assert_same(tpre.miss_mask(torch.from_numpy(x)),
                    jpre.miss_mask(jnp.asarray(x)))
    gn = np.exp(gl_log)
    assert_same(tpre.expected_geno(torch.from_numpy(gn)),
                jpre.expected_geno(jnp.asarray(gn)))


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_est_maf_matches_jax(ignore_miss):
    _, gl_log = _gl_log(seed=3)
    a = tpre.est_maf(torch.from_numpy(gl_log), ignore_miss)
    b = jpre.est_maf(jnp.asarray(gl_log), ignore_miss)
    assert_same(a, b)
    if ignore_miss:
        assert np.isnan(_np(a)).any()   # all-missing sites: 0/0


@pytest.mark.parametrize("N_thresh,call_thresh", [(0.0, 0.0), (0.3, 0.9),
                                                  (0.0, 0.4)])
def test_call_geno_matches_jax_with_ties(N_thresh, call_thresh):
    _, gl_log = _gl_log(seed=5)
    # crafted rows: tied maxima (first-max rule), tied minima, all equal
    lg = np.log
    crafted = np.array([[lg(.45), lg(.45), lg(.10)],
                        [lg(.10), lg(.45), lg(.45)],
                        [lg(.45), lg(.10), lg(.45)],
                        [lg(.40), lg(.30), lg(.30)],
                        [lg(1 / 3)] * 3,
                        [0.0, -1e15, -1e15]])
    gl_log[:len(crafted), 0] = crafted
    a = tpre.call_geno(torch.from_numpy(gl_log), N_thresh, call_thresh)
    b = jpre.call_geno(jnp.asarray(gl_log), N_thresh, call_thresh)
    assert_same(a, b)
    if call_thresh == 0.4:   # the tied rows are called at the FIRST max
        assert _np(a)[0, 0].tolist() == [0.0, -1e15, -1e15]
        assert _np(a)[1, 0].tolist() == [-1e15, 0.0, -1e15]
        assert _np(a)[2, 0].tolist() == [0.0, -1e15, -1e15]


@pytest.mark.parametrize("call,ignore_miss,raw,in_log", [
    (False, False, False, True),
    (True, False, False, True),
    (False, True, False, True),
    (True, True, False, True),
    (False, False, True, True),
    (False, True, True, False),
    (True, False, True, False),
])
def test_preprocess_matches_jax(call, ignore_miss, raw, in_log):
    sim, gl_log = _gl_log(seed=11)
    if raw:
        x = sim.gl * 7.0 if not in_log else np.log(sim.gl) - 2.0
        x = np.array(x)
        x[1, 2] = 0.0 if not in_log else -np.inf   # log(0) -> -INF clamp
    else:
        x = gl_log
    kw = dict(call=call, N_thresh=0.2 if call else 0.0,
              call_thresh=0.8 if call else 0.0,
              ignore_miss_data=ignore_miss, raw=raw, in_log=in_log)
    for a, b in zip(tpre.preprocess(torch.from_numpy(x), **kw),
                    jpre.preprocess(jnp.asarray(x), **kw)):
        assert_same(a, b)


def test_pearson_r2_matches_jax_incl_zero_variance():
    rng = np.random.default_rng(0)
    x = rng.random((64, 15)) * 2
    y = rng.random((64, 15)) * 2
    x[3] = 1.25          # zero-variance sites: 0/0 -> NaN
    y[7] = 0.0
    x[9], y[9] = 0.5, 2.0
    a = tstats.pearson_r2(torch.from_numpy(x), torch.from_numpy(y))
    b = jstats.pearson_r2(jnp.asarray(x), jnp.asarray(y))
    assert_same(a, b)
    assert np.isnan(_np(a)[[3, 7, 9]]).all()


def _pairs(n_pairs, n_ind, seed, dtype, miss=True):
    """As tests/test_pallas_em.py:9-17 builds its cases."""
    sim = simulate(n_ind=n_ind, n_sites=2 * n_pairs, seed=seed,
                   all_missing_site_rate=0.05 if miss else 0.0)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = eg.mean(axis=1) / 2
    return tuple(a.astype(dtype) for a in (
        gl[:n_pairs], gl[n_pairs:], maf[:n_pairs], maf[n_pairs:]))


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_pair_em_f64_matches_jax(ignore_miss):
    args = _pairs(150, 14, 31, np.float64)
    f_t, it_t, nu_t = tem.pair_em(*map(torch.from_numpy, args), ignore_miss)
    f_j, it_j, nu_j = jem.pair_em(*map(jnp.asarray, args), ignore_miss)
    assert_same(f_t, f_j)
    assert_same(it_t, it_j)
    assert_same(nu_t, nu_j)
    if ignore_miss:   # x = 0 pairs: NaN f frozen at n_iter 0
        x0 = _np(nu_t) == 0
        assert x0.any()
        assert np.isnan(_np(f_t)[x0]).all() and (_np(it_t)[x0] == 0).all()


def test_pair_em_live_mask_matches_jax():
    args = _pairs(64, 10, 7, np.float64, miss=False)
    live = np.random.default_rng(7).random(64) < 0.5
    f_t, it_t, nu_t = tem.pair_em(*map(torch.from_numpy, args), False,
                                  live=torch.from_numpy(live))
    f_j, it_j, nu_j = jem.pair_em(*map(jnp.asarray, args), False,
                                  live=jnp.asarray(live))
    assert_same(f_t, f_j)
    assert_same(it_t, it_j)
    assert_same(nu_t, nu_j)
    m1, m2 = args[2][~live], args[3][~live]
    f0 = np.stack([(1 - m1) * (1 - m2), (1 - m1) * m2,
                   m1 * (1 - m2), m1 * m2], axis=1)
    np.testing.assert_array_equal(_np(f_t)[~live], f0)
    assert (_np(it_t)[~live] == 100).all()


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_pair_em_f32_matches_pallas_kernel(ignore_miss):
    from ngsld_tpu.kernels.pallas_em import pair_em_pallas
    args = _pairs(130, 24, 154, np.float32)
    f_t, it_t, nu_t = tem.pair_em(*map(torch.from_numpy, args), ignore_miss)
    f_k, it_k, nu_k = pair_em_pallas(*map(jnp.asarray, args), ignore_miss,
                                     pair_tile=128, interpret=True)
    np.testing.assert_array_equal(_np(nu_t), _np(nu_k))
    ft, fk = _np(f_t), _np(f_k)
    np.testing.assert_array_equal(np.isnan(ft), np.isnan(fk))
    both = np.isnan(ft)
    np.testing.assert_allclose(np.where(both, 0, ft), np.where(both, 0, fk),
                               atol=3e-5)
    it_diff = np.abs(_np(it_t).astype(np.int64) - _np(it_k))
    assert (it_diff <= 1).mean() > 0.95
