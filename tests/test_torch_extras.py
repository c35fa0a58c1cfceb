"""The port's extras (ngsld_tpu_torch/extras) against the JAX package's on
the CPU, on the same seeded inputs.

The HMM functions run in f64 on both sides (the JAX side inside the
scoped `jax.enable_x64(True)`, so that the setting does not leak into
other test files on the same worker): values within 1e-12 absolute,
Viterbi paths equal, batched inputs against `jax.vmap` of the JAX
function. A Viterbi tie pins the first-maximum rule. findmax is the same
scipy code on both sides; findmax_torch is held to findmax_jax's
results on the quadratic and bounded cases of tests/test_extras.py
within 1e-4 (both stop on a gradient test, not at the exact optimum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.extras import hmm as jhmm
from ngsld_tpu.extras.optimize import findmax as j_findmax
from ngsld_tpu.extras.optimize import findmax_jax
from ngsld_tpu_torch.extras import hmm
from ngsld_tpu_torch.extras.optimize import findmax, findmax_torch

TOL = 1e-12         # f64 on both sides
OPT_TOL = 1e-4      # two quasi-Newton runs that stop on a gradient test


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def case():
    """Three sequences of 40 sites, two states."""
    rng = np.random.default_rng(0)
    B, L, K = 3, 40, 2
    q = np.array([0.7, 0.3])
    em = np.log(rng.random((B, L, K)))
    dist = rng.integers(1, 2000, (B, L)).astype(float)
    return q, 1e-3, em, dist


def _jax_batched(fn, q, alpha, em, dist):
    with jax.enable_x64(True):
        out = jax.vmap(lambda e, d: fn(jnp.asarray(q), alpha, e, d))(
            jnp.asarray(em), jnp.asarray(dist))
        return jax.tree.map(np.asarray, out)


def _torch(fn, q, alpha, em, dist):
    out = fn(torch.tensor(q), alpha, torch.tensor(em), torch.tensor(dist))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@pytest.mark.parametrize("name", ["forward", "backward", "posterior"])
def test_hmm_batched_matches_jax_vmap(case, name):
    want = _jax_batched(getattr(jhmm, name), *case)
    got = _torch(getattr(hmm, name), *case)
    if name == "posterior":
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_hmm_single_sequence_matches_jax(case):
    q, alpha, em, dist = case
    with jax.enable_x64(True):
        want = jhmm.forward(jnp.asarray(q), alpha, jnp.asarray(em[0]),
                            jnp.asarray(dist[0]))
        want_t = np.asarray(jhmm.log_trans_matrix(jnp.asarray(q), alpha,
                                                  jnp.asarray(dist[0])))
    got = hmm.forward(torch.tensor(q), alpha, torch.tensor(em[0]),
                      torch.tensor(dist[0]))
    assert abs(float(got[0]) - float(want[0])) <= TOL
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=TOL)
    got_t = hmm.log_trans_matrix(torch.tensor(q), alpha,
                                 torch.tensor(dist[0])).numpy()
    assert got_t.shape == want_t.shape == (40, 2, 2)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=TOL)


def test_viterbi_batched_matches_jax_vmap(case):
    w_score, w_path = _jax_batched(jhmm.viterbi, *case)
    g_score, g_path = _torch(hmm.viterbi, *case)
    np.testing.assert_allclose(g_score, w_score, rtol=0, atol=TOL)
    assert g_path.dtype == np.int32 and w_path.dtype == np.int32
    np.testing.assert_array_equal(g_path, w_path)


@pytest.mark.parametrize("q,state", [([0.5, 0.5], 0), ([0.2, 0.4, 0.4], 1)])
def test_viterbi_tie_takes_the_first_maximum(q, state):
    """Distances so long that every transition is q itself, flat
    emissions: every step's scores tie between the states of largest q,
    and the path takes the lowest of them, as jnp.argmax does."""
    q = np.array(q)
    em = np.zeros((8, len(q)))
    dist = np.full(8, 1e9)
    j_score, j_path = jhmm.viterbi(jnp.asarray(q), 1e-3, jnp.asarray(em),
                                   jnp.asarray(dist))
    score, path = hmm.viterbi(torch.tensor(q), 1e-3, torch.tensor(em),
                              torch.tensor(dist))
    assert path.tolist() == np.asarray(j_path).tolist() == [state] * 8
    assert float(score) == pytest.approx(float(j_score), abs=1e-6)


@pytest.mark.parametrize("F", [0, 1])
def test_emissions_batched_match_jax_vmap(F):
    rng = np.random.default_rng(1)
    B = 5
    h = rng.dirichlet(np.ones(4), size=B)
    gl_prev = np.log(rng.dirichlet(np.ones(3), size=B))
    gl_curr = np.log(rng.dirichlet(np.ones(3), size=B))
    maf = rng.random(B) * 0.5
    with jax.enable_x64(True):
        j_joint = np.asarray(jax.vmap(
            lambda x: jhmm.joint_geno_logprob(x, F))(jnp.asarray(h)))
        j_hwe = np.asarray(jax.vmap(
            lambda g, m: jhmm.emission_hwe(g, m, float(F)))(
                jnp.asarray(gl_prev), jnp.asarray(maf)))
        j_freq = np.asarray(jax.vmap(
            lambda m: jhmm.hwe_genotype_logfreq(m, float(F)))(
                jnp.asarray(maf)))
        j_ld = np.asarray(jax.vmap(
            lambda x, a, b, m: jhmm.emission_ld(x, a, b, m, F))(
                jnp.asarray(h), jnp.asarray(gl_prev), jnp.asarray(gl_curr),
                jnp.asarray(maf)))
    t = torch.tensor
    joint = hmm.joint_geno_logprob(t(h), F).numpy()
    assert joint.shape == (B, 3, 3)
    # F = 1 has impossible cells: -inf on both sides
    np.testing.assert_array_equal(np.isinf(joint), np.isinf(j_joint))
    fin = np.isfinite(j_joint)
    np.testing.assert_allclose(joint[fin], j_joint[fin], rtol=0, atol=TOL)
    freq = hmm.hwe_genotype_logfreq(t(maf), float(F)).numpy()
    np.testing.assert_allclose(freq, j_freq, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        hmm.emission_hwe(t(gl_prev), t(maf), float(F)).numpy(), j_hwe,
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        hmm.emission_ld(t(h), t(gl_prev), t(gl_curr), t(maf), F).numpy(),
        j_ld, rtol=0, atol=TOL)


def test_hmm_keeps_the_input_dtype(case):
    """f32 in, f32 out, as the JAX default; within 1e-4 of f64."""
    q, alpha, em, dist = case
    ll32, fw32 = hmm.forward(torch.tensor(q, dtype=torch.float32), alpha,
                             torch.tensor(em, dtype=torch.float32),
                             torch.tensor(dist, dtype=torch.float32))
    ll64, _ = hmm.forward(torch.tensor(q), alpha, torch.tensor(em),
                          torch.tensor(dist))
    assert ll32.dtype == fw32.dtype == torch.float32
    np.testing.assert_allclose(ll32.numpy(), ll64.numpy(), rtol=1e-4)


QUADRATIC = (lambda x: -((x[0] - 2) ** 2 + (x[1] + 1) ** 2), [0.0, 0.0],
             [-5.0, -5.0], [5.0, 5.0], [2.0, -1.0])
BOUNDED = (lambda x: x[0], [0.0], [-1.0], [1.0], [1.0])


@pytest.mark.parametrize("fn,x0,lo,hi,x_opt", [QUADRATIC, BOUNDED],
                         ids=["quadratic", "bounded"])
def test_findmax_is_the_jax_packages(fn, x0, lo, hi, x_opt):
    x, f, ok = findmax(fn, x0, lower=lo, upper=hi)
    jx, jf, jok = j_findmax(fn, x0, lower=lo, upper=hi)
    np.testing.assert_array_equal(x, jx)
    assert f == jf and ok == jok
    np.testing.assert_allclose(x, x_opt, atol=1e-4)


@pytest.mark.parametrize("fn,x0,lo,hi,x_opt", [QUADRATIC, BOUNDED],
                         ids=["quadratic", "bounded"])
def test_findmax_torch_matches_findmax_jax(fn, x0, lo, hi, x_opt):
    jx, jf, jok = findmax_jax(fn, jnp.asarray(x0), lower=jnp.asarray(lo),
                              upper=jnp.asarray(hi))
    x, f, ok = findmax_torch(fn, torch.tensor(x0), lower=torch.tensor(lo),
                             upper=torch.tensor(hi))
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert ok and bool(jok)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=OPT_TOL)
    np.testing.assert_allclose(x.numpy(), x_opt, atol=OPT_TOL)
    assert float(f) == pytest.approx(float(jf), abs=OPT_TOL)


def test_findmax_torch_unbounded_f64():
    x, f, ok = findmax_torch(QUADRATIC[0], torch.zeros(2, dtype=torch.float64))
    assert ok and x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), [2.0, -1.0], atol=1e-8)
    assert float(f) == pytest.approx(0.0, abs=1e-12)
