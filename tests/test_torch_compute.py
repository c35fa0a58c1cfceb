"""The port's block step (compute.compute_block), on tables uploaded as
the engine uploads them (torch.from_numpy(...).to(device, dtype)), vs
the JAX package's _compute_block_fn(use_pallas=False, n_shards=1) on the
same tables and index, in f64: fmat at 1e-12, imat exact, for both
_imat layouts (--ignore_miss_data off: (P, 1) int8; on: (P, 2) int16)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.compute import _compute_block_fn
from ngsld_tpu.ops.preprocess import preprocess
from ngsld_tpu.utils.simulate import simulate
from ngsld_tpu_torch.compute import compute_block


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_compute_block_matches_jax(ignore_miss):
    n_sites, n_ind, P = 300, 12, 700
    sim = simulate(n_ind=n_ind, n_sites=n_sites, seed=19,
                   all_missing_site_rate=0.03, mono_rate=0.05)
    with np.errstate(divide="ignore"):
        gl_log = np.log(sim.gl / sim.gl.sum(axis=2, keepdims=True))
    # the JAX package's preprocess outputs are the tables both sides use
    gn, maf, eg = (np.array(a) for a in preprocess(
        jnp.asarray(gl_log), False, 0.0, 0.0, ignore_miss))
    rng = np.random.default_rng(4)
    s1 = rng.integers(0, n_sites - 1, P)
    s2 = np.minimum(s1 + rng.integers(1, 40, P), n_sites - 1)
    sidx = np.stack([s1, s2]).astype(np.int32)

    fm_j, im_j = _compute_block_fn(ignore_miss, False, 1)(
        jnp.asarray(gn), jnp.asarray(eg), jnp.asarray(maf),
        jnp.asarray(sidx))
    gn_t, eg_t, maf_t = (torch.from_numpy(a).to("cpu", torch.float64)
                         for a in (gn, eg, maf))
    fm_t, im_t = compute_block(gn_t, eg_t, maf_t, torch.from_numpy(sidx),
                               ignore_miss)

    fm_j, im_j = np.asarray(fm_j), np.asarray(im_j)
    fm_t, im_t = fm_t.numpy(), im_t.numpy()
    assert fm_t.shape == fm_j.shape == (P, 5) and fm_t.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(fm_t), np.isnan(fm_j))
    ok = ~np.isnan(fm_t)
    np.testing.assert_allclose(fm_t[ok], fm_j[ok], rtol=0, atol=1e-12)
    assert im_t.dtype == im_j.dtype
    assert im_t.shape == im_j.shape == ((P, 2) if ignore_miss else (P, 1))
    np.testing.assert_array_equal(im_t, im_j)
    if ignore_miss:
        assert (im_t[:, 1] < n_ind).any()   # some pairs excluded inds

