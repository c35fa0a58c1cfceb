"""The port's graft entry points (ngsld_tpu_torch/graft_entry.py) against
the JAX package's (__graft_entry__.py), on the CPU (NGSLD_PLATFORM=cpu;
the kernels' plain versions): entry()'s step against the JAX step on the
same example block, under the reference's contract; dryrun_multichip over
2 and 4 gloo ranks, rank 0's sweep step and ring sweep against the JAX
sweep_step and ring_sweep on one-device meshes, with the same inputs; a
rank that raises fails the call; without a card and without the CPU asked
for, both refuse."""

import os
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as graft
from ngsld_tpu.parallel.mesh import make_mesh
from ngsld_tpu.parallel.ring import partner_index
from ngsld_tpu.parallel.ring import ring_sweep as jax_ring_sweep
from ngsld_tpu.parallel.sweep import sweep_step as jax_sweep_step
from ngsld_tpu_torch import graft_entry
from ngsld_tpu_torch.strict import StrictError


@pytest.fixture(autouse=True)
def cpu_two_threads(monkeypatch):
    # the port runs on the card unless the caller asks for the CPU; the
    # ranks share the caller's threads, capped as in the heavy port files;
    # a rank that dies cannot keep the others waiting past 120 s
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    monkeypatch.setenv("NGSLD_DIST_TIMEOUT", "120")
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(cols):
    return [np.asarray(c) for c in cols]


def _hold(jax_cols, port_cols):
    """(r2p, f, n_iter, n_used, hmaf0, hmaf1, D, Dp, r2, chi2) of the port
    against the JAX function's: the reference's contract (hap freqs 3e-5,
    n_used exact, nIter within 1 on more than 95% of pairs, r2p 2e-5);
    the derived columns under utils/conformance.cmp_vs_strict's f32
    tolerances (2e-3; D' and r2 2e-3 + 6e-6/den and chi2 unchecked where
    the hap-MAF denominator den is below 1e-3). Neither side repairs such
    fragile pairs (the engine's refine tiers do), and their f32 hap MAFs
    can round to 0 on one side only: there D' and r2 are held where both
    are finite."""
    r2p_j, f_j, it_j, nu_j, *der_j = _np(jax_cols)
    r2p_t, f_t, it_t, nu_t, *der_t = _np(port_cols)
    f_j, f_t = f_j.reshape(-1, 4), f_t.reshape(-1, 4)
    np.testing.assert_allclose(f_t, f_j, atol=3e-5)
    np.testing.assert_array_equal(nu_t.ravel(), nu_j.ravel())
    close = np.abs(it_t.ravel().astype(np.int64)
                   - it_j.ravel().astype(np.int64)) <= 1
    assert close.mean() > 0.95, close.mean()
    np.testing.assert_allclose(r2p_t.ravel(), r2p_j.ravel(), atol=2e-5)
    m0, m1 = 1 - (f_j[:, 0] + f_j[:, 1]), 1 - (f_j[:, 0] + f_j[:, 2])
    den = np.min(np.abs([m0 * m1, (1 - m0) * (1 - m1), m0 * (1 - m1),
                         (1 - m0) * m1]), axis=0)
    fragile = den < 1e-3
    for k, (a, b) in enumerate(zip(der_j, der_t)):
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        tol = np.full(a.shape, 2e-3)
        if k in (3, 4):      # D', r2
            tol[fragile] += 6e-6 / np.maximum(den[fragile], 1e-12)
        same = np.isfinite(a) == np.isfinite(b)
        assert (same | (fragile if k >= 3 else False)).all(), k
        both = np.isfinite(a) & np.isfinite(b) & (~fragile if k == 5
                                                  else True)
        assert (np.abs(a[both] - b[both]) <= tol[both]).all(), k


def test_entry_step_matches_jax():
    """entry()'s example block is the JAX one bit for bit, and its step
    (the gather kernel's plain version, hostcols' derive) holds against
    the JAX step under the reference's contract."""
    step, args = graft_entry.entry()
    assert all(a.device.type == "cpu" and a.dtype == torch.float32
               for a in args)
    with jax.enable_x64(False):
        jstep, jargs = graft.entry()
        for a, b in zip(jargs, args):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jout = jax.jit(jstep)(*jargs)
    out = step(*args)
    assert len(out) == 10 and out[1].shape == (256, 4)
    assert out[1].dtype == torch.float32
    _hold(jout, [o.numpy() for o in out])
    # f64 tables on an explicit device: the same pairs, the same contract
    step64, _ = graft_entry.entry(device="cpu")
    out64 = step64(*(a.double() for a in args))
    assert out64[1].dtype == torch.float64
    _hold(jout, [o.numpy() for o in out64])


def _ring_inputs(n):
    rng = np.random.default_rng(2)
    gl = rng.dirichlet([2.0, 1.0, 1.0], size=(4 * n, 8)).astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    return gl, eg, (eg.mean(axis=1) / 2).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_jax(n, capfd):
    """Every check of the JAX dry run passes on n gloo CPU ranks; rank 0's
    sweep step (P = 8 a 'pairs' row, I = 8 an 'ind' rank) and ring sweep
    (S = 4n, B = 4, 2 steps) hold against the JAX functions on one-device
    meshes under the reference's contract."""
    out = graft_entry.dryrun_multichip(n)
    assert "DRYRUN_OK" in capfd.readouterr().out
    pairs = n // 2
    assert out["layout"] == (pairs, 2) and out["backend"] == "gloo"
    assert len(out["launches"]) == n
    assert out["strip_chunk"].shape == out["strip_ind_chunk"].shape \
        == (256, 5)
    S, B = 4 * n, 4
    assert out["stepper_counts"][0] == [B * (B - 1) // 2, B * B]
    with jax.enable_x64(False):
        jout = jax_sweep_step(make_mesh(1, 1, devices=jax.devices()[:1]))(
            *graft._example_block(8 * pairs, 16, seed=1))
        gl, eg, maf = _ring_inputs(n)
        rj = jax_ring_sweep(Mesh(np.array(jax.devices()[:1]), ("sites",)),
                            n_steps=2)(gl, eg, maf)
        rj = {k: np.asarray(v) for k, v in rj.items()}
    _hold(jout, [out["sweep_step"][k] for k in graft_entry.STAT_KEYS])
    # out["ring_sweep"][k][t, a, o] is the pair (a, partner_index(t, a,
    # B, S)[o]); on one device every partner is in the one block
    rp = out["ring_sweep"]
    pj = np.stack([np.stack([partner_index(t, a, B, S) for a in range(S)])
                   for t in range(2)])
    t_, a_ = np.arange(2)[:, None, None], np.arange(S)[None, :, None]
    cols = ("r2p", "f", "n_iter", "n_used", "hmaf1", "hmaf2", "D", "Dp",
            "r2", "chi2")
    _hold([rj[k][t_, a_, pj] for k in cols], [rp[k] for k in cols])


@pytest.fixture(scope="module")
def helper_module(tmp_path_factory):
    """A module the spawned ranks can import: `failing` raises on rank 1
    before its first check."""
    d = tmp_path_factory.mktemp("graft_helper")
    (d / "ngsld_graft_helper.py").write_text(textwrap.dedent("""
        from ngsld_tpu_torch import graft_entry


        def failing(rank, world, port, job):
            def dies(m, n):
                raise RuntimeError("rank %d fails its check" % m.rank)
            graft_entry._dryrun = dies
            graft_entry._dryrun_rank(rank, world, port, job)
        """))
    return str(d)


def test_dryrun_rank_failure_fails_the_call(helper_module, monkeypatch,
                                           capfd):
    """A rank that raises makes dryrun_multichip raise, naming it, within
    the collectives' timeout, and DRYRUN_OK is not printed."""
    import time
    monkeypatch.syspath_prepend(helper_module)
    monkeypatch.setenv("PYTHONPATH", helper_module + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    import ngsld_graft_helper
    monkeypatch.setattr(graft_entry, "_dryrun_rank",
                        ngsld_graft_helper.failing)
    t0 = time.monotonic()
    with pytest.raises(StrictError, match="rank 1 failed: RuntimeError: "
                       "rank 1 fails its check"):
        graft_entry.dryrun_multichip(2)
    assert time.monotonic() - t0 < 120
    assert "DRYRUN_OK" not in capfd.readouterr().out


def test_entry_and_dryrun_refuse_the_cpu_unless_asked(monkeypatch):
    """Without a CUDA device and without NGSLD_PLATFORM=cpu both entry
    points refuse with the engine's StrictError, and start no rank."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would run")
    monkeypatch.delenv("NGSLD_PLATFORM")
    with pytest.raises(StrictError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(StrictError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
