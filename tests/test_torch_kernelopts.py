"""The kernel options of the port against the JAX package's, on the CPU:
pair_em_gather's iteration cap, warm start and eps export (pallas_em.
_em_kernel's), pair_em_phased (pallas_em.pair_em_phased), strip_em's
want_eps (pallas_strip._strip_kernel's) and strip_em_twophase
(dev/strip_twophase.py); the rows and ichunk rungs' cap is held against
the JAX kernels in tests/test_torch_largecohort.py, its launch here. The JAX side runs its Pallas kernels in
interpret mode; the port's wrappers take their plain versions on CPU
tensors. The kernels themselves are held against those plain versions in
the `gpu`-marked cases and by chip_smoke.py phase 11 on the card.

Contract against the JAX package (its f32 EM against the port's f64 one):
n_used exact, f within 3e-5, nIter within +/-1 on more than 95% of the
pairs (5e-5 on the survivors of the two-phase strip sweep, the bound of
dev/strip_twophase.py's own check). Within the port: a capped run resumed warm is the
one-phase run bit for bit."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.kernels import pallas_em as jem
from ngsld_tpu.kernels import pallas_strip as jstrip
from ngsld_tpu.ops.preprocess import expected_geno
from ngsld_tpu.utils.simulate import simulate
from ngsld_tpu_torch.constants import EPSILON, ITER_MAX
from ngsld_tpu_torch.kernels import pair_em as kmod
from ngsld_tpu_torch.kernels import strip_em as tstrip
from ngsld_tpu_torch.kernels.strip_twophase import strip_em_twophase
from ngsld_tpu_torch.plan.strips import TA, TB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def few_threads():
    # the plain versions run many small tensor ops: more threads only
    # fight the other test workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _nan_equal(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    nan = np.isnan(a)
    np.testing.assert_array_equal(np.where(nan, 0, a), np.where(nan, 0, b))


def _near(a, b, tol):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    nan = np.isnan(a)
    np.testing.assert_allclose(np.where(nan, 0, a), np.where(nan, 0, b),
                               atol=tol, rtol=0)


# ------------------------------------------------- the gather options

def _case(n_pairs, n_ind, seed, miss=True):
    """tests/test_pallas_em.py::_case: two (P, I, 3) f32 sides and their
    MAFs."""
    sim = simulate(n_ind=n_ind, n_sites=2 * n_pairs, seed=seed,
                   all_missing_site_rate=0.02 if miss else 0.0)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    gn1 = gl[:n_pairs].astype(np.float32)
    gn2 = gl[n_pairs:2 * n_pairs].astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = (eg.mean(axis=1) / 2).astype(np.float32)
    return gn1, gn2, maf[:n_pairs], maf[n_pairs:2 * n_pairs]


def _stacked(gn1, gn2, m1, m2):
    """The same pairs as (gn, sidx, maf): both sides' rows stacked, pair p
    = (p, P + p)."""
    P = len(gn1)
    gn = torch.from_numpy(np.concatenate([gn1, gn2]))
    sidx = torch.from_numpy(np.stack([np.arange(P), P + np.arange(P)])
                            .astype(np.int32))
    return gn, sidx, torch.from_numpy(np.concatenate([m1, m2]))


def _with_x0(gn1, gn2):
    """Make pair 0 all-missing on one side (n_used 0 under ignore_miss)."""
    gn1 = gn1.copy()
    gn1[0] = 1.0 / 3.0
    return gn1, gn2


@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("ignore_miss", [False, True])
def test_capped_plain_twin_matches_jax_capped_kernel(ignore_miss, cap):
    """pair_em_gather(iter_cap=cap, want_eps=True) on CPU tensors against
    the JAX kernel's capped launch (pallas_em._phase1, interpret mode):
    n_used exact, f within 3e-5, nIter within +/-1 on more than 95%, and
    where both stopped at the same iteration the eps within the same
    3e-5."""
    gn1, gn2, m1, m2 = _case(130, 24, seed=5 + cap)
    gn1, gn2 = _with_x0(gn1, gn2)
    gn, sidx, maf = _stacked(gn1, gn2, m1, m2)
    f, it, nu, eps = (t.numpy() for t in kmod.pair_em_gather(
        gn, sidx, maf, ignore_miss, iter_cap=cap, want_eps=True))
    assert f.dtype == np.float64 and eps.shape == (130, 2)
    jf, jnu, meta = (np.asarray(x) for x in jem._phase1(
        *map(jnp.asarray, (gn1, gn2, m1, m2)), ignore_miss, 128, True, cap))
    jit = meta[:, 0].astype(np.int32)
    np.testing.assert_array_equal(nu, jnu)
    _near(f, jf, 3e-5)
    assert (np.abs(it - jit) <= 1).mean() > 0.95
    assert (it == cap).sum() > 10 and it.max() == cap
    same = it == jit
    _near(eps[same], meta[same, 1:], 3e-5)
    if ignore_miss:
        # the all-missing pair: frozen at iteration 0, NaN f, eps_last 0
        assert nu[0] == 0 and it[0] == 0 and np.isnan(f[0]).all()
        assert eps[0, 0] == 0 and meta[0, 1] == 0


@pytest.mark.parametrize("cap", [1, 8, 16, 99])
@pytest.mark.parametrize("ignore_miss", [False, True])
def test_resume_is_the_one_phase_run_bit_for_bit(ignore_miss, cap):
    """A launch capped at cap, then the pairs still running at the cap
    resumed from its f64 state (f0) with the cap ITER_MAX - cap: f (in the
    table dtype), nIter and n_used equal the one-phase launch's bit for
    bit, the all-missing pair included. The eps of the capped launch keep
    their semantics."""
    gn1, gn2, m1, m2 = _case(120, 16, seed=31)
    gn, sidx, maf = _stacked(*_with_x0(gn1, gn2), m1, m2)
    one = [t.numpy() for t in kmod.pair_em_gather(gn, sidx, maf,
                                                  ignore_miss)]
    f1, it1, nu1, eps = kmod.pair_em_gather(gn, sidx, maf, ignore_miss,
                                            iter_cap=cap, want_eps=True)
    un = torch.nonzero(it1 == cap).squeeze(1)
    assert len(un) > 0
    f2, it2, nu2 = kmod.pair_em_gather(gn, sidx[:, un], maf, ignore_miss,
                                       iter_cap=ITER_MAX - cap,
                                       f0=f1[un])
    np.testing.assert_array_equal(nu2.numpy(), nu1[un].numpy())
    f = f1.index_copy(0, un, f2).to(gn.dtype).numpy()
    it = it1.index_copy(0, un, cap + it2).numpy()
    _nan_equal(f, one[0])
    np.testing.assert_array_equal(it, one[1])
    np.testing.assert_array_equal(nu1.numpy(), one[2])
    it1, eps = it1.numpy(), eps.numpy()
    conv = it1 < cap
    # stopped at iteration n >= 1: the last eps below EPSILON, the one
    # before not; at the cap the last one not below EPSILON
    late = conv & (it1 >= 1)
    assert (eps[late, 0] < EPSILON).all() and (eps[late, 1] >= EPSILON).all()
    assert (eps[conv & (it1 == 0), 1] == 1.0).all()
    assert (eps[~conv, 0] >= EPSILON).all()
    if ignore_miss:
        assert one[2][0] == 0 and one[1][0] == 0 and eps[0, 0] == 0
        assert np.isnan(f[0]).all()


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_phased_equals_gather_and_jax_phased(ignore_miss):
    """pair_em_phased on the shapes of tests/test_pallas_em.py:
    test_phased_matches_single_pass (200 pairs x 16, cap1 8): bit-equal to
    pair_em_gather, and within the contract of the JAX package's
    pair_em_phased in interpret mode."""
    gn1, gn2, m1, m2 = _case(200, 16, seed=77)
    gn, sidx, maf = _stacked(gn1, gn2, m1, m2)
    f, it, nu = kmod.pair_em_phased(gn, sidx, maf, ignore_miss, cap1=8)
    assert isinstance(f, np.ndarray) and f.dtype == np.float32
    one = [t.numpy() for t in kmod.pair_em_gather(gn, sidx, maf,
                                                  ignore_miss)]
    _nan_equal(f, one[0])
    np.testing.assert_array_equal(it, one[1])
    np.testing.assert_array_equal(nu, one[2])
    assert (it >= 8).sum() > 20
    jf, jit, jnu = jem.pair_em_phased(
        *map(jnp.asarray, (gn1, gn2, m1, m2)), ignore_miss, cap1=8,
        pair_tile=128, interpret=True, bucket=128)
    np.testing.assert_array_equal(nu, jnu)
    _near(f, jf, 3e-5)
    assert (np.abs(it - jit) <= 1).mean() > 0.95


@pytest.mark.parametrize("order", ["easiest_first", "shuffled"])
def test_phase2_order_does_not_change_a_bit(monkeypatch, order):
    gn1, gn2, m1, m2 = _case(150, 12, seed=9)
    gn, sidx, maf = _stacked(*_with_x0(gn1, gn2), m1, m2)
    hardest = kmod.pair_em_phased(gn, sidx, maf, True, cap1=4)
    real = kmod.phase2_order
    if order == "easiest_first":
        other = lambda e, ep: real(e, ep).flip(0)  # noqa: E731
    else:
        gen = torch.Generator().manual_seed(1)
        other = lambda e, ep: torch.randperm(len(e), generator=gen)  # noqa
    monkeypatch.setattr(kmod, "phase2_order", other)
    got = kmod.pair_em_phased(gn, sidx, maf, True, cap1=4)
    for a, b in zip(got, hardest):
        _nan_equal(a, b) if a.dtype.kind == "f" else \
            np.testing.assert_array_equal(a, b)


def test_phase2_order_is_hardest_first():
    # contraction 0.5 from 1e-3 needs ~7 more iterations, 0.9 from 1e-3
    # ~44, 0.5 from 1e-4 ~3, a non-finite estimate (NaN eps) counts as
    # ITER_MAX
    eps = torch.tensor([1e-3, 1e-3, 1e-4, float("nan")], dtype=torch.float64)
    eps_prev = torch.tensor([2e-3, 1.111e-3, 2e-4, 1.0], dtype=torch.float64)
    assert kmod.phase2_order(eps, eps_prev).tolist() == [3, 1, 0, 2]


def test_options_on_other_rungs_raise():
    """The rows and ichunk rungs take the cap alone (as their JAX wrappers
    do): a warm or eps call that lands there raises, naming the rung, on
    any device, and so does a cap below 1."""
    gn, sidx, maf = _stacked(*_case(8, 6, seed=2))
    f0 = torch.full((8, 4), 0.25, dtype=torch.float64)
    for fn, name in ((kmod.pair_em_rows, "pair_em_rows"),
                     (kmod.pair_em_ichunk, "pair_em_ichunk")):
        for kw in (dict(f0=f0), dict(want_eps=True)):
            with pytest.raises(TypeError, match=name):
                fn(gn, sidx, maf, False, **kw)
        with pytest.raises(ValueError, match="iter_cap"):
            fn(gn, sidx, maf, False, iter_cap=0)
    # the gather rung's own checks
    with pytest.raises(ValueError, match="iter_cap"):
        kmod.pair_em_gather(gn, sidx, maf, False, iter_cap=0)
    with pytest.raises(ValueError, match="f0"):
        kmod.pair_em_gather(gn, sidx, maf, False, f0=f0.float())
    with pytest.raises(ValueError, match="cap1"):
        kmod.pair_em_phased(gn, sidx, maf, False, cap1=ITER_MAX)


def test_option_launch_arguments(monkeypatch):
    """On the card path: the launch without options keeps its entry point
    and arguments; with one, the option entry point gets the cap, f0's
    and eps' pointers (null when absent) and the head, and f is f64."""
    calls = []

    def launch(lib_name, fn_stem, gn, sidx, maf, ign, pre=(), post=(),
               f_dtype=None):
        calls.append((fn_stem, pre, post, f_dtype))
        return kmod._empty(gn, sidx, f_dtype)

    monkeypatch.setattr(kmod, "_device_kind", lambda gn, name: "cuda")
    monkeypatch.setattr(kmod, "_launch", launch)
    gn, sidx, maf = _stacked(*_case(8, 100, seed=2))
    g = kmod.gather_group(100)
    pre = (g, kmod.gather_slot(100, g))
    n0 = kmod.LAUNCHES
    kmod.pair_em_gather(gn, sidx, maf, False)
    assert calls[-1][:2] == ("ngsld_pair_em", pre) \
        and len(calls[-1][2]) == 1 and calls[-1][3] is None
    f0 = torch.full((8, 4), 0.25, dtype=torch.float64)
    out = kmod.pair_em_gather(gn, sidx, maf, False, iter_cap=16, f0=f0,
                              want_eps=True)
    stem, pre2, post, f_dtype = calls[-1]
    assert (stem, pre2, f_dtype) == ("ngsld_pair_em_opts", pre,
                                     torch.float64)
    assert post[0] == 16 and post[1] == f0.data_ptr() \
        and post[2] == out[3].data_ptr() and len(post) == 4
    kmod.pair_em_gather(gn, sidx, maf, False, iter_cap=16)
    assert calls[-1][2][1:3] == (None, None)
    assert out[0].dtype == torch.float64 and out[3].shape == (8, 2)
    assert kmod.LAUNCHES == n0 + 3


@pytest.mark.parametrize("rung", ["rows", "cluster", "stream"])
def test_cap_launch_arguments(monkeypatch, rung):
    """On the card path: the launch without a cap (or at ITER_MAX) keeps
    its entry point and arguments; with one, the capped entry point gets
    the cap after ignore_miss, f stays in the table dtype, and the capped
    launches are counted apart."""
    calls = []

    def launch(lib_name, fn_stem, gn, sidx, maf, ign, pre=(), post=(),
               f_dtype=None):
        calls.append((lib_name, fn_stem, pre, post, f_dtype))
        return kmod._empty(gn, sidx, f_dtype)

    monkeypatch.setattr(kmod, "_device_kind", lambda gn, name: "cuda")
    monkeypatch.setattr(kmod, "_launch", launch)
    monkeypatch.setattr(kmod, "_cluster_fits", lambda *a: None)
    gn, sidx, maf = _stacked(*_case(8, 100, seed=2))
    fn, stem, pre, count = {
        "rows": (kmod.pair_em_rows, "ngsld_pair_em_rows",
                 (kmod.rows_threads(100),), "LAUNCHES_ROWS_CAP"),
        "cluster": (kmod.pair_em_ichunk, "ngsld_pair_em_cluster",
                    (kmod.ichunk_cluster(100),
                     kmod.cluster_threads(100, kmod.ichunk_cluster(100))),
                    "LAUNCHES_ICHUNK_CAP"),
        "stream": (lambda *a, **k: kmod._pair_em_ichunk_stream(
            *a, i_chunk=16, **k), "ngsld_pair_em_ichunk", (16,),
            "LAUNCHES_ICHUNK_CAP")}[rung]
    n0 = getattr(kmod, count)
    fn(gn, sidx, maf, False)
    fn(gn, sidx, maf, False, iter_cap=ITER_MAX)
    assert calls == [(calls[0][0], stem, pre, (), None)] * 2
    out = fn(gn, sidx, maf, False, iter_cap=16)
    assert calls[-1][1:] == (stem + "_cap", pre, (16,), None)
    assert out[0].dtype == gn.dtype
    assert getattr(kmod, count) == n0 + 1


# -------------------------------------------------- the strip options

def _strip_fixture(S, I, seed, W):
    """tests/test_pallas_strip.py::_tables' inputs, for both packages:
    (JAX args, port args, live (n, TA, TB))."""
    sim = simulate(n_ind=I, n_sites=S, seed=seed)
    gl = (sim.gl / sim.gl.sum(axis=2, keepdims=True)).astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = (eg.mean(axis=1) / 2).astype(np.float32)
    Sp = -(-S // TA) * TA
    glp = np.pad(gl, ((0, Sp - S), (0, 0), (0, 0)),
                 constant_values=1.0 / 3.0)
    lo = np.arange(Sp, dtype=np.int32) + 1
    hi = np.minimum(np.arange(Sp) + W + 1, S).astype(np.int32)
    ok = (np.arange(Sp) < S).astype(np.float32)
    tiles = []
    for k in range(Sp // TA):
        hi_max = int(hi[k * TA:(k + 1) * TA].max())
        for j in range(k, max(k + 1, -(-hi_max // TB))):
            tiles.append((k, j))
    mafp = np.pad(maf, (0, Sp - S), constant_values=0.5)
    ta = np.array([t[0] for t in tiles], np.int32)
    tb = np.array([t[1] for t in tiles], np.int32)
    g = jnp.asarray(glp)
    jtabs = jax.jit(lambda g: jstrip.strip_tables(g, expected_geno(g), I))(g)
    m, okj = jnp.asarray(mafp), jnp.asarray(ok)
    j_args = (*jtabs, m, m, jnp.asarray(lo), jnp.asarray(hi), okj, okj,
              jnp.asarray(ta), jnp.asarray(tb))
    gt = torch.from_numpy(glp)
    ttabs = tstrip.strip_tables(gt, gt[..., 1] + 2 * gt[..., 2], I)
    mt, okt = torch.from_numpy(mafp), torch.from_numpy(ok)
    t_args = (*ttabs, mt, mt, torch.from_numpy(lo), torch.from_numpy(hi),
              okt, okt, torch.from_numpy(ta), torch.from_numpy(tb))
    A = ta.astype(np.int64)[:, None, None] * TA + np.arange(TA)[None, :, None]
    B = tb.astype(np.int64)[:, None, None] * TB + np.arange(TB)[None, None, :]
    live = (B >= lo[A]) & (B < hi[A]) & (ok[A] > 0) & (ok[B] > 0)
    return j_args, t_args, live


def _eps_semantics(nit, epsl, epsp, live, cap):
    """The reference's eps contract (tests/test_pallas_strip.py:706-748)
    on every live cell, and dead cells at 1."""
    el, ep, nt = epsl[live], epsp[live], nit[live]
    conv = nt < cap
    which = conv & (nt >= 1) & (el != 1.0)
    assert which.sum() > 100
    assert (el[which] < EPSILON).all()
    un = el[~conv]
    assert (un[np.isfinite(un)] >= EPSILON).all()
    assert (epsl[~live] == 1.0).all() and (epsp[~live] == 1.0).all()
    return int((~conv).sum())


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_strip_want_eps_matches_jax(ignore_miss):
    """strip_em(want_eps=True) on CPU tensors (the resident kernel's plain
    version) against the JAX strip kernel's want_eps (interpret mode), on
    the fixture of tests/test_pallas_strip.py::
    test_strip_eps_export_semantics (256 sites x 6, band 80, cap 20): the
    export leaves the four outputs as they were; the eps semantics hold
    on every live cell on both sides; where nIter agree the eps agree
    within 3e-5."""
    cap = 20
    j_args, t_args, live = _strip_fixture(256, 6, seed=21, W=80)
    jo = [np.asarray(x) for x in jstrip.strip_em(
        *j_args, n_ind=6, iter_cap=cap, ignore_miss=ignore_miss,
        interpret=True, want_eps=True)]
    to = [t.numpy() for t in tstrip.strip_em(
        *t_args, n_ind=6, iter_cap=cap, ignore_miss=ignore_miss,
        want_eps=True)]
    plain = [t.numpy() for t in tstrip.strip_em(
        *t_args, n_ind=6, iter_cap=cap, ignore_miss=ignore_miss)]
    assert len(to) == 6 and len(plain) == 4
    for a, b in zip(to[:4], plain):
        _nan_equal(a, b)
    np.testing.assert_array_equal(to[3], jo[3])
    _near(to[0], jo[0], 3e-5)
    assert (np.abs(to[2][live] - jo[2][live]) <= 1).mean() > 0.95
    assert to[4].dtype == np.float32 and to[4].shape == to[2].shape
    for o in (to, jo):
        _eps_semantics(o[2], o[4], o[5], live, cap)
    same = live & (to[2] == jo[2])
    for k in (4, 5):
        _near(to[k][same], jo[k][same], 3e-5)


def test_want_eps_on_a_streamed_cohort_raises(monkeypatch):
    _, t_args, _ = _strip_fixture(256, 6, seed=21, W=80)
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "8")
    n0 = (tstrip.LAUNCHES, tstrip.LAUNCHES_STREAM)
    with pytest.raises(ValueError, match="streamed strip kernel .* exports "
                                         "no eps"):
        tstrip.strip_em(*t_args, n_ind=6, want_eps=True)
    assert (tstrip.LAUNCHES, tstrip.LAUNCHES_STREAM) == n0


def test_eps_export_shared_memory():
    """Two float planes of a block's cells: 2,048 bytes more, so the
    resident kernel's ceiling with the export sits lower, and a cohort
    past it is refused with both numbers, not sent elsewhere."""
    assert tstrip.strip_smem(100, want_eps=True) \
        == tstrip.strip_smem(100) + 2048
    limit = tstrip.smem_limits("cpu")[1]
    n = max(i for i in range(1, 400) if tstrip.strip_smem(i) <= limit)
    assert tstrip.strip_smem(n, want_eps=True) > limit
    sim = simulate(n_ind=n, n_sites=TA, seed=3)
    gl = torch.from_numpy((sim.gl / sim.gl.sum(axis=2, keepdims=True))
                          .astype(np.float32))
    tabs = tstrip.strip_tables(gl, gl[..., 1] + 2 * gl[..., 2], n)
    v = torch.full((TA,), 0.5)
    z = torch.zeros(1, dtype=torch.int32)
    args = (*tabs, v, v, torch.arange(1, TA + 1, dtype=torch.int32),
            torch.full((TA,), TA, dtype=torch.int32), v, v, z, z)
    need = tstrip.strip_smem(n, want_eps=True)
    with pytest.raises(ValueError, match=rf"{n} individuals with the eps "
                       rf"export needs {need} bytes.*allows {limit}"):
        tstrip.strip_em(*args, n_ind=n, iter_cap=1, want_eps=True)


def _dev_twophase():
    """dev/strip_twophase.py, loaded by path (it is no package module)."""
    spec = importlib.util.spec_from_file_location(
        "dev_strip_twophase", os.path.join(REPO, "dev", "strip_twophase.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sel(live):
    """The flat indices of the live cells, in (tile, anchor, partner)
    order."""
    return np.flatnonzero(live.reshape(-1)).astype(np.int32)


def test_strip_twophase_matches_dev_reference_and_one_phase():
    """strip_em_twophase on the fixture of dev/strip_twophase.py's parity
    check (384 sites x 8, band 120, seed 13, cap1 10): rows that stopped
    in phase A bit-equal to strip_em_compact's, survivors within 5e-5 and
    nIter within +/-1 on more than 95%; the same contract against
    dev/strip_twophase.py in interpret mode."""
    cap1 = 10
    j_args, t_args, live = _strip_fixture(384, 8, seed=13, W=120)
    sel = _sel(live)
    P = len(sel)
    one_fm, one_im = (t.numpy() for t in tstrip.strip_em_compact(
        *t_args, torch.from_numpy(sel), n_ind=8))
    fm, im, n_surv = strip_em_twophase(*t_args, torch.from_numpy(sel), P,
                                       n_ind=8, cap1=cap1, surv_cap=32768)
    fm, im = fm.numpy(), im.numpy()
    assert im.dtype == np.int16 and fm.shape == (P, 5)
    it1 = one_im[:, 0].astype(np.int32)
    conv = it1 < cap1
    assert n_surv == int((~conv).sum()) and n_surv > 1000
    _nan_equal(fm[conv], one_fm[conv])
    np.testing.assert_array_equal(im[conv], one_im[conv])
    np.testing.assert_array_equal(im[:, 1], one_im[:, 1])
    _near(fm[~conv], one_fm[~conv], 5e-5)
    assert (np.abs(im[~conv, 0] - it1[~conv]) <= 1).mean() > 0.95

    dev = _dev_twophase()
    jfm, jim, jn = (np.asarray(x) for x in dev.strip_em_twophase(
        *j_args, jnp.asarray(sel), jnp.int32(P), n_ind=8, interpret=True,
        cap1=cap1, surv_cap=32768, phase2_tile=256, phase2_unroll=5))
    jfm, jim = jfm[:P], jim[:P]
    assert abs(int(jn) - n_surv) <= 0.01 * n_surv
    np.testing.assert_array_equal(im[:, 1], jim[:, 1])
    _near(fm, jfm, 5e-5)
    assert (np.abs(im[:, 0] - jim[:, 0].astype(np.int32)) <= 1).mean() > 0.95


def test_strip_twophase_reports_an_overflow():
    """More survivors than surv_cap: n_surv says so, the first surv_cap
    survivors (in sel's order) finish, the rest keep phase A's state
    (nIter == cap1) for the caller to redo in one phase."""
    cap1 = 10
    _, t_args, live = _strip_fixture(256, 6, seed=21, W=80)
    sel = torch.from_numpy(_sel(live))
    fm, im, n_surv = strip_em_twophase(*t_args, sel, len(sel), n_ind=6,
                                       cap1=cap1, surv_cap=50)
    full_fm, full_im, n_full = strip_em_twophase(*t_args, sel, len(sel),
                                                 n_ind=6, cap1=cap1)
    assert n_surv == n_full > 50
    a_fm, a_im = tstrip.strip_em_compact(*t_args, sel, n_ind=6,
                                         iter_cap=cap1)
    surv = np.flatnonzero(a_im[:, 0].numpy() == cap1)
    done, left = surv[:50], surv[50:]
    _nan_equal(fm.numpy()[left], a_fm.numpy()[left])
    assert (im[left, 0].numpy() == cap1).all()
    _nan_equal(fm.numpy()[done], full_fm.numpy()[done])
    np.testing.assert_array_equal(im.numpy()[done], full_im.numpy()[done])


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_options_on_the_card(dtype):
    """The option instance against its plain version (nIter, n_used
    exact, f and eps to the EM's f64 rounding), and the phased run equal
    to the one-phase launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gn, sidx, maf = (t.cuda() for t in _stacked(*_case(500, 37, seed=4)))
    gn, maf = gn.to(dtype), maf.to(dtype)
    for ign in (False, True):
        kern = [t.cpu().numpy() for t in kmod.pair_em_gather(
            gn, sidx, maf, ign, iter_cap=16, want_eps=True)]
        plain = [t.cpu().numpy() for t in kmod.pair_em_gather_ref(
            gn, sidx, maf, ign, iter_cap=16, want_eps=True)]
        np.testing.assert_array_equal(kern[1], plain[1])
        np.testing.assert_array_equal(kern[2], plain[2])
        _near(kern[0], plain[0], 1e-12)
        _near(kern[3], plain[3], 1e-12)
        one = [t.cpu().numpy() for t in kmod.pair_em_gather(gn, sidx, maf,
                                                            ign)]
        for a, b in zip(kmod.pair_em_phased(gn, sidx, maf, ign), one):
            _nan_equal(a, b) if a.dtype.kind == "f" else \
                np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_and_ichunk_caps_on_the_card(dtype):
    """The capped instances of pair_em_rows.cu and both bodies of
    pair_em_ichunk.cu against their plain versions: nIter and n_used
    exact (capped pairs at the cap), f to the table dtype's rounding; the
    launch at ITER_MAX is the launch without a cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gn, sidx, maf = (t.cuda() for t in _stacked(*_case(300, 37, seed=4)))
    gn, maf = gn.to(dtype), maf.to(dtype)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    stream = lambda *a, **k: kmod._pair_em_ichunk_stream(  # noqa: E731
        *a, i_chunk=16, **k)
    for kern, plain in (
            (kmod.pair_em_rows, kmod.pair_em_rows_ref),
            (kmod.pair_em_ichunk, kmod.pair_em_ichunk_ref),
            (stream, lambda *a, **k: kmod.pair_em_ichunk_ref(
                *a, i_chunk=16, **k))):
        for ign in (False, True):
            for cap in (1, 16, ITER_MAX):
                k_out = [t.cpu().numpy() for t in kern(gn, sidx, maf, ign,
                                                       iter_cap=cap)]
                p_out = [t.cpu().numpy() for t in plain(gn, sidx, maf, ign,
                                                        iter_cap=cap)]
                np.testing.assert_array_equal(k_out[1], p_out[1])
                np.testing.assert_array_equal(k_out[2], p_out[2])
                assert k_out[1].max() <= cap
                _near(k_out[0], p_out[0], tol)
            one = [t.cpu().numpy() for t in kern(gn, sidx, maf, ign)]
            for a, b in zip(one, k_out):
                _nan_equal(a, b) if a.dtype.kind == "f" else \
                    np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_strip_eps_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, t_args, live = _strip_fixture(256, 6, seed=21, W=80)
    t_args = [t.cuda() for t in t_args]
    kern = [t.cpu().numpy() for t in tstrip.strip_em(
        *t_args, n_ind=6, iter_cap=20, want_eps=True)]
    without = [t.cpu().numpy() for t in tstrip.strip_em(
        *t_args, n_ind=6, iter_cap=20)]
    for a, b in zip(kern[:4], without):
        _nan_equal(a, b)
    plain = [t.cpu().numpy() for t in tstrip.strip_em_ref(
        *t_args, n_ind=6, iter_cap=20, want_eps=True)]
    for k in (4, 5):
        _near(kern[k], plain[k], 1e-6)
    _eps_semantics(kern[2], kern[4], kern[5], live, 20)
