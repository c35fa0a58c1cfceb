"""The port's large-cohort path on the CPU, held against the JAX package:
the plain versions of the three large-cohort kernels (pair_em_rows,
pair_em_ichunk, the streamed strip_em) against the Pallas kernels they
replace, run in interpret mode as tests/test_pallas_em.py and
tests/test_pallas_strip.py run them, on those files' cases; the routing
ladder; and the port's CLI with the streamed strip kernel forced.

Tolerances against the JAX package (its kernels run the EM in f32, the
port's in f64): n_used exact, hap freqs within 3e-5, nIter within 1 on more
than 95% of pairs (98% of cells for the strip), r2p within 2e-5. Between
two plain versions of the port (both f64, another summation order): nIter
exact, f within 1e-6. The rows and ichunk kernels' iteration cap: the JAX
kernels test it once every pallas_em._UNROLL iterations, so there a pair
still running at the cap runs on to the next multiple of _UNROLL; the
port's capped plain version is held against them through its own run to
that multiple (_hold_capped). The CUDA kernels themselves are compared with their
plain versions in the `gpu`-marked tests and by chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.cli import params_from_args as j_params_from_args
from ngsld_tpu.constants import ITER_MAX
from ngsld_tpu.engine import run_jax
from ngsld_tpu.kernels import pallas_em as jem
from ngsld_tpu.kernels import pallas_strip as jstrip
from ngsld_tpu.ops.em import pair_em as j_pair_em
from ngsld_tpu.ops.preprocess import expected_geno
from ngsld_tpu.utils.simulate import simulate, write_all
from ngsld_tpu_torch import compute
from ngsld_tpu_torch.cli import main, params_from_args
from ngsld_tpu_torch.engine import run_torch
from ngsld_tpu_torch.kernels import pair_em as kmod
from ngsld_tpu_torch.kernels import strip_em as tstrip
from ngsld_tpu_torch.kernels.build import NOMINAL_SMEM, smem_limits
from ngsld_tpu_torch.plan.strips import TA, TB
from ngsld_tpu_torch.strict import StrictError
from ngsld_tpu_torch.utils.conformance import cmp_vs_strict


@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    # the plain versions run many small tensor ops: more threads only
    # fight the other test workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ gathered EM

def _case(n_pairs, n_ind, seed):
    """tests/test_pallas_em.py::_case, plus the same pairs as the port
    takes them: one site table and a (2, P) index."""
    sim = simulate(n_ind=n_ind, n_sites=2 * n_pairs, seed=seed,
                   all_missing_site_rate=0.02)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    gn = gl[:2 * n_pairs].astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = (eg.mean(axis=1) / 2).astype(np.float32)[:2 * n_pairs]
    j_args = (jnp.asarray(gn[:n_pairs]), jnp.asarray(gn[n_pairs:]),
              jnp.asarray(maf[:n_pairs]), jnp.asarray(maf[n_pairs:]))
    sidx = np.stack([np.arange(n_pairs), n_pairs + np.arange(n_pairs)])
    t_args = (torch.from_numpy(gn), torch.from_numpy(sidx.astype(np.int32)),
              torch.from_numpy(maf))
    return j_args, t_args


def _hold_pairs(t_out, j_out, it_share=0.95):
    tf, tn, tu = (x.numpy() for x in t_out)
    jf, jn, ju = (np.asarray(x) for x in j_out)
    np.testing.assert_array_equal(tu, ju)
    both_nan = np.isnan(tf) & np.isnan(jf)
    np.testing.assert_allclose(np.where(both_nan, 0, tf),
                               np.where(both_nan, 0, jf), atol=3e-5, rtol=0)
    assert (np.abs(tn - jn) <= 1).mean() > it_share


def _hold_capped(t_out, j_out, t_c4, cap):
    """The port's plain version capped at `cap` (t_out) against the JAX
    kernel capped at `cap` (j_out), through t_c4, the port's plain version
    capped at c4 = cap rounded up to a multiple of pallas_em._UNROLL, where
    the JAX kernel's loop stops. The port: pairs that stopped before the cap
    are the c4 run's bit for bit, the others stop at the cap with f there.
    The JAX kernel: the c4 run under the contract, a pair still running at
    c4 keeping n_iter == cap as the kernel reports it."""
    c4 = -(-cap // jem._UNROLL) * jem._UNROLL
    tf, tn, tu = (x.numpy() for x in t_out)
    cf, cn, cu = (x.numpy() for x in t_c4)
    np.testing.assert_array_equal(tu, cu)
    before = cn < cap
    np.testing.assert_array_equal(tn, np.where(before, cn, cap))
    np.testing.assert_array_equal(np.isnan(tf[before]), np.isnan(cf[before]))
    np.testing.assert_array_equal(np.nan_to_num(tf[before]),
                                  np.nan_to_num(cf[before]))
    mapped = np.where(cn == c4, cap, cn).astype(np.int32)
    _hold_pairs((torch.from_numpy(cf), torch.from_numpy(mapped),
                 torch.from_numpy(cu)), j_out)


_ROWS_CASES = [pytest.param(40, 12, ITER_MAX, id="40-12"),
               pytest.param(16, 300, ITER_MAX, id="16-300")] + [
    pytest.param(40, 12, cap, id=f"40-12-cap{cap}") for cap in (1, 16, 99)]


@pytest.mark.parametrize("ignore_miss", [False, True])
@pytest.mark.parametrize("n_pairs,n_ind,cap", _ROWS_CASES)
def test_pair_em_rows_ref_vs_jax_rows_kernel(n_pairs, n_ind, cap,
                                             ignore_miss):
    j_args, t_args = _case(n_pairs, n_ind, seed=7 * n_pairs + n_ind)
    t_out = kmod.pair_em_rows_ref(*t_args, ignore_miss, iter_cap=cap)
    assert t_out[0].dtype == torch.float32 and t_out[1].dtype == torch.int32
    j_out = jem.pair_em_rows_from_gl(*j_args, ignore_miss, pair_tile=8,
                                     interpret=True, iter_cap=cap)
    if cap == ITER_MAX:
        _hold_pairs(t_out, j_out)
        _hold_pairs(t_out, j_pair_em(*j_args, ignore_miss))
    else:
        c4 = -(-cap // jem._UNROLL) * jem._UNROLL
        _hold_capped(t_out, j_out, kmod.pair_em_rows_ref(
            *t_args, ignore_miss, iter_cap=c4), cap)
    # CPU tensors: the wrapper is its plain version, and launches nothing
    n0 = kmod.LAUNCHES_ROWS
    for a, b in zip(kmod.pair_em_rows(*t_args, ignore_miss, iter_cap=cap),
                    t_out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kmod.LAUNCHES_ROWS == n0


_ICHUNK_CASES = [pytest.param(24, 40, 16, ITER_MAX, id="24-40-16"),
                 pytest.param(60, 100, 32, ITER_MAX, id="60-100-32")] + [
    pytest.param(24, 40, 16, cap, id=f"24-40-16-cap{cap}")
    for cap in (1, 16, 99)]


@pytest.mark.parametrize("ignore_miss", [False, True])
@pytest.mark.parametrize("n_pairs,n_ind,ic,cap", _ICHUNK_CASES)
def test_pair_em_ichunk_ref_vs_jax_ichunk_kernel(n_pairs, n_ind, ic, cap,
                                                 ignore_miss):
    """Cohorts that span several chunks, the last one partial."""
    j_args, t_args = _case(n_pairs, n_ind, seed=7 * n_pairs + n_ind)
    assert n_ind % ic
    t_out = kmod.pair_em_ichunk_ref(*t_args, ignore_miss, i_chunk=ic,
                                    iter_cap=cap)
    j_out = jem.pair_em_ichunk(*j_args, ignore_miss, pair_tile=8,
                               i_chunk=ic, interpret=True, iter_cap=cap)
    if cap == ITER_MAX:
        _hold_pairs(t_out, j_out)
        _hold_pairs(t_out, j_pair_em(*j_args, ignore_miss))
    else:
        c4 = -(-cap // jem._UNROLL) * jem._UNROLL
        _hold_capped(t_out, j_out, kmod.pair_em_ichunk_ref(
            *t_args, ignore_miss, i_chunk=ic, iter_cap=c4), cap)
    n0 = kmod.LAUNCHES_ICHUNK
    for a, b in zip(kmod.pair_em_ichunk(*t_args, ignore_miss, i_chunk=ic,
                                        iter_cap=cap), t_out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kmod.LAUNCHES_ICHUNK == n0


def test_pair_em_ichunk_ref_matches_the_other_rungs():
    """tests/test_pallas_em.py:144: chunked accumulation differs from the
    whole-row sum only by the order of the partial sums. In the port all
    three plain versions run in f64, so nIter agrees on every pair and f to
    f32 rounding; the JAX streamed kernel stays within its own bounds."""
    j_args, t_args = _case(32, 48, seed=99)
    whole = kmod.pair_em_gather_ref(*t_args, False)
    rows = kmod.pair_em_rows_ref(*t_args, False)
    chunked = kmod.pair_em_ichunk_ref(*t_args, False, i_chunk=16)
    for other in (rows, chunked):
        np.testing.assert_array_equal(other[1].numpy(), whole[1].numpy())
        np.testing.assert_array_equal(other[2].numpy(), whole[2].numpy())
        np.testing.assert_allclose(other[0].numpy(), whole[0].numpy(),
                                   atol=1e-6, rtol=0)
    jf, jn, _ = jem.pair_em_ichunk(*j_args, False, pair_tile=8, i_chunk=16,
                                   interpret=True)
    np.testing.assert_allclose(chunked[0].numpy(), np.asarray(jf), atol=2e-5,
                               rtol=0)
    assert (np.abs(chunked[1].numpy() - np.asarray(jn)) <= 1).all()
    with pytest.raises(ValueError, match="i_chunk must be positive"):
        kmod.pair_em_ichunk(*t_args, False, i_chunk=0)


# ------------------------------------------------------------- the ladder

def test_pick_gather_kernel_follows_the_shared_memory_limits():
    """Rung 1 (lane groups) to GATHER_MAX_IND individuals, where the rows
    kernel overtook it on the card at the gather sweep's 524,288-pair
    block, for each table dtype (or to the lane groups' design limit, where
    that comes first), on blocks of at least GATHER_MIN_PAIRS pairs (by
    dtype); rung 2 up to the opt-in limit less the rows kernel's sum slots;
    rung 3 beyond; for the CPU the H100's limits stand in."""
    assert smem_limits("cpu") == NOMINAL_SMEM == (49152, 232448)

    def pick(n_ind, itemsize=4, n_pairs=1 << 19):
        return kmod.pick_gather_kernel(n_ind, itemsize, "cpu", n_pairs)

    assert kmod.GATHER_MAX_IND == {4: 500, 8: 250}
    assert [pick(n) for n in (1, 100, 500)] == ["gather"] * 3
    assert [pick(n) for n in (501, 2048, 4000, 8000, 9642)] == ["rows"] * 5
    assert [pick(n) for n in (9643, 20000, 10 ** 6)] == ["ichunk"] * 3
    # f64 tables: their own measured switch to rows (their slots fit to
    # 2,421 individuals), the rows kernel's limit halves
    assert [pick(n, 8) for n in (250, 251, 4821, 4822)] == \
        ["gather", "rows", "rows", "ichunk"]
    # blocks of fewer than GATHER_MIN_PAIRS pairs skip the lane groups
    for itemsize, least in kmod.GATHER_MIN_PAIRS.items():
        assert pick(100, itemsize, least) == "gather"
        assert pick(100, itemsize, least - 1) == "rows"
    assert sorted(kmod.GATHER_KERNELS) == ["gather", "ichunk", "rows"]
    # as in the JAX package, every cohort size has a rung
    assert jem.pick_pair_tile(2000) is None
    assert jem.pick_rows_tile(8000) is not None and pick(8000) == "rows"


@pytest.mark.parametrize("rung", ["rows", "ichunk"])
def test_compute_block_takes_the_rung_the_ladder_names(monkeypatch, rung):
    _, (gn, sidx, maf) = _case(50, 20, seed=5)
    gn, maf = gn.double(), maf.double()
    eg = gn[..., 1] + 2 * gn[..., 2]
    base_fm, base_im = compute.compute_block(gn, eg, maf, sidx, True)
    calls = []
    real = kmod.GATHER_KERNELS[rung]

    def counted(*a, **k):
        calls.append(a[1].shape[1])
        return real(*a, **k)

    monkeypatch.setitem(kmod.GATHER_KERNELS, rung, counted)
    monkeypatch.setattr(compute, "pick_gather_kernel", lambda *a: rung)
    monkeypatch.setattr(kmod, "I_CHUNK", 8)
    fm, im = compute.compute_block(gn, eg, maf, sidx, True)
    assert calls == [50]
    np.testing.assert_array_equal(im.numpy(), base_im.numpy())
    nan = np.isnan(base_fm.numpy())
    np.testing.assert_allclose(np.where(nan, 0, fm.numpy()),
                               np.where(nan, 0, base_fm.numpy()),
                               atol=1e-12, rtol=0)
    # the Pearson r2 step in slices of pairs changes nothing
    monkeypatch.setattr(compute, "_R2P_BYTES", 20 * 8 * 7)
    fm2, _ = compute.compute_block(gn, eg, maf, sidx, True)
    np.testing.assert_array_equal(fm2.numpy(), fm.numpy())


def test_cli_gather_sweep_through_the_streamed_rung(tmp_path, monkeypatch):
    """The gather sweep with the ladder on its last rung (as a cohort past
    the shared-memory limit takes it) prints what the first rung prints."""
    files = write_all(simulate(n_ind=10, n_sites=250, seed=21),
                      str(tmp_path / "fx"))
    argv = ["--geno", files["glf"], "--log_scale", "--n_ind", "10",
            "--n_sites", "250", "--pos", files["pos"], "--max_kb_dist", "10",
            "--extend_out", "--verbose", "0"]
    a, b = tmp_path / "a.ld", tmp_path / "b.ld"
    assert main(argv + ["--out", str(a)]) == 0
    calls = []
    real = kmod.pair_em_ichunk

    def counted(*args, **k):
        calls.append(1)
        return real(*args, i_chunk=4)

    monkeypatch.setitem(kmod.GATHER_KERNELS, "ichunk", counted)
    monkeypatch.setattr(compute, "pick_gather_kernel", lambda *a: "ichunk")
    assert main(argv + ["--out", str(b)]) == 0
    assert calls and a.read_bytes() == b.read_bytes()
    assert a.read_bytes().count(b"\n") > 500


# ----------------------------------------------------- the streamed strip

def _gl(S, I, seed):
    sim = simulate(n_ind=I, n_sites=S, seed=seed)
    return (sim.gl / sim.gl.sum(axis=2, keepdims=True)).astype(np.float32)


def _tables(S, I, seed, W):
    """The inputs of tests/test_pallas_strip.py::_tables, as numpy."""
    gl = _gl(S, I, seed)
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
    return glp, mafp, lo, hi, ok, ta, tb


def _torch_args(glp, mafp, lo, hi, ok, ta, tb, I, i_align, device="cpu"):
    g = torch.from_numpy(glp).to(device)
    tabs = tstrip.strip_tables(g, g[..., 1] + 2 * g[..., 2], I,
                               i_align=i_align)
    m, okt = torch.from_numpy(mafp).to(device), torch.from_numpy(ok).to(device)
    return (*tabs, m, m, torch.from_numpy(lo).to(device),
            torch.from_numpy(hi).to(device), okt, okt,
            torch.from_numpy(ta).to(device), torch.from_numpy(tb).to(device))


def test_streamed_rule_and_alignment_match_jax(monkeypatch):
    """strip_streamed / strip_i_align / strip_tables(i_align=): the same
    answers as the JAX functions under the forcing knobs and at small
    cohorts; past either package's resident limit both stream. (The chunk
    defaults differ on purpose: the TPU's lane width, the card's shared
    memory.)"""
    for n in (9, 40, 100, 200):
        assert not tstrip.strip_streamed(n) and not jstrip.strip_streamed(n)
        assert tstrip.strip_i_align(n) == jstrip.strip_i_align(n) == 8
    # a block's strips as doubles, 968 bytes an individual, against the
    # shared memory a block may opt into
    assert not tstrip.strip_streamed(230) and tstrip.strip_streamed(231)
    for n in (4000, 20000):
        assert tstrip.strip_streamed(n) and jstrip.strip_streamed(n)
        assert tstrip.strip_i_align(n) == tstrip.IC_STREAM == 64
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "16")
    assert tstrip.strip_streamed(9) and jstrip.strip_streamed(9)
    assert tstrip.strip_i_align(9) == jstrip.strip_i_align(9) == 16
    gl = _gl(130, 40, seed=4)
    eg = gl[..., 1] + 2 * gl[..., 2]
    j_tabs = jstrip.strip_tables(jnp.asarray(gl), jnp.asarray(eg), 40,
                                 i_align=jstrip.strip_i_align(40))
    t_tabs = tstrip.strip_tables(torch.from_numpy(gl), torch.from_numpy(eg),
                                 40, i_align=tstrip.strip_i_align(40))
    assert [tuple(t.shape) for t in t_tabs] == \
        [(3, 130, 48), (3, 48, 130), (130, 48), (48, 130)]
    for j, t in zip(j_tabs, t_tabs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
    # the pads: the uniform record and a zero of the standardized rows
    assert (t_tabs[0].numpy()[:, :, 40:] == np.float32(1 / 3)).all()
    assert (t_tabs[2].numpy()[:, 40:] == 0).all()


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_strip_em_stream_ref_vs_jax_streamed_kernel(monkeypatch, ignore_miss):
    """tests/test_pallas_strip.py:565: I = 40 with IC = 16 splits the real
    rows across three chunks and leaves padding rows in the last."""
    S, I, W = 256, 40, 60
    case = _tables(S, I, seed=11, W=W)
    glp, mafp, lo, hi, ok, ta, tb = case
    kw = dict(n_ind=I, ignore_miss=ignore_miss)
    resident = [x.numpy() for x in tstrip.strip_em(
        *_torch_args(*case, I, 8), **kw)]

    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "16")
    t_args = _torch_args(*case, I, tstrip.strip_i_align(I))
    assert t_args[0].shape[2] == 48
    n0, calls = tstrip.LAUNCHES_STREAM, []
    real = tstrip.strip_em_stream_ref
    monkeypatch.setattr(tstrip, "strip_em_stream_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    t_out = [x.numpy() for x in tstrip.strip_em(*t_args, **kw)]
    # CPU tensors: the wrapper is the streamed plain version, no launch
    assert tstrip.LAUNCHES_STREAM == n0 and calls == [1]

    g = jnp.asarray(glp)
    j_tabs = jax.jit(lambda g: jstrip.strip_tables(
        g, expected_geno(g), I, i_align=jstrip.strip_i_align(I)))(g)
    m, okj = jnp.asarray(mafp), jnp.asarray(ok)
    j_out = [np.asarray(x) for x in jstrip.strip_em(
        *j_tabs, m, m, jnp.asarray(lo), jnp.asarray(hi), okj, okj,
        jnp.asarray(ta), jnp.asarray(tb), interpret=True, **kw)]

    A = ta.astype(np.int64)[:, None, None] * TA + np.arange(TA)[None, :, None]
    B = tb.astype(np.int64)[:, None, None] * TB + np.arange(TB)[None, None, :]
    live = (B >= lo[A]) & (B < hi[A]) & (ok[A] > 0) & (ok[B] > 0)
    assert live.sum() > 300

    def hold(out, other, f_tol, it_exact):
        f, r, n, u = out
        of, orr, on, ou = other
        np.testing.assert_array_equal(u, ou)
        same = n == on
        if it_exact:
            assert same.all()
        else:
            assert same[live].mean() > 0.98
            assert (np.abs(n - on) <= 1)[live].mean() > 0.98
        nan = np.isnan(f) & np.isnan(of)
        d = np.abs(np.where(nan, 0, f) - np.where(nan, 0, of)).max(axis=1)
        assert d[same].max() <= f_tol
        rn = np.isnan(r) & np.isnan(orr)
        assert np.abs(np.where(rn, 0, r) - np.where(rn, 0, orr)).max() <= 2e-5
        assert (n[~live] == ITER_MAX).all()

    # the Pallas streamed kernel (f32 EM), then the port's resident plain
    # version (f64 EM, another summation order)
    hold(t_out, j_out, 3e-5, it_exact=False)
    hold(t_out, resident, 1e-6, it_exact=True)


def test_streamed_strip_refuses_tables_without_the_chunk(monkeypatch):
    S, I, W = 256, 40, 60
    case = _tables(S, I, seed=11, W=W)
    args = _torch_args(*case, I, 8)          # Ip = 40
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "16")
    with pytest.raises(ValueError, match=r"needs Ip % 16 == 0.*Ip=40"):
        tstrip.strip_em(*args, n_ind=I)
    # another chunk for the plain version: the same function (a few
    # iterations are enough to show it)
    ok_args = _torch_args(*case, I, 16)
    a = tstrip.strip_em_stream_ref(*ok_args, n_ind=I, iter_cap=6)
    b = tstrip.strip_em_stream_ref(*ok_args, n_ind=I, iter_cap=6, i_chunk=7)
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())
    np.testing.assert_array_equal(a[3].numpy(), b[3].numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-6, rtol=0)
    assert 0 < (a[2].numpy() < 6).mean() < 1


# ------------------------------------- the slice: CLI, streamed strip forced

def _stream_fixture(tmp_path, n_sites=700):
    """The fixture of tests/test_pallas_strip.py:607 (9 x 700)."""
    files = write_all(simulate(n_ind=9, n_sites=n_sites, seed=61,
                               contig_kb=40.0), str(tmp_path / "fx"))
    return ["--geno", files["beagle"], "--probs", "--n_ind", "9",
            "--n_sites", str(n_sites), "--pos", files["pos"],
            "--max_kb_dist", "3", "--min_maf", "0.04", "--extend_out",
            "--verbose", "0"]


def test_cli_streamed_strip_matches_strict_and_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "16")
    argv = _stream_fixture(tmp_path)
    calls = []
    real = tstrip.strip_em_stream_ref

    def counted(*a, **k):
        calls.append(a[0].shape[2])
        return real(*a, **k)

    monkeypatch.setattr(tstrip, "strip_em_stream_ref", counted)
    t_out, s_out, j_out = (tmp_path / n for n in ("t.ld", "s.ld", "j.ld"))
    assert main(argv + ["--precision", "f32", "--out", str(t_out)]) == 0
    assert calls and set(calls) == {16}      # 9 individuals padded to IC
    assert main(argv + ["--engine", "strict", "--out", str(s_out)]) == 0
    t_rows = t_out.read_text().splitlines()
    cmp_vs_strict(s_out.read_text().splitlines(), t_rows, 400)
    run_jax(j_params_from_args(argv + ["--precision", "f32", "--out",
                                       str(j_out)]))
    cmp_vs_strict(j_out.read_text().splitlines(), t_rows, 400)


def test_streamed_chunk_is_part_of_the_checkpoint_fingerprint(tmp_path,
                                                              monkeypatch):
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "16")
    argv = _stream_fixture(tmp_path, 260) + ["--precision", "f32"]
    ckpt = str(tmp_path / "ckpt")
    straight, out1 = tmp_path / "straight.ld", tmp_path / "ck.ld"
    assert main(argv + ["--out", str(straight)]) == 0
    assert main(argv + ["--checkpoint", ckpt, "--out", str(out1)]) == 0
    assert out1.read_bytes() == straight.read_bytes()
    for knobs in ({"NGSLD_STRIP_IC": "8"}, {"NGSLD_STRIP_STREAM": "0"}):
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(StrictError, match="different run"):
            run_torch(params_from_args(argv + ["--checkpoint", ckpt, "--out",
                                               str(tmp_path / "x.ld")]))


# ------------------------------------------------------------ on the card

def _card_table(n_ind, n_pairs, seed):
    sim = simulate(n_ind=n_ind, n_sites=300, seed=seed,
                   all_missing_site_rate=0.05)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    maf = (gl[..., 1] + 2 * gl[..., 2]).mean(axis=1) / 2
    rng = np.random.default_rng(seed)
    s1 = rng.integers(0, 299, n_pairs)
    s2 = np.minimum(s1 + rng.integers(1, 9, n_pairs), 299)
    return (torch.tensor(gl, dtype=torch.float32, device="cuda"),
            torch.tensor(np.stack([s1, s2]), dtype=torch.int32,
                         device="cuda"),
            torch.tensor(maf, dtype=torch.float32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("rung", ["rows", "ichunk"])
def test_large_cohort_gather_kernels_match_plain_on_the_card(rung):
    # both sides run the EM in f64: nIter and n_used exact, f to f32
    # rounding. pair_em_rows: also on both sides of every change of its
    # block width and at its ceiling. pair_em_ichunk: its cluster body at
    # I = 37 (one block) and at 4,777 (the first cohort of two blocks a
    # cluster), its streamed body (called directly) with i_chunk 16, which
    # leaves a partial last chunk; each body shown by its counters
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cases = [(37, 3000, False)]
    if rung == "rows":
        top = kmod.rows_max_ind(4, "cuda")
        steps = [n for n in range(2, top + 1)
                 if kmod.rows_threads(n, 4, "cuda")
                 != kmod.rows_threads(n - 1, 4, "cuda")]
        cases += [(n, 40, False) for s in steps for n in (s - 1, s)]
        cases += [(top, 20, False)]
    if rung == "ichunk":
        assert kmod.ichunk_cluster(4777, 4, "cuda") == 2
        cases += [(4777, 40, False), (37, 3000, True)]
    for n_ind, n_pairs, streamed in cases:
        gn, sidx, maf = _card_table(n_ind, n_pairs, seed=3)
        ichunk = kmod._pair_em_ichunk_stream if streamed \
            else kmod.pair_em_ichunk
        kern, plain, counter = {
            "rows": (kmod.pair_em_rows, kmod.pair_em_rows_ref,
                     "LAUNCHES_ROWS"),
            "ichunk": (lambda *a: ichunk(*a, i_chunk=16),
                       lambda *a: kmod.pair_em_ichunk_ref(*a, i_chunk=16),
                       "LAUNCHES_ICHUNK")}[rung]
        for ignore_miss in (False, True):
            n0 = getattr(kmod, counter)
            s0 = kmod.LAUNCHES_ICHUNK_STREAM
            fk, itk, nuk = (t.cpu().numpy() for t in
                            kern(gn, sidx, maf, ignore_miss))
            assert getattr(kmod, counter) == n0 + 1
            assert kmod.LAUNCHES_ICHUNK_STREAM == s0 + streamed
            fp, itp, nup = (t.cpu().numpy() for t in
                            plain(gn, sidx, maf, ignore_miss))
            np.testing.assert_array_equal(nuk, nup)
            np.testing.assert_array_equal(itk, itp)
            np.testing.assert_array_equal(np.isnan(fk), np.isnan(fp))
            nan = np.isnan(fk)
            np.testing.assert_allclose(np.where(nan, 0, fk),
                                       np.where(nan, 0, fp), rtol=0,
                                       atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("ignore_miss", [False, True])
def test_streamed_strip_kernel_matches_plain_on_the_card(monkeypatch,
                                                         ignore_miss):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "16")
    S, I, W = 512, 37, 200
    case = _tables(S, I, seed=11, W=W)
    args = _torch_args(*case, I, 16, device="cuda")
    n0 = tstrip.LAUNCHES_STREAM
    kern = [t.cpu().numpy() for t in tstrip.strip_em(
        *args, n_ind=I, ignore_miss=ignore_miss)]
    assert tstrip.LAUNCHES_STREAM == n0 + 1
    plain = [t.cpu().numpy() for t in tstrip.strip_em_stream_ref(
        *args, n_ind=I, ignore_miss=ignore_miss)]
    np.testing.assert_array_equal(kern[3], plain[3])
    np.testing.assert_array_equal(kern[2], plain[2])
    for k, p, tol in ((kern[0], plain[0], 1e-6), (kern[1], plain[1], 2e-5)):
        np.testing.assert_array_equal(np.isnan(k), np.isnan(p))
        nan = np.isnan(k)
        np.testing.assert_allclose(np.where(nan, 0, k), np.where(nan, 0, p),
                                   rtol=0, atol=tol)
