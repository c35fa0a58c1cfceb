"""The port's strip sweep on the CPU, held against the JAX package and the
strict oracle: the strip planner, the strip chunker (no device), the
strip tables, the strip EM's plain PyTorch version against the Pallas
kernel in interpret mode (the contract
of tests/test_pallas_strip.py: hap freqs within 3e-5, n_used exact, nIter
within 1 on more than 95% of live cells, r2p within 2e-5, dead cells at
the f0 init with nIter at the cap), the emission epilogues, and the
port's CLI with the strip sweep forced (NGSLD_PLATFORM=cpu
NGSLD_BLOCK_STRIP=1 --precision f32) on the fixtures of that file. The
CUDA kernel itself is compared with the plain version in the `gpu`-marked
test and by chip_smoke.py on the card."""

import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.cli import params_from_args as j_params_from_args
from ngsld_tpu.constants import ITER_MAX
from ngsld_tpu.engine import run_jax
from ngsld_tpu.kernels import pallas_strip as jstrip
from ngsld_tpu.ops.preprocess import expected_geno
from ngsld_tpu.plan import strips as jplan
from ngsld_tpu.utils.simulate import simulate, write_all
from ngsld_tpu_torch import engine_block
from ngsld_tpu_torch.cli import main, params_from_args
from ngsld_tpu_torch.engine import run_torch
from ngsld_tpu_torch.kernels import strip_em as tstrip
from ngsld_tpu_torch.plan.band import PairBlock
from ngsld_tpu_torch.plan.strips import TA, TB, strip_chunks, strip_plan
from ngsld_tpu_torch.strict import StrictError
from ngsld_tpu_torch.utils.conformance import cmp_vs_strict


@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    # the plain version runs many small tensor ops: more threads only
    # fight the other test workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the planner

def _band(kind):
    rng = np.random.default_rng(3)
    if kind == "snp_window":          # fixed 100-site window, S = 700
        S = 700
        hi = np.minimum(np.arange(S) + 101, S)
        ok = np.ones(S, bool)
    elif kind == "all_pairs_maf":     # all pairs, a third of the sites out
        S = 520
        hi = np.full(S, S)
        ok = rng.random(S) > 0.33
    else:                             # ragged kb band, anchor tile 2 all dead
        S = 900
        hi = np.minimum(np.arange(S) + 1 + rng.integers(0, 300, S), S)
        hi = np.maximum.accumulate(hi)
        ok = np.ones(S, bool)
        ok[2 * TA:3 * TA] = False
    Sp = -(-S // TA) * TA + TB        # as the JAX engine pads: + a dead tile
    hi_p = np.zeros(Sp, np.int64)
    hi_p[:S] = hi
    ok_p = np.zeros(Sp, np.float32)
    ok_p[:S] = ok
    return S, hi_p, ok_p


@pytest.mark.parametrize("kind", ["snp_window", "all_pairs_maf",
                                  "dead_anchor_tile"])
def test_strip_plan_matches_jax(kind):
    S, hi_p, ok_p = _band(kind)
    assert (jstrip.TA, jstrip.TB) == (TA, TB) == (128, 128)
    j_ta, j_tb, j_groups, j_util = jplan.strip_plan(hi_p, ok_p, S)
    t_ta, t_tb, t_groups, t_util = strip_plan(hi_p, ok_p, S, 128, 128)
    np.testing.assert_array_equal(t_ta, j_ta)
    np.testing.assert_array_equal(t_tb, j_tb)
    np.testing.assert_array_equal(t_groups, j_groups)
    assert t_ta.dtype == np.int32 and t_util == j_util and len(t_ta) > 5
    if kind == "dead_anchor_tile":
        assert t_groups[2] == 0 and 2 not in t_ta
    # without the JAX engine's extra dead tile (the port's padding) the
    # tile list and the utilization are the same
    ta2, tb2, _, util2 = strip_plan(hi_p[:-TB], ok_p[:-TB], S)
    np.testing.assert_array_equal(ta2, j_ta)
    np.testing.assert_array_equal(tb2, j_tb)
    assert util2 == j_util


# ------------------------------------------------------------ the chunker

def _pair_stream(S, width, keep, block_pairs, seed=5):
    """A banded pair stream as plan.band.iter_pair_blocks yields it:
    anchor-major pairs a < b < a + width + 1, a `keep` share of them, in
    blocks of block_pairs pairs that cut through anchor-tile groups."""
    rng = np.random.default_rng(seed)
    a = np.repeat(np.arange(S, dtype=np.int64), width)
    b = a + np.tile(np.arange(1, width + 1), S)
    live = (b < S) & (rng.random(len(a)) < keep)
    a, b = a[live], b[live]
    d = (b - a).astype(np.float64)
    blocks = [PairBlock(s1=a[i:i + block_pairs], s2=b[i:i + block_pairs],
                        dist=d[i:i + block_pairs])
              for i in range(0, len(a), block_pairs)]
    return a, b, blocks


@pytest.mark.parametrize("S,width,gmaxt,ctarget", [
    (1536, 60, 4, 1 << 20),     # narrow groups batch under gmaxt
    (1024, 700, 2, 1 << 20),    # wide groups split into gmaxt-tile pieces
    (1536, 60, 8, 9000),        # chunks cut by ctarget
], ids=["narrow_batched", "wide_split", "ctarget_cut"])
def test_strip_chunks_budgets_cells_and_order(S, width, gmaxt, ctarget):
    a, b, blocks = _pair_stream(S, width, 0.5, 777)
    chunks = list(strip_chunks(iter(blocks), gmaxt, ctarget))
    anchors_per_chunk = []
    for i, (ta, tb, sel, blk, rem) in enumerate(chunks):
        gc = len(ta)
        assert 1 <= gc <= gmaxt and len(tb) == gc
        assert len(sel) == len(blk.s1) > 0
        # sel's cell is the pair's: tile, anchor row, partner column
        assert ((0 <= sel) & (sel < gc * TA * TB)).all()
        t, r, c = sel // (TA * TB), sel // TB % TA, sel % TB
        np.testing.assert_array_equal(ta[t] * TA + r, blk.s1)
        np.testing.assert_array_equal(tb[t] * TB + c, blk.s2)
        np.testing.assert_array_equal(blk.dist, blk.s2 - blk.s1)
        if rem:
            # a non-final piece of a split group fills its chunk alone
            assert gc == gmaxt and len(set(ta)) == 1
            assert chunks[i + 1][4] == rem - 1
        elif len(set(ta)) > 1:
            # whole groups batch only within the pair budget
            assert len(sel) <= ctarget
        anchors_per_chunk.append(len(set(ta)))
    # the pairs, each split group merged back as the emit pipeline does
    # (its chunks up to the final one, lexsorted), are the stream's
    got, run = [], []
    for ta, tb, sel, blk, rem in chunks:
        run.append(blk)
        if rem:
            continue
        s1 = np.concatenate([x.s1 for x in run])
        s2 = np.concatenate([x.s2 for x in run])
        order = np.lexsort((s2, s1))
        got.append((s1[order], s2[order]))
        run = []
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), a)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), b)
    n_split = sum(1 for c in chunks if c[4])
    whole = len(list(strip_chunks(iter(blocks), gmaxt, 1 << 30)))
    if width > gmaxt * TB:
        assert n_split > 0
    else:
        assert n_split == 0
        if ctarget < 1 << 20:
            assert len(chunks) > whole
        else:
            assert max(anchors_per_chunk) > 1


# ------------------------------------------------------------- the tables

def _gl(S, I, seed, **kw):
    sim = simulate(n_ind=I, n_sites=S, seed=seed, **kw)
    return (sim.gl / sim.gl.sum(axis=2, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("I,i_align", [(10, 8), (13, 8), (16, 16)])
def test_strip_tables_match_jax(I, i_align):
    """Same gn (S, I, 3), eg (S, I) through both strip_tables: the four
    tables equal in f32 (rtol 1e-6, plus atol 1e-7 for entries of a
    standardized row that cancel to near 0), inf/NaN at the same places
    (zero-variance sites)."""
    gl = _gl(200, I, seed=4, mono_rate=0.1, all_missing_site_rate=0.05)
    gl[7] = 1.0 / 3.0                      # a zero-variance site: 0/0 rows
    eg = gl[..., 1] + 2 * gl[..., 2]
    j_tabs = jstrip.strip_tables(jnp.asarray(gl), jnp.asarray(eg), I,
                                 i_align=i_align)
    t_tabs = tstrip.strip_tables(torch.from_numpy(gl), torch.from_numpy(eg),
                                 I, i_align=i_align)
    Ip = -(-I // i_align) * i_align
    assert [tuple(t.shape) for t in t_tabs] == \
        [(3, 200, Ip), (3, Ip, 200), (200, Ip), (Ip, 200)]
    for name, j, t in zip(("ga", "gb", "ea", "eb"), j_tabs, t_tabs):
        j, t = np.asarray(j), t.numpy()
        assert t.dtype == np.float32 and t.flags["C_CONTIGUOUS"], name
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j), err_msg=name)
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j), err_msg=name)
        fin = np.isfinite(j)
        np.testing.assert_allclose(t[fin], j[fin], rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    assert np.isnan(t_tabs[2].numpy()[7, :I]).all()


# ----------------------------------------------- the strip EM, tile layout

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


def _jax_args(glp, mafp, lo, hi, ok, ta, tb, I):
    g = jnp.asarray(glp)
    tabs = jax.jit(lambda g: jstrip.strip_tables(g, expected_geno(g), I))(g)
    m, okj = jnp.asarray(mafp), jnp.asarray(ok)
    return (*tabs, m, m, jnp.asarray(lo), jnp.asarray(hi), okj, okj,
            jnp.asarray(ta), jnp.asarray(tb))


def _torch_args(glp, mafp, lo, hi, ok, ta, tb, I, device="cpu"):
    g = torch.from_numpy(glp).to(device)
    tabs = tstrip.strip_tables(g, g[..., 1] + 2 * g[..., 2], I)
    m, okt = torch.from_numpy(mafp).to(device), torch.from_numpy(ok).to(device)
    return (*tabs, m, m, torch.from_numpy(lo).to(device),
            torch.from_numpy(hi).to(device), okt, okt,
            torch.from_numpy(ta).to(device), torch.from_numpy(tb).to(device))


def _live(lo, hi, ok, ta, tb):
    A = ta.astype(np.int64)[:, None, None] * TA + np.arange(TA)[None, :, None]
    B = tb.astype(np.int64)[:, None, None] * TB + np.arange(TB)[None, None, :]
    return (B >= lo[A]) & (B < hi[A]) & (ok[A] > 0) & (ok[B] > 0), A, B


def _hold_tile_outputs(t_out, j_out, live, mafp, A, B):
    """The kernel contract between two (f, r2p, n_iter, n_used) sets."""
    tf, tr, tn, tu = t_out
    jf, jr, jn, ju = j_out
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(np.isnan(tf), np.isnan(jf))
    nan = np.isnan(jf)
    np.testing.assert_allclose(np.where(nan, 0, tf), np.where(nan, 0, jf),
                               atol=3e-5, rtol=0)
    assert live.sum() > 300
    assert (np.abs(tn[live] - jn[live]) <= 1).mean() > 0.95
    np.testing.assert_array_equal(np.isnan(tr), np.isnan(jr))
    rn = np.isnan(jr)
    np.testing.assert_allclose(np.where(rn, 0, tr), np.where(rn, 0, jr),
                               atol=2e-5, rtol=0)
    # dead cells: never iterate, keep the f0 init
    dead = ~live
    assert (tn[dead] == ITER_MAX).all() and (jn[dead] == ITER_MAX).all()
    ma, mb = mafp[np.broadcast_to(A, live.shape)], \
        mafp[np.broadcast_to(B, live.shape)]
    f0 = np.stack([(1 - ma) * (1 - mb), (1 - ma) * mb, ma * (1 - mb),
                   ma * mb], axis=1)
    np.testing.assert_allclose(np.moveaxis(tf, 1, -1)[dead],
                               np.moveaxis(f0, 1, -1)[dead], atol=1e-7, rtol=0)


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_strip_em_ref_vs_jax_strip_kernel(ignore_miss):
    S, I, W = 512, 10, 100
    case = _tables(S, I, seed=2, W=W)
    glp, mafp, lo, hi, ok, ta, tb = case
    j_out = [np.asarray(x) for x in jstrip.strip_em(
        *_jax_args(*case, I), n_ind=I, ignore_miss=ignore_miss,
        interpret=True)]
    t_out = [x.numpy() for x in tstrip.strip_em_ref(
        *_torch_args(*case, I), n_ind=I, ignore_miss=ignore_miss)]
    assert t_out[0].shape == (len(ta), 4, TA, TB)
    assert t_out[0].dtype == np.float32 and t_out[2].dtype == np.int32
    live, A, B = _live(lo, hi, ok, ta, tb)
    _hold_tile_outputs(t_out, j_out, live, mafp, A, B)


def test_strip_em_ref_dead_cells_and_bounds():
    """Out-of-band / triangle / not-ok cells stay at the f0 init with
    n_iter == cap; live bounds honor [lo, hi) exactly (nearly every live
    cell of this 6-individual fixture converges well before the cap)."""
    S, I, W = 256, 6, 40
    glp, mafp, lo, hi, ok, ta, tb = _tables(S, I, seed=5, W=W)
    ok[3] = 0.0   # a not-ok anchor/partner
    case = (glp, mafp, lo, hi, ok, ta, tb)
    j_out = [np.asarray(x) for x in jstrip.strip_em(
        *_jax_args(*case, I), n_ind=I, interpret=True)]
    t_out = [x.numpy() for x in tstrip.strip_em(   # CPU tensors: the ref
        *_torch_args(*case, I), n_ind=I)]
    live, A, B = _live(lo, hi, ok, ta, tb)
    assert not live[:, 3, :][ta == 0].any() and live.sum() > 300
    _hold_tile_outputs(t_out, j_out, live, mafp, A, B)
    assert (t_out[2][live] < ITER_MAX).mean() > 0.95
    # a smaller cap marks dead cells with that cap
    capped = tstrip.strip_em(*_torch_args(*case, I), n_ind=I, iter_cap=3)
    assert (capped[2].numpy()[~live] == 3).all()
    assert capped[2].numpy().max() == 3


def test_strip_em_ref_batches_tiles(monkeypatch):
    """The plain version's bounded batches change nothing."""
    S, I, W = 384, 7, 150
    case = _tables(S, I, seed=8, W=W)
    args = _torch_args(*case, I)
    whole = tstrip.strip_em_ref(*args, n_ind=I, ignore_miss=True)
    monkeypatch.setattr(tstrip, "_REF_PLANE_BYTES", 1)   # one tile a batch
    split = tstrip.strip_em_ref(*args, n_ind=I, ignore_miss=True)
    assert len(case[5]) > 3
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    empty = tstrip.strip_em_ref(*args[:10], args[10][:0], args[11][:0],
                                n_ind=I)
    assert empty[0].shape == (0, 4, TA, TB) and empty[3].shape == (0, TA, TB)


def test_strip_em_wrapper_checks_and_devices(monkeypatch):
    S, I, W = 256, 6, 40
    case = _tables(S, I, seed=5, W=W)
    args = list(_torch_args(*case, I))
    monkeypatch.setattr(tstrip, "LAUNCHES", 0)
    tstrip.strip_em(*args, n_ind=I)
    assert tstrip.LAUNCHES == 0            # CPU tensors: no kernel launch
    with pytest.raises(ValueError, match="lo must be torch.int32"):
        tstrip.strip_em(*args[:6], args[6].long(), *args[7:], n_ind=I)
    with pytest.raises(ValueError, match=r"gb must be \(3, Ip, Sb\)"):
        tstrip.strip_em(args[0], args[1][:, :4], *args[2:], n_ind=I)
    with pytest.raises(ValueError, match="n_ind"):
        tstrip.strip_em(*args, n_ind=I + 8)
    with pytest.raises(ValueError, match=r"multiple of \(8, 32\)"):
        tstrip.strip_em(*args, n_ind=I, ta_sz=100, tb_sz=100)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no strip-EM kernel for device"):
        tstrip.strip_em(*meta, n_ind=I)


# ------------------------------------------------------- the epilogues

def _sel_for(lo, hi, ok, ta, tb):
    live, _, _ = _live(lo, hi, ok, ta, tb)
    return np.flatnonzero(live.reshape(-1)).astype(np.int32)


def test_strip_compact_slim_im_matches_wide():
    """slim_im=True ships n_iter as (C, 1) i8 and drops the constant n_used
    column; values match the wide (C, 2) i16 layout element for element,
    and both match the JAX epilogue's rows."""
    S, I, W = 256, 6, 60
    case = _tables(S, I, seed=9, W=W)
    glp, mafp, lo, hi, ok, ta, tb = case
    sel = _sel_for(lo, hi, ok, ta, tb)
    assert len(sel) > 500
    args = _torch_args(*case, I) + (torch.from_numpy(sel),)
    fm_w, im_w = tstrip.strip_em_compact(*args, n_ind=I)
    fm_s, im_s = tstrip.strip_em_compact(*args, n_ind=I, slim_im=True)
    assert im_w.shape == (len(sel), 2) and im_w.dtype == torch.int16
    assert im_s.shape == (len(sel), 1) and im_s.dtype == torch.int8
    assert fm_w.shape == (len(sel), 5) and fm_w.dtype == torch.float32
    np.testing.assert_array_equal(fm_w.numpy(), fm_s.numpy())
    np.testing.assert_array_equal(im_w[:, 0].numpy(),
                                  im_s[:, 0].numpy().astype(np.int16))
    np.testing.assert_array_equal(im_w[:, 1].numpy(),
                                  np.full(len(sel), I, np.int16))
    _, im_32 = tstrip.strip_em_compact(*args, n_ind=I, use_i16=False)
    assert im_32.dtype == torch.int32
    jfm, jim = jstrip.strip_em_compact(
        *_jax_args(*case, I), jnp.asarray(sel), n_ind=I, interpret=True)
    np.testing.assert_allclose(fm_w.numpy(), np.asarray(jfm), atol=3e-5,
                               rtol=0)
    np.testing.assert_array_equal(im_w[:, 1].numpy(), np.asarray(jim)[:, 1])
    assert (np.abs(im_w[:, 0].numpy().astype(int)
                   - np.asarray(jim)[:, 0]) <= 1).mean() > 0.95


def test_strip_flat_rows_are_the_cells_sel_addresses():
    """strip_em_flat emits every cell in (tile, a, b) order: taking its rows
    at sel gives strip_em_compact's rows, and both are the tile-layout
    outputs relaid."""
    S, I, W = 256, 6, 60
    case = _tables(S, I, seed=9, W=W)
    glp, mafp, lo, hi, ok, ta, tb = case
    sel = _sel_for(lo, hi, ok, ta, tb)
    args = _torch_args(*case, I)
    for ign in (False, True):
        kw = dict(n_ind=I, ignore_miss=ign, slim_im=not ign)
        fm_f, im_f = tstrip.strip_em_flat(*args, **kw)
        fm_c, im_c = tstrip.strip_em_compact(*args, torch.from_numpy(sel),
                                             **kw)
        assert fm_f.shape == (len(ta) * TA * TB, 5)
        assert im_f.shape == (len(ta) * TA * TB, 1 if not ign else 2)
        np.testing.assert_array_equal(fm_f.numpy()[sel], fm_c.numpy())
        np.testing.assert_array_equal(im_f.numpy()[sel], im_c.numpy())
        f, r2p, nit, nu = tstrip.strip_em(*args, n_ind=I, ignore_miss=ign)
        np.testing.assert_array_equal(fm_f[:, 0].numpy(),
                                      r2p.numpy().reshape(-1))
        np.testing.assert_array_equal(
            fm_f[:, 1:].numpy(),
            np.moveaxis(f.numpy(), 1, -1).reshape(-1, 4))
        np.testing.assert_array_equal(im_f[:, 0].numpy(),
                                      nit.numpy().reshape(-1))
    with pytest.raises(AssertionError, match="slim_im"):
        tstrip.strip_em_flat(*args, n_ind=I, ignore_miss=True, slim_im=True)


# --------------------------------------------- the CLI, strip sweep forced

def _fixture(tmp_path, n_ind, n_sites, seed, contig_kb):
    return write_all(simulate(n_ind=n_ind, n_sites=n_sites, seed=seed,
                              contig_kb=contig_kb), str(tmp_path / "fx"))


def _argv(files, n_ind, n_sites, extra):
    return ["--geno", files["beagle"], "--probs", "--n_ind", str(n_ind),
            "--n_sites", str(n_sites), "--pos", files["pos"], "--extend_out",
            "--verbose", "0"] + extra


def _cli(argv, out):
    assert main(argv + ["--out", str(out)]) == 0
    return out.read_text().splitlines()


def _strip_launch_counter(monkeypatch):
    """Count the strip steps a run dispatches (on the CPU they reach the
    plain version)."""
    calls = []
    real = tstrip.strip_em

    def counted(*a, **k):
        calls.append(len(a[10]))
        return real(*a, **k)

    monkeypatch.setattr(tstrip, "strip_em", counted)
    return calls


@pytest.mark.parametrize("extra,min_rows", [
    (["--max_kb_dist", "4", "--min_maf", "0.05"], 1000),
    (["--max_kb_dist", "4", "--min_maf", "0.05", "--ignore_miss_data"], 1000),
], ids=["default", "ignore_miss"])
def test_strip_sweep_matches_strict(tmp_path, monkeypatch, extra, min_rows):
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    calls = _strip_launch_counter(monkeypatch)
    files = _fixture(tmp_path, 8, 1024, 47, 50.0)
    argv = _argv(files, 8, 1024, extra)
    r = _cli(argv + ["--precision", "f32"], tmp_path / "r.ld")
    assert calls and sum(calls) > 8       # the strip sweep did run
    s = _cli(argv + ["--engine", "strict"], tmp_path / "s.ld")
    cmp_vs_strict(s, r, min_rows)


def test_strip_sweep_is_f32_only_and_can_be_switched_off(tmp_path,
                                                         monkeypatch):
    files = _fixture(tmp_path, 8, 512, 48, 50.0)
    argv = _argv(files, 8, 512, ["--max_kb_dist", "4"])
    calls = _strip_launch_counter(monkeypatch)
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    a = _cli(argv + ["--precision", "f64"], tmp_path / "a.ld")
    assert not calls                      # f64: the gather sweep
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "0")
    b = _cli(argv + ["--precision", "f32"], tmp_path / "b.ld")
    assert not calls                      # switched off
    monkeypatch.delenv("NGSLD_BLOCK_STRIP")
    c = _cli(argv + ["--precision", "f32"], tmp_path / "c.ld")
    assert not calls                      # auto rule: never on the CPU
    assert b == c and len(a) == len(b) > 500
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    d = _cli(argv + ["--precision", "f32"], tmp_path / "d.ld")
    assert calls
    cmp_vs_strict(b, d, 500)              # gather f32 vs strip f32


def test_strip_rnd_sample_matches_strict(tmp_path, monkeypatch):
    """Strip sweep + --rnd_sample: the sampled pair SET is byte-identical to
    the strict oracle's (the sel mask derives from the shared
    iter_pair_blocks plan), values to f32 grade."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    files = _fixture(tmp_path, 8, 1024, 51, 50.0)
    argv = _argv(files, 8, 1024, ["--max_kb_dist", "4", "--min_maf", "0.05",
                                  "--rnd_sample", "0.5", "--seed", "12345"])
    r = _cli(argv + ["--precision", "f32"], tmp_path / "r.ld")
    s = _cli(argv + ["--engine", "strict"], tmp_path / "s.ld")
    cmp_vs_strict(s, r, 500)


def test_strip_checkpoint_roundtrip(tmp_path, monkeypatch):
    """A checkpointed strip run equals a straight one byte for byte; a rerun
    resumes every chunk from the shards and still matches; the fingerprint
    refuses a gather-mode resume of a strip checkpoint."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    monkeypatch.setenv("NGSLD_STRIP_CTARGET", "1500")
    files = _fixture(tmp_path, 8, 768, 52, 50.0)
    argv = _argv(files, 8, 768, ["--max_kb_dist", "4", "--precision", "f32"])
    straight = tmp_path / "straight.ld"
    _cli(argv, straight)
    ckpt = str(tmp_path / "ckpt")
    out1 = tmp_path / "ck.ld"
    _cli(argv + ["--checkpoint", ckpt], out1)
    assert out1.read_bytes() == straight.read_bytes()
    assert len([p for p in os.listdir(ckpt) if p.endswith(".tsv")]) > 2

    calls = _strip_launch_counter(monkeypatch)
    out2 = tmp_path / "resumed.ld"
    _cli(argv + ["--checkpoint", ckpt], out2)
    assert out2.read_bytes() == straight.read_bytes() and not calls

    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "0")
    with pytest.raises(StrictError, match="different run"):
        run_torch(params_from_args(argv + ["--checkpoint", ckpt, "--out",
                                           str(tmp_path / "x.ld")]))


def test_strip_sigint_then_resume(tmp_path, monkeypatch):
    """SIGINT mid strip sweep: exit 130 with committed chunk shards; a rerun
    with the same --checkpoint resumes and matches the straight run."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    monkeypatch.setenv("NGSLD_STRIP_CTARGET", "1500")
    files = _fixture(tmp_path, 8, 768, 53, 50.0)
    argv = _argv(files, 8, 768, ["--max_kb_dist", "4", "--precision", "f32"])
    straight = tmp_path / "straight.ld"
    _cli(argv, straight)

    real_prefetch = engine_block._prefetch_blocks

    def prefetch_with_sigint(gen, depth=4):
        for i, blk in enumerate(real_prefetch(gen, depth)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGINT)
            yield blk

    monkeypatch.setattr(engine_block, "_prefetch_blocks",
                        prefetch_with_sigint)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit) as ei:
        run_torch(params_from_args(argv + ["--checkpoint", ckpt, "--out",
                                           str(tmp_path / "cut.ld")]))
    assert ei.value.code == 130
    n_done = len([p for p in os.listdir(ckpt) if p.endswith(".tsv")])
    assert n_done >= 1
    monkeypatch.setattr(engine_block, "_prefetch_blocks", real_prefetch)

    calls = _strip_launch_counter(monkeypatch)
    out2 = tmp_path / "resumed.ld"
    _cli(argv + ["--checkpoint", ckpt], out2)
    assert out2.read_bytes() == straight.read_bytes()
    n_all = len([p for p in os.listdir(ckpt) if p.endswith(".tsv")])
    assert len(calls) == n_all - n_done > 0   # only the missing chunks ran


def test_strip_wide_band_row_order(tmp_path, monkeypatch):
    """A split anchor-tile group (partner span > GMAXT*TB sites) still emits
    rows in global (s1, s2) order: NGSLD_STRIP_TILES=2 caps the dispatch
    window at 256 sites, so the 640-site all-pairs run splits several
    groups; output is byte-identical to the single-window run and
    explicitly (s1, s2)-sorted."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    files = _fixture(tmp_path, 6, 640, 61, 500.0)
    argv = _argv(files, 6, 640, ["--max_kb_dist", "0", "--precision", "f32"])
    big, small = tmp_path / "big.ld", tmp_path / "small.ld"
    _cli(argv, big)
    monkeypatch.setenv("NGSLD_STRIP_TILES", "2")
    calls = _strip_launch_counter(monkeypatch)
    rows = _cli(argv, small)
    assert max(calls) == 2 and len(calls) >= 8
    assert small.read_bytes() == big.read_bytes()
    idx = {}
    with open(files["pos"]) as fh:
        for i, line in enumerate(fh):
            c, p = line.split()[:2]
            idx[f"{c}:{p}"] = i
    keys = [(idx[r.split("\t")[0]], idx[r.split("\t")[1]]) for r in rows[1:]]
    assert len(keys) == 640 * 639 // 2
    assert keys == sorted(keys)


def test_strip_wide_band_checkpoint_resume(tmp_path, monkeypatch):
    """Split groups under --checkpoint: the merged rows live in the run's
    FINAL shard with empty placeholders before it. A full resume skips the
    whole group; a resume after the placeholders were lost re-ensures
    them; both reproduce the straight run byte for byte."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    monkeypatch.setenv("NGSLD_STRIP_TILES", "2")
    files = _fixture(tmp_path, 6, 512, 62, 500.0)
    argv = _argv(files, 6, 512, ["--max_kb_dist", "0", "--precision", "f32"])
    straight = tmp_path / "straight.ld"
    _cli(argv, straight)
    ckpt = str(tmp_path / "ckpt")
    out1 = tmp_path / "ck.ld"
    _cli(argv + ["--checkpoint", ckpt], out1)
    assert out1.read_bytes() == straight.read_bytes()
    parts = sorted(p for p in os.listdir(ckpt) if p.endswith(".tsv"))
    empties = [p for p in parts
               if os.path.getsize(os.path.join(ckpt, p)) == 0]
    assert empties, "expected placeholder shards for split groups"
    out2 = tmp_path / "resumed.ld"
    _cli(argv + ["--checkpoint", ckpt], out2)
    assert out2.read_bytes() == straight.read_bytes()
    for p in empties:
        os.unlink(os.path.join(ckpt, p))
    out3 = tmp_path / "resumed2.ld"
    _cli(argv + ["--checkpoint", ckpt], out3)
    assert out3.read_bytes() == straight.read_bytes()


@pytest.mark.parametrize("seed", [101, 102])
def test_strip_fuzz_configs(tmp_path, monkeypatch, seed):
    """Randomized flag combinations, forced strip sweep vs the strict
    oracle across band kinds, sampling, min_maf and genotype calling: the
    pair SET matches exactly, values to f32 grade."""
    rng = np.random.default_rng(seed)
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    monkeypatch.setenv("NGSLD_STRIP_TILES", str(rng.choice([2, 3, 256])))
    monkeypatch.setenv("NGSLD_STRIP_EMIT",
                       str(rng.choice(["auto", "flat", "compact"])))
    n_sites = int(rng.integers(300, 700))
    n_ind = int(rng.integers(6, 14))
    files = _fixture(tmp_path, n_ind, n_sites, seed, 50.0)
    argv = _argv(files, n_ind, n_sites, [])
    if rng.random() < 0.5:
        argv += ["--max_kb_dist", str(int(rng.integers(2, 6)))]
    else:
        argv += ["--max_kb_dist", "0", "--max_snp_dist",
                 str(int(rng.integers(20, 80)))]
    if rng.random() < 0.5:
        argv += ["--min_maf", "0.05"]
    if rng.random() < 0.5:
        argv += ["--rnd_sample", "0.6", "--seed", str(seed)]
    if rng.random() < 0.5:
        argv += ["--call_geno", "--N_thresh", "0.2", "--call_thresh", "0.9"]
    if rng.random() < 0.5:
        argv += ["--ignore_miss_data"]
    r = _cli(argv + ["--precision", "f32"], tmp_path / "r.ld")
    s = _cli(argv + ["--engine", "strict"], tmp_path / "s.ld")
    assert len(s) == len(r) > 50, (len(s), len(r), argv)
    cmp_vs_strict(s, r, 50)


def test_flat_emission_byte_equal_to_compact(tmp_path, monkeypatch):
    """NGSLD_STRIP_EMIT=flat (dense cell-major pull + host-side sel take)
    is byte-identical to the compacted form: same step, other transport.
    The auto rule takes flat for these full tiles and compact for the
    diagonal ones."""
    files = _fixture(tmp_path, 12, 384, 9, 500.0)
    argv = _argv(files, 12, 384, ["--max_kb_dist", "0", "--precision", "f32"])
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    outs = {}
    for mode in ("compact", "flat", "auto"):
        monkeypatch.setenv("NGSLD_STRIP_EMIT", mode)
        out = tmp_path / f"{mode}.ld"
        _cli(argv, out)
        outs[mode] = out.read_bytes()
    assert outs["flat"].count(b"\n") == 1 + 384 * 383 // 2
    assert outs["flat"] == outs["compact"] == outs["auto"]


def test_strip_sweep_matches_jax_strip_sweep(tmp_path, monkeypatch):
    """The port's strip run against run_jax's strip run (the Pallas kernel
    in interpret mode) on one fixture: same pairs in the same order,
    values within cmp_vs_strict's f32 tolerances."""
    monkeypatch.setenv("NGSLD_BLOCK_STRIP", "1")
    files = _fixture(tmp_path, 8, 600, 47, 50.0)
    argv = _argv(files, 8, 600, ["--max_kb_dist", "4", "--min_maf", "0.05",
                                 "--precision", "f32"])
    t = _cli(argv, tmp_path / "t.ld")
    j_out = tmp_path / "j.ld"
    run_jax(j_params_from_args(argv + ["--out", str(j_out)]))
    cmp_vs_strict(j_out.read_text().splitlines(), t, 500)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("ignore_miss", [False, True])
def test_strip_kernel_matches_plain_on_the_card(ignore_miss):
    # both sides run the EM in f64: nIter and n_used agree exactly, f to
    # f32 rounding, r2p (an f64 dot on both sides) within 2e-5
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    S, I, W = 1024, 37, 300
    sim_kw = dict(all_missing_site_rate=0.05)
    gl = _gl(S, I, 11, **sim_kw)
    eg = gl[..., 1] + 2 * gl[..., 2]
    glp, mafp, lo, hi, ok, ta, tb = _tables(S, I, seed=11, W=W)
    glp[:S] = gl
    mafp[:S] = (eg.mean(axis=1) / 2).astype(np.float32)
    args = _torch_args(glp, mafp, lo, hi, ok, ta, tb, I, device="cuda")
    n0 = tstrip.LAUNCHES
    kern = [t.cpu().numpy() for t in tstrip.strip_em(
        *args, n_ind=I, ignore_miss=ignore_miss)]
    assert tstrip.LAUNCHES == n0 + 1
    plain = [t.cpu().numpy() for t in tstrip.strip_em_ref(
        *args, n_ind=I, ignore_miss=ignore_miss)]
    np.testing.assert_array_equal(kern[3], plain[3])
    np.testing.assert_array_equal(kern[2], plain[2])
    for k, p, tol in ((kern[0], plain[0], 1e-6), (kern[1], plain[1], 2e-5)):
        np.testing.assert_array_equal(np.isnan(k), np.isnan(p))
        nan = np.isnan(k)
        np.testing.assert_allclose(np.where(nan, 0, k), np.where(nan, 0, p),
                                   rtol=0, atol=tol)
    live, _, _ = _live(lo, hi, ok, ta, tb)
    assert (kern[2][~live] == ITER_MAX).all()
