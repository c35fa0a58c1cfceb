"""What a machine without CUDA can check of the strip-EM kernels' design:
the lane-efficiency model that reads a launch's own n_iter, the parser
that counts a compiled inner loop's instructions, the routing between the
resident and the streamed kernel at the shared-memory limit, the wrapper's
refusals, and the plain versions at iteration caps 0, 1 and 3 (the sides
the card-side repack cases are held against) against the Pallas kernel in
interpret mode. Tolerances against the JAX package as in
tests/test_torch_strip.py: n_used exact, hap freqs within 3e-5, nIter
within 1 on more than 95% of live cells, r2p within 2e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.kernels import pallas_strip as jstrip
from ngsld_tpu.ops.preprocess import expected_geno
from ngsld_tpu.utils.simulate import simulate
from ngsld_tpu_torch.kernels import build
from ngsld_tpu_torch.kernels import strip_em as tstrip
from ngsld_tpu_torch.plan.strips import TA, TB
from ngsld_tpu_torch.utils import devtrace
from ngsld_tpu_torch.utils.devtrace import lane_efficiency


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- lane efficiency

def _tile(value=4, rows=8, cols=64):
    return (torch.full((1, rows, cols), value, dtype=torch.int32),
            torch.ones((1, rows, cols), dtype=torch.bool))


@pytest.mark.parametrize("round_iters", [1, 2, 4])
def test_lane_efficiency_is_one_when_all_cells_stop_together(round_iters):
    n_iter, live = _tile()
    eff = lane_efficiency(n_iter, live, 10, round_iters=round_iters)
    assert eff["needed"] == 8 * 64 * 5 * 10     # stop at 4: five updates
    # a warp leaves a round once all its cells have stopped
    assert eff["warp"] == eff["block"] == eff["repacked"] == 1.0


def test_lane_efficiency_with_one_capped_cell_a_warp():
    n_iter, live = _tile()
    n_iter[0, :, 0] = 99          # every row's first warp waits to the cap
    eff = lane_efficiency(n_iter, live, 10)
    needed = 504 * 5 + 8 * 100
    assert eff["needed"] == needed * 10
    # 8 warps run 100 iterations, the other 8 run 5
    assert eff["warp"] == pytest.approx(needed / (32 * (8 * 100 + 8 * 5)))
    # the 8 x 32 block that holds the capped cells runs 100, the other 5
    assert eff["block"] == pytest.approx(needed / (256 * (100 + 5)))
    # repacked every iteration: 8 cells left get 32 lanes each
    assert lane_efficiency(n_iter, live, 10, round_iters=1)["repacked"] \
        == pytest.approx(1.0)
    # a cap below the longest cell bounds every cell's updates
    assert lane_efficiency(n_iter, live, 10, cap=3)["needed"] == 512 * 3 * 10


def test_lane_efficiency_ignores_dead_cells():
    n_iter, live = _tile()
    n_iter[0, :, 32:] = 100       # a dead half at the cap: never counted
    live[0, :, 32:] = False
    eff = lane_efficiency(n_iter, live, 7, round_iters=2)
    assert eff["needed"] == 256 * 5 * 7
    assert eff["warp"] == eff["block"] == 1.0
    # nothing live at all
    none = lane_efficiency(n_iter, torch.zeros_like(live), 7, round_iters=1)
    assert none == {"needed": 0, "warp": 1.0, "block": 1.0, "repacked": 1.0}


def test_lane_efficiency_of_lane_groups():
    """65 cells of a 256-thread block get 2 lanes each (the largest power
    of two with 65 G <= 256): 5 warps of 16 seats, the last with one cell;
    a 512-thread block gives the same cells 4 lanes each."""
    n_iter = torch.zeros((1, 16, 32), dtype=torch.int32)
    live = torch.zeros((1, 16, 32), dtype=torch.bool)
    live.view(-1)[:65] = True
    n_iter.view(-1)[:65] = 9
    eff8 = lane_efficiency(n_iter, live, 3, rows=8, round_iters=1)
    assert eff8["repacked"] == pytest.approx(65 / (5 * 32 / 2))
    eff16 = lane_efficiency(n_iter, live, 3, rows=16, round_iters=1)
    assert eff16["repacked"] == pytest.approx(65 / (9 * 32 / 4))
    assert eff8["needed"] == eff16["needed"] == 65 * 10 * 3


# ------------------------------------------------------------ SASS parser

_SASS = """
	code for sm_90a
		Function : _ZN3foo22strip_em_stream_kernelILb0EEEvN5ngsld9StripArgsE
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   DFMA R2, R2, R4, R6 ;
        /*0020*/                   EXIT ;
		Function : _ZN3foo15strip_em_kernelILb0EEEvN5ngsld9StripArgsE
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                             /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDS.64 R8, [R3+0x40] ;
        /*0030*/                   DFMA R2, R2, R4, R6 ;
        /*0040*/                   MUFU.RCP64H R5, R7 ;
        /*0050*/                   DMUL R2, R2, R4 ;
        /*0060*/                   IADD3 R3, R3, 0x3c8, RZ ;
        /*0070*/              @!P0 BRA 0x20 ;
        /*0080*/                   F2F.F64.F32 R2, R3 ;
        /*0090*/               @P1 BRA 0x10 ;
        /*00a0*/                   BRA 0xa0 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_inner_loop_counts_the_innermost_arithmetic_loop():
    loop = devtrace.sass_inner_loop(_SASS, ["strip_em_kernel", "ILb0E"])
    assert loop["function"].startswith("_ZN3foo15strip_em_kernel")
    assert loop["loop"] == [0x20, 0x70]     # not the outer 0x10..0x90 one
    assert (loop["fp64"], loop["lds"], loop["mufu"], loop["int"],
            loop["ctrl"], loop["cvt"]) == (2, 1, 1, 1, 1, 0)
    assert loop["n_instr"] == 6 and loop["terms"] == 1
    other = devtrace.sass_inner_loop(_SASS, ["strip_em_stream_kernel"])
    assert other["loop"] is None and other["fp64"] == 1   # no loop: whole
    assert devtrace.sass_inner_loop(_SASS, ["no_such_kernel"]) is None


def test_kernel_registers_reads_res_usage():
    text = ("Fatbin elf code:\n arch = sm_90a\n\n"
            " Function _Z3barv:\n  REG:16 STACK:0 SHARED:0 LOCAL:0\n"
            " Function _ZN3foo15strip_em_kernelILb0EEEv:\n"
            "  REG:88 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:760\n")
    assert devtrace.kernel_registers(text, ["strip_em_kernel"]) == 88
    assert devtrace.kernel_registers(text, ["bar"]) == 16
    assert devtrace.kernel_registers(text, ["missing"]) is None


def test_cuobjdump_raises_without_the_toolkit(monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        devtrace.cuobjdump("x.so", "-sass")


# ------------------------------------------------------------ the routing

def test_strip_smem_follows_the_kernels_layout():
    # resident: 8 + 32 sites x 3 planes + 1 doubles an individual, and per
    # cell 4 doubles, an int and a list entry, plus 2 x 8 warp counts
    assert tstrip.strip_smem(100) == 100 * 121 * 8 + 256 * 38 + 64 == 106592
    # streamed: 16 + 32 sites; two buffers of doubles and one of floats;
    # 3 x 16 ints of the warps
    assert tstrip.strip_smem(64, streamed=True) \
        == 64 * (2 * 145 * 8 + 144 * 4) + 512 * 38 + 192 == 204992
    assert tstrip.strip_smem(tstrip.IC_STREAM, streamed=True) \
        <= build.NOMINAL_SMEM[1]


@pytest.mark.parametrize("limit,last_resident", [
    (build.NOMINAL_SMEM[1], 230),     # the card the CPU path assumes
    (101376, 94),                     # a card with 99 KB a block
    (49152, 40)])
def test_strip_streamed_switches_at_the_shared_memory_limit(
        monkeypatch, limit, last_resident):
    monkeypatch.setattr(tstrip, "smem_limits", lambda device: (49152, limit))
    n = last_resident
    assert tstrip.strip_smem(n) <= limit < tstrip.strip_smem(n + 1)
    assert not tstrip.strip_streamed(n) and tstrip.strip_streamed(n + 1)
    assert tstrip.strip_i_align(n) == 8
    assert tstrip.strip_i_align(n + 1) == tstrip.IC_STREAM == 64
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "16")
    assert tstrip.strip_streamed(2) and tstrip.strip_i_align(2) == 16


def _gl(S, I, seed):
    sim = simulate(n_ind=I, n_sites=S, seed=seed, all_missing_site_rate=0.02)
    return (sim.gl / sim.gl.sum(axis=2, keepdims=True)).astype(np.float32)


def _case(S, I, seed, W, i_align=8):
    """tests/test_pallas_strip.py::_tables and the two packages' args."""
    gl = _gl(S, I, seed)
    maf = ((gl[..., 1] + 2 * gl[..., 2]).mean(axis=1) / 2).astype(np.float32)
    Sp = -(-S // TA) * TA
    glp = np.pad(gl, ((0, Sp - S), (0, 0), (0, 0)), constant_values=1.0 / 3.0)
    lo = np.arange(Sp, dtype=np.int32) + 1
    hi = np.minimum(np.arange(Sp) + W + 1, S).astype(np.int32)
    ok = (np.arange(Sp) < S).astype(np.float32)
    tiles = [(k, j) for k in range(Sp // TA)
             for j in range(k, max(k + 1, -(-int(
                 hi[k * TA:(k + 1) * TA].max()) // TB)))]
    mafp = np.pad(maf, (0, Sp - S), constant_values=0.5)
    ta = np.array([t[0] for t in tiles], np.int32)
    tb = np.array([t[1] for t in tiles], np.int32)
    g = torch.from_numpy(glp)
    m, okt = torch.from_numpy(mafp), torch.from_numpy(ok)
    t_args = (*tstrip.strip_tables(g, g[..., 1] + 2 * g[..., 2], I,
                                   i_align=i_align),
              m, m, torch.from_numpy(lo), torch.from_numpy(hi), okt, okt,
              torch.from_numpy(ta), torch.from_numpy(tb))
    gj = jnp.asarray(glp)
    mj, okj = jnp.asarray(mafp), jnp.asarray(ok)
    j_args = (*jax.jit(lambda g: jstrip.strip_tables(
        g, expected_geno(g), I))(gj), mj, mj, jnp.asarray(lo),
        jnp.asarray(hi), okj, okj, jnp.asarray(ta), jnp.asarray(tb))
    A = ta.astype(np.int64)[:, None, None] * TA + np.arange(TA)[None, :, None]
    B = tb.astype(np.int64)[:, None, None] * TB + np.arange(TB)[None, None, :]
    live = (B >= lo[A]) & (B < hi[A]) & (ok[A] > 0) & (ok[B] > 0)
    return t_args, j_args, live


def test_wrapper_refuses_what_the_shared_memory_cannot_hold(monkeypatch):
    S, I = 256, 6
    t_args, _, _ = _case(S, I, seed=5, W=40, i_align=128)
    limit = build.NOMINAL_SMEM[1]
    # a chunk too large for the streamed kernel, with both numbers
    monkeypatch.setenv("NGSLD_STRIP_STREAM", "1")
    monkeypatch.setenv("NGSLD_STRIP_IC", "128")
    need = tstrip.strip_smem(128, streamed=True)
    with pytest.raises(ValueError, match=rf"chunk 128 needs {need} bytes.*"
                                         rf"allows {limit}"):
        tstrip.strip_em(*t_args, n_ind=I)
    monkeypatch.setenv("NGSLD_STRIP_IC", "64")      # this one fits
    assert tstrip.strip_em(*t_args, n_ind=I, iter_cap=1)[0].shape[1:] \
        == (4, TA, TB)
    # the streamed kernel's sub-tile has 16 anchors
    with pytest.raises(ValueError, match="multiple of 16, got 8"):
        tstrip.strip_em(*t_args, n_ind=I, ta_sz=8, tb_sz=32)
    # the resident kernel sent a cohort its block cannot hold
    monkeypatch.delenv("NGSLD_STRIP_STREAM")
    monkeypatch.setattr(tstrip, "smem_limits", lambda device: (49152, 12000))
    monkeypatch.setattr(tstrip, "strip_streamed", lambda *a, **k: False)
    with pytest.raises(ValueError, match=rf"6 individuals needs "
                                         rf"{tstrip.strip_smem(6)} bytes.*"
                                         r"allows 12000"):
        tstrip.strip_em(*t_args, n_ind=I)


# ------------------------------------------- the plain versions at low caps

@pytest.mark.parametrize("ignore_miss", [False, True])
@pytest.mark.parametrize("cap", [1, 3])
def test_plain_versions_at_low_caps_vs_jax_strip_kernel(cap, ignore_miss):
    S, I, W = 256, 10, 100
    t_args, j_args, live = _case(S, I, seed=2, W=W, i_align=16)
    kw = dict(n_ind=I, iter_cap=cap, ignore_miss=ignore_miss)
    jf, jr, jn, ju = (np.asarray(x) for x in jstrip.strip_em(
        *j_args, interpret=True, first_check=1, unroll=1, **kw))
    resident = [x.numpy() for x in tstrip.strip_em_ref(*t_args, **kw)]
    streamed = [x.numpy() for x in tstrip.strip_em_stream_ref(
        *t_args, i_chunk=16, **kw)]
    assert live.sum() > 300
    for tf, tr, tn, tu in (resident, streamed):
        np.testing.assert_array_equal(tu, ju)
        assert tn.max() <= cap and (tn[~live] == cap).all()
        assert (jn[~live] == cap).all()
        assert (np.abs(tn[live] - jn[live]) <= 1).mean() > 0.95
        nan = np.isnan(jf)
        np.testing.assert_array_equal(np.isnan(tf), nan)
        np.testing.assert_allclose(np.where(nan, 0, tf), np.where(nan, 0, jf),
                                   atol=3e-5, rtol=0)
        rn = np.isnan(jr)
        np.testing.assert_array_equal(np.isnan(tr), rn)
        np.testing.assert_allclose(np.where(rn, 0, tr), np.where(rn, 0, jr),
                                   atol=2e-5, rtol=0)
    # the two plain versions: another summation order, the same stops
    np.testing.assert_array_equal(resident[2], streamed[2])
    np.testing.assert_allclose(np.nan_to_num(resident[0]),
                               np.nan_to_num(streamed[0]), atol=1e-6, rtol=0)
    assert 0 < (resident[2][live] < cap).mean() < 1 or cap == 1


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_plain_versions_at_cap_zero_keep_the_init(ignore_miss):
    """iter_cap 0: no update at all. Every cell, live or dead, holds the f0
    init with n_iter 0, and still gets its r2p and n_used."""
    S, I, W = 256, 10, 100
    t_args, _, live = _case(S, I, seed=2, W=W, i_align=16)
    kw = dict(n_ind=I, ignore_miss=ignore_miss)
    full = tstrip.strip_em_ref(*t_args, **kw)
    for ref, extra in ((tstrip.strip_em_ref, {}),
                       (tstrip.strip_em_stream_ref, {"i_chunk": 16})):
        f, r2p, n_iter, n_used = ref(*t_args, iter_cap=0, **extra, **kw)
        assert (n_iter == 0).all() and not f.isnan().any()
        ma, mb = t_args[4].double(), t_args[5].double()
        ta, tb = t_args[10].long(), t_args[11].long()
        a = ma[(ta[:, None] * TA + torch.arange(TA))][:, :, None]
        b = mb[(tb[:, None] * TB + torch.arange(TB))][:, None, :]
        f0 = torch.stack([(1 - a) * (1 - b), (1 - a) * b, a * (1 - b), a * b],
                         dim=1).float()
        np.testing.assert_array_equal(f.numpy(), f0.numpy())
        np.testing.assert_array_equal(n_used.numpy(), full[3].numpy())
        np.testing.assert_allclose(np.nan_to_num(r2p.numpy()),
                                   np.nan_to_num(full[1].numpy()), atol=2e-5)
    assert live.any() and (~live).any()
