"""The redesigned gather kernels' launch arithmetic and routing, as far as
a machine without CUDA reaches them: pair_em_gather's lane-group size,
slot and rung limit, pair_em_ichunk's cluster size, block width and the
routing between its cluster and streamed bodies (with the refusal where no
cluster fits), the lane-use model of both gather layouts on hand-made
nIter, and the plain versions against the JAX kernels (interpret mode) at
I = 1 and at a chunk and slot boundary. For the CPU the H100's shared
memory stands in (kernels/build.py::NOMINAL_SMEM). The kernels themselves
are held against their plain versions by the `gpu`-marked tests and by
chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngsld_tpu.kernels import pallas_em as jem
from ngsld_tpu.utils.simulate import simulate
from ngsld_tpu_torch.kernels import pair_em as kmod
from ngsld_tpu_torch.kernels.build import NOMINAL_SMEM
from ngsld_tpu_torch.utils.devtrace import gather_lane_use

SM_BYTES = NOMINAL_SMEM[1] + 1024    # an H100 SM's shared memory


@pytest.fixture(autouse=True)
def small_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ pair_em_gather's layout

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n_ind", [1, 37, 100, 291, 1200])
def test_slot_stride_spreads_a_warp_over_the_banks(n_ind, group, itemsize):
    """Lane q of the j-th group of a warp reads value 3 (q + k G) + c of
    its slot: with the slot's stride the warp's 32 lanes hit 32 distinct
    banks of 4 bytes (8-byte values: each half-warp 16 distinct pairs of
    banks), at every k and c."""
    slot = kmod.gather_slot(n_ind, group, itemsize)
    assert 6 * n_ind <= slot < 6 * n_ind + 32
    lanes = np.arange(32)
    j, q = lanes // group, lanes % group
    for k in range(3):
        for c in range(3):
            idx = j * slot + 3 * (q + k * group) + c    # in table values
            if itemsize == 4:
                assert len(set(idx % 32)) == 32
            else:
                for half in (idx[:16], idx[16:]):
                    assert len(set(half % 16)) == 16


def test_group_size_follows_the_warps_an_sm():
    """The smallest G whose slots leave GATHER_WARPS_SM (16) warps an SM:
    a block is two warps with 64 / G slots of 6 I table values each."""
    assert kmod.GATHER_WARPS_SM == 16 and kmod.GATHER_THREADS == 64

    def warps(n, g, itemsize):
        smem = (64 // g) * kmod.gather_slot(n, g, itemsize) * itemsize
        return 2 * (SM_BYTES // (smem + 1024))

    for itemsize in (4, 8):
        for n in (1, 16, 17, 37, 71, 72, 100, 142, 143, 290, 291, 1200):
            g = kmod.gather_group(n, itemsize)
            # G = 32 also where even it leaves fewer warps (n = 1,200)
            assert warps(n, g, itemsize) >= 16 or g == 32
            if g > 1:
                assert warps(n, g // 2, itemsize) < 16
            assert kmod.gather_warps_sm(n, g, itemsize) == \
                warps(n, g, itemsize)
    # the G steps of an H100 for f32 tables
    assert [kmod.gather_group(n) for n in (16, 17, 33, 34, 71, 72, 100, 142,
                                            143, 290, 291)] == \
        [1, 2, 2, 4, 4, 8, 8, 8, 16, 16, 32]
    # doubles take twice the room: each step comes at half the cohort
    assert [kmod.gather_group(n, 8) for n in (8, 9, 36, 37, 146, 147)] == \
        [1, 2, 4, 8, 16, 32]


def test_gather_rung_design_limit_and_fixed_group():
    """Past 16 warps G stays 32 while a block of two one-slot warps fits
    the opt-in shared memory: 4,842 individuals in f32 tables, 2,421 in
    f64; beyond it there is no group size. A smaller G does not fit where
    its slots do not (16 slots of 96 KB at 4,000)."""
    assert kmod.gather_group(4842) == 32 and kmod.gather_group(4843) is None
    assert kmod.gather_group(2421, 8) == 32
    assert kmod.gather_group(2422, 8) is None
    assert kmod.gather_smem(4842, 32, 4) <= NOMINAL_SMEM[1] \
        < kmod.gather_smem(4843, 32, 4)
    assert kmod.gather_warps_sm(100, 4) == 10
    assert kmod.gather_warps_sm(4000, 4) == 0


# ------------------------------------------- pair_em_ichunk's cluster body

def test_cluster_size_from_the_cohort(monkeypatch):
    """The smallest C <= 8 whose slices fit two blocks an SM, else one
    block an SM, else the streamed body; slices on whole 16-byte runs."""
    assert kmod.CLUSTER_BLOCKS_SM == 2 and kmod.CLUSTER_MAX == 8
    assert kmod._CLUSTER_RESERVED == 2048
    assert kmod.cluster_slice(20000, 5) == 4000
    assert kmod.cluster_slice(37, 1) == 40
    assert kmod.cluster_slice(37, 1, 8) == 38
    assert kmod.cluster_slice(20000, 3) == 6668
    assert kmod.cluster_smem(20000, 5) == 6 * 4000 * 4

    def rule(n, itemsize):
        for room in (SM_BYTES // 2 - 2048, SM_BYTES - 2048):
            fits = [b for b in range(1, 9)
                    if kmod.cluster_smem(n, b, itemsize) <= room]
            if fits:
                return fits[0]
        return None

    for n in (1, 37, 4000, 4776, 4777, 9642, 20000, 38208, 38209, 60000,
              77120, 77121):
        for itemsize in (4, 8):
            assert kmod.ichunk_cluster(n, itemsize) == rule(n, itemsize)
    assert [kmod.ichunk_cluster(n) for n in (4776, 4777, 20000, 33433)] == \
        [1, 2, 5, 8]
    assert kmod.ichunk_cluster(20000, 8) == 5     # one block an SM
    # capacity: eight blocks of the opt-in shared memory
    assert kmod.ichunk_cluster(77120) == 8
    assert kmod.ichunk_cluster(77121) is None
    assert kmod.ichunk_cluster(38560, 8) == 8
    assert kmod.ichunk_cluster(38561, 8) is None
    monkeypatch.setattr(kmod, "CLUSTER_BLOCKS_SM", 1)
    assert kmod.ichunk_cluster(20000) == 3


def test_cluster_block_width():
    assert kmod.cluster_threads(37, 1) == 64
    assert kmod.cluster_threads(4000, 1) == 256       # 4,000 / 16 -> 250
    assert kmod.cluster_threads(20000, 5) == 256
    assert kmod.cluster_threads(2000, 1) == 128
    assert kmod.cluster_threads(77120, 8) == 512      # capped


def test_ladder_takes_the_design_limit_where_it_comes_first(monkeypatch):
    """With the measured switch set past the lane groups' design limit, the
    limit decides: a block of two one-slot warps must fit the opt-in
    shared memory (4,842 individuals as floats, 2,421 as doubles)."""
    def pick(n_ind, itemsize=4):     # on the sweep's default block
        return kmod.pick_gather_kernel(n_ind, itemsize, "cpu", 1 << 19)

    for itemsize, last in kmod.GATHER_MAX_IND.items():
        assert pick(last, itemsize) == "gather"
        assert pick(last + 1, itemsize) == "rows"
    monkeypatch.setattr(kmod, "GATHER_MAX_IND", {4: 10 ** 6, 8: 10 ** 6})
    assert pick(4842) == "gather"
    assert pick(4843) == "rows"
    assert pick(2421, 8) == "gather"
    assert pick(2422, 8) == "rows"
    assert pick(9643) == "ichunk"


def _cpu_case(n_ind, n_pairs=6, n_sites=4):
    rng = np.random.default_rng(n_ind)
    gl = rng.random((n_sites, n_ind, 3)).astype(np.float32)
    gl /= gl.sum(axis=2, keepdims=True)
    maf = (gl[..., 1] + 2 * gl[..., 2]).mean(axis=1) / 2
    sidx = rng.integers(0, n_sites, (2, n_pairs)).astype(np.int32)
    return (torch.from_numpy(gl), torch.from_numpy(sidx),
            torch.from_numpy(maf.astype(np.float32)))


def _as_card(monkeypatch, fits=1):
    """Send the wrappers down their CUDA path on CPU tensors, with the
    launches recorded instead of made and the card's answer about
    clusters given."""
    calls = []

    def launch(lib_name, fn_stem, gn, sidx, maf, ign, pre=(), post=()):
        calls.append((lib_name, fn_stem, tuple(pre), len(post)))
        return kmod._empty(gn, sidx)

    monkeypatch.setattr(kmod, "_device_kind", lambda gn, name: "cuda")
    monkeypatch.setattr(kmod, "_launch", launch)

    class Answer(dict):
        def __contains__(self, key):
            return True

        def __getitem__(self, key):
            return fits

    monkeypatch.setattr(kmod, "_CLUSTER_FITS", Answer())
    return calls


def test_ichunk_routes_by_size_before_the_launch(monkeypatch):
    calls = _as_card(monkeypatch)
    n0, s0 = kmod.LAUNCHES_ICHUNK, kmod.LAUNCHES_ICHUNK_STREAM
    kmod.pair_em_ichunk(*_cpu_case(20000), False)
    assert calls[-1] == ("pair_em_ichunk", "ngsld_pair_em_cluster", (5, 256),
                         0)
    assert (kmod.LAUNCHES_ICHUNK, kmod.LAUNCHES_ICHUNK_STREAM) == (n0 + 1, s0)
    kmod.pair_em_ichunk(*_cpu_case(77121, n_sites=2), True, i_chunk=500)
    assert calls[-1] == ("pair_em_ichunk", "ngsld_pair_em_ichunk", (500,), 0)
    assert (kmod.LAUNCHES_ICHUNK, kmod.LAUNCHES_ICHUNK_STREAM) == \
        (n0 + 2, s0 + 1)
    # the streamed body at a cohort the cluster holds: only by a direct call
    kmod._pair_em_ichunk_stream(*_cpu_case(37), False, i_chunk=16)
    assert calls[-1][1:3] == ("ngsld_pair_em_ichunk", (16,))
    assert (kmod.LAUNCHES_ICHUNK, kmod.LAUNCHES_ICHUNK_STREAM) == \
        (n0 + 3, s0 + 2)
    with pytest.raises(ValueError, match="i_chunk 20000 needs 961024 bytes"):
        kmod._pair_em_ichunk_stream(*_cpu_case(37), False, i_chunk=20000)
    assert kmod.LAUNCHES_ICHUNK_STREAM == s0 + 2


def test_ichunk_refuses_a_cluster_the_card_cannot_hold(monkeypatch):
    """No fallback to the streamed body: the wrapper raises with the
    cluster's size, its blocks' shared memory and the card's count."""
    calls = _as_card(monkeypatch, fits=0)
    n0 = kmod.LAUNCHES_ICHUNK
    with pytest.raises(ValueError, match=r"cluster of 5 blocks with 96000 "
                       r"bytes .* holds 0 such clusters"):
        kmod.pair_em_ichunk(*_cpu_case(20000), False)
    assert calls == [] and kmod.LAUNCHES_ICHUNK == n0


def test_gather_launch_arguments_and_refusal(monkeypatch):
    calls = _as_card(monkeypatch)
    n0 = kmod.LAUNCHES
    kmod.pair_em_gather(*_cpu_case(100), False)
    g = kmod.gather_group(100)
    # group and slot; then the zeroed queue head
    assert calls[-1] == ("pair_em", "ngsld_pair_em",
                         (g, kmod.gather_slot(100, g)), 1)
    assert kmod.LAUNCHES == n0 + 1
    gn, sidx, maf = _cpu_case(100)
    kmod.pair_em_gather(gn.double(), sidx, maf.double(), True)
    assert calls[-1][2] == (16, kmod.gather_slot(100, 16, 8))
    with pytest.raises(ValueError, match=f"need {kmod.gather_smem(4843, 32)} "
                       f"bytes .* allows {NOMINAL_SMEM[1]}"):
        kmod.pair_em_gather(*_cpu_case(4843, n_sites=2), False)
    assert kmod.LAUNCHES == n0 + 2
    # no pairs: nothing to launch
    gn, sidx, maf = _cpu_case(37)
    out = kmod.pair_em_gather(gn, sidx[:, :0], maf, False)
    assert out[0].shape == (0, 4) and kmod.LAUNCHES == n0 + 2


# ------------------------------------------------------ the lane-use model

def test_lane_use_model_on_hand_made_n_iter():
    # four pairs of 100 individuals: 1 + 10 + 100 + 5 updates
    n_iter = np.array([0, 9, 99, 4])
    use = gather_lane_use(n_iter, 100, 4, 8)
    assert use["needed"] == 116 * 100
    # one 4-warp block, 4 trips of 32 lanes, until the 100-update pair stops
    assert use["warp"] == pytest.approx(11600 / (4 * 32 * 4 * 100))
    # one warp of eight 4-lane groups (25 trips), until the same pair stops
    assert use["queue"] == pytest.approx(11600 / (32 * 25 * 100))
    # twenty one-update pairs of 4 individuals, eight 4-lane groups: they
    # take pairs 0-7, then 8-15, then 16-19; the warp runs 3 steps
    flat = gather_lane_use(np.zeros(20, np.int64), 4, 4, 8)
    assert flat["needed"] == 80
    assert flat["queue"] == pytest.approx(80 / (32 * 1 * 3))
    assert flat["warp"] == pytest.approx(80 / (5 * 4 * 32 * 1 * 1))
    # a long pair behind short ones: the queue keeps the other groups busy,
    # a block of warps waits for it
    n_iter = np.array([99] + [0] * 63)
    q = gather_lane_use(n_iter, 32, 32, 4)
    # 16 blocks: the first waits 100 steps, the other 15 one step each
    assert q["warp"] == pytest.approx(163 * 32 / (4 * 32 * 1 * 115))
    # four one-warp groups: the first runs the long pair, the other three
    # the 63 short ones, 21 steps each, so no lane idles
    assert q["queue"] == pytest.approx(1.0)
    # fewer pairs than twice the groups: each group holds one pair at a
    # time, so twelve one-update pairs take all eight one-warp groups in
    # the first step and four of them in the second
    few = gather_lane_use(np.zeros(12, np.int64), 32, 32, 8)
    assert few["queue"] == pytest.approx(1.0)
    # capped pairs count ITER_MAX updates
    assert gather_lane_use(np.array([150]), 32, 32, 1)["needed"] == 100 * 32


# ------------------------------------- plain versions against the JAX kernels

def _jax_case(n_pairs, n_ind, seed):
    sim = simulate(n_ind=n_ind, n_sites=2 * n_pairs, seed=seed,
                   all_missing_site_rate=0.05)
    gl = (sim.gl / sim.gl.sum(axis=2, keepdims=True)).astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = (eg.mean(axis=1) / 2).astype(np.float32)
    j_args = (jnp.asarray(gl[:n_pairs]), jnp.asarray(gl[n_pairs:]),
              jnp.asarray(maf[:n_pairs]), jnp.asarray(maf[n_pairs:]))
    sidx = np.stack([np.arange(n_pairs), n_pairs + np.arange(n_pairs)])
    return j_args, (torch.from_numpy(gl),
                    torch.from_numpy(sidx.astype(np.int32)),
                    torch.from_numpy(maf))


def _hold(t_out, j_out):
    tf, tn, tu = (x.numpy() for x in t_out)
    jf, jn, ju = (np.asarray(x) for x in j_out)
    np.testing.assert_array_equal(tu, ju)
    nan = np.isnan(tf) & np.isnan(jf)
    np.testing.assert_allclose(np.where(nan, 0, tf), np.where(nan, 0, jf),
                               atol=3e-5, rtol=0)
    assert (np.abs(tn.astype(np.int64) - jn) <= 1).mean() > 0.95


@pytest.mark.parametrize("ignore_miss", [False, True])
@pytest.mark.parametrize("n_ind", [1, 17])
def test_gather_plain_vs_jax_kernel_at_one_and_a_group_step(n_ind,
                                                            ignore_miss):
    """I = 1 (one lane a pair) and I = 17, the first cohort whose rule
    takes two lanes a pair: the plain version against the Pallas gather
    kernel in interpret mode."""
    j_args, t_args = _jax_case(40, n_ind, seed=3 + n_ind)
    assert kmod.gather_group(n_ind) == (1 if n_ind == 1 else 2)
    t_out = kmod.pair_em_gather_ref(*t_args, ignore_miss)
    _hold(t_out, jem.pair_em_pallas(*j_args, ignore_miss, pair_tile=128,
                                    interpret=True))


@pytest.mark.parametrize("n_ind,ignore_miss", [(1, True), (32, False)])
def test_ichunk_plain_vs_jax_kernel_at_one_and_a_chunk_boundary(n_ind,
                                                                ignore_miss):
    """I = 1, and I = 32 with chunks of 16 (the last chunk full: the
    boundary), against the Pallas streamed kernel in interpret mode; the
    plain version's sums do not depend on the chunk beyond rounding."""
    ic = 16
    j_args, t_args = _jax_case(16, n_ind, seed=11 + n_ind)
    t_out = kmod.pair_em_ichunk_ref(*t_args, ignore_miss, i_chunk=ic)
    _hold(t_out, jem.pair_em_ichunk(*j_args, ignore_miss, pair_tile=8,
                                    i_chunk=ic, interpret=True))
    whole = kmod.pair_em_ichunk_ref(*t_args, ignore_miss, i_chunk=n_ind)
    np.testing.assert_array_equal(t_out[1].numpy(), whole[1].numpy())
    nan = np.isnan(t_out[0].numpy())
    np.testing.assert_allclose(np.where(nan, 0, t_out[0].numpy()),
                               np.where(nan, 0, whole[0].numpy()),
                               atol=1e-6, rtol=0)
