"""The redesigned rows kernel (pair_em_rows) as far as a machine without
CUDA reaches it: its launch arithmetic (block width from the resident
warps, a pair's slot of shared memory, blocks an SM, the rung's ceiling
and the refusal one past it), its place in the gather ladder, the wrapper
on CPU tensors, and its plain version against the JAX package's rows
kernel (interpret mode) on both sides of every change of the block width.
For the CPU the H100's shared memory stands in
(kernels/build.py::NOMINAL_SMEM). The kernel itself is held against its
plain version by the `gpu`-marked tests and by chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ngsld_tpu.kernels import pallas_em as jem
from ngsld_tpu.ops.em import pair_em as j_pair_em
from ngsld_tpu.utils.simulate import simulate
from ngsld_tpu_torch.kernels import pair_em as kmod
from ngsld_tpu_torch.kernels.build import NOMINAL_SMEM

SM_BYTES = NOMINAL_SMEM[1] + 1024    # an H100 SM's shared memory
# (last cohort, first cohort) of each change of the block width on an H100
WIDTH_STEPS = {4: ((1168, 1169), (2378, 2379), (4800, 4801)),
               8: ((584, 585), (1189, 1190), (2400, 2401))}


@pytest.fixture(autouse=True)
def small_threads():
    # the plain versions run many small tensor ops: more threads only
    # fight the other test workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ launch arithmetic

def test_block_shared_memory():
    """A block holds two slots of its warps' four sums (2 x 4 doubles a
    warp), then both rows of its pair in the table dtype, 6 I values."""
    assert kmod.rows_smem_bytes(4000) == 96_000
    assert kmod.rows_smem_bytes(4000, 8) == 192_000
    assert kmod.rows_block_smem(4000, 4, 256) == 2 * 4 * 8 * 8 + 96_000
    assert kmod.rows_block_smem(4000, 8, 512) == 2 * 4 * 16 * 8 + 192_000


@pytest.mark.parametrize("n_ind,itemsize", [
    (n, 4) for n in (1, 701, 800, 1200, 2048, 4000, 4821, 9642)] + [
    (n, 8) for n in (1, 201, 300, 800, 2048, 4821)])
def test_width_follows_the_warps_an_sm(n_ind, itemsize):
    """The smallest power of two from 64 to 512 whose blocks, as many as
    an SM's shared memory holds, leave 16 warps an SM."""
    assert kmod.ROWS_WARPS_SM == 16 and kmod.ROWS_THREADS == 512

    def blocks(t):
        return SM_BYTES // (6 * n_ind * itemsize + 2 * t + 1024)

    t = kmod.rows_threads(n_ind, itemsize)
    assert t in (64, 128, 256, 512)
    assert blocks(t) * t >= 16 * 32 or t == 512
    if t > 64:
        assert blocks(t // 2) * (t // 2) < 16 * 32


@pytest.mark.parametrize("itemsize", [4, 8])
def test_width_steps(itemsize):
    """Where the width changes: 64 to 128 to 256 to 512 threads, the last
    step where an SM no longer holds two blocks."""
    widths = [64, 128, 256, 512]
    for (lo, hi), (a, b) in zip(WIDTH_STEPS[itemsize],
                                zip(widths, widths[1:])):
        assert kmod.rows_threads(lo, itemsize) == a
        assert kmod.rows_threads(hi, itemsize) == b
    lo, hi = WIDTH_STEPS[itemsize][-1]
    assert kmod.rows_pairs_sm(lo, itemsize) == 2
    assert kmod.rows_pairs_sm(hi, itemsize) == 1


def test_pairs_an_sm():
    """By shared memory, by the SM's 2,048 threads, at most 32."""
    assert kmod.rows_pairs_sm(800) == 11        # 64 threads, shared memory
    assert kmod.rows_threads(800) == 64
    assert kmod.rows_pairs_sm(4000) == 2
    assert kmod.rows_threads(4000) == 256
    assert kmod.rows_pairs_sm(9642) == 1
    assert kmod.rows_threads(9642) == 512
    assert kmod.rows_pairs_sm(300, 8) == 15
    assert kmod.rows_pairs_sm(1, 4) == 32                    # block limit
    assert kmod.rows_pairs_sm(100, 4, threads=512) == 4      # threads


def test_ceiling():
    """The rung holds at least 9,642 individuals in f32 and 4,821 in f64:
    a block of 512 threads with both rows within the opt-in shared
    memory."""
    assert kmod.rows_max_ind(4) == 9642 and kmod.rows_max_ind(8) == 4821
    for itemsize in (4, 8):
        top = kmod.rows_max_ind(itemsize)
        assert kmod.rows_threads(top, itemsize) == 512
        assert kmod.rows_block_smem(top, itemsize, 512) <= NOMINAL_SMEM[1] \
            < kmod.rows_block_smem(top + 1, itemsize, 512)


def _cpu_case(n_ind, n_pairs=6, n_sites=3, dtype=np.float32):
    rng = np.random.default_rng(n_ind)
    gl = rng.random((n_sites, n_ind, 3)).astype(dtype)
    gl /= gl.sum(axis=2, keepdims=True)
    maf = ((gl[..., 1] + 2 * gl[..., 2]).mean(axis=1) / 2).astype(dtype)
    sidx = rng.integers(0, n_sites, (2, n_pairs)).astype(np.int32)
    return torch.from_numpy(gl), torch.from_numpy(sidx), torch.from_numpy(maf)


def _as_card(monkeypatch):
    """Send the wrappers down their CUDA path on CPU tensors, with the
    launches recorded instead of made."""
    calls = []

    def launch(lib_name, fn_stem, gn, sidx, maf, ign, pre=(), post=()):
        calls.append((lib_name, fn_stem, tuple(pre), len(post)))
        return kmod._empty(gn, sidx)

    monkeypatch.setattr(kmod, "_device_kind", lambda gn, name: "cuda")
    monkeypatch.setattr(kmod, "_launch", launch)
    return calls


@pytest.mark.parametrize("dtype,top", [(np.float32, 9642),
                                       (np.float64, 4821)])
def test_launch_width_and_refusal_one_past_the_ceiling(monkeypatch, dtype,
                                                       top):
    calls = _as_card(monkeypatch)
    n0 = kmod.LAUNCHES_ROWS
    kmod.pair_em_rows(*_cpu_case(top, dtype=dtype), True)
    assert calls[-1] == ("pair_em_rows", "ngsld_pair_em_rows", (512,), 0)
    assert kmod.LAUNCHES_ROWS == n0 + 1
    kmod.pair_em_rows(*_cpu_case(800, dtype=dtype), False)
    assert calls[-1][2] == (kmod.rows_threads(800, np.dtype(dtype).itemsize),)
    esz = np.dtype(dtype).itemsize
    need = kmod.rows_block_smem(top + 1, esz, 512)
    with pytest.raises(ValueError, match=f"{top + 1} individuals need {need} "
                       f"bytes .* allows {NOMINAL_SMEM[1]}; use "
                       "pair_em_ichunk"):
        kmod.pair_em_rows(*_cpu_case(top + 1, n_sites=2, dtype=dtype), False)
    assert kmod.LAUNCHES_ROWS == n0 + 2 and len(calls) == 2
    # no pairs: nothing to launch
    gn, sidx, maf = _cpu_case(37, dtype=dtype)
    out = kmod.pair_em_rows(gn, sidx[:, :0], maf, False)
    assert out[0].shape == (0, 4) and kmod.LAUNCHES_ROWS == n0 + 2


@pytest.mark.parametrize("itemsize", [4, 8])
def test_ladder_around_the_rung(itemsize):
    """From GATHER_MIN_PAIRS pairs on (65,536 for f32 tables, 32,768 for
    f64; the sweep's default block of 524,288 among them): gather to
    GATHER_MAX_IND, rows from one past it to the ceiling. On smaller blocks
    (a sampled large-cohort block, a run's last block) rows from one
    individual on. ichunk one past the ceiling at every block size."""
    assert kmod.GATHER_MAX_IND == {4: 500, 8: 250}
    assert kmod.GATHER_MIN_PAIRS == {4: 65_536, 8: 32_768}
    last = kmod.GATHER_MAX_IND[itemsize]
    least = kmod.GATHER_MIN_PAIRS[itemsize]
    top = kmod.rows_max_ind(itemsize)
    for n_pairs in (least, 65_536, 524_288):
        assert kmod.pick_gather_kernel(1, itemsize, "cpu",
                                       n_pairs) == "gather"
        assert kmod.pick_gather_kernel(last, itemsize, "cpu",
                                       n_pairs) == "gather"
        assert kmod.pick_gather_kernel(last + 1, itemsize, "cpu",
                                       n_pairs) == "rows"
    for n_pairs in (1, 8_192, 16_384, least - 1):
        for n in (1, 100, last):
            assert kmod.pick_gather_kernel(n, itemsize, "cpu",
                                           n_pairs) == "rows"
    # the block at which the two dtypes part
    assert kmod.pick_gather_kernel(200, itemsize, "cpu", 32_768) == \
        ("rows" if itemsize == 4 else "gather")
    for n_pairs in (1, 16_384, 524_288):
        assert kmod.pick_gather_kernel(top, itemsize, "cpu",
                                       n_pairs) == "rows"
        assert kmod.pick_gather_kernel(top + 1, itemsize, "cpu",
                                       n_pairs) == "ichunk"


def test_compute_block_passes_the_block_size(monkeypatch):
    """compute_block asks the ladder with the block's pair count."""
    from ngsld_tpu_torch import compute
    seen = []

    def pick(*a):
        seen.append(a)
        return "rows"

    monkeypatch.setattr(compute, "pick_gather_kernel", pick)
    gn, sidx, maf = _cpu_case(20, n_pairs=7, n_sites=4, dtype=np.float64)
    eg = gn[..., 1] + 2 * gn[..., 2]
    compute.compute_block(gn, eg, maf, sidx, False)
    assert seen == [(20, 8, gn.device, 7)]


# ------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("ignore_miss", [False, True])
def test_wrapper_on_cpu_tensors_is_the_plain_version(ignore_miss):
    gn, sidx, maf = _cpu_case(300, n_pairs=12, n_sites=5)
    n0 = kmod.LAUNCHES_ROWS
    got = kmod.pair_em_rows(gn, sidx, maf, ignore_miss)
    want = kmod.pair_em_rows_ref(gn, sidx, maf, ignore_miss)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert kmod.LAUNCHES_ROWS == n0
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


def _jax_case(n_pairs, n_ind, seed):
    sim = simulate(n_ind=n_ind, n_sites=2 * n_pairs, seed=seed,
                   all_missing_site_rate=0.05)
    gl = (sim.gl / sim.gl.sum(axis=2, keepdims=True)).astype(np.float32)
    maf = ((gl[..., 1] + 2 * gl[..., 2]).mean(axis=1) / 2).astype(np.float32)
    j_args = (jnp.asarray(gl[:n_pairs]), jnp.asarray(gl[n_pairs:]),
              jnp.asarray(maf[:n_pairs]), jnp.asarray(maf[n_pairs:]))
    sidx = np.stack([np.arange(n_pairs), n_pairs + np.arange(n_pairs)])
    return j_args, (torch.from_numpy(gl),
                    torch.from_numpy(sidx.astype(np.int32)),
                    torch.from_numpy(maf))


def _hold(t_out, j_out):
    """Against the JAX package (its kernels run the EM in f32, the port's
    plain version in f64): n_used exact, hap freqs within 3e-5, nIter
    within 1 on more than 95% of pairs."""
    tf, tn, tu = (x.numpy() for x in t_out)
    jf, jn, ju = (np.asarray(x) for x in j_out)
    np.testing.assert_array_equal(tu, ju)
    nan = np.isnan(tf) & np.isnan(jf)
    np.testing.assert_allclose(np.where(nan, 0, tf), np.where(nan, 0, jf),
                               atol=3e-5, rtol=0)
    assert (np.abs(tn.astype(np.int64) - jn) <= 1).mean() > 0.95


@pytest.mark.parametrize("n_ind", [n for step in WIDTH_STEPS[4]
                                   for n in step])
def test_plain_vs_jax_rows_kernel_at_the_width_steps(n_ind):
    """On both sides of each change of the block width (f32 tables), the
    plain version against the Pallas rows kernel in interpret mode and the
    JAX package's EM; --ignore_miss_data on at the first cohort of each
    step."""
    ignore_miss = n_ind in {hi for _, hi in WIDTH_STEPS[4]}
    j_args, t_args = _jax_case(8, n_ind, seed=n_ind)
    t_out = kmod.pair_em_rows_ref(*t_args, ignore_miss)
    _hold(t_out, jem.pair_em_rows_from_gl(*j_args, ignore_miss, pair_tile=8,
                                          interpret=True))
    _hold(t_out, j_pair_em(*j_args, ignore_miss))
