"""The port's ring sweep on one device (--ring) on the CPU, held against the
JAX package and against --engine strict.

Module level, each against the JAX function on a one-device mesh: the
emission mask, its packed sampling bits and the on-device compaction
(exact); the gather stepper against the JAX package's compacted XLA
stepper (rows in the same order, n_iter / n_used exact, f and r2p within
1e-12 in f64); the strip stepper on one 256 x 128 step whose shifted band
bounds run below 0 and past the sub-block, against the Pallas strip
kernel in interpret mode, under the reference's kernel contract (hap
freqs within 3e-5, n_used exact, nIter within 1 on more than 95% of the
rows, r2p within 2e-5).

CLI level, each mirroring a one-device case of tests/test_parallel.py and
tests/test_checkpoint.py: the port's --ring (f64, the kernels' plain
versions) against strict under `compare`, and in the pair columns
against the JAX ring at --shard 1 where named; the ring loader; the
spill merge; checkpoint and resume; the auto-route; the forced strip
stepper under `cmp_vs_strict`; the refusal of the CPU unless asked. The
ring across devices is tests/test_torch_ringmesh*.py's.
"""

import io
import os
import tracemalloc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsld_tpu.cli import params_from_args as j_params_from_args
from ngsld_tpu.engine import run_jax
from ngsld_tpu.kernels import pallas_strip as jstrip
from ngsld_tpu.parallel import ring as jring
from ngsld_tpu.utils.simulate import simulate, write_all, write_glf_bin
from ngsld_tpu_torch import strict
from ngsld_tpu_torch.cli import main, params_from_args
from ngsld_tpu_torch.engine import run_torch
from ngsld_tpu_torch.kernels import strip_em as tstrip
from ngsld_tpu_torch.loaders import RING_SLAB_BYTES, _ring_sharded_tables
from ngsld_tpu_torch.parallel import ring as tring
from ngsld_tpu_torch.plan.strips import TA, TB
from ngsld_tpu_torch.strict import StrictError
from ngsld_tpu_torch.utils.conformance import cmp_vs_strict, compare
from ngsld_tpu_torch.utils.logging import RunLog


@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    # tests/conftest.py turns the auto-route off for every test; the
    # auto-route tests turn it back on
    monkeypatch.setenv("NGSLD_RING_AUTOROUTE", "0")
    # the plain versions run many small tensor ops: more threads only
    # fight the other test workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("sites",))


def _cfg(n, B, B_sub, sample, slim_im=True):
    return dict(n=n, B=B, B_sub=B_sub, n_dev=1, sample=sample,
                slim_im=slim_im, use_i16=True)


def _bits(rng, area):
    """A random membership plane, packed as the engine packs it: u32 words
    for JAX, their bytes for the port."""
    plane = rng.random(area) < 0.5
    by = np.packbits(plane, bitorder="little")
    capw = -(-area // 32)
    words = np.pad(by, (0, capw * 4 - len(by))).view(np.uint32)
    return plane, words


# ------------------------------------------------------------ module level

@pytest.mark.parametrize("area", [1, 31, 32, 1000])
def test_unpack_bits_matches_jax(area):
    rng = np.random.default_rng(area)
    plane, words = _bits(rng, area)
    j = np.asarray(jring._unpack_bits(jnp.asarray(words), area))
    t = tring._unpack_bits(torch.from_numpy(words.view(np.uint8)), area)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy(), plane)


@pytest.mark.parametrize("si,sample", [(0, False), (1, False), (1, True),
                                       (2, True)])
def test_tile_mask_matches_jax(si, sample):
    n, B, B_sub = 90, 96, 32          # 6 pad sites; three sub-rings
    rng = np.random.default_rng(si * 2 + sample)
    hi = np.zeros(B, np.int32)
    hi[:n] = np.minimum(np.arange(n) + rng.integers(1, 60, n), n)
    ok = np.zeros(B, np.float32)
    ok[:n] = rng.random(n) < 0.8
    vok = ok[si * B_sub:(si + 1) * B_sub]
    _, words = _bits(rng, B * B_sub)
    cfg = _cfg(n, B, B_sub, sample)
    j = np.asarray(jring._tile_mask(
        jnp.int32(0), 0, si, cfg, jnp.asarray(hi), jnp.asarray(ok),
        jnp.asarray(vok), jnp.asarray(words)))
    t = tring._tile_mask(0, 0, si, cfg, torch.from_numpy(hi),
                         torch.from_numpy(ok), torch.from_numpy(vok),
                         torch.from_numpy(words.view(np.uint8)))
    np.testing.assert_array_equal(t.numpy(), j)
    assert j.any() and not j.all()


@pytest.mark.parametrize("slim_im", [True, False])
def test_device_compact_matches_jax(slim_im):
    B, B_sub = 40, 24
    rng = np.random.default_rng(7)
    r2p = rng.random((B, B_sub)).astype(np.float32)
    f = rng.random((B, B_sub, 4)).astype(np.float32)
    nit = rng.integers(0, 101, (B, B_sub)).astype(np.int32)
    nu = rng.integers(0, 30, (B, B_sub)).astype(np.int32)
    valid = rng.random((B, B_sub)) < 0.3
    cfg = _cfg(B, B, B_sub, False, slim_im)
    jfm, jim, jcnt = jring._device_compact(
        jnp.asarray(r2p), jnp.asarray(f), jnp.asarray(nit), jnp.asarray(nu),
        jnp.asarray(valid), cfg)
    tfm, tim, tcnt = tring._device_compact(
        torch.from_numpy(r2p), torch.from_numpy(f), torch.from_numpy(nit),
        torch.from_numpy(nu), torch.from_numpy(valid), cfg)
    assert tcnt == int(jcnt) == valid.sum()
    np.testing.assert_array_equal(tfm.numpy(), np.asarray(jfm)[:tcnt])
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim)[:tcnt])
    assert tim.dtype == (torch.int8 if slim_im else torch.int16)


def _step_tables(S, I, seed, missing=0.0):
    sim = simulate(n_ind=I, n_sites=S, seed=seed,
                   all_missing_site_rate=missing)
    gn = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    eg = gn[..., 1] + 2 * gn[..., 2]
    maf = eg.mean(axis=1) / 2
    return gn, eg, maf


@pytest.mark.parametrize("ignore_miss,sample", [(False, False),
                                                (True, True)])
def test_gather_stepper_matches_jax_stepper(ignore_miss, sample):
    """The port's gather stepper (live cells through compute_block, in
    pieces) against the JAX package's compacted XLA stepper, f64."""
    jax.config.update("jax_enable_x64", True)
    n, B, B_sub, I, si = 60, 64, 32, 8, 1
    gn, eg, maf = _step_tables(B, I, seed=11, missing=0.05)
    rng = np.random.default_rng(3)
    hi = np.zeros(B, np.int32)
    hi[:n] = np.minimum(np.arange(n) + rng.integers(1, 50, n), n)
    ok = np.zeros(B, np.float32)
    ok[:n] = rng.random(n) < 0.9
    _, words = _bits(rng, B * B_sub)
    cfg = _cfg(n, B, B_sub, sample, slim_im=not ignore_miss)
    sl = slice(si * B_sub, (si + 1) * B_sub)
    j_step = jring.ring_sweep_stepper(_mesh1(), ignore_miss, True,
                                      row_chunk=256, compact_cfg=cfg)
    j_args = [jnp.asarray(x) for x in (gn, eg, maf, hi, ok, gn[sl], eg[sl],
                                       maf[sl], ok[sl])]
    (jfm, jim, jcnt), *_ = j_step(*j_args, jnp.int32(0), jnp.int32(si),
                                  *([jnp.asarray(words)[None]] if sample
                                    else []))
    cnt = int(np.asarray(jcnt)[0])
    t_args = [torch.from_numpy(np.ascontiguousarray(x)) for x in
              (gn, eg, maf, hi, ok)]
    vis = tring.ring_subblock_taker(1, 2, si, with_ok=True)(
        t_args[0], t_args[1], t_args[2], t_args[4])
    # pieces of 37 pairs: several compute_block calls a step
    t_step = tring.ring_sweep_stepper(ignore_miss, 37, cfg)
    (tfm, tim, tcnt), *t_vis = t_step(
        *t_args, *vis, 0, si,
        torch.from_numpy(words.view(np.uint8)) if sample else None)
    assert tcnt == cnt > 37 and tfm.dtype == torch.float64
    assert all(a is b for a, b in zip(t_vis, vis))   # stays in place
    jfm, jim = np.asarray(jfm)[0, :cnt], np.asarray(jim)[0, :cnt]
    np.testing.assert_array_equal(tim.numpy(), jim)
    fm = tfm.numpy()
    both_nan = np.isnan(fm) & np.isnan(jfm)
    np.testing.assert_allclose(np.where(both_nan, 0, fm),
                               np.where(both_nan, 0, jfm), atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("si,ignore_miss", [(0, False), (1, False),
                                             (1, True)])
def test_strip_stepper_matches_jax_on_shifted_bounds(si, ignore_miss):
    """One 256 x 128 step: sub-ring 0 (partners 0..127), where hi runs
    past B_sub, or sub-ring 1 (partners 128..255), where lo runs negative
    and hi below 0. The port's strip stepper (plain version) against the
    JAX package's in interpret mode."""
    n, B, B_sub, I = 250, 256, 128, 6
    gn, eg, maf = _step_tables(B, I, seed=19, missing=0.03)
    rng = np.random.default_rng(5)
    hi = np.zeros(B, np.int32)
    hi[:n] = np.minimum(np.arange(n) + rng.integers(1, 220, n), n)
    ok = np.zeros(B, np.float32)
    ok[:n] = rng.random(n) < 0.95
    org = si * B_sub
    lo_sh, hi_sh = np.arange(1, B + 1) - org, hi - org
    if si:
        assert (lo_sh < 0).any() and (hi_sh < 0).any()
    else:
        assert (hi_sh > B_sub).any()
    cfg = _cfg(n, B, B_sub, False, slim_im=not ignore_miss)
    sl = slice(si * B_sub, (si + 1) * B_sub)
    ga, gb, ea, eb = jstrip.strip_tables(jnp.asarray(gn, jnp.float32),
                                         jnp.asarray(eg, jnp.float32),
                                         n_ind=I)
    j_step = jring.ring_sweep_stepper_strip(
        _mesh1(), I, B, B_sub, ignore_miss, True, interpret=True,
        compact_cfg=cfg)
    maf32 = jnp.asarray(maf, jnp.float32)
    (jfm, jim, jcnt), *_ = j_step(
        ga, ea, jnp.asarray(hi), jnp.asarray(ok), maf32, gb[:, :, sl],
        eb[:, sl], maf32[sl], jnp.asarray(ok)[sl], jnp.int32(0),
        jnp.int32(si))
    cnt = int(np.asarray(jcnt)[0])
    tga, tgb, tea, teb = tstrip.strip_tables(
        torch.from_numpy(gn), torch.from_numpy(eg), I)
    tmaf = torch.from_numpy(maf.astype(np.float32))
    tok, thi = torch.from_numpy(ok), torch.from_numpy(hi)
    vis = tring.ring_subblock_taker_strip(1, 2, si)(tgb, teb, tmaf, tok)
    t_step = tring.ring_sweep_stepper_strip(I, B, B_sub, ignore_miss, cfg)
    (tfm, tim, tcnt), *_ = t_step(tga, tea, thi, tok, tmaf, *vis, 0, si)
    assert tcnt == cnt > 1000 and tfm.dtype == torch.float32
    # the stepper's (tile, cell) gather is _device_compact of the kernel's
    # outputs rearranged to (B, B_sub), as the reference compacts them
    nk, nj = B // TA, B_sub // TB
    org_t = torch.tensor(org, dtype=torch.int32)
    outs = tstrip.strip_em(
        tga, vis[0], tea, vis[1], tmaf, vis[2],
        torch.arange(1, B + 1, dtype=torch.int32) - org_t, thi - org_t,
        tok, vis[3],
        torch.arange(nk, dtype=torch.int32).repeat_interleave(nj),
        torch.arange(nj, dtype=torch.int32).repeat(nk), n_ind=I,
        ignore_miss=ignore_miss)

    def rearrange(x):   # (n, [4,] TA, TB) -> (B, B_sub[, 4])
        if x.dim() == 4:
            return x.reshape(nk, nj, 4, TA, TB).permute(0, 3, 1, 4, 2) \
                .reshape(B, B_sub, 4)
        return x.reshape(nk, nj, TA, TB).permute(0, 2, 1, 3) \
            .reshape(B, B_sub)

    f_, r2p_, nit_, nu_ = outs
    rfm, rim, rcnt = tring._device_compact(
        rearrange(r2p_), rearrange(f_), rearrange(nit_), rearrange(nu_),
        tring._tile_mask(0, 0, si, cfg, thi, tok, vis[3], None), cfg)
    assert rcnt == tcnt and torch.equal(rim, tim)
    torch.testing.assert_close(rfm, tfm, rtol=0, atol=0, equal_nan=True)
    jfm, jim = np.asarray(jfm)[0, :cnt], np.asarray(jim)[0, :cnt]
    fm, im = tfm.numpy(), tim.numpy()
    if ignore_miss:
        np.testing.assert_array_equal(im[:, 1], jim[:, 1])   # n_used
    assert (np.abs(im[:, 0].astype(int) - jim[:, 0]) <= 1).mean() > 0.95
    nan = np.isnan(fm) & np.isnan(jfm)
    fm, jfm = np.where(nan, 0, fm), np.where(nan, 0, jfm)
    np.testing.assert_allclose(fm[:, 1:], jfm[:, 1:], atol=3e-5, rtol=0)
    np.testing.assert_allclose(fm[:, 0], jfm[:, 0], atol=2e-5, rtol=0)


def test_partner_index_and_steps_for_band_match_jax():
    hi = np.minimum(np.arange(64) + 9, 64)
    for t in (0, 1, 3):
        for a in (0, 5, 17, 63):
            np.testing.assert_array_equal(
                tring.partner_index(t, a, 8, 64),
                jring.partner_index(t, a, 8, 64))
    assert tring.steps_for_band(hi, 8) == jring.steps_for_band(hi, 8) == 2
    assert tring.steps_for_band(np.zeros(0, int), 8) == 1


# --------------------------------------------------------------- CLI level

def _run_port(argv, out):
    assert main(argv + ["--out", str(out)]) == 0
    return out.read_text().splitlines()


def _run_strict(argv, out):
    strict.run(params_from_args(argv + ["--engine", "strict",
                                        "--out", str(out)]))
    return out.read_text().splitlines()


def _run_jax_ring(argv, out):
    run_jax(j_params_from_args(argv + ["--ring", "--shard", "1",
                                       "--out", str(out)]))
    return out.read_text().splitlines()


def _pairs(rows):
    return [r.split("\t")[:2] for r in rows]


@pytest.mark.parametrize("case", ["kb2", "all_pairs", "call_geno_ignore_miss",
                                  "rnd_sample"])
def test_ring_cli_matches_strict_and_the_jax_ring(tmp_path, case):
    """tests/test_parallel.py:146-293 at one device: the port's ring
    against strict (f64 column contract) and, in the pair columns,
    against the JAX package's ring at --shard 1."""
    kw = dict(
        kb2=dict(sim=dict(n_ind=10, n_sites=120, seed=77, contig_kb=3.0),
                 flags=["--max_kb_dist", "2", "--extend_out"], sub="2"),
        all_pairs=dict(sim=dict(n_ind=6, n_sites=48, seed=3, contig_kb=2.0),
                       flags=["--max_kb_dist", "0", "--min_maf", "0.05"],
                       sub="2"),
        call_geno_ignore_miss=dict(
            sim=dict(n_ind=8, n_sites=96, seed=13, contig_kb=3.0,
                     all_missing_site_rate=0.05),
            flags=["--max_kb_dist", "2", "--call_geno", "--N_thresh", "0.3",
                   "--call_thresh", "0.9", "--ignore_miss_data",
                   "--extend_out"], sub="3"),
        rnd_sample=dict(sim=dict(n_ind=8, n_sites=200, seed=21,
                                 contig_kb=3.0),
                        flags=["--max_kb_dist", "2", "--min_maf", "0.05",
                               "--rnd_sample", "0.4", "--seed", "12345",
                               "--extend_out"], sub="2"))[case]
    sim = simulate(**kw["sim"])
    files = write_all(sim, str(tmp_path / "fix"))
    n = str(kw["sim"]["n_sites"])
    argv = ["--geno", files["beagle"], "--probs", "--n_ind",
            str(kw["sim"]["n_ind"]), "--n_sites", n, "--pos", files["pos"],
            "--verbose", "0"] + kw["flags"]
    s_rows = _run_strict(argv, tmp_path / "s.ld")
    r_rows = _run_port(argv + ["--ring", "--ring_sub", kw["sub"]],
                       tmp_path / "r.ld")
    assert len(s_rows) > 20
    compare(s_rows, r_rows)
    j_rows = _run_jax_ring(argv + ["--ring_sub", kw["sub"]],
                           tmp_path / "j.ld")
    assert _pairs(j_rows) == _pairs(r_rows)
    if case == "all_pairs":
        assert any("\tinf\t" in r for r in r_rows)   # cross-contig pairs
    if case == "rnd_sample":
        # sampling thinned the band
        full = _run_strict([a for a in argv if a not in ("--rnd_sample",
                                                          "0.4")],
                           tmp_path / "full.ld")
        assert len(s_rows) < len(full)


def test_ring_binary_input_matches_the_block_engine(tmp_path):
    """Binary GL input: the ring loader's raw records, normalised on the
    device, byte-equal to the block engine's run (f64)."""
    files = write_all(simulate(n_ind=10, n_sites=160, seed=31,
                               contig_kb=3.0), str(tmp_path / "fix"))
    argv = ["--geno", files["glf"], "--log_scale", "--n_ind", "10",
            "--n_sites", "160", "--pos", files["pos"], "--max_kb_dist", "2",
            "--extend_out", "--precision", "f64", "--verbose", "0"]
    b_out, r_out = tmp_path / "b.ld", tmp_path / "r.ld"
    _run_port(argv, b_out)
    _run_port(argv + ["--ring", "--ring_sub", "2"], r_out)
    assert b_out.read_bytes() == r_out.read_bytes()
    assert len(r_out.read_text().splitlines()) > 40


@pytest.mark.parametrize("route", ["text", "read_geno"])
def test_ring_text_load_matches_read_geno(tmp_path, monkeypatch, route):
    """The gz-text route (and the strict.read_geno fallback) deliver
    exactly read_geno's log-normalised records, pad rows uniform."""
    if route == "read_geno":
        monkeypatch.setenv("NGSLD_NO_FASTTEXT", "1")
    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")   # several slabs
    n, m, B = 100, 7, 112
    files = write_all(simulate(n_ind=m, n_sites=n, seed=23),
                      str(tmp_path / "fix"))
    pars = params_from_args(
        ["--geno", files["beagle"], "--probs", "--n_ind", str(m),
         "--n_sites", str(n), "--pos", files["pos"], "--ring",
         "--verbose", "0"])
    gl, raw = _ring_sharded_tables(pars, 1, B, B, np.float64, RunLog(0),
                                   "cpu")
    assert not raw and gl.shape == (B, m, 3)
    ref = strict.read_geno(files["beagle"], False, True, False, m, n)
    np.testing.assert_array_equal(gl.numpy()[:n], np.asarray(ref))
    np.testing.assert_array_equal(gl.numpy()[n:], np.log(1.0 / 3.0))


def test_ring_load_host_memory_bounded(tmp_path):
    """At one device the ring's one block is the whole table: the loader
    fills it slab by slab, so its host (numpy/Python) peak stays below the
    file's size; the records are exactly the file's."""
    n, m = 16384, 100
    glf = str(tmp_path / "sim.glf")
    write_glf_bin(simulate(n_ind=m, n_sites=n, seed=9, contig_kb=40.0), glf)
    file_bytes = os.path.getsize(glf)
    assert file_bytes > 35_000_000   # the bound below must mean something
    pars = params_from_args(
        ["--geno", glf, "--log_scale", "--n_ind", str(m),
         "--n_sites", str(n), "--max_kb_dist", "0", "--ring",
         "--verbose", "0"])
    B = n + 128
    tracemalloc.start()
    try:
        gl, raw = _ring_sharded_tables(pars, 1, B, B, np.float64, RunLog(0),
                                       "cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert raw   # binary fast path taken
    # one slab (and its narrowed copy, with the NaN checks' masks), not
    # the table
    assert peak < file_bytes and peak < 2 * RING_SLAB_BYTES, \
        (peak, file_bytes)
    ref = np.fromfile(glf, np.float64).reshape(n, m, 3)
    np.testing.assert_array_equal(gl.numpy()[:n], ref)
    np.testing.assert_array_equal(gl.numpy()[n:], np.log(1.0 / 3.0))


def test_ring_emit_merge_chunking_invariant(tmp_path, monkeypatch):
    """The bounded-memory spill merge is byte-identical whatever its
    anchor-chunk budget."""
    files = write_all(simulate(n_ind=6, n_sites=120, seed=51,
                               contig_kb=3.0), str(tmp_path / "fix"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "6",
            "--n_sites", "120", "--pos", files["pos"], "--max_kb_dist", "0",
            "--extend_out", "--ring", "--ring_sub", "2", "--verbose", "0"]
    outs = []
    for budget in ("1", "37", "1000000"):
        monkeypatch.setenv("NGSLD_RING_EMIT_ROWS", budget)
        out = tmp_path / f"o{budget}.ld"
        _run_port(argv, out)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2]
    assert outs[0].count(b"\n") == 1 + 120 * 119 // 2


@pytest.fixture(scope="module")
def ckfix(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ck"))
    return write_all(simulate(n_ind=8, n_sites=150, seed=41), d)


def _ring_argv(ckfix, *extra):
    # all pairs, so every sub-ring holds rows
    return ["--geno", ckfix["beagle"], "--probs", "--n_ind", "8",
            "--n_sites", "150", "--pos", ckfix["pos"], "--max_kb_dist", "0",
            "--min_maf", "0.05", "--seed", "5", "--extend_out",
            "--precision", "f64", "--verbose", "0", "--ring",
            "--ring_sub", "3", *extra]


def _ring_bytes(argv):
    out = io.BytesIO()
    run_torch(params_from_args(argv), out_fh=out)
    return out.getvalue()


def test_ring_checkpoint_output_identical(ckfix, tmp_path):
    plain = _ring_bytes(_ring_argv(ckfix))
    ck = _ring_bytes(_ring_argv(ckfix, "--checkpoint", str(tmp_path / "rck")))
    assert plain == ck and plain.count(b"\n") > 1000
    steps = [p for p in os.listdir(tmp_path / "rck")
             if p.startswith("ring_") and p.endswith(".done")]
    assert len(steps) == 3   # one step a sub-ring on one device


def test_ring_resume_by_sub_ring(ckfix, tmp_path):
    """On one device every sub-ring has one step (t = 0), so a crash
    mid-sweep leaves a prefix of whole sub-rings: delete the later
    sub-rings' files (not the reference's later steps, of which there are
    none) and resume."""
    cdir = tmp_path / "rck"
    first = _ring_bytes(_ring_argv(ckfix, "--checkpoint", str(cdir)))
    removed = 0
    for p in os.listdir(cdir):
        if p.startswith("ring_") and "_s0000_" not in p:
            os.remove(cdir / p)
            removed += 1
    assert removed >= 4   # two sub-rings' tiles and markers
    log_counts = {}
    orig = RunLog.summary

    def keep(self):
        log_counts.update(self.counters)
        orig(self)

    RunLog.summary = keep
    try:
        second = _ring_bytes(_ring_argv(ckfix, "--checkpoint", str(cdir)))
    finally:
        RunLog.summary = orig
    assert first == second
    assert log_counts["ring_steps_resumed"] == 1
    assert log_counts["ring_steps"] == 2


def test_ring_manifest_guards_decomposition(ckfix, tmp_path):
    cdir = tmp_path / "rck"
    _ring_bytes(_ring_argv(ckfix, "--checkpoint", str(cdir)))
    argv = _ring_argv(ckfix, "--checkpoint", str(cdir))
    argv[argv.index("--ring_sub") + 1] = "1"
    with pytest.raises(StrictError, match="different run configuration"):
        _ring_bytes(argv)
    # the stepper is part of the fingerprint: strip tiles never mix with
    # gather tiles
    os.environ["NGSLD_FORCE_STRIP"] = "1"
    try:
        with pytest.raises(StrictError, match="different run configuration"):
            _ring_bytes(_ring_argv(ckfix, "--checkpoint", str(cdir)))
    finally:
        del os.environ["NGSLD_FORCE_STRIP"]


def test_ring_narrow_band_autoroutes_to_block(tmp_path, monkeypatch, capfd):
    """A band inside one ring step's partner sub-block runs the block
    engine, byte-equal, and the log says so; an explicit --ring_sub pins
    the ring."""
    monkeypatch.setenv("NGSLD_RING_AUTOROUTE", "1")
    files = write_all(simulate(n_ind=8, n_sites=256, seed=88,
                               contig_kb=10.0), str(tmp_path / "fx"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "8",
            "--n_sites", "256", "--pos", files["pos"], "--max_kb_dist",
            "1", "--extend_out"]
    b_out = tmp_path / "block.ld"
    _run_port(argv + ["--verbose", "0"], b_out)
    r_out = tmp_path / "ring.ld"
    _run_port(argv + ["--ring", "--verbose", "1"], r_out)
    assert "auto-route" in capfd.readouterr().err
    assert r_out.read_bytes() == b_out.read_bytes()
    r2_out = tmp_path / "ring2.ld"
    _run_port(argv + ["--ring", "--ring_sub", "2", "--verbose", "2"], r2_out)
    err = capfd.readouterr().err
    assert "auto-route" not in err and "ring: gather stepper" in err
    assert _pairs(b_out.read_text().splitlines()) \
        == _pairs(r2_out.read_text().splitlines())


def test_ring_wide_band_stays_on_ring(tmp_path, monkeypatch, capfd):
    """All pairs over 64 sites with a 1,000-cell step area: 5 sub-blocks,
    each far narrower than the band, so no auto-route."""
    monkeypatch.setenv("NGSLD_RING_AUTOROUTE", "1")
    monkeypatch.setenv("NGSLD_RING_AREA", "1000")
    files = write_all(simulate(n_ind=6, n_sites=64, seed=89,
                               contig_kb=2.0), str(tmp_path / "fx"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "6",
            "--n_sites", "64", "--pos", files["pos"], "--max_kb_dist",
            "0", "--verbose", "2", "--ring"]
    rows = _run_port(argv, tmp_path / "r.ld")
    err = capfd.readouterr().err
    assert "auto-route" not in err and "5 sub-blocks of 13" in err
    assert len(rows) == 1 + 64 * 63 // 2


def test_forced_strip_stepper_matches_strict(tmp_path, monkeypatch, capfd):
    """NGSLD_FORCE_STRIP=1: the strip stepper (plain version on the CPU,
    f32 values in an f64 run, refine's tiers keyed on f32) against
    strict under the f32 column contract."""
    monkeypatch.setenv("NGSLD_FORCE_STRIP", "1")
    files = write_all(simulate(n_ind=8, n_sites=250, seed=101,
                               contig_kb=50.0), str(tmp_path / "fx"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "8",
            "--n_sites", "250", "--pos", files["pos"], "--max_kb_dist", "0",
            "--max_snp_dist", "60", "--min_maf", "0.05", "--rnd_sample",
            "0.6", "--seed", "101", "--extend_out"]
    s_rows = _run_strict(argv + ["--verbose", "0"], tmp_path / "s.ld")
    r_rows = _run_port(argv + ["--ring", "--ring_sub", "2", "--verbose",
                               "2"], tmp_path / "r.ld")
    assert "ring: strip-kernel stepper" in capfd.readouterr().err
    cmp_vs_strict(s_rows, r_rows, 30)


def test_strip_stepper_failure_ends_the_run(tmp_path, monkeypatch):
    """A strip kernel that fails on the ring's first step ends the run with
    its error: no retry on the gather stepper, no rows."""
    monkeypatch.setenv("NGSLD_FORCE_STRIP", "1")

    def broken(*a, **kw):
        raise RuntimeError("strip_em CUDA kernel launch failed: cudaError 98")

    def no_gather(*a, **kw):
        raise AssertionError("the gather stepper ran")

    monkeypatch.setattr(tring, "strip_em_compact", broken)
    monkeypatch.setattr(tring.compute, "compute_block", no_gather)
    files = write_all(simulate(n_ind=4, n_sites=40, seed=2),
                      str(tmp_path / "fx"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "4",
            "--n_sites", "40", "--pos", files["pos"], "--max_kb_dist", "0",
            "--ring", "--ring_sub", "2", "--verbose", "0"]
    out = io.BytesIO()
    with pytest.raises(RuntimeError, match="cudaError 98"):
        run_torch(params_from_args(argv), out_fh=out)
    assert out.getvalue().count(b"\n") <= 1   # the header at most


def test_ring_refuses_the_cpu_unless_asked(tmp_path, monkeypatch, capsys):
    """--ring, like every run: no CUDA device and no NGSLD_PLATFORM=cpu
    is a refusal, with no rows."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine would run on it")
    monkeypatch.delenv("NGSLD_PLATFORM")
    files = write_all(simulate(n_ind=4, n_sites=20, seed=1),
                      str(tmp_path / "fx"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "4",
            "--n_sites", "20", "--pos", files["pos"], "--ring",
            "--ring_sub", "2"]
    assert main(argv + ["--out", str(tmp_path / "x.ld")]) == 1
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out == ""
    assert not os.path.exists(tmp_path / "x.ld")
