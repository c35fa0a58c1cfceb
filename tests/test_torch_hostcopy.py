"""The port's own copies of the host modules (ngsld_tpu_torch/{strict,
gsl_rng,config,cli,refine,checkpoint,hostcols,loaders}.py, plan/band.py,
io/writer.py, utils/simulate.py, native/) against the JAX package's: the
same inputs, made from a numpy seed, go through both packages and the
outputs are equal exactly. With and without the native library
(NGSLD_NO_NATIVE=1 takes the pure-Python paths of both)."""

import dataclasses
import io
import os

import numpy as np
import pytest

import ngsld_tpu.checkpoint as j_ckpt
import ngsld_tpu.cli as j_cli
import ngsld_tpu.engine_block as j_eb
import ngsld_tpu.gsl_rng as j_rng
import ngsld_tpu.loaders as j_loaders
import ngsld_tpu.native as j_native
import ngsld_tpu.refine as j_refine
import ngsld_tpu.strict as j_strict
import ngsld_tpu.utils.simulate as j_sim
import ngsld_tpu_torch.checkpoint as t_ckpt
import ngsld_tpu_torch.cli as t_cli
import ngsld_tpu_torch.engine_block as t_eb
import ngsld_tpu_torch.gsl_rng as t_rng
import ngsld_tpu_torch.hostcols as t_hc
import ngsld_tpu_torch.loaders as t_loaders
import ngsld_tpu_torch.native as t_native
import ngsld_tpu_torch.refine as t_refine
import ngsld_tpu_torch.strict as t_strict
import ngsld_tpu_torch.utils.simulate as t_sim
from ngsld_tpu.io.writer import RowWriter as JRowWriter
from ngsld_tpu.plan import band as j_band
from ngsld_tpu_torch.io.writer import RowWriter as TRowWriter
from ngsld_tpu_torch.plan import band as t_band
from ngsld_tpu_torch.utils.logging import RunLog


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    sim = j_sim.simulate(n_ind=10, n_sites=300, seed=31,
                         all_missing_site_rate=0.02, mono_rate=0.05)
    return j_sim.write_all(sim, str(tmp_path_factory.mktemp("hostcopy")))


def _argv(files, extra, geno="beagle"):
    inp = {"beagle": ["--geno", files["beagle"], "--probs"],
           "geno_text": ["--geno", files["geno_text"]],
           "glf": ["--geno", files["glf"], "--log_scale"]}[geno]
    return inp + ["--n_ind", "10", "--n_sites", "300", "--pos", files["pos"],
                  "--verbose", "0"] + extra


def test_the_port_has_its_own_native_library():
    """Built from the port's own source into the port's .build/, never
    beside the source and never the JAX package's."""
    if t_native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: pure-Python host paths")
    so = t_native.get_lib()._name
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(t_native.__file__)))
    assert os.path.dirname(so) == os.path.join(pkg, ".build")
    assert j_native.get_lib() is None or j_native.get_lib()._name != so
    assert not [f for f in os.listdir(os.path.dirname(t_native.__file__))
                if f.endswith(".so")]


def test_simulate_copies_agree(tmp_path):
    a = j_sim.simulate(n_ind=7, n_sites=90, seed=5, mono_rate=0.1)
    b = t_sim.simulate(n_ind=7, n_sites=90, seed=5, mono_rate=0.1)
    for fld in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, fld.name),
                                      getattr(b, fld.name), err_msg=fld.name)
    fa = j_sim.write_all(a, str(tmp_path / "j"))
    fb = t_sim.write_all(b, str(tmp_path / "t"))
    assert sorted(fa) == sorted(fb)
    import gzip
    for k in fa:
        op = gzip.open if fa[k].endswith(".gz") else open
        with op(fa[k], "rb") as x, op(fb[k], "rb") as y:
            assert x.read() == y.read(), k


@pytest.mark.parametrize("geno,extra", [
    ("beagle", []),
    ("glf", ["-d", "0", "-D", "40", "-f", "0.1", "-m", "-c", "-N", "0.2",
             "-C", "0.9", "-r", "0.5", "-S", "7", "-x", "-o", "out.ld", "-t",
             "3"]),
    ("geno_text", ["--engine", "strict", "--precision", "f32",
                   "--chunk_pairs", "77", "--checkpoint", "ck", "--shard",
                   "2", "--shard_ind", "2", "--max_kb_dist", "3"]),
    ("beagle", ["--ring", "--ring_sub", "3", "--shard", "0", "--profile",
                "tr", "--seed", "11"]),
], ids=["defaults", "short_flags", "engine_flags", "ring_flags"])
def test_params_from_args_copies_agree(files, geno, extra):
    argv = _argv(files, extra, geno)
    a, b = j_cli.params_from_args(argv), t_cli.params_from_args(argv)
    if "--seed" not in argv and "-S" not in argv:
        a.seed = b.seed = 0          # the default seed is the clock
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert type(a).__module__ == "ngsld_tpu.config"
    assert type(b).__module__ == "ngsld_tpu_torch.config"
    assert t_ckpt._config_fingerprint(b, {"chunk": 9}) == \
        j_ckpt._config_fingerprint(a, {"chunk": 9})
    # --posH goes to the same two fields in both
    argv_h = [x if x != "--pos" else "--posH" for x in argv]
    a, b = j_cli.params_from_args(argv_h), t_cli.params_from_args(argv_h)
    assert (a.in_pos, a.in_pos_header) == (b.in_pos, b.in_pos_header) == \
        (files["pos"], True)


@pytest.mark.parametrize("argv,msg", [
    (["--n_ind", "5", "--n_sites", "9"], "geno"),
    (["--geno", "x", "--n_sites", "9"], "n_ind"),
    (["--geno", "x", "--n_ind", "5", "--n_sites", "9", "--max_kb_dist", "5"],
     "pos"),
    (["--geno", "x", "--n_ind", "5", "--n_sites", "9", "--pos", "p", "--ring",
      "--engine", "strict"], "ring"),
], ids=["no_geno", "no_n_ind", "no_pos", "ring_strict"])
def test_config_errors_copies_agree(argv, msg):
    errs = []
    for mod in (j_cli, t_cli):
        with pytest.raises(ValueError) as ei:
            mod.params_from_args(argv)
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and msg in errs[0].lower()
    assert t_cli.main(argv) == 1


def test_gsl_rng_copies_agree():
    for seed in (0, 1, 12345, 2**31 + 7):
        a, b = j_rng.TausRNG(seed), t_rng.TausRNG(seed)
        assert [a.get() for _ in range(20)] == [b.get() for _ in range(20)]
        assert [a.uniform() for _ in range(20)] == \
            [b.uniform() for _ in range(20)]
        assert a.draw_rnd(2.0, 9.0) == b.draw_rnd(2.0, 9.0)
    seeds = np.random.default_rng(1).integers(0, 2**32, 50, dtype=np.uint64)
    np.testing.assert_array_equal(j_rng.taus_uniforms(seeds, 17),
                                  t_rng.taus_uniforms(seeds, 17))
    for x, y in zip(j_rng.taus_seed_states(seeds),
                    t_rng.taus_seed_states(seeds)):
        np.testing.assert_array_equal(x, y)
    n_draws = np.random.default_rng(2).integers(0, 40, 50)
    ja = list(j_rng.iter_uniform_chunks(seeds, n_draws, 300))
    ta = list(t_rng.iter_uniform_chunks(seeds, n_draws, 300))
    assert len(ja) == len(ta) > 1
    for x, y in zip(ja, ta):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("extra,geno", [
    (["--max_kb_dist", "10", "--min_maf", "0.05", "--extend_out"], "beagle"),
    (["--max_kb_dist", "5", "--ignore_miss_data", "--call_geno", "--N_thresh",
      "0.3", "--call_thresh", "0.9", "--extend_out"], "beagle"),
    (["--max_kb_dist", "0", "--max_snp_dist", "25", "--rnd_sample", "0.5",
      "--seed", "12345"], "glf"),
    (["--max_kb_dist", "10", "--min_maf", "0.05", "--extend_out"],
     "geno_text"),
], ids=["default", "miss_call", "binary_sampled", "genotypes"])
def test_strict_whole_run_copies_agree(files, monkeypatch, native, extra,
                                       geno):
    """--engine strict through both packages: bytes equal."""
    if not native:
        monkeypatch.setenv("NGSLD_NO_NATIVE", "1")
    argv = _argv(files, extra, geno)
    a, b = io.StringIO(), io.StringIO()
    j_strict.run(j_cli.params_from_args(argv), out_fh=a)
    t_strict.run(t_cli.params_from_args(argv), out_fh=b)
    assert a.getvalue() == b.getvalue()
    assert a.getvalue().count("\n") > 300


@pytest.mark.parametrize("extra,block_pairs", [
    (["--max_kb_dist", "10", "--min_maf", "0.05"], 512),
    (["--max_kb_dist", "10", "--rnd_sample", "0.4", "--seed", "99"], 300),
    (["--max_kb_dist", "0", "--max_snp_dist", "30", "--rnd_sample", "0.7",
      "--seed", "5", "--min_maf", "0.1"], 1 << 19),
], ids=["kb_maf", "kb_sampled", "snp_sampled_maf"])
def test_iter_pair_blocks_copies_agree(files, extra, block_pairs):
    argv = _argv(files, extra)
    maf = np.random.default_rng(8).random(300) * 0.5
    maf[[3, 40]] = np.nan
    pos_j, lab_j = j_strict.read_pos(files["pos"], False, 300)
    pos_t, lab_t = t_strict.read_pos(files["pos"], False, 300)
    np.testing.assert_array_equal(pos_j, pos_t)
    assert list(lab_j) == list(lab_t)
    jb = list(j_band.iter_pair_blocks(j_cli.params_from_args(argv), maf,
                                      pos_j, block_pairs=block_pairs))
    tb = list(t_band.iter_pair_blocks(t_cli.params_from_args(argv), maf,
                                      pos_t, block_pairs=block_pairs))
    assert len(jb) == len(tb) >= 1 and sum(len(b.s1) for b in tb) > 1000
    for x, y in zip(jb, tb):
        np.testing.assert_array_equal(x.s1, y.s1)
        np.testing.assert_array_equal(x.s2, y.s2)
        np.testing.assert_array_equal(x.dist, y.dist)
    np.testing.assert_array_equal(j_band.band_limits(pos_j, 10, 0),
                                  t_band.band_limits(pos_t, 10, 0))
    np.testing.assert_array_equal(j_band.child_seeds(7, 300),
                                  t_band.child_seeds(7, 300))


@pytest.mark.parametrize("geno,extra", [
    ("beagle", []), ("glf", ["--ignore_miss_data"]),
    ("beagle", ["--call_geno", "--N_thresh", "0.3", "--call_thresh", "0.9"]),
], ids=["beagle", "binary_miss", "call_geno"])
def test_strict_refiner_copies_agree(files, geno, extra):
    argv = _argv(files, ["--max_kb_dist", "10", "--extend_out"] + extra, geno)
    rng = np.random.default_rng(12)
    s1 = np.sort(rng.integers(0, 290, 400))
    s2 = s1 + rng.integers(1, 10, 400)
    ja = j_refine.StrictRefiner(j_cli.params_from_args(argv))
    ta = t_refine.StrictRefiner(t_cli.params_from_args(argv))
    a, b = ja.refine_columns(s1, s2), ta.refine_columns(s1, s2)
    assert sorted(a) == sorted(b) and len(a) >= 12
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sites = np.array([0, 5, 77, 299])
    np.testing.assert_array_equal(ja.exact_maf(sites), ta.exact_maf(sites))


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_refine_tiers_copies_agree(prec):
    rng = np.random.default_rng(21)
    dt = np.float32 if prec == "f32" else np.float64
    f = rng.dirichlet(np.ones(4), 5000).astype(dt)
    f[:500, 1] = 0                       # boundary rows: D' denominators at 0
    f[500:1000, [1, 2]] *= 1e-4
    f[1000:1010] = np.nan
    f /= f.sum(axis=1, keepdims=True)
    a, b = j_refine.degenerate_tiers(f, prec), t_refine.degenerate_tiers(f,
                                                                         prec)
    np.testing.assert_array_equal(a, b)
    assert (a == 1).any() and (a == 0).any()
    ja, tb = j_refine.derive_columns_f64(f), t_refine.derive_columns_f64(f)
    for k in ja:
        np.testing.assert_array_equal(ja[k], tb[k], err_msg=k)
    maf = rng.random(4000) * 0.2
    maf[:50] = 0.05 + rng.normal(0, 1e-5 if prec == "f32" else 1e-12, 50)
    np.testing.assert_array_equal(j_refine.knife_edge_sites(maf, 0.05, prec),
                                  t_refine.knife_edge_sites(maf, 0.05, prec))
    assert len(t_refine.knife_edge_sites(maf, 0.05, prec)) > 0


def _block(n, seed, dt=np.float64):
    rng = np.random.default_rng(seed)
    s1 = np.sort(rng.integers(0, 190, n)).astype(np.int64)
    s2 = s1 + rng.integers(1, 9, n)
    f = rng.dirichlet(np.ones(4), n).astype(dt)
    f[::17] = np.nan
    dist = rng.integers(1, 50000, n).astype(np.float64)
    dist[::23] = np.inf
    return rng, s1, s2, f, dist


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("extend", [False, True], ids=["short", "extended"])
def test_row_writer_format_block_copies_agree(native, extend):
    labels = [f"chr{i % 3}:{100 + i}" for i in range(200)]
    rng, s1, s2, f, dist = _block(600, 4)
    cols = [rng.random(600) for _ in range(4)]
    cols[1][::29] = np.nan
    cols[2][::31] = np.inf
    kw = dict(n_used=rng.integers(0, 10, 600).astype(np.int32),
              maf1=rng.random(600), maf2=rng.random(600), hap=f,
              hmaf1=rng.random(600), hmaf2=rng.random(600),
              chi2=rng.random(600).astype(np.float32),
              n_iter=rng.integers(0, 100, 600).astype(np.int32))
    ja = JRowWriter(None, labels, extend, use_native=native)
    ta = TRowWriter(None, labels, extend, use_native=native)
    a = ja.format_block(s1, s2, dist, *cols, **kw)
    b = ta.format_block(s1, s2, dist, *cols, **kw)
    as_bytes = lambda d: d if isinstance(d, bytes) else d.encode()  # noqa
    assert as_bytes(a) == as_bytes(b) and as_bytes(b).count(b"\n") == 600
    assert j_strict.header_line(extend) == t_strict.header_line(extend)


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_native_derive_formatter_and_host_columns_copies_agree(dt):
    """The engines' fast path (derive + format in one native call) and the
    NumPy derive of the same columns."""
    rng, s1, s2, f, dist = _block(500, 6, dt)
    fm = np.concatenate([rng.random((500, 1)).astype(dt), f], axis=1)
    im = np.stack([rng.integers(0, 100, 500), rng.integers(1, 10, 500)],
                  axis=1).astype(np.int16)
    for ext in (True, False):
        for x, y in zip(j_eb._unpack(fm, im, ext), t_hc._unpack(fm, im, ext)):
            np.testing.assert_array_equal(x, y)
    if t_native.get_lib() is None or j_native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: pure-Python host paths")
    labels = [f"c:{i}" for i in range(200)]
    maf = rng.random(200)
    outs = []
    for nat in (j_native, t_native):
        blob, off = nat.make_labels_blob(labels)
        outs.append(nat.format_rows_derive(
            blob, off, s1, s2, dist, fm[:, 0], fm[:, 1:5], maf[s1], maf[s2],
            im[:, 1].astype(np.int32), im[:, 0].astype(np.int32), True))
    assert outs[0] == outs[1] and outs[0].count(b"\n") == 500
    (j_tiers, j_nz), (t_tiers, t_nz) = (
        nat.tier_scan_native(f, dt == np.float32)
        for nat in (j_native, t_native))
    np.testing.assert_array_equal(j_tiers, t_tiers)
    assert j_nz == t_nz > 0


def test_prefetch_blocks_copy_keeps_order_and_errors():
    assert list(t_hc._prefetch_blocks(iter(range(50)), depth=2)) == \
        list(j_eb._prefetch_blocks(iter(range(50)), depth=2)) == \
        list(range(50))

    def boom():
        yield 1
        raise KeyError("plan failed")

    with pytest.raises(KeyError, match="plan failed"):
        list(t_hc._prefetch_blocks(boom()))


def test_checkpoint_copy_roundtrip(files, tmp_path):
    """The port's _Checkpoint writes the shards and the manifest the JAX
    package's would, and each refuses the other's directory only when the
    configuration differs."""
    argv = _argv(files, ["--max_kb_dist", "10"])
    jp, tp = j_cli.params_from_args(argv), t_cli.params_from_args(argv)
    log = RunLog(0)
    ck = t_ckpt._Checkpoint(str(tmp_path / "ck"), tp, log, extra={"chunk": 5})
    for i, data in enumerate((b"a\n", b"", b"c\n")):
        with ck.open_block(i) as fh:
            fh.write(data)
        assert not ck.done(i)
        ck.commit_block(i)
        assert ck.done(i)
    out = io.BytesIO()
    ck.concatenate(out, 3)
    assert out.getvalue() == b"a\nc\n"
    # the JAX package's class opens the same directory with the same config
    again = j_ckpt._Checkpoint(str(tmp_path / "ck"), jp, log,
                               extra={"chunk": 5})
    assert again.done(2) and again.path(1) == ck.path(1)
    with pytest.raises(t_strict.StrictError, match="different run"):
        t_ckpt._Checkpoint(str(tmp_path / "ck"), tp, log, extra={"chunk": 6})
    # the ring's spill: the same manifest, tile files and record layout
    assert t_ckpt._RING_COLS == j_ckpt._RING_COLS
    extra = dict(mode="ring", n_dev=1, n_sub=2, block=256, strip=False,
                 cols="slim-v2")
    cols = dict(a=np.array([3, 3, 7], np.int32),
                pj=np.array([4, 9, 8], np.int32),
                r2p=np.array([0.5, 0.25, 1.0]),
                f=np.arange(12, dtype=np.float64).reshape(3, 4),
                n_iter=np.array([3, 4, 5], np.int8))
    rdir = str(tmp_path / "rck")
    rs = t_ckpt._RingSpill(rdir, tp, extra, 0, True)
    rs.save_step(1, 0, {0: cols})
    jr = j_ckpt._RingSpill(rdir, jp, extra, 0, True)
    assert jr.done(1, 0) and not jr.done(0, 0)
    assert jr.block_tiles(0) == rs.block_tiles(0) == [rs.tile_path(1, 0, 0)]
    got = np.load(rs.tile_path(1, 0, 0))
    want = j_ckpt._RingSpill.pack(cols)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(t_strict.StrictError, match="different run"):
        t_ckpt._RingSpill(rdir, tp, dict(extra, strip=True), 0, True)


def test_loaders_copy_keeps_the_rules_and_imports_only_the_port():
    """loaders.py is a port, not a copy (torch uploads in the place of
    jax.device_put): it keeps the reference's class names, binary slab
    size and knobs, and imports neither jax nor the JAX package. What it
    delivers is held against the JAX loaders in
    tests/test_torch_loaders.py."""
    import inspect
    import re
    for name in ("_StreamedGLLoader", "_StreamedTextLoader"):
        assert hasattr(t_loaders, name) and hasattr(j_loaders, name)
    assert t_loaders._StreamedGLLoader.SLAB_BYTES == \
        j_loaders._StreamedGLLoader.SLAB_BYTES == 256 << 20
    # the port's text loader inflates smaller pieces, whose slices parse
    # on several threads while the next piece inflates
    assert j_loaders._StreamedTextLoader.CHUNK_BYTES == 48 << 20
    assert t_loaders._StreamedTextLoader.CHUNK_BYTES == 6 << 20
    src = inspect.getsource(t_loaders)
    assert not re.search(r"^\s*(import|from)\s+(jax|ngsld_tpu)(\.|\s|$)", src,
                         re.M)
    for knob in ("NGSLD_NO_FASTBIN", "NGSLD_NO_FASTTEXT", "NGSLD_SLAB_BYTES"):
        assert knob in src and knob in inspect.getsource(j_loaders)
    # the overlap ingest's knob: its gate sits in engine_block in both
    assert "NGSLD_OVERLAP_UPLOAD" in inspect.getsource(t_eb) \
        and "NGSLD_OVERLAP_UPLOAD" in inspect.getsource(j_eb)
    # the ring loader came with the ring, the overlap ingest with its slice
    assert hasattr(t_loaders, "_ring_sharded_tables")
    assert hasattr(t_loaders, "_OverlapIngest") \
        and hasattr(j_loaders, "_OverlapIngest")
    for name in ("wait", "join_all"):
        assert callable(getattr(t_loaders._OverlapIngest, name))
        assert callable(getattr(j_loaders._OverlapIngest, name))
