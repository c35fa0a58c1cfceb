"""The port's streamed input loaders (ngsld_tpu_torch/loaders.py) on the
CPU: the tensor they hand the engine against strict.read_geno and against
the JAX package's loaders on the same files (binary log-scale and linear,
Beagle gz, called genotypes; one slab and many), the reference's error
surface (NaN, +inf, all -inf, negative linear, premature EOF, not at EOF:
the same StrictError text from both packages), and the port's CLI through
each loader against the run that NGSLD_NO_FASTBIN=1 / NGSLD_NO_FASTTEXT=1
sends through strict.read_geno.

Tolerances: a text loader's records are read_geno's, bit for bit. A binary
loader delivers the file's raw records (equal to the JAX loader's bit for
bit, compared at f32); normalised by the device preprocess in f64 they agree with
read_geno's host normalisation within 1e-12."""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from ngsld_tpu import loaders as j_loaders
from ngsld_tpu import strict as j_strict
from ngsld_tpu.utils.simulate import simulate, write_all
from ngsld_tpu_torch import engine_block, loaders, native, strict
from ngsld_tpu_torch.cli import main, params_from_args
from ngsld_tpu_torch.ops.preprocess import preprocess


@pytest.fixture(autouse=True)
def ask_for_the_cpu(monkeypatch):
    # the engine runs on the card unless the caller asks for the CPU
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    # small tensors: more threads only fight the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


N_IND, N_SITES = 9, 300


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("loaders")
    sim = simulate(n_ind=N_IND, n_sites=N_SITES, seed=23,
                   all_missing_site_rate=0.02, mono_rate=0.05)
    out = write_all(sim, str(d))
    # the same GLs in linear scale, with exact zeros (log -> -inf -> -INF)
    lin = np.exp(np.fromfile(out["glf"], np.float64))
    lin[::17] = 0.0
    out["glf_lin"] = str(d / "lin.glf")
    lin.tofile(out["glf_lin"])
    return out


def _pars(files, key, extra=()):
    inp = {"glf": ["--geno", files["glf"], "--log_scale"],
           "glf_lin": ["--geno", files["glf_lin"]],
           "beagle": ["--geno", files["beagle"], "--probs"],
           "geno_text": ["--geno", files["geno_text"]]}[key]
    return inp + ["--n_ind", str(N_IND), "--n_sites", str(N_SITES), "--pos",
                  files["pos"], "--max_kb_dist", "5", "--extend_out",
                  "--verbose", "0", *extra]


def _read_geno(p):
    return strict.read_geno(p.in_geno, p.in_bin, p.in_probs, p.in_logscale,
                            p.n_ind, p.n_sites)


@pytest.mark.parametrize("slab_bytes,n_slabs", [(None, 1), ("4000", 17)])
@pytest.mark.parametrize("key", ["glf", "glf_lin"])
def test_binary_loader_delivers_the_files_records(files, monkeypatch, key,
                                                  slab_bytes, n_slabs):
    if slab_bytes:
        monkeypatch.setenv("NGSLD_SLAB_BYTES", slab_bytes)
    p = params_from_args(_pars(files, key))
    assert loaders._StreamedGLLoader.applicable(p)
    assert j_loaders._StreamedGLLoader.applicable(p)
    ld = loaders._StreamedGLLoader(p, np.float64, "cpu")
    got = ld.join()
    assert ld.n_slabs == n_slabs
    assert got.shape == (N_SITES, N_IND, 3) and got.dtype == torch.float64
    raw = np.fromfile(p.in_geno, np.float64).reshape(N_SITES, N_IND, 3)
    np.testing.assert_array_equal(got.numpy(), raw)
    # normalised on the device, it is what strict.read_geno returns
    kw = dict(call=False, N_thresh=0.0, call_thresh=0.0,
              ignore_miss_data=False)
    a = preprocess(got, raw=True, in_log=p.in_logscale, **kw)
    b = preprocess(torch.from_numpy(_read_geno(p)), **kw)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-12)
    # f32: narrowed on the host, slab by slab
    f32 = loaders._StreamedGLLoader(p, np.float32, "cpu").join()
    assert f32.dtype == torch.float32
    np.testing.assert_array_equal(f32.numpy(), raw.astype(np.float32))
    # the JAX loader at f32 (JAX holds no f64 unless x64 is enabled)
    j_got = np.asarray(j_loaders._StreamedGLLoader(p, np.float32).join())
    np.testing.assert_array_equal(f32.numpy(), j_got)


@pytest.mark.parametrize("slab_bytes,min_slabs", [(None, 1), ("4096", 2)])
@pytest.mark.parametrize("key", ["beagle", "geno_text"])
def test_text_loader_delivers_read_genos_records(files, monkeypatch, key,
                                                 slab_bytes, min_slabs):
    if native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: the text loader is declined")
    if slab_bytes:   # many chunks: the line-boundary carry logic runs
        monkeypatch.setenv("NGSLD_SLAB_BYTES", slab_bytes)
    p = params_from_args(_pars(files, key))
    assert loaders._StreamedTextLoader.applicable(p)
    assert not loaders._StreamedGLLoader.applicable(p)
    ld = loaders._StreamedTextLoader(p, np.float64, "cpu")
    got = ld.join()
    assert ld.n_slabs >= min_slabs
    np.testing.assert_array_equal(got.numpy(), _read_geno(p))
    # the JAX loader at f32 (JAX holds no f64 unless x64 is enabled)
    f32 = loaders._StreamedTextLoader(p, np.float32, "cpu").join()
    j_got = np.asarray(j_loaders._StreamedTextLoader(p, np.float32).join())
    assert f32.dtype == torch.float32 and j_got.dtype == np.float32
    np.testing.assert_array_equal(f32.numpy(), j_got)


def test_applicable_rules(files, monkeypatch, tmp_path):
    p_bin = params_from_args(_pars(files, "glf"))
    p_txt = params_from_args(_pars(files, "beagle"))
    for mod in (loaders, j_loaders):
        assert mod._StreamedGLLoader.applicable(p_bin)
        assert not mod._StreamedGLLoader.applicable(p_txt)
        assert not mod._StreamedTextLoader.applicable(p_bin)
    # a size that does not match exactly goes to strict.read_geno
    short = tmp_path / "short.glf"
    short.write_bytes(open(files["glf"], "rb").read()[:-8])
    p_short = dataclasses.replace(p_bin, in_geno=str(short))
    for mod in (loaders, j_loaders):
        assert not mod._StreamedGLLoader.applicable(p_short)
    short.unlink()                       # and so does a file that is gone
    for mod in (loaders, j_loaders):
        assert not mod._StreamedGLLoader.applicable(p_short)
    monkeypatch.setenv("NGSLD_NO_FASTBIN", "1")
    monkeypatch.setenv("NGSLD_NO_FASTTEXT", "1")
    for mod in (loaders, j_loaders):
        assert not mod._StreamedGLLoader.applicable(p_bin)
        assert not mod._StreamedTextLoader.applicable(p_txt)


def _both_errors(make_t, make_j):
    msgs = []
    for make, err in ((make_t, strict.StrictError),
                      (make_j, j_strict.StrictError)):
        with pytest.raises(err) as ei:
            make().join()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


@pytest.mark.parametrize("key,where,value", [
    ("glf", 7, np.nan), ("glf", 2000, np.inf), ("glf", (30, 31, 32), -np.inf),
    ("glf_lin", 1234, -0.25), ("glf_lin", 8099, np.nan),
], ids=["nan", "posinf", "all_neginf_record", "negative_linear",
        "nan_last_slab"])
def test_binary_loader_nan_surface(files, tmp_path, monkeypatch, key, where,
                                   value):
    """Per slab, on the narrowed records: the reference's error after
    post_prob (read_data.cpp:42-45), the same text as the JAX loader's."""
    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")
    raw = np.fromfile(files[key], np.float64)
    raw[list(where) if isinstance(where, tuple) else where] = value
    bad = tmp_path / "bad.glf"
    raw.tofile(bad)
    p = params_from_args(_pars(dict(files, **{key: str(bad)}), key))
    for dt in (np.float32, np.float64):
        msg = _both_errors(
            lambda: loaders._StreamedGLLoader(p, dt, "cpu"),
            lambda: j_loaders._StreamedGLLoader(p, dt))
        assert "NaN found! Is the file format correct?" in msg
    # a single -inf in a log-scale record, or a linear zero, is fine
    ok = np.fromfile(files[key], np.float64)
    ok[30] = -np.inf if key == "glf" else 0.0
    ok.tofile(bad)
    assert loaders._StreamedGLLoader(p, np.float32, "cpu").join().shape[0] \
        == N_SITES
    # the CLI ends with that error and prints no rows
    raw.tofile(bad)
    out = tmp_path / "bad.ld"
    assert main(_pars(dict(files, **{key: str(bad)}), key)
                + ["--out", str(out)]) == 1
    assert out.read_bytes() == b""


@pytest.mark.parametrize("n_sites,text", [
    (N_SITES + 1, "GENO file at premature EOF"),
    (N_SITES - 1, "GENO file not at EOF"),
], ids=["premature_eof", "not_at_eof"])
def test_text_loader_eof_surface(files, monkeypatch, n_sites, text):
    if native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: the text loader is declined")
    argv = _pars(files, "beagle")
    argv[argv.index("--n_sites") + 1] = str(n_sites)
    p = params_from_args(argv)
    for slab in (None, "4096"):
        if slab:
            monkeypatch.setenv("NGSLD_SLAB_BYTES", slab)
        msg = _both_errors(
            lambda: loaders._StreamedTextLoader(p, np.float64, "cpu"),
            lambda: j_loaders._StreamedTextLoader(p, np.float64))
        assert text in msg and "Check GENO file and number of sites!" in msg


def test_text_loader_trailing_bytes_are_not_eof(files, tmp_path):
    if native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: the text loader is declined")
    with gzip.open(files["beagle"], "rb") as fh:
        body = fh.read()
    extra = tmp_path / "extra.beagle.gz"
    with gzip.open(extra, "wb") as fh:
        fh.write(body + b"x")
    p = params_from_args(_pars(dict(files, beagle=str(extra)), "beagle"))
    msg = _both_errors(
        lambda: loaders._StreamedTextLoader(p, np.float64, "cpu"),
        lambda: j_loaders._StreamedTextLoader(p, np.float64))
    assert "GENO file not at EOF" in msg


@pytest.mark.parametrize("key,knob,loader", [
    ("glf", "NGSLD_NO_FASTBIN", "_StreamedGLLoader"),
    ("glf_lin", "NGSLD_NO_FASTBIN", "_StreamedGLLoader"),
    ("beagle", "NGSLD_NO_FASTTEXT", "_StreamedTextLoader"),
    ("geno_text", "NGSLD_NO_FASTTEXT", "_StreamedTextLoader"),
])
def test_cli_through_a_loader_equals_the_read_geno_run(files, tmp_path,
                                                       monkeypatch, key, knob,
                                                       loader):
    """f64 on the CPU: the rows are byte-equal whichever way the GLs came
    in, in one slab or in many."""
    if loader == "_StreamedTextLoader" and native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: the text loader is declined")
    made = []
    real = getattr(engine_block, loader)

    class Counted(real):
        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(engine_block, loader, Counted)
    reads = []
    real_read = strict.read_geno
    monkeypatch.setattr(strict, "read_geno",
                        lambda *a, **k: reads.append(1) or real_read(*a, **k))
    argv = _pars(files, key, ["--min_maf", "0.05"])
    outs = {}
    for name, env in (("loader", {}), ("slabs", {"NGSLD_SLAB_BYTES": "4096"}),
                      ("read_geno", {knob: "1"})):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        n_made, n_reads = len(made), len(reads)
        out = tmp_path / f"{name}.ld"
        assert main(argv + ["--out", str(out)]) == 0
        # the loader fed the run, or read_geno did: never both
        assert (len(made) - n_made, len(reads) - n_reads) == \
            ((0, 1) if name == "read_geno" else (1, 0))
        outs[name] = out.read_bytes()
        for k in env:
            monkeypatch.delenv(k)
    assert outs["loader"] == outs["slabs"] == outs["read_geno"]
    assert outs["loader"].count(b"\n") > 300


def test_loader_error_in_the_uploader_reaches_join(files, monkeypatch):
    """A failure on the upload side must not leave the reader blocked on a
    full queue: join() raises it."""
    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")
    p = params_from_args(_pars(files, "glf"))

    def boom(a):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(loaders.torch, "from_numpy", boom)
    with pytest.raises(RuntimeError, match="upload failed"):
        loaders._StreamedGLLoader(p, np.float32, "cpu").join()


def test_f32_run_through_the_binary_loader_holds_the_f32_contract(files,
                                                                  tmp_path):
    """--precision f32 (the card's default): the loader narrows the raw
    records before the device normalises them, read_geno's path normalises
    in f64 first; both hold the f32 column contract against strict."""
    from ngsld_tpu_torch.utils.conformance import cmp_vs_strict
    # no all-missing or monomorphic sites: their zero-variance r2 prints
    # NaN or 0 by rounding alone, whichever way the GLs came in
    clean = write_all(simulate(n_ind=N_IND, n_sites=N_SITES, seed=24),
                      str(tmp_path / "clean"))
    argv = _pars(dict(clean, glf_lin=""), "glf", ["--min_maf", "0.05"])
    t_out, s_out = tmp_path / "t.ld", tmp_path / "s.ld"
    assert main(argv + ["--precision", "f32", "--out", str(t_out)]) == 0
    assert main(argv + ["--engine", "strict", "--out", str(s_out)]) == 0
    cmp_vs_strict(s_out.read_text().splitlines(),
                  t_out.read_text().splitlines(), 300)


def _numpy_verdict(a, np_dt, in_log):
    """The host checks the binary loader made before they moved to the
    slab's consumer: numpy's, on the slab narrowed by astype."""
    with np.errstate(over="ignore"):
        a = a.astype(np_dt)
    bad = np.isnan(a).any() or np.isposinf(a).any()
    if in_log:
        return bool(bad or np.isneginf(a).all(axis=-1).any())
    return bool(bad or (a < 0).any())


# (record, flagged in f32, flagged in f64) for each scale: the checks read
# the narrowed values, so an f64 value past f32-max narrows to inf (the
# documented deviation of f32 tables) and a negative f64 subnormal to -0
_RECORDS = {
    True: [((np.nan, -1.0, -2.0), True, True),
           ((-1.0, np.inf, -2.0), True, True),
           ((-np.inf, -np.inf, -np.inf), True, True),
           ((-np.inf, -1.0, -np.inf), False, False),
           ((-1e300, -1e300, -1e300), True, False),
           ((-1.0, 1e300, -2.0), True, False),
           ((-5.0, -1e-310, -0.0), False, False)],
    False: [((np.nan, 0.5, 0.2), True, True),
            ((0.5, np.inf, 0.2), True, True),
            ((0.5, -0.25, 0.2), True, True),
            ((0.5, 0.2, -np.inf), True, True),
            ((-1e-310, 0.5, 0.2), False, True),   # f32: -0.0
            ((0.0, 0.0, 0.0), False, False),
            ((-0.0, 0.5, 1e-310), False, False),
            ((0.5, 1e300, 0.2), True, False)],
}


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("in_log", [True, False], ids=["log", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_narrow_check_flags_the_references_records(dtype, in_log,
                                                         where):
    """kernels.gl_narrow's plain version on CPU slabs: narrowed bit for
    bit as numpy's astype (subnormals, values past f32-max), flagged
    exactly where the host checks flagged (NaN, +inf, three -infs in log
    scale, a negative in linear scale), on a bad record first or last in
    the slab; a linear zero and a single -inf pass. The flag is ORed, not
    set: a clean slab leaves a set flag set."""
    from ngsld_tpu_torch.kernels.gl_narrow import narrow_check
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(41)
    k, m = 6, 5
    base = rng.uniform(0.01, 1.0, (k, m, 3))
    base[1, 2] = (1e-40, 3e-45, 1e-310)   # subnormal in f32 or f64
    base = np.log(base) if in_log else base
    pos = (0, 0) if where == "first" else (k - 1, m - 1)
    for rec, bad32, bad64 in [((0.3, 0.3, 0.3) if not in_log
                               else (-0.3, -0.3, -0.3), False, False),
                              *_RECORDS[in_log]]:
        a = base.copy()
        a[pos] = rec
        flag = torch.zeros(1, dtype=torch.int32)
        out = narrow_check(torch.from_numpy(a), dtype, in_log, flag)
        want = bad32 if dtype == torch.float32 else bad64
        assert int(flag) == want == _numpy_verdict(a, np_dt, in_log), rec
        assert out.dtype == dtype and out.shape == a.shape
        with np.errstate(over="ignore"):
            host = a.astype(np_dt)
        np.testing.assert_array_equal(out.numpy().view(np.uint8),
                                      host.view(np.uint8)) \
            if not np.isnan(a).any() else \
            np.testing.assert_array_equal(out.numpy(), host)
        if not want:
            narrow_check(torch.from_numpy(a), dtype, in_log,
                         flag.fill_(1))
            assert int(flag) == 1


@pytest.mark.parametrize("stream_np", [False, True])
def test_binary_reader_short_read_is_premature_eof(files, monkeypatch,
                                                   stream_np):
    """A file that ends before n_sites records (it shrank after the size
    check) ends the reader with strict.read_geno's error on that file."""
    monkeypatch.setenv("NGSLD_SLAB_BYTES", "4000")
    p = dataclasses.replace(params_from_args(_pars(files, "glf")),
                            n_sites=N_SITES + 1)
    with pytest.raises(strict.StrictError) as want:
        _read_geno(p)
    ld = loaders._StreamedGLLoader(p, np.float32, "cpu", stream_np=stream_np)
    with pytest.raises(strict.StrictError) as got:
        if stream_np:
            for _ in ld.np_slabs():
                pass
        else:
            ld.join()
    assert "premature EOF" in str(got.value)
    assert str(got.value) == str(want.value)
