"""The binary loader's narrowing and checks on the card
(csrc/gl_narrow.cu through kernels/gl_narrow.py): the kernel against its
plain version, and a binary run's device tables against the same run's
tables narrowed on the host. These tests need a CUDA device and skip
without one; the file imports nothing of JAX, so that on the card it runs
without the test configuration:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gl_narrow.py -q

Equality is bit for bit, with one exception: a NaN narrows to a NaN, the
card's canonical one where numpy keeps the payload's top bits (a slab
holding one is refused whatever its bits)."""

import functools

import numpy as np
import pytest
import torch

from ngsld_tpu_torch import engine_block
from ngsld_tpu_torch.cli import params_from_args
from ngsld_tpu_torch.kernels import gl_narrow
from ngsld_tpu_torch.ops.preprocess import preprocess
from ngsld_tpu_torch.utils.logging import RunLog
from ngsld_tpu_torch.utils.simulate import simulate, write_all


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, a NaN equal to any NaN."""
    a, b = a.cpu(), b.cpu()
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    return torch.equal(torch.where(nan, 0, a).view(torch.int32 if
                       a.dtype == torch.float32 else torch.int64),
                       torch.where(nan, 0, b).view(torch.int32 if
                       b.dtype == torch.float32 else torch.int64))


def _slab(rng, k, m, in_log):
    """A random (k, m, 3) slab of doubles in the scale's range, with
    subnormals of both widths, values just under the last that round to
    f32-max, exact zeros and, in log scale, single -infs and negative
    subnormals."""
    a = rng.uniform(1e-6, 1.0, (k, m, 3))
    if in_log:
        a = np.log(a)
    flat = a.reshape(-1)
    idx = rng.choice(flat.size, 4_000, replace=False)
    flat[idx[:500]] = 1e-310                         # f64 subnormal
    flat[idx[500:1_500]] = rng.uniform(1e-45, 1e-38, 1_000)
    flat[idx[1_500:2_000]] = 3.4028235e38            # rounds to f32-max
    flat[idx[2_000:2_500]] = 0.0
    if in_log:
        flat[idx[2_500:3_000]] = -np.inf
        flat[idx[3_000:3_500]] = -1e-310
    return a


def _bad_variants(a, in_log):
    """(name, slab) with bad records (or ones that only f32 refuses) at
    the first record, the last and one between."""
    nans = np.array([0x7ff0000000000001, 0xfff8000000000123,
                     0x7ff8deadbeef0000], dtype=np.uint64).view(np.float64)
    k, m = a.shape[:2]
    spots = [(0, 0), (k - 1, m - 1), (k // 2, m // 3)]
    out = []
    for name, rec in [("nan", (nans[0], 1.0, 1.0)),
                      ("nan_payloads", (nans[1], nans[2], 0.5)),
                      ("posinf", (0.5, np.inf, 0.5)),
                      ("past_f32_max", (0.5, 1e39, 0.5)),
                      ("three_neginf", (-np.inf, -np.inf, -np.inf)),
                      ("negative", (0.5, -1e-300, 0.5)),
                      ("neg_subnormal", (-1e-310, 0.5, 0.5))]:
        for spot in spots:
            b = a.copy()
            b[spot] = rec
            out.append((f"{name}@{spot}", b))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("in_log", [True, False], ids=["log", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_its_plain_version(dtype, in_log):
    """gl_narrow.cu against narrow_check_ref on the card, on slabs with
    an even and an odd record count and one record: output and flag
    bit-equal, for a clean slab and for each kind of bad record at the
    slab's first, last and a middle record; one launch a call."""
    dev = _card()
    rng = np.random.default_rng(2026)
    for k, m in ((1_051, 517), (333, 37), (1, 1)):
        a = _slab(rng, k, m, in_log) if k > 1 else \
            np.full((1, 1, 3), -1.5 if in_log else 0.25)
        cases = [("clean", a)] + (_bad_variants(a, in_log) if k > 1 else [])
        for name, b in cases:
            raw = torch.from_numpy(b).to(dev)
            fk = torch.zeros(1, dtype=torch.int32, device=dev)
            fp = torch.zeros(1, dtype=torch.int32, device=dev)
            n0 = gl_narrow.LAUNCHES
            got = gl_narrow.narrow_check(raw, dtype, in_log, fk)
            assert gl_narrow.LAUNCHES == n0 + 1
            want = gl_narrow.narrow_check_ref(raw, dtype, in_log, fp)
            torch.cuda.synchronize()
            assert int(fk) == int(fp), (k, m, name)
            assert got.dtype == dtype and _same(got, want), (k, m, name)
            if dtype == torch.float64:
                assert got.data_ptr() == raw.data_ptr()
            if name == "clean":
                assert int(fk) == 0
                # the host's astype, bit for bit
                host = torch.from_numpy(b.astype(
                    np.float32 if dtype == torch.float32 else np.float64))
                assert _same(got, host)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlap", "uploader"])
def test_binary_run_tables_equal_the_host_narrowed_ones(tmp_path,
                                                        monkeypatch, prec,
                                                        overlap):
    """engine_block._load on the card from a binary file in slabs of 40
    sites (the last one short): gn, maf and eg bit-equal to the
    preprocess of the table narrowed on the host, through the overlap
    ingest and through the uploader; one gl_narrow launch a slab."""
    dev = _card()
    monkeypatch.delenv("NGSLD_OVERLAP_UPLOAD", raising=False)
    n_ind, n_sites = 37, 1_000
    monkeypatch.setenv("NGSLD_SLAB_BYTES", str(40 * n_ind * 24))
    files = write_all(simulate(n_ind=n_ind, n_sites=n_sites, seed=61),
                      str(tmp_path))
    pars = params_from_args(
        ["--geno", files["glf"], "--log_scale", "--n_ind", str(n_ind),
         "--n_sites", str(n_sites), "--pos", files["pos"], "--max_kb_dist",
         "5", "--verbose", "0"])
    n0 = gl_narrow.LAUNCHES
    got = engine_block._load(pars, RunLog(0), prec, dev, None,
                             overlap=overlap)
    ingest = got[-1]
    if overlap:
        ingest.join_all()
    gn_d, maf_d, eg_d = got[:3]
    torch.cuda.synchronize()
    assert gl_narrow.LAUNCHES - n0 == -(-n_sites // 40)
    np_dt = np.float32 if prec == "f32" else np.float64
    raw = np.fromfile(files["glf"], np.float64).reshape(n_sites, n_ind, 3)
    pre = functools.partial(
        preprocess, call=pars.call_geno, N_thresh=pars.N_thresh,
        call_thresh=pars.call_thresh, ignore_miss_data=pars.ignore_miss_data,
        raw=True, in_log=True)
    want = pre(torch.from_numpy(raw.astype(np_dt)).to(dev))
    for name, a, b in zip(("gn", "maf", "eg"), (gn_d, maf_d, eg_d), want):
        assert torch.equal(a, b), name
