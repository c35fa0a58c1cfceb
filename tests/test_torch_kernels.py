"""The gather pair-EM kernel's wrapper, the kernels' build helper and the
chip smoke script, as far as a machine without CUDA can check them: CPU tensors take
the plain twin (no launch counted), a missing or failing nvcc raises,
other devices raise, and chip_smoke.py refuses to run. The kernel itself
is compared with its twin in the `gpu`-marked test and by chip_smoke.py
on the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngsld_tpu.utils.simulate import simulate
from ngsld_tpu_torch.kernels import build
from ngsld_tpu_torch.kernels import pair_em as kmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(device, dtype, n_ind=9, n_sites=60, n_pairs=200, seed=3):
    sim = simulate(n_ind=n_ind, n_sites=n_sites, seed=seed,
                   all_missing_site_rate=0.05)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    maf = (gl[..., 1] + 2 * gl[..., 2]).mean(axis=1) / 2
    rng = np.random.default_rng(seed)
    s1 = rng.integers(0, n_sites - 1, n_pairs)
    s2 = np.minimum(s1 + rng.integers(1, 9, n_pairs), n_sites - 1)
    return (torch.tensor(gl, dtype=dtype, device=device),
            torch.tensor(np.stack([s1, s2]), dtype=torch.int32,
                         device=device),
            torch.tensor(maf, dtype=dtype, device=device))


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_cpu_tensors_take_the_twin_without_a_launch(monkeypatch, ignore_miss):
    monkeypatch.setattr(kmod, "LAUNCHES", 0)
    gn, sidx, maf = _table("cpu", torch.float64)
    got = kmod.pair_em_gather(gn, sidx, maf, ignore_miss)
    ref = kmod.pair_em_gather_ref(gn, sidx, maf, ignore_miss)
    assert kmod.LAUNCHES == 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got[0].shape == (200, 4) and got[1].dtype == torch.int32


def test_other_devices_raise_instead_of_falling_back():
    gn, sidx, maf = _table("meta", torch.float32)
    with pytest.raises(ValueError, match="no pair-EM kernel for device"):
        kmod.pair_em_gather(gn, sidx, maf, False)


def test_wrapper_rejects_bad_inputs():
    gn, sidx, maf = _table("cpu", torch.float32)
    with pytest.raises(ValueError, match="int32"):
        kmod.pair_em_gather(gn, sidx.long(), maf, False)
    with pytest.raises(ValueError, match="maf"):
        kmod.pair_em_gather(gn, sidx, maf.double(), False)
    with pytest.raises(ValueError, match=r"\(S, I, 3\)"):
        kmod.pair_em_gather(gn[..., :2], sidx, maf, False)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "library_path",
                        lambda name: str(tmp_path / f"missing_{name}.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_libraries()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.get_library("strip_em")


def test_failed_compile_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'pair_em.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "library_path",
                        lambda name: str(tmp_path / "out" / f"{name}.so"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="error: boom") as ei:
        build.build_libraries()
    # one nvcc per source, and every failure is reported
    assert all(f"{name}.cu" in str(ei.value) for name in build.sources())
    assert len(build.sources()) == 6
    assert os.listdir(tmp_path / "out") == []


def test_library_path_keys_on_sources_and_flags(monkeypatch):
    a = build.library_path("pair_em")
    assert os.path.dirname(a) == build.BUILD_DIR
    assert build.library_path("strip_em") != a
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("pair_em") != a
    assert sorted(build.sources()) == sorted(build.ENTRY_POINTS) \
        == ["gl_narrow", "pair_em", "pair_em_ichunk", "pair_em_rows",
            "strip_em", "strip_em_stream"]
    assert all(s.endswith(".cu") for s in build.sources().values())
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_library_path_covers_the_headers(monkeypatch, tmp_path):
    """Every library's key hashes the .cuh headers beside the sources (the
    EM arithmetic and the strip kernels' block body), so an edited header
    rebuilds; the package data ships them."""
    import shutil
    assert sorted(os.path.basename(p) for p in
                  build.glob.glob(os.path.join(build.CSRC, "*.cuh"))) \
        == ["em_core.cuh", "strip_core.cuh"]
    for src in ("strip_em.cu", "strip_em_stream.cu"):
        with open(os.path.join(build.CSRC, src)) as fh:
            assert '#include "strip_core.cuh"' in fh.read()
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", str(copy))
    before = {n: build.library_path(n) for n in build.sources()}
    assert before == {n: build.library_path(n) for n in build.sources()}
    with open(copy / "strip_core.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {n: build.library_path(n) for n in build.sources()}
    assert all(after[n] != before[n] for n in before)
    with open(os.path.join(REPO, "pyproject.toml")) as fh:
        assert '"csrc/*.cuh"' in fh.read()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no CUDA device" in r.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_kernel_matches_twin_on_the_card(dtype, tol):
    # both sides run the EM in f64: f agrees to its dtype's rounding, and
    # nIter and n_used exactly; the cases aim at the lane groups' edges:
    # one individual (one lane a pair), one pair, pair counts that leave a
    # block's groups part-filled, cohorts on both sides of a change of the
    # group size; two launches give the same bits
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for n_ind, n_pairs in ((37, 5000), (1, 1001), (37, 1), (100, 4099),
                           (16, 2048), (17, 2048), (290, 2048), (291, 2048)):
        gn, sidx, maf = _table("cuda", dtype, n_ind=n_ind, n_sites=300,
                               n_pairs=n_pairs)
        for ignore_miss in (False, True):
            n0 = kmod.LAUNCHES
            kern = kmod.pair_em_gather(gn, sidx, maf, ignore_miss)
            assert kmod.LAUNCHES == n0 + 1
            again = kmod.pair_em_gather(gn, sidx, maf, ignore_miss)
            for a, b in zip(kern, again):
                assert torch.equal(a.nan_to_num(), b.nan_to_num())
            fk, itk, nuk = (t.cpu().numpy() for t in kern)
            fp, itp, nup = (t.cpu().numpy() for t in
                            kmod.pair_em_gather_ref(gn, sidx, maf,
                                                    ignore_miss))
            np.testing.assert_array_equal(nuk, nup)
            np.testing.assert_array_equal(itk, itp)
            np.testing.assert_array_equal(np.isnan(fk), np.isnan(fp))
            nan = np.isnan(fk)
            np.testing.assert_allclose(np.where(nan, 0, fk),
                                       np.where(nan, 0, fp), rtol=0, atol=tol)
            x0 = nup == 0
            if ignore_miss and n_pairs > 1000:
                assert x0.any()
            assert np.isnan(fk[x0]).all() and (itk[x0] == 0).all()


def test_device_busy_is_the_union_of_device_intervals():
    from ngsld_tpu_torch.utils.devtrace import device_busy
    events = [
        # an operator on the host and the kernel it launched: only the
        # kernel counts
        {"ph": "X", "cat": "cpu_op", "name": "aten::gather", "ts": 0,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "gather_k", "ts": 10, "dur": 20},
        # overlapping kernels on two streams count once
        {"ph": "X", "cat": "kernel", "name": "pair_em_kernel", "ts": 25,
         "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30,
         "dur": 5},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 100,
         "dur": 4},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 200},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 300},
    ]
    busy, by_cat, by_kernel = device_busy(events)
    assert busy == 30 + 4           # [10, 40) and [100, 104)
    assert by_cat == {"kernel": 35, "gpu_memcpy": 5, "gpu_memset": 4}
    assert by_kernel == {"gather_k": 20, "pair_em_kernel": 15}
    assert device_busy([]) == (0.0, {}, {})
