"""The port's LD tools (ngsld_tpu_torch/tools) against the JAX package's on
the same seeded inputs, on the CPU.

prune, merge and fit_decay (fixed --seed) must print byte-equal output,
extract_region return equal arrays (NaN where NaN); each tool also runs
as `python -m ngsld_tpu_torch.tools.*` with jax, ngsld_tpu and
matplotlib blocked from import (the card's machine has none of them).
Last, the pipeline: the port's CLI (the torch engine on the CPU) and the
port's prune keep the set that the JAX package's prune keeps on
--engine strict output.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from ngsld_tpu import strict as j_strict
from ngsld_tpu.config import Params
from ngsld_tpu.tools import fit_decay as j_fit_decay
from ngsld_tpu.tools import ld_blocks as j_ld_blocks
from ngsld_tpu.tools import merge as j_merge
from ngsld_tpu.tools import prune as j_prune
from ngsld_tpu.utils.simulate import simulate, write_all
from ngsld_tpu_torch.cli import main as port_cli
from ngsld_tpu_torch.tools import fit_decay, ld_blocks, merge, prune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "site1\tsite2\tdist\tr2_ExpG\tD\tDp\tr2\n"


def _main(mod, argv):
    """(rc, stdout, stderr) of a tool's main() in-process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def ld_graph(tmp_path_factory):
    """A random LD graph over 80 sites on two chromosomes: repeated
    weights (ties), negative D, NaN and inf weights, self-loops, pairs
    past --max_dist."""
    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("g") / "g.ld"
    rows = []
    for _ in range(600):
        a, b = rng.integers(0, 80, 2)
        ca, cb = f"chr{1 + a % 2}", f"chr{1 + b % 2}"
        dist = int(rng.integers(1, 80_000))
        r2 = rng.choice([0.25, 0.5, 0.75, 0.9]) if rng.random() < 0.3 \
            else round(float(rng.random()), 6)
        d = round(float(rng.normal(0, 0.3)), 6)
        u = rng.random()
        if u < 0.03:
            r2, d = "nan", "nan"
        elif u < 0.05:
            r2, d = "inf", "-inf"
        rows.append(f"{ca}:{a + 1}\t{cb}:{b + 1}\t{dist}\t0.1\t{d}\t0.2\t"
                    f"{r2}\n")
    rows.append("chr1:5\tchr1:5\t0\t1\t1\t1\t1\n")
    path.write_text(HEADER + "".join(rows))
    return path


@pytest.mark.parametrize("extra", [
    ["--weight_type", "a"],
    ["--weight_type", "e", "--field_weight", "5", "--min_weight", "-0.2"],
    ["--weight_type", "n"],
    ["--keep_heavy"],
    ["--max_kb_dist", "40", "--weight_precision", "2"],
], ids=["abs", "raw", "count", "keep_heavy", "kb_alias"])
def test_prune_byte_equal(ld_graph, tmp_path, extra):
    argv = ["--input", str(ld_graph), "--min_weight", "0.3"]
    if "--max_kb_dist" not in extra:
        argv += ["--max_dist", "50000"]
    argv += extra
    outs = []
    for mod, tag in ((prune, "port"), (j_prune, "jax")):
        excl = tmp_path / f"{tag}.excl"
        rc, out, err = _main(mod, argv + ["--print_excl", str(excl)])
        assert rc == 0
        outs.append((out, excl.read_bytes(), err))
    assert outs[0] == outs[1]
    kept, dropped = outs[0][0].split(), outs[0][1].split()
    assert kept and dropped and not set(kept) & set(dropped)


def test_prune_tie_break_and_subset(tmp_path):
    ld = tmp_path / "t.ld"
    ld.write_text(HEADER + "chr1:20\tchr1:10\t100\t0\t0\t0\t0.9\n"
                  "chr1:30\tchr1:40\t100\t0\t0\t0\t0.9\n"
                  "chr1:40\tchr1:10\t100\t0\t0\t0\t0.9\n")
    sub = tmp_path / "subset.txt"
    sub.write_text("chr1:10 chr1:20 chr1:30\n")
    for extra in ([], ["--subset", str(sub)]):
        argv = ["--input", str(ld), "--max_dist", "1000", "--min_weight",
                "0.5"] + extra
        got, want = _main(prune, argv), _main(j_prune, argv)
        assert got == want
    # chr1:10 and chr1:40 tie at two edges: the smaller lowercase label,
    # chr1:10, goes; then chr1:30 and chr1:40 tie at one: chr1:30 goes
    assert _main(prune, argv[:6])[1] == "chr1:20\nchr1:40\n"


def _decay_file(path, n_ind, seed):
    rng = np.random.default_rng(seed)
    dist = rng.integers(1, 80_000, 800)
    if n_ind:
        C = 1e-3 * dist
        r2 = (((10 + C) / ((2 + C) * (11 + C)))
              * (1 + ((3 + C) * (12 + 12 * C + C ** 2))
                 / (n_ind * (2 + C) * (11 + C))))
    else:
        r2 = 0.75 / (1 + 2e-3 * dist) + 0.05
    r2 = np.clip(r2 + rng.normal(0, 0.02, len(dist)), 0, 1)
    dp = np.clip(0.9 * (1 - dist / 1e6) ** 20 + rng.normal(0, 0.02,
                                                             len(dist)), 0, 1)
    with open(path, "w") as fh:
        fh.write(HEADER)
        for d, v, p in zip(dist, r2, dp):
            fh.write(f"chr1:1\tchr1:{1 + d}\t{d}\t0\t0\t{p:.6f}\t{v:.6f}\n")


@pytest.mark.parametrize("extra", [
    ["--ld", "r2", "--fit_level", "3", "--fit_boot", "3"],
    ["--ld", "r2,Dp", "--n_ind", "50", "--fit_level", "3", "--fit_boot",
     "2", "--bin_quant", "50", "--fit_bin_size", "1000"],
], ids=["sved_boot", "hill_weir_dp"])
def test_fit_decay_byte_equal(tmp_path, extra):
    n_ind = 50 if "--n_ind" in extra else 0
    ld = tmp_path / "d.ld"
    _decay_file(ld, n_ind, seed=11)
    lst = tmp_path / "files.txt"
    lst.write_text(f"{ld}\n")
    argv = ["--ld_files", str(lst), "--seed", "7"] + extra
    got, want = _main(fit_decay, argv), _main(j_fit_decay, argv)
    assert got[0] == 0 and got == want
    hdr, *rows = got[1].splitlines()
    assert "DecayRate_CI_l" in hdr and len(rows) == extra[1].count(",") + 1


def test_extract_region_equal(tmp_path):
    paths = write_all(simulate(n_ind=8, n_sites=150, seed=4), str(tmp_path))
    ld = tmp_path / "out.ld"
    j_strict.run(Params(in_geno=paths["beagle"], in_probs=True, n_ind=8,
                        n_sites=150, in_pos=paths["pos"], max_kb_dist=10,
                        out=str(ld)).finalize())
    chrom = open(paths["pos"]).readline().split("\t")[0]
    for lo, hi in ((1, 10_000), (2_000, 6_000), (10**9, 2 * 10**9)):
        got = ld_blocks.extract_region(str(ld), chrom, lo, hi)
        want = j_ld_blocks.extract_region(str(ld), chrom, lo, hi)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == w.shape == (len(got[0]),) * 2
            np.testing.assert_array_equal(g, w)
    assert len(ld_blocks.extract_region(str(ld), chrom, 1, 10_000)[0]) > 5


def _parts(d):
    """Shards of one output, numbered so that numeric and lexicographic
    order differ; the header on the first and again on a later one."""
    stem = d / "run.ld"
    body = {1: HEADER + "a\tb\t1\n", 2: "c\td\t2\n", 10: HEADER + "e\tf\t3\n",
            11: "g\th\t4\nlast line without newline"}
    for k, text in body.items():
        (d / f"run.ld.part{k}").write_text(text)
    return stem, HEADER + "a\tb\t1\nc\td\t2\ne\tf\t3\ng\th\t4\n" \
        "last line without newline"


def test_merge_byte_equal(tmp_path):
    stem, want = _parts(tmp_path)
    assert merge.discover_parts(str(stem)) == \
        j_merge.discover_parts(str(stem)) == \
        [f"{stem}.part{k}" for k in (1, 2, 10, 11)]
    outs = []
    for mod, tag in ((merge, "port"), (j_merge, "jax")):
        out = tmp_path / f"{tag}.ld"
        rc, _, err = _main(mod, ["--out", str(out), str(stem)])
        assert rc == 0 and "merged 4 shard(s)" in err
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == want.encode()
    # explicit shard lists merge in the order given
    parts = [f"{stem}.part{k}" for k in (2, 1)]
    for mod, tag in ((merge, "port2"), (j_merge, "jax2")):
        rc, _, _ = _main(mod, ["--out", str(tmp_path / tag)] + parts)
        assert rc == 0
    assert (tmp_path / "port2").read_bytes() \
        == (tmp_path / "jax2").read_bytes() == b"c\td\t2\n" + HEADER.encode() \
        + b"a\tb\t1\n"
    assert _main(merge, [str(tmp_path / "none")])[0] == 1


_BLOCKED = (
    "import runpy, sys\n"
    "for name in ('jax', 'ngsld_tpu', 'matplotlib'):\n"
    "    sys.modules[name] = None\n"
    "sys.argv = [{mod!r}] + {argv!r}\n"
    "try:\n"
    "    runpy.run_module({mod!r}, run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    for name in ('jax', 'ngsld_tpu', 'matplotlib'):\n"
    "        assert sys.modules[name] is None and not [m for m in "
    "sys.modules if m.startswith(name + '.')], name + ' imported'\n")


def _blocked(mod, argv):
    code = _BLOCKED.format(mod=mod, argv=argv)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))


def test_tools_run_with_jax_and_matplotlib_blocked(ld_graph, tmp_path):
    argv = ["--input", str(ld_graph), "--max_dist", "50000", "--min_weight",
            "0.3"]
    r = _blocked("ngsld_tpu_torch.tools.prune", argv)
    assert r.returncode == 0, r.stderr
    assert r.stdout == _main(j_prune, argv)[1]

    ld = tmp_path / "d.ld"
    _decay_file(ld, 0, seed=5)
    lst = tmp_path / "files.txt"
    lst.write_text(f"{ld}\n")
    argv = ["--ld_files", str(lst), "--seed", "3", "--fit_level", "3"]
    r = _blocked("ngsld_tpu_torch.tools.fit_decay", argv)
    assert r.returncode == 0, r.stderr
    assert r.stdout == _main(j_fit_decay, argv)[1]

    stem, want = _parts(tmp_path)
    r = _blocked("ngsld_tpu_torch.tools.merge", ["--out", str(stem)
                                                 + ".m", str(stem)])
    assert r.returncode == 0, r.stderr
    assert open(f"{stem}.m").read() == want

    # ld_blocks: the module loads and extracts without matplotlib; its
    # main always plots, so it stops at the plot's import
    r = _blocked("ngsld_tpu_torch.tools.ld_blocks",
                 [str(ld), "chr1:1-100000", "--out_prefix",
                  str(tmp_path / "blk")])
    assert r.returncode != 0 and "in plot_heatmap" in r.stderr
    assert "import of matplotlib halted" in r.stderr


def test_pipeline_port_cli_then_port_prune(tmp_path, monkeypatch):
    """The port's CLI on the CPU, then the port's prune, against the JAX
    package's prune on --engine strict output of the same fixture."""
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    paths = write_all(simulate(n_ind=10, n_sites=250, seed=21),
                      str(tmp_path / "fx"))
    common = ["--geno", paths["beagle"], "--probs", "--n_ind", "10",
              "--n_sites", "250", "--pos", paths["pos"], "--max_kb_dist",
              "10", "--min_maf", "0.05", "--verbose", "0"]
    ref, ours = tmp_path / "strict.ld", tmp_path / "port.ld"
    j_strict.run(Params(in_geno=paths["beagle"], in_probs=True, n_ind=10,
                        n_sites=250, in_pos=paths["pos"], max_kb_dist=10,
                        min_maf=0.05, out=str(ref)).finalize())
    assert port_cli(common + ["--out", str(ours)]) == 0
    threshold = 0.2
    w = np.array([float(ln.split("\t")[6])
                  for ln in ref.read_text().splitlines()[1:]])
    assert len(w) > 1000 and (np.abs(w - threshold) > 1e-6).all()
    argv = ["--max_kb_dist", "10", "--min_weight", str(threshold)]
    want = _main(j_prune, argv + ["--input", str(ref)])
    got = _main(prune, argv + ["--input", str(ours)])
    assert got == want
    kept = got[1].split()
    assert 10 < len(kept) < 250
