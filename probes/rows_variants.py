#!/usr/bin/env python3
"""Probe (not part of the port): source variants of the rows kernel,
csrc/pair_em_rows.cu, timed against the kernel as it is, on the card it
runs on. Each variant is the kernel's own source with one change, made by
text substitution here, built with the package's nvcc flags into
probes/.build/ (which git ignores), loaded with ctypes and put in the
place of the package's library, so that the wrapper pair_em_rows launches
it; every run is held against the kernel as built (nIter and n_used exact,
f to its dtype's rounding), and that against the plain version on the
2,048-pair cell (the plain version's gathered operands of 524,288 pairs do
not fit the card):

  unroll 1, unroll 2   the term loop unrolled 1 or 2 times (4 as built)
  4/2/1 remainder      four terms a trip, then two, then one, written out
  masked trips         every trip four terms, those past the cohort with
                       inclusion 0 (no remainder loop)
  reciprocal           the term's 1 / s as __drcp_rn (the same bits)
  double rows          the rows widened once into shared memory as doubles
                       (no conversion a term, twice the bytes; f32 tables)
  threads T            the block width forced to T, to 1,024 (the kernel
                       built with a 1,024-thread bound)

Cells: random pairs of a 512-individual panel tiled to the cohort, as
chip_smoke.py phase 3d builds them (2,048 pairs of seed 5 on panel seed 3;
524,288 pairs of seed 11 on panel seed 13). Run from the root of the repo
on a machine with the card:

    python3 probes/rows_variants.py

It prints the card's name and power limit, then one line a cell, then the
whole as one JSON object.

The substitutions match the kernel's source as PERF.md's numbers for these
variants were taken from it; any later edit of pair_em_rows.cu may break
them (_sub raises where its text is gone). The probe is kept as the source
of those numbers and is not kept up with the kernel.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.modules["jax"] = None          # the port imports neither
sys.modules["ngsld_tpu"] = None

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ngsld_tpu_torch.kernels import build  # noqa: E402
from ngsld_tpu_torch.kernels import pair_em as pmod  # noqa: E402

OUT = os.path.join(ROOT, "probes", ".build")
LOOP = '''#pragma unroll 4
    for (int i = tid; i < I; i += nthr) {
      const double x0 = r1[3 * i], x1 = r1[3 * i + 1], x2 = r1[3 * i + 2];
      const double y0 = r2[3 * i], y1 = r2[3 * i + 1], y2 = r2[3 * i + 2];
      em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                           a1, a2, a3);
    }'''
TERM = '''
      const double x0 = r1[3 * c], x1 = r1[3 * c + 1], x2 = r1[3 * c + 2];
      const double y0 = r2[3 * c], y1 = r2[3 * c + 1], y2 = r2[3 * c + 2];
      TERM_FN<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0, a1,
                           a2, a3, LIVE);'''
# em_term with a weight (masked trips) or a reciprocal in place of 1 / s
TERM_FNS = '''
template <bool kIgnoreMiss>
__device__ __forceinline__ void term_v(
    double x0, double x1, double x2, double y0, double y1, double y2,
    double f0, double f1, double f2, double f3, double& a0, double& a1,
    double& a2, double& a3, bool live) {
  const double q00 = f0 * y0 + f1 * y1, q01 = f0 * y1 + f1 * y2;
  const double q10 = f2 * y0 + f3 * y1, q11 = f2 * y1 + f3 * y2;
  const double d0 = x0 * q00 + x1 * q10;
  const double d1 = x0 * q01 + x1 * q11;
  const double d2 = x1 * q00 + x2 * q10;
  const double d3 = x1 * q01 + x2 * q11;
  const double s = ((f0 * d0 + f1 * d1) + f2 * d2) + f3 * d3;
  double inc = live ? 1.0 : 0.0;
  if (kIgnoreMiss && (is_miss(x0, x1, x2) || is_miss(y0, y1, y2))) inc = 0;
#if RECIPROCAL
  const double r = inc * __drcp_rn(s);
#else
  const double r = inc / s;
#endif
  a0 += d0 * r;
  a1 += d1 * r;
  a2 += d2 * r;
  a3 += d3 * r;
}
'''


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"the kernel source no longer holds: {old[:60]}")
    return src.replace(old, new)


def variants(src):
    """{name: source} of every variant."""
    base = _sub(src, '#include "em_core.cuh"',
                '#include "../../ngsld_tpu_torch/csrc/em_core.cuh"')
    fns = _sub(base, "constexpr int kIterMax", TERM_FNS
               + "\nconstexpr int kIterMax")
    one = TERM.replace("TERM_FN", "term_v")
    out = {
        "unroll 1": _sub(base, LOOP, LOOP.replace("unroll 4", "unroll 1")),
        "unroll 2": _sub(base, LOOP, LOOP.replace("unroll 4", "unroll 2")),
        "4/2/1 remainder": _sub(fns, LOOP, "    int i = tid;\n"
                                "    for (; i + 3 * nthr < I; i += 4 * nthr) {"
                                + "".join("\n      { const int c = i + %d * "
                                          "nthr;%s }" % (u, one.replace(
                                              "LIVE", "true"))
                                          for u in range(4))
                                + "\n    }\n    if (i + nthr < I) {"
                                + "".join("\n      { const int c = i + %d * "
                                          "nthr;%s }" % (u, one.replace(
                                              "LIVE", "true"))
                                          for u in range(2))
                                + "\n      i += 2 * nthr;\n    }\n"
                                "    if (i < I) { const int c = i;"
                                + one.replace("LIVE", "true") + " }"),
        "masked trips": _sub(fns, LOOP, "    for (int i0 = tid; i0 < I; i0 += "
                             "4 * nthr) {\n#pragma unroll\n      for (int u = "
                             "0; u < 4; ++u) {\n        const int i = i0 + u "
                             "* nthr, c = i < I ? i : I - 1;"
                             + one.replace("LIVE", "i < I")
                             + "\n      }\n    }"),
        "reciprocal": "#define RECIPROCAL 1\n" + _sub(
            fns, LOOP, "#pragma unroll 4\n    for (int c = tid; c < I; c += "
            "nthr) {" + one.replace("LIVE", "true") + "\n    }"),
        "threads to 1024": _sub(base, "constexpr int kMaxThreads = 512;",
                                "constexpr int kMaxThreads = 1024;"),
    }
    wide = base
    for old, new in (
            ("  T* __restrict__ r1 = reinterpret_cast<T*>(part + 8 * nwarps);"
             "\n  T* __restrict__ r2 = r1 + 3 * (int64_t)I;",
             "  double* __restrict__ r1 = reinterpret_cast<double*>(part + 8 "
             "* nwarps);\n  double* __restrict__ r2 = r1 + 3 * (int64_t)I;"),
            ("  stage(r1, g1, 3 * I, vec16, tid, nthr);\n"
             "  stage(r2, g2, 3 * I, vec16, tid, nthr);\n"
             "  __pipeline_commit();\n  __pipeline_wait_prior(0);",
             "  for (int j = tid; j < 3 * I; j += nthr) {\n"
             "    r1[j] = (double)g1[j];\n    r2[j] = (double)g2[j];\n  }"),
            ("      const T* a = r1 + 3 * i;\n      const T* b = r2 + 3 * i;",
             "      const double* a = r1 + 3 * i;\n"
             "      const double* b = r2 + 3 * i;"),
            ("2 * 3 * (size_t)I * sizeof(T)", "2 * 3 * (size_t)I * 8")):
        wide = _sub(wide, old, new)
    out["double rows"] = wide
    return out


def build_all():
    """Build every variant at once; {name: ctypes library}."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(build.CSRC, "pair_em_rows.cu")) as fh:
        srcs = variants(fh.read())
    procs = {}
    for name, src in srcs.items():
        stem = os.path.join(OUT, "rows_" + re.sub(r"\W+", "_", name))
        with open(stem + ".cu", "w") as fh:
            fh.write(src)
        procs[name] = (stem + ".so", subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-3000:]}")
        lib = ctypes.CDLL(path)
        for fn, argtypes in build.ENTRY_POINTS["pair_em_rows"].items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


# (pairs, cohort, table itemsize, the variants, widths for "threads to 1024")
CELLS = ((2_048, 4_000, 4, "all", (256, 512)),
         (524_288, 800, 4, "all", ()),
         (524_288, 4_000, 4, "all", (320, 512)),
         (524_288, 6_000, 4, "loops", (512, 640, 768, 1024)),
         (524_288, 8_000, 4, "loops", (512, 640, 768, 1024)),
         (524_288, 2_048, 8, "loops", (256, 320, 512)))


def main():
    dev = torch.device("cuda", 0)
    print(cs._run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]), flush=True)
    build.build_libraries()
    libs = {"as built": build.get_library("pair_em_rows"), **build_all()}
    limit = pmod.smem_limits(dev)[1]
    res = {}
    for n_pairs, n_ind, esz, which, widths in CELLS:
        dtype = torch.float32 if esz == 4 else torch.float64
        tol = cs.F32_TOL if esz == 4 else cs.F64_TOL
        sidx = cs._random_pairs(n_pairs, 5 if n_pairs == 2_048 else 11)
        gn, _, maf = cs._tiled_panel(4_096, n_ind, 3 if n_pairs == 2_048
                                     else 13, dev)
        gn, maf = gn.to(dtype), maf.to(dtype)
        base = pmod.pair_em_rows(gn, sidx, maf, False)
        if n_pairs <= 2_048:
            cs._check(base, pmod.pair_em_rows_ref(gn, sidx, maf, False), tol,
                      "as built", quiet=True)
        rule = pmod.rows_threads(n_ind, esz, dev)
        runs = [(name, rule) for name in libs
                if name != "threads to 1024" and (which == "all" or name in (
                    "as built", "unroll 1", "unroll 2", "4/2/1 remainder"))
                and not (name == "double rows" and (esz == 8 or 6 * n_ind * 8
                                                    + 2 * rule > limit))]
        runs += [("threads to 1024", t) for t in widths
                 if pmod.rows_block_smem(n_ind, esz, t) <= limit]
        runs += [("as built", rule)]   # again: the spread of one variant
        row = {}
        for name, t in runs:
            build._LIBS["pair_em_rows"] = libs[name]
            try:
                with cs._rows_forced(t):
                    ms, out = cs._time(lambda: pmod.pair_em_rows(gn, sidx,
                                                                 maf, False))
            finally:
                build._LIBS["pair_em_rows"] = libs["as built"]
            cs._check(out, base, tol, f"{name} T={t}", quiet=True)
            row.setdefault(f"{name}, T={t}", []).append(round(ms, 3))
        key = f"{esz * 8}-bit P={n_pairs} I={n_ind}"
        res[key] = row
        print(f"  {key} (ms; each held against the kernel as built): {row}",
              flush=True)
        del gn, maf, sidx, base
    print(json.dumps(res))


if __name__ == "__main__":
    main()
