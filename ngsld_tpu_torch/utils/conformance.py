"""Column contracts between a fast engine's TSV and the strict oracle's.

One copy shared by chip_smoke.py and the port's tests. Both are copied
unchanged from test-file functions of the JAX package:
  * compare        — tests/test_engine.py:38-74 (f64 engines)
  * cmp_vs_strict  — tests/test_pallas_strip.py:222-256 (_cmp_vs_strict,
                     f32 engines)
"""

from __future__ import annotations

import numpy as np


def compare(s_rows, j_rows):
    """Column contract between the fast engine and the byte-exact oracle:

    * same pair set, same order
    * >=90% of rows byte-identical
    * D, hap freqs, mafs, chi2: within one %f print quantum (1e-6)
    * Dp, r2: within 5e-5 (ratio stats amplify the EM's 1e-5 stop tolerance)
    * degenerate pairs (an estimated hap MAF at the 0/1 boundary within the
      EM tolerance) exempt Dp/r2/chi2 — 0/0 forms, garbage in both engines
    * nIter within 2
    """
    assert s_rows[0] == j_rows[0]
    assert len(s_rows) == len(j_rows)
    n_exact = 0
    for sr, jr in zip(s_rows[1:], j_rows[1:]):
        if sr == jr:
            n_exact += 1
            continue
        sf, jf = sr.split("\t"), jr.split("\t")
        assert sf[:2] == jf[:2], f"pair mismatch: {sf[:2]} vs {jf[:2]}"
        hm1, hm2 = float(sf[14]), float(sf[15])  # hap_maf1, hap_maf2
        degenerate = any(np.isnan(m) or min(m, 1 - m) < 2e-5 for m in (hm1, hm2))
        for c, (a, b) in enumerate(zip(sf[2:], jf[2:])):
            if a == b:
                continue
            av, bv = float(a), float(b)
            if np.isnan(av) and np.isnan(bv):
                continue
            if c == 16:  # nIter may differ on convergence knife-edges
                assert abs(av - bv) <= 2, f"nIter far apart: {sr} vs {jr}"
            elif c in (3, 4, 14):  # Dp, r2, chi2
                if not degenerate:
                    assert abs(av - bv) <= 5e-5, f"col {c}: {a} vs {b}\n{sr}\n{jr}"
            else:
                assert abs(av - bv) <= 1.01e-6, f"col {c}: {a} vs {b}\n{sr}\n{jr}"
    assert n_exact >= 0.9 * (len(s_rows) - 1), \
        f"only {n_exact}/{len(s_rows)-1} rows exact"


def cmp_vs_strict(s_lines, r_lines, min_rows):
    """Shared column comparison: pair set byte-exact, values f32-grade.

    Near-degenerate hap-MAF denominators amplify both the engines'
    SHARED 1e-5 EM stop tolerance and the derive rounding, so Dp/r2
    (cols 5, 6) carry a denominator-scaled tolerance below 1e-3 —
    2e-3 + 6e-6/den, the tier-2 derive-only repair's measured bound at
    ~10x margin (test_refine.test_derive_only_band_bound) — so no
    denominator range is unasserted (VERDICT r3 item 5). chi2 (col 16)
    stays excluded below 1e-3: its expected-count denominators make it
    stop-point-dependent across ANY two implementations; the exact-zero
    tier's byte equality is pinned by test_refine / conformance."""
    assert len(s_lines) == len(r_lines) > min_rows
    for a, b in zip(s_lines[1:], r_lines[1:]):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:3] == fb[:3]
        hap = [float(v) for v in fa[10:14]]
        m0, m1 = 1 - (hap[0] + hap[1]), 1 - (hap[0] + hap[2])
        den = min(abs(m0 * m1), abs((1 - m0) * (1 - m1)),
                  abs(m0 * (1 - m1)), abs((1 - m0) * m1))
        fragile = den < 1e-3
        for c in range(3, len(fa)):
            if fragile and c == 16:
                continue
            tol = 2e-3
            if fragile and c in (5, 6):
                tol = 2e-3 + 6e-6 / max(den, 1e-12)
            x, y = float(fa[c]), float(fb[c])
            if c == 18:
                assert abs(x - y) <= 2, (a, b)
                continue
            if not (np.isfinite(x) and np.isfinite(y)):
                assert x == y or (np.isnan(x) and np.isnan(y)), (c, a, b)
                continue
            assert abs(x - y) <= tol, (c, den, a, b)
