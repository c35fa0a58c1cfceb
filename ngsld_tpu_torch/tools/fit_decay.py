"""ngsld-fit-decay — fit LD-decay curves to pairwise LD output.

Functional port of the reference's scripts/fit_LDdecay.R:

Models (fit_LDdecay.R:179-201):
  * r2/r2_ExpG with --n_ind > 0: Hill & Weir finite-sample 1-parameter decay
      E[r2] = ((10+C)/((2+C)(11+C))) * (1 + ((3+C)(12+12C+C^2))/(n(2+C)(11+C)))
    with C = rate * dist.
  * r2/r2_ExpG without n_ind: 3-parameter Sved extension
      (r2h - r2l)/(1 + C) + r2l.
  * Dp: Abecasis-style  Dl + (Dh-Dl) * (1 - dist*recomb_rate/1e6)^t.
  * D has no model (skipped, fit_LDdecay.R:215).

Pipeline parity: per-file MAF/dist filters (:129-134), Inf->NA (:138),
optional Haldane genetic distance (:140-141), fixed-size binning with mean
or quantile aggregation (:143-151), multi-start SSE optimization with
BFGS / Nelder-Mead / L-BFGS-B by --fit_level (:231-233), convergence and
bound filtering incl. LDmax >= LDmin (:243-247), optional bootstrap CIs
(:264-272), optional plot (matplotlib instead of ggplot).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..strict import open_maybe_gz

LD_STATS = ("r2_ExpG", "D", "Dp", "r2")


def ld_exp(par, dist, ld_stat, n_ind, recomb_rate):
    p1, p2, p3 = float(par[0]), float(par[1]), float(par[2])
    if ld_stat in ("r2", "r2_ExpG"):
        C = p1 * dist
        if n_ind:
            return (((10 + C) / ((2 + C) * (11 + C)))
                    * (1 + ((3 + C) * (12 + 12 * C + C ** 2))
                       / (n_ind * (2 + C) * (11 + C))))
        return (p2 - p3) / (1 + C) + p3
    if ld_stat == "Dp":
        return p3 + (p2 - p3) * np.power(1 - dist * recomb_rate / 1e6, p1)
    raise ValueError(ld_stat)


def _fit_one(dist, value, ld_stat, n_ind, recomb_rate, fit_level, rng):
    from scipy.optimize import minimize

    def sse(par):
        with np.errstate(all="ignore"):
            model = ld_exp(par, dist, ld_stat, n_ind, recomb_rate)
            return float(np.sum((model - value) ** 2))

    if ld_stat == "Dp":
        lo, hi = np.zeros(3), np.array([np.inf, 1.0, 1.0])
    else:
        lo, hi = np.zeros(3), np.ones(3)

    candidates = []
    n_iter = fit_level if fit_level >= 10 else 1
    for _ in range(n_iter):
        init = rng.uniform(size=3)
        init[0] = rng.uniform(10, 20) if ld_stat == "Dp" else rng.uniform(0, 0.1)
        runs = [minimize(sse, init, method="BFGS")]
        if fit_level > 1:
            runs.append(minimize(sse, init, method="Nelder-Mead"))
        if fit_level > 2:
            runs.append(minimize(sse, init, method="L-BFGS-B",
                                 bounds=list(zip(lo, hi))))
        candidates += runs

    if n_ind and ld_stat != "Dp":
        for r in candidates:
            r.x = np.array([r.x[0], 0.0, 0.0])

    ok = [r for r in candidates if r.success
          and np.all(r.x >= lo - 1e-12) and np.all(r.x <= hi + 1e-12)
          and r.x[1] >= r.x[2]]
    if not ok:
        return None
    best = min(ok, key=lambda r: r.fun)
    return np.asarray(best.x, dtype=float)


def load_ld_file(path, ld_stats, min_maf, max_kb_dist, use_recomb, recomb_rate,
                 fit_bin_size, bin_quant, header=True):
    """Read one .ld TSV into {stat: (dist, value)} after filtering/binning."""
    with open_maybe_gz(path) as fh:
        first = fh.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
        if first and first[0] == "site1":
            cols = first
        else:  # headerless input: standard column order, first line is data
            cols = ["site1", "site2", "dist", "r2_ExpG", "D", "Dp", "r2"]
            rows.insert(0, first)
        idx = {c: i for i, c in enumerate(cols)}

    # one parse pass over the rows: pull every needed column at once
    # (col-at-a-time float() passes multiply load time on multi-GB files)
    want = ["dist"] + [s for s in ld_stats]
    if "maf1" in idx and "maf2" in idx:
        want += ["maf1", "maf2"]
    for stat in ld_stats:
        if stat not in idx:
            raise SystemExit(f"column {stat} not in {path}")
    take = [idx[c] for c in want]
    mat = np.array([[float(r[i]) for i in take] for r in rows])
    mat = mat.reshape(-1, len(want))  # empty input: (0,) -> (0, n_cols)
    bycol = {c: mat[:, j] for j, c in enumerate(want)}

    dist = bycol["dist"]
    keep = dist < max_kb_dist * 1000
    if "maf1" in bycol:
        keep &= (bycol["maf1"] >= min_maf) & (bycol["maf2"] >= min_maf)
    out = {}
    for stat in ld_stats:
        v = bycol[stat][keep]
        d = dist[keep]
        fin = np.isfinite(v) & np.isfinite(d)
        v, d = v[fin], d[fin]
        if use_recomb:
            d = (1 - (1 - recomb_rate * 0.01 / 1e6) ** d) / 2
        if fit_bin_size > 1 and len(d):
            # left-open right-closed bins (a, b], like the R reference's
            # cut() (fit_LDdecay.R:143-151): an edge-exact distance joins
            # the LOWER bin, and dist <= 0 falls outside all bins (R's NA)
            edges = np.arange(0, d.max() + 2 * fit_bin_size, fit_bin_size)
            which = np.digitize(d, edges, right=True) - 1
            bd, bv = [], []
            for b in np.unique(which):
                if b < 0:  # dist <= 0: R's cut() yields NA -> dropped
                    continue
                sel = which == b
                bd.append(edges[b])
                bv.append(np.quantile(v[sel], bin_quant / 100)
                          if bin_quant > 0 else v[sel].mean())
            d, v = np.array(bd), np.array(bv)
        out[stat] = (d, v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ngsld-fit-decay",
        description="Fit LD decay models to ngsld output files.")
    ap.add_argument("--ld_files", default=None,
                    help="file listing .ld paths (one per line) [STDIN]")
    ap.add_argument("--ld", default="r2", help="comma list of stats to fit "
                    "(r2_ExpG, D, Dp, r2) [r2]")
    ap.add_argument("--n_ind", type=int, default=0)
    ap.add_argument("--use_recomb_rate", "-r", action="store_true")
    ap.add_argument("--recomb_rate", type=float, default=1.0)
    ap.add_argument("--min_maf", type=float, default=0.0)
    ap.add_argument("--max_kb_dist", type=float, default=float("inf"))
    ap.add_argument("--fit_boot", type=int, default=0)
    ap.add_argument("--fit_bin_size", type=float, default=250)
    ap.add_argument("--fit_level", type=int, default=1)
    ap.add_argument("--bin_quant", type=float, default=0)
    ap.add_argument("--plot_x_lim", type=float, default=None, help="kb")
    ap.add_argument("--out", "-o", default=None, help="plot file (pdf/png); "
                    "fit table always goes to stdout")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    ld_stats = [s for s in args.ld.split(",") if s]
    for s in ld_stats:
        if s not in LD_STATS:
            raise SystemExit(f"Invalid LD measure to plot: {s}")
    if args.n_ind and not any(s in ("r2", "r2_ExpG") for s in ld_stats):
        raise SystemExit("Number of individuals is only used for r^2 fitting")

    rng = np.random.default_rng(args.seed)
    if args.ld_files:
        with open(args.ld_files) as fh:
            files = [ln.split()[0] for ln in fh if ln.strip()]
    else:
        files = [ln.split()[0] for ln in sys.stdin if ln.strip()]

    results = []
    curves = []
    for path in files:
        data = load_ld_file(path, ld_stats, args.min_maf, args.max_kb_dist,
                            args.use_recomb_rate, args.recomb_rate,
                            args.fit_bin_size, args.bin_quant)
        for stat in ld_stats:
            if stat == "D":
                continue  # no decay model for D
            d, v = data[stat]
            par = _fit_one(d, v, stat, args.n_ind, args.recomb_rate,
                           args.fit_level, rng)
            if par is None:
                raise SystemExit("convergence analyses failed. Please try "
                                 "increasing the fit level (--fit_level)")
            row = dict(File=path, LD=stat, DecayRate=par[0], LDmax=par[1],
                       LDmin=par[2])
            if args.fit_boot > 0:
                boots = []
                for _ in range(args.fit_boot):
                    sel = rng.integers(0, len(d), len(d))
                    bp = _fit_one(d[sel], v[sel], stat, args.n_ind,
                                  args.recomb_rate, args.fit_level, rng)
                    if bp is not None:
                        boots.append(bp)
                if boots:
                    q = np.quantile(np.array(boots), [0.025, 0.975], axis=0)
                    row.update(DecayRate_CI_l=q[0, 0], DecayRate_CI_u=q[1, 0],
                               LDmax_CI_l=q[0, 1], LDmax_CI_u=q[1, 1],
                               LDmin_CI_l=q[0, 2], LDmin_CI_u=q[1, 2])
            results.append(row)
            curves.append((path, stat, d, v, par))

    # union of keys across rows: a row whose bootstrap fits all failed has
    # no CI columns and must print nan there, not raise
    cols = []
    for row in results:
        cols += [c for c in row if c not in cols]
    print("\t".join(cols))
    for row in results:
        print("\t".join(
            f"{row[c]:.6g}" if isinstance(row.get(c), float)
            else str(row.get(c, "nan")) for c in cols))

    if args.out:
        _plot(curves, args, ld_stats)
    return 0


def _plot(curves, args, ld_stats):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, max(len(ld_stats), 1),
                             figsize=(5 * len(ld_stats), 4), squeeze=False)
    ax_of = {s: axes[0, i] for i, s in enumerate(ld_stats)}
    for path, stat, d, v, par in curves:
        ax = ax_of[stat]
        xmax = args.plot_x_lim * 1000 if args.plot_x_lim else (d.max() if len(d) else 1)
        xs = np.linspace(1, xmax, 1000)
        ax.plot(d, v, ".", ms=2, alpha=0.4)
        ax.plot(xs, ld_exp(par, xs, stat, args.n_ind, args.recomb_rate),
                label=f"{path}")
        ax.set_xlabel("distance (bp)")
        ax.set_ylabel(stat)
        ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(args.out)


if __name__ == "__main__":
    sys.exit(main())
