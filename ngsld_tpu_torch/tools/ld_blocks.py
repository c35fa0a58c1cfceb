"""ngsld-blocks — LD block heatmaps for a genomic region.

Functional port of the reference's scripts/LD_blocks.sh: extract the rows of
a pairwise .ld file whose BOTH sites fall inside chr:start-end, then render
triangular LD heatmaps for r^2 (column 7) and D' (column 6). The reference
shells out to R's LDheatmap; here matplotlib draws the classic rotated
lower-triangle block plot.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..strict import open_maybe_gz


def parse_site(label):
    chrom, _, pos = label.rpartition(":")
    try:
        return chrom, int(float(pos))
    except ValueError:
        return None, None


def extract_region(path, chrom, start, end):
    """Rows with both sites inside [start, end] on chrom."""
    sites = {}
    entries = []
    with open_maybe_gz(path) as fh:
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            if not f or f[0] == "site1":
                continue
            c1, p1 = parse_site(f[0])
            c2, p2 = parse_site(f[1])
            if c1 != chrom or c2 != chrom or p1 is None or p2 is None:
                continue
            if not (start <= p1 <= end and start <= p2 <= end):
                continue
            sites.setdefault(p1, None)
            sites.setdefault(p2, None)
            def fl(x):
                try:
                    v = float(x)
                    return v if np.isfinite(v) else np.nan
                except ValueError:
                    return np.nan
            entries.append((p1, p2, fl(f[5]) if len(f) > 5 else np.nan,
                            fl(f[6]) if len(f) > 6 else np.nan))
    pos = sorted(sites)
    index = {p: i for i, p in enumerate(pos)}
    n = len(pos)
    dp = np.full((n, n), np.nan)
    r2 = np.full((n, n), np.nan)
    for p1, p2, v_dp, v_r2 in entries:
        i, j = index[p1], index[p2]
        dp[i, j] = dp[j, i] = v_dp
        r2[i, j] = r2[j, i] = v_r2
    return pos, dp, r2


def plot_heatmap(pos, mat, title, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(pos)
    fig, ax = plt.subplots(figsize=(8, 5))
    # rotated lower triangle: cell (i,j), i<j -> x=(i+j)/2, y=(j-i)/2
    xs, ys, cs = [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            if np.isfinite(mat[i, j]):
                xs.append((i + j) / 2.0)
                ys.append((j - i) / 2.0)
                cs.append(abs(mat[i, j]))
    sc = ax.scatter(xs, ys, c=cs, cmap="Reds", vmin=0, vmax=1, marker="D",
                    s=max(2, int(4000 / max(n, 1) ** 1.5)))
    ax.set_title(f"{title}  ({n} SNPs, {pos[0]}-{pos[-1]})" if n else title)
    ax.invert_yaxis()
    ax.set_xticks([])
    ax.set_yticks([])
    fig.colorbar(sc, ax=ax, label=title)
    fig.tight_layout()
    fig.savefig(out_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ngsld-blocks",
        description="Plot LD-block heatmaps (r2 and D') for a region from "
                    "ngsld output.")
    ap.add_argument("input", help=".ld file (optionally gz)")
    ap.add_argument("region", help="chr:start-end, e.g. chrSIM_1:1-50000")
    ap.add_argument("--out_prefix", default=None,
                    help="output prefix [input basename + region]")
    args = ap.parse_args(argv)

    chrom, _, rng = args.region.partition(":")
    start, _, end = rng.partition("-")
    start, end = int(start or 0), int(end or 2 ** 62)

    pos, dp, r2 = extract_region(args.input, chrom, start, end)
    if not pos:
        print(f"No sites found in {args.region}", file=sys.stderr)
        return 1
    prefix = args.out_prefix or f"{args.input}.{chrom}_{start}_{end}"
    plot_heatmap(pos, r2, "r2", f"{prefix}.r2.pdf")
    plot_heatmap(pos, dp, "Dp", f"{prefix}.Dp.pdf")
    print(f"{prefix}.r2.pdf\n{prefix}.Dp.pdf")
    return 0


if __name__ == "__main__":
    sys.exit(main())
