"""ngsld-prune — LD-graph pruning to a linkage-equilibrium SNP set.

Functional port of the reference's pruning tools
(scripts/prune_ngsLD.py, and the older prune_graph.pl):
build an undirected graph from the pairwise LD TSV, iteratively remove the
"heaviest" node (or keep it and remove its neighbors) until no edges remain,
then print the surviving positions.

Semantics matched to prune_ngsLD.py:
  * nodes = every label seen in the first two columns (isolated nodes are
    kept and emitted);
  * edges filtered by dist > max_dist and weight < min_weight
    (prune_ngsLD.py:114-126); weight_type a|e|n = abs / raw / count
    (:104-106, :128-130);
  * edge weights quantized to int(weight * 10^precision) (:157-160);
  * node weight = sum of incident quantized weights; ties broken by
    lexicographically smallest lowercase label (:171-175);
  * keep_heavy removes the heaviest node's neighbors instead (:178-183);
  * output = kept labels split on ':', sorted by (chr, int(pos)), printed
    as chr:pos (:193-200); --print_excl dumps dropped labels the same way.
"""

from __future__ import annotations

import argparse
import heapq
import math
import sys

from ..strict import open_maybe_gz


def build_graph(lines, field_dist: int, field_weight: int, max_dist: float,
                min_weight: float, weight_type: str, precision: int):
    """Returns (nodes list in first-seen order, adjacency {u: {v: w_int}})."""
    scale = 10 ** precision
    nodes: dict = {}
    adj: dict = {}

    def node(name):
        if name not in nodes:
            nodes[name] = len(nodes)
            adj[name] = {}
        return name

    for ln in lines:
        f = ln.rstrip("\n").split("\t")
        u, v = node(f[0]), node(f[1])
        dist = float(f[field_dist - 1])
        w = float(f[field_weight - 1])
        if weight_type == "a":
            w = abs(w)
        if max_dist is not None and dist > max_dist:
            continue
        if min_weight is not None and w < min_weight:
            continue
        if not math.isfinite(w):
            # degenerate pairs (zero-variance r2 etc.) print nan/inf; they
            # carry no usable LD weight and would overflow quantization
            # (checked before the 'n' override so count-mode skips them too)
            continue
        if weight_type == "n":
            w = 1.0
        wq = int(w * scale)
        # parallel edges accumulate, like repeated rows in a graph
        adj[u][v] = adj[u].get(v, 0) + wq
        adj[v][u] = adj[v].get(u, 0) + wq
    return list(nodes), adj


def prune(nodes, adj, keep_heavy: bool = False, debug=None):
    """Iteratively drop the heaviest node (or its neighbors) until edgeless.
    Returns (kept, dropped) label lists.

    The reference takes max(weight) over ALL vertices while ANY edges
    remain (prune_ngsLD.py:163-186) — including zero/negative-weight and
    isolated ones (raw D weights can be negative under --weight_type e;
    isolated weight-0 vertices get selected and dropped before
    negative-weight edged ones). Self-loop rows (site1 == site2) are
    tolerated."""
    weight = {u: sum(adj[u].values()) for u in nodes}
    n_self = sum(1 for u in nodes if u in adj[u])
    n_edges = (sum(len(a) for a in adj.values()) + n_self) // 2
    alive = set(nodes)
    dropped = []
    # lazy max-heap keyed by (-weight, lowercase label) matches the
    # reference's max-weight-then-lexicographic-lowercase selection
    heap = [(-weight[u], u.lower(), u) for u in nodes]
    heapq.heapify(heap)

    def remove_node(u):
        """Remove u; returns the number of live edges it carried."""
        cut = 0
        for v, w in list(adj[u].items()):
            if v == u:       # self-loop: one edge, no neighbor update
                cut += 1
                continue
            if v in alive:
                cut += 1
                weight[v] -= w
                del adj[v][u]
                heapq.heappush(heap, (-weight[v], v.lower(), v))
        adj[u] = {}
        weight[u] = 0
        alive.discard(u)
        dropped.append(u)
        return cut

    while n_edges > 0:
        while heap:
            negw, _, u = heapq.heappop(heap)
            if u in alive and weight[u] == -negw:
                break
        else:
            break
        if debug:
            print(f"Max weight node and weight: {u} {-negw}", file=debug)
        if keep_heavy:
            for v in [v for v in adj[u] if v in alive]:
                n_edges -= remove_node(v)
        else:
            n_edges -= remove_node(u)
    kept = [u for u in nodes if u in alive]
    return kept, dropped


def _sorted_positions(labels):
    def key(lbl):
        chrom, _, pos = lbl.partition(":")
        try:
            return (chrom, int(pos))
        except ValueError:
            return (chrom, 0)
    return sorted(labels, key=key)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ngsld-prune",
        description="Prune SNPs from pairwise LD output to a set in "
                    "approximate linkage equilibrium.")
    ap.add_argument("--input", default=None, help=".ld TSV (optionally gz) [STDIN]")
    ap.add_argument("--output", default=None, help="kept positions out [STDOUT]")
    ap.add_argument("--field_dist", type=int, default=3)
    ap.add_argument("--field_weight", type=int, default=7)
    ap.add_argument("--max_dist", type=float, default=None,
                    help="max bp distance for nodes to be connected")
    ap.add_argument("--max_kb_dist", type=float, default=None,
                    help="prune_graph.pl-compatible alias: max distance in "
                         "KB (prune_graph.pl:22); mutually exclusive with "
                         "--max_dist")
    ap.add_argument("--in_file", dest="input_alias", default=None,
                    help="prune_graph.pl-compatible alias for --input")
    ap.add_argument("--out", dest="output_alias", default=None,
                    help="prune_graph.pl-compatible alias for --output")
    ap.add_argument("--min_weight", type=float, required=True,
                    help="min edge weight for nodes to be connected")
    ap.add_argument("--weight_type", choices=["a", "e", "n"], default="a",
                    help="abs weight | raw weight | edge count")
    ap.add_argument("--keep_heavy", action="store_true",
                    help="keep heaviest nodes, drop their neighbors")
    ap.add_argument("--print_excl", default=None, help="file for dropped nodes")
    ap.add_argument("--subset", default=None, help="file of node IDs to include")
    ap.add_argument("--weight_precision", type=int, default=4)
    ap.add_argument("--debug", action="store_true")
    args = ap.parse_args(argv)
    if (args.max_dist is None) == (args.max_kb_dist is None):
        ap.error("exactly one of --max_dist (bp) or --max_kb_dist (kb) "
                 "is required")
    if args.max_kb_dist is not None:
        args.max_dist = args.max_kb_dist * 1000.0
    if args.input_alias is not None:
        args.input = args.input_alias
    if args.output_alias is not None:
        args.output = args.output_alias

    fh = open_maybe_gz(args.input) if args.input else sys.stdin
    lines = iter(fh)
    first = next(lines, None)
    rows = []
    if first is not None and not first.startswith(("site1", "Pos1", "#")):
        rows.append(first)  # headerless input
    rows.extend(lines)
    if fh is not sys.stdin:
        fh.close()

    nodes, adj = build_graph(rows, args.field_dist, args.field_weight,
                             args.max_dist, args.min_weight, args.weight_type,
                             args.weight_precision)
    if args.subset:
        with open(args.subset) as sf:
            allowed = set(sf.read().split())
        for u in [n for n in nodes if n not in allowed]:
            for v in adj[u]:
                adj[v].pop(u, None)
            adj[u] = {}
        nodes = [n for n in nodes if n in allowed]

    kept, dropped = prune(nodes, adj, args.keep_heavy,
                          debug=sys.stderr if args.debug else None)

    out = open(args.output, "w") if args.output else sys.stdout
    for lbl in _sorted_positions(kept):
        out.write(lbl + "\n")
    if args.output:
        out.close()
    if args.print_excl:
        with open(args.print_excl, "w") as ef:
            for lbl in _sorted_positions(dropped):
                ef.write(lbl + "\n")
    print(f"Pruning complete! Kept {len(kept)} of {len(kept) + len(dropped)} "
          "positions.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
