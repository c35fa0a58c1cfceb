"""Merge multi-host ring output shards into one reference-shaped file.

A multi-host `--ring` run writes one `OUT.partNNNNN` per process (each
process owns its resident site-blocks' rows; see engine ring driver). The
reference produces a single TSV (ngsLD.cpp:72-77), so the
pod workflow ends here: concatenate the shards in part order, keeping a
single header line.

Usage:
    ngsld-merge OUT                    # finds OUT.part00000, OUT.part00001, ...
    ngsld-merge --out merged.ld OUT
    ngsld-merge --out merged.ld a.part00000 a.part00001 ...

With a single non-file argument STEM, shards are discovered as
`STEM.part*` and ordered by their numeric part index. Explicit file lists
are merged in the order given. Only the first header encountered is kept;
a leading header line on any later shard is dropped (shards written by
process 0 carry the header, others do not — but re-merges and hand-split
files stay safe).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

_HEADER_RE = re.compile(rb"^site1\tsite2\tdist\t")


def discover_parts(stem: str) -> list:
    """`STEM` -> existing `STEM.part*` files sorted by part index."""
    hits = glob.glob(glob.escape(stem) + ".part*")
    keyed = []
    for h in hits:
        m = re.search(r"\.part(\d+)$", h)
        if m:
            keyed.append((int(m.group(1)), h))
    return [h for _, h in sorted(keyed)]


def merge(parts: list, out_fh, delete: bool = False) -> int:
    """Concatenate `parts` into `out_fh` (binary), single header.
    Returns the number of data bytes written."""
    written = 0
    header_done = False
    for k, p in enumerate(parts):
        with open(p, "rb") as fh:
            head = fh.readline()
            if _HEADER_RE.match(head):
                if not header_done:
                    out_fh.write(head)
                    written += len(head)
                    header_done = True
                # else: duplicate header — drop it
            else:
                out_fh.write(head)
                written += len(head)
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                out_fh.write(chunk)
                written += len(chunk)
    if delete:
        for p in parts:
            os.unlink(p)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ngsld-merge",
        description="Merge multi-host ring output shards (OUT.partNNNNN) "
                    "into one TSV with a single header.")
    ap.add_argument("inputs", nargs="+",
                    help="output stem (finds STEM.part*) or explicit shard "
                         "files in merge order")
    ap.add_argument("--out", default=None,
                    help="merged output path (default: the stem itself when "
                         "discovering, else stdout)")
    ap.add_argument("--delete-parts", action="store_true",
                    help="remove the shard files after a successful merge")
    args = ap.parse_args(argv)

    if len(args.inputs) == 1 and not os.path.exists(args.inputs[0]):
        stem = args.inputs[0]
        parts = discover_parts(stem)
        if not parts:
            print(f"ngsld-merge: no shards found for {stem}.part*",
                  file=sys.stderr)
            return 1
        out_path = args.out if args.out is not None else stem
    else:
        parts = args.inputs
        missing = [p for p in parts if not os.path.exists(p)]
        if missing:
            print(f"ngsld-merge: missing shard(s): {', '.join(missing)}",
                  file=sys.stderr)
            return 1
        out_path = args.out

    if out_path is None:
        merge(parts, sys.stdout.buffer, delete=args.delete_parts)
        sys.stdout.buffer.flush()
    else:
        tmp = out_path + ".tmp"
        with open(tmp, "wb") as fh:
            merge(parts, fh, delete=False)
        os.replace(tmp, out_path)   # atomic: never leave a partial merge
        if args.delete_parts:
            for p in parts:
                os.unlink(p)
        print(f"==> merged {len(parts)} shard(s) into {out_path}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
