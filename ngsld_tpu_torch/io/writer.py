"""TSV row emission — the output contract of ngsLD.cpp:72-77,314-351.

RowWriter formats blocks of result rows, preferring the native bulk
formatter (bit-identical to the Python path; see tests/test_native.py) and
falling back to per-row Python formatting. It writes to either text or
binary file handles; binary avoids a bytes->str->bytes round trip on the
native path (the formatted block is pure ASCII).
"""

from __future__ import annotations

import numpy as np

from ..strict import fmt_f, fmt_f0, header_line


class RowWriter:
    def __init__(self, out_fh, labels, extend_out: bool, use_native: bool = True):
        self.fh = out_fh
        self.labels = labels
        self.extend = extend_out
        self.native = None
        if use_native:
            try:
                from ..native import LabelBlob, get_lib, make_labels_blob
                if get_lib() is not None:
                    if isinstance(labels, LabelBlob):
                        self.blob, self.off = labels.blob, labels.off
                    else:
                        self.blob, self.off = make_labels_blob(labels)
                    self.native = True
            except Exception:
                self.native = None

    def _write_bytes(self, data: bytes) -> None:
        try:
            self.fh.write(data)
        except TypeError:
            self.fh.write(data.decode())

    def _write_str(self, s: str) -> None:
        try:
            self.fh.write(s)
        except TypeError:
            self.fh.write(s.encode())

    def write_header(self):
        self._write_str(header_line(self.extend))

    def write_block(self, s1, s2, dist, r2p, D, Dp, r2, **kw):
        self._write_bytes(self.format_block(s1, s2, dist, r2p, D, Dp, r2,
                                            **kw))

    def format_block(self, s1, s2, dist, r2p, D, Dp, r2, *, n_used=None,
                     maf1=None, maf2=None, hap=None, hmaf1=None, hmaf2=None,
                     chi2=None, n_iter=None) -> bytes:
        """Format a block of rows to bytes without touching the file handle
        (lets the engine pipeline formatting and file IO on separate
        threads)."""
        if self.native:
            from ..native import format_rows_native
            data = format_rows_native(
                self.blob, self.off, np.asarray(s1, np.int64),
                np.asarray(s2, np.int64), dist, r2p, D, Dp, r2, self.extend,
                n_used, maf1, maf2, hap, hmaf1, hmaf2, chi2, n_iter)
            if data is not None:
                return data
        labels = self.labels
        rows = []
        for j in range(len(s1)):
            row = (f"{labels[int(s1[j])]}\t{labels[int(s2[j])]}"
                   f"\t{fmt_f0(dist[j])}\t{fmt_f(r2p[j])}\t{fmt_f(D[j])}"
                   f"\t{fmt_f(Dp[j])}\t{fmt_f(r2[j])}")
            if self.extend:
                row += ("\t%d\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s\t%d"
                        % (int(n_used[j]), fmt_f(maf1[j]), fmt_f(maf2[j]),
                           fmt_f(hap[j, 0]), fmt_f(hap[j, 1]),
                           fmt_f(hap[j, 2]), fmt_f(hap[j, 3]),
                           fmt_f(hmaf1[j]), fmt_f(hmaf2[j]),
                           fmt_f(np.float64(chi2[j])), fmt_f(0.0),
                           int(n_iter[j])))
            rows.append(row)
        rows.append("")
        return "\n".join(rows).encode()
