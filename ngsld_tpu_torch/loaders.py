"""Host->device input loaders of the torch engine (ngsld_tpu/loaders.py).

Three streaming paths, all with the reference's exact read semantics
(read_data.cpp:13-116):
  * _StreamedGLLoader    binary doubles: slab reader + uploader threads
  * _StreamedTextLoader  gz text: pieces inflated by the reader thread,
                         their slices parsed on a pool of threads
  * _ring_sharded_tables this rank's block of the --ring table, filled
                         slab by slab into its rows of one device tensor

Each replaces read -> f64 normalise -> f32 narrow -> one monolithic upload
(three serial passes over the data) with a pipeline: a reader thread
produces slabs, an uploader thread copies each to the device, join()
concatenates them there. On a CUDA device a slab crosses from pinned host
memory with a non-blocking copy on a side stream; join() synchronises that
stream before the table is handed over. The binary reader only reads: its
raw doubles go to the device as they are, and the consumer narrows and
checks them there (kernels/gl_narrow.py, one launch a slab).

_OverlapIngest goes one step further for binary input: the binary loader
in its streaming mode (stream_np=True: the reader thread only) feeds an
ingest thread that uploads and preprocesses slab by slab into full-size
device tables while the block sweep already runs, each block dispatched
once its sites are in (the engine's gate: engine_block._overlap_engaged,
NGSLD_OVERLAP_UPLOAD). Not carried over: the tunnel keep-alive hooks.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading

import numpy as np
import torch

from . import strict
from .kernels.gl_narrow import narrow_check
from .utils.logging import RunLog


def _nan_error():
    """The reference's error on a record that post_prob turns into a NaN
    (read_data.cpp:44)."""
    return strict.StrictError("read_geno",
                              "NaN found! Is the file format correct?")


def _eof_error():
    """strict.read_geno's error on a file with fewer records than
    n_sites."""
    return strict.StrictError("read_geno", "GENO file at premature EOF. "
                              "Check GENO file and number of sites!")


def _not_eof_error():
    """read_geno's error on any byte after the n_sites-th record."""
    return strict.StrictError("read_geno", "GENO file not at EOF. "
                              "Check GENO file and number of sites!")


class _SlabUploader:
    """The part both loaders share: a bounded queue of host slabs, an
    uploader thread, and join(); or, with stream_np=True, no uploader and
    the host slabs handed out by np_slabs(). log: the run's RunLog, which
    gets the threads' spans (load: read, parse, queue wait, upload) and
    the GENO file's bytes as stored (counter load_bytes). A subclass that
    sets _flag before this __init__ gets each device slab through
    _arrived() and join() raises the reference's NaN error when the flag
    is set."""

    _flag = None

    def __init__(self, pars, np_dtype, device, name: str, stream_np=False,
                 log=None):
        self._log = RunLog(0) if log is None else log
        self._pars = pars
        self._dt = np_dtype
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = None
        if self._cuda and not stream_np:
            self._stream = torch.cuda.Stream(self._device)
            # _flag's zeros are written on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
        self._q = queue.Queue(maxsize=2)
        self._slabs = []    # device slabs, file order
        self._pinned = []   # host sides of copies still in flight
        self._err = []
        self._ended = False  # np_slabs() has taken the end of the stream
        self.n_slabs = 0    # set by join()
        self._reader = threading.Thread(
            target=self._read_guarded, daemon=True, name=f"ngsld-{name}-read")
        self._reader.start()
        self._uploader = None
        if not stream_np:
            self._uploader = threading.Thread(
                target=self._upload, daemon=True, name=f"ngsld-{name}-upload")
            self._uploader.start()

    def _read(self):
        raise NotImplementedError

    def _read_guarded(self):
        try:
            self._read()
            self._log.count("load_bytes",
                            os.path.getsize(self._pars.in_geno))
        except BaseException as e:
            self._err.append(e)
        self._q.put(None)

    def _put(self, a):
        """The reader's hand-off of a slab (blocks while the queue is
        full)."""
        with self._log.span("load: queue wait"):
            self._q.put(a)

    def _arrived(self, t):
        """A slab on the device, on the uploader's stream: what join()
        concatenates."""
        return t

    def _upload(self):
        try:
            while True:
                a = self._q.get()
                if a is None:
                    return
                with self._log.span("load: upload"):
                    if torch.is_tensor(a):   # pinned by the reader
                        t = a
                    else:
                        t = torch.from_numpy(a)
                        if self._cuda:
                            t = t.pin_memory()
                    if self._cuda:
                        # the copy runs on the side stream while the reader
                        # fills the next slab; the pinned slab must outlive
                        # it
                        with torch.cuda.stream(self._stream):
                            self._slabs.append(self._arrived(
                                t.to(self._device, non_blocking=True)))
                        self._pinned.append(t)
                    else:
                        self._slabs.append(self._arrived(t))
        except BaseException as e:
            self._err.append(e)
            # drain so the reader never blocks on a full queue
            while self._q.get() is not None:
                pass

    def np_slabs(self):
        """stream_np mode: yield the host slabs in file order (the reader
        keeps at most 2 queued); raises the reader's error (the reference's
        EOF semantics) after the stream ends."""
        while True:
            a = self._q.get()
            if a is None:
                break
            yield a
        self._ended = True
        self._reader.join()
        if self._err:
            raise self._err[0]

    def drain(self):
        """stream_np mode, a consumer that stops early: take the slabs left
        so that the reader never blocks on a full queue."""
        while not self._ended:
            self._ended = self._q.get() is None

    def join(self) -> torch.Tensor:
        """The whole (n_sites, n_ind, 3) table on the device; raises the
        reference's NaN error when the flag is set, else the reader's or
        the uploader's error (a bad record lies before any read error)."""
        self._reader.join()
        self._uploader.join()
        if self._cuda:
            self._stream.synchronize()
            self._pinned.clear()
            # later work runs on the current stream
            torch.cuda.current_stream(self._device).wait_stream(self._stream)
        if self._flag is not None and self._flag.item():
            raise _nan_error()
        if self._err:
            raise self._err[0]
        self.n_slabs = len(self._slabs)
        out = (torch.cat(self._slabs, dim=0) if self.n_slabs > 1
               else self._slabs[0])
        self._slabs = []
        return out


class _StreamedGLLoader(_SlabUploader):
    """Binary GL fast path: a reader thread reads slabs of raw doubles (on
    a CUDA device straight into pinned host memory), an uploader thread
    copies each to the device and narrows and checks it there
    (narrow_check, on its stream), one device-side concatenate at join().
    With stream_np the raw slabs go to np_slabs() instead (pinned torch
    tensors on a CUDA device, numpy arrays on the CPU), and the consumer
    (_OverlapIngest) narrows and checks them.

    The records arrive UNNORMALISED; normalisation moves into the device
    preprocess (ops.preprocess raw=True). Only used when the file size
    matches exactly (ngsLD.cpp:55 semantics): anything else goes through
    strict.read_geno, which raises the reference's exact errors.

    NaN parity: the reference errors on NaN after post_prob
    (read_data.cpp:44-45). narrow_check flags, on the records narrowed to
    the table's dtype: raw NaN; +inf anywhere (inf - inf in the
    normalise); log-scale all-(-inf) records (-inf - -inf); linear-scale
    negatives (log -> NaN). Linear zeros are FINE: conv_space clamps the
    -inf to a finite -INF (gen_func.cpp:127-128). The one deviation: a
    finite f64 > f32-max narrows to +inf and errors where the f64
    reference would accept it; use --precision f64 for such
    (pathological) inputs.
    """

    SLAB_BYTES = 256 << 20

    @staticmethod
    def applicable(pars) -> bool:
        if not pars.in_bin or os.environ.get("NGSLD_NO_FASTBIN") == "1":
            return False
        try:
            size = os.path.getsize(pars.in_geno)
        except OSError:
            return False
        return size == pars.n_sites * pars.n_ind * 3 * 8

    def __init__(self, pars, np_dtype, device, stream_np=False, log=None):
        self._tdt = torch.from_numpy(np.empty(0, np_dtype)).dtype
        if not stream_np:
            # the run's bad-record flag, ORed by every slab's check
            self._flag = torch.zeros(1, dtype=torch.int32, device=device)
        super().__init__(pars, np_dtype, device, "gl", stream_np, log)

    def _arrived(self, t):
        return narrow_check(t, self._tdt, self._pars.in_logscale, self._flag)

    def _read(self):
        p = self._pars
        n, m = p.n_sites, p.n_ind
        # NGSLD_SLAB_BYTES: test/tuning override (small values force the
        # multi-slab path on tiny fixtures)
        slab_bytes = int(os.environ.get("NGSLD_SLAB_BYTES", self.SLAB_BYTES))
        slab_sites = max(1, slab_bytes // (m * 3 * 8))
        span = self._log.span
        with open(p.in_geno, "rb", buffering=0) as fh:
            s = 0
            while s < n:
                k = min(slab_sites, n - s)
                with span("load: read"):
                    # torch's caching host allocator hands back the pinned
                    # blocks of earlier slabs once their copies are done
                    t = torch.empty((k, m, 3), dtype=torch.float64,
                                    pin_memory=self._cuda)
                    a = t.numpy()
                    buf, got = memoryview(a).cast("B"), 0
                    while got < len(buf):
                        r = fh.readinto(buf[got:])
                        if not r:
                            raise _eof_error()
                        got += r
                self._put(t if self._cuda else a)
                s += k


class _StreamedTextLoader(_SlabUploader):
    """gz-text GL fast path (Beagle probs / called-genotype formats): the
    reader thread inflates the text piece by piece and its whole-line
    slices parse on PARSE_THREADS worker threads (_text_slabs), while an
    uploader thread copies the slabs to the device. Records arrive already
    log-normalised (the parser is the code path of the native read_geno),
    so the engine's standard (raw=False) preprocess applies.

    EOF parity with read_geno (read_data.cpp:33,106-109): fewer lines than
    n_sites -> 'premature EOF'; ANY byte after the n_sites-th record ->
    'not at EOF'. NGSLD_NO_FASTTEXT=1 opts out."""

    # decompressed bytes of one piece: the reader inflates the next piece
    # while the slices of the last one parse
    CHUNK_BYTES = 6 << 20
    # a piece parses in at most PARSE_THREADS slices of at least
    # MIN_SLICE_BYTES each (so a small file parses in one). One core is
    # left to the reader: its inflate sets the pace, and a parse thread on
    # every core slows it by a third
    PARSE_THREADS = max(1, min((os.cpu_count() or 1) - 1, 8))
    MIN_SLICE_BYTES = 128 << 10

    @staticmethod
    def applicable(pars) -> bool:
        if pars.in_bin or os.environ.get("NGSLD_NO_FASTTEXT") == "1":
            return False
        try:
            from .native import get_lib
            return get_lib() is not None
        except Exception:
            return False

    def __init__(self, pars, np_dtype, device, log=None):
        super().__init__(pars, np_dtype, device, "gltext", log=log)

    def _read(self):
        # NGSLD_SLAB_BYTES caps the decompressed bytes of a piece, as it
        # caps the binary loader's slab (small values force several
        # pieces on tiny fixtures)
        piece = min(self.CHUNK_BYTES, int(os.environ.get(
            "NGSLD_SLAB_BYTES", self.CHUNK_BYTES)))
        # on a card the slices are parsed straight into pinned slabs
        for a in _text_slabs(self._pars, self._dt, piece, self._log,
                             "ngsld-gltext-parse", pinned=self._cuda):
            self._put(a)


def _fill(fh, buf, start):
    """Read from fh into buf[start:len(buf) - 1] (the last byte stays
    spare); returns (bytes in buf, whether the file ended)."""
    cap = len(buf) - 1
    with memoryview(buf) as mv:
        while start < cap:
            r = fh.readinto(mv[start:cap])
            if not r:
                return start, True
            start += r
    return start, False


def _text_slabs(pars, np_dtype, piece_bytes, log, thread_name,
                pinned=False):
    """The records of a text GENO file (gz or plain; Beagle probs or
    called genotypes), log-normalised as read_geno makes them, at np_dtype
    (float32 or float64), as host slabs in file order: numpy arrays, or
    pinned torch tensors when `pinned`. Raises read_geno's errors
    (read_data.cpp:13-116), each where read_geno would.

    The calling thread inflates the file in pieces of piece_bytes into two
    buffers in turn, each with a spare byte for the NUL of a last line
    without '\\n' (a line longer than a piece grows its buffer). A piece's
    whole lines are cut into up to PARSE_THREADS slices, which parse on a
    pool of threads of that name (span `load: parse slice`), each into its
    rows of one slab of the slices' line count (C counts them), while the
    caller inflates the next piece; the caller takes the slices back in
    file order (span `load: parse`) and hands on the piece's slab.
    Only lines before the file's first record are tested as headers with
    read_geno's first-site rule: while no record has been read, the
    caller parses a piece's lines up to its first record itself. So the
    thread count never changes a record or an error: a bad line raises
    only where fewer than n_sites records come before it, and any byte
    after the n_sites-th record raises 'not at EOF', whichever slice or
    piece holds it. Counters: parse_threads, parse_slices."""
    from concurrent.futures import ThreadPoolExecutor

    from .native import count_lines_native, parse_geno_text_to
    n, m = pars.n_sites, pars.n_ind
    f32 = np.dtype(np_dtype) == np.float32
    tdt = torch.float32 if f32 else torch.float64
    n_threads = _StreamedTextLoader.PARSE_THREADS
    floor = _StreamedTextLoader.MIN_SLICE_BYTES
    span = log.span
    log.count("parse_threads", n_threads)

    rec_bytes = m * 3 * np.dtype(np_dtype).itemsize

    def alloc(rows):
        """A host slab of `rows` records, and its address."""
        if pinned:
            t = torch.empty((rows, m, 3), dtype=tdt, pin_memory=True)
            return t, t.data_ptr()
        a = np.empty((rows, m, 3), np_dtype)
        return a, a.ctypes.data

    def parse(base, length, s_global, addr, rows):
        """The `length` bytes at address `base` parsed into at most `rows`
        records at address addr: (records, bytes up to the end of the
        last record's line, the error's text or None)."""
        return parse_geno_text_to(base, length, pars.in_probs,
                                  pars.in_logscale, m, s_global, addr, f32,
                                  rows)

    def parse_slice(buf, slab, *args):
        """parse() on the pool; buf and slab, which hold the slice's bytes
        and its rows, stay alive while the call runs."""
        with span("load: parse slice"):
            return parse(*args)

    s = 0   # records taken so far

    def take(piece):
        """The slabs of a piece's slices, in file order, checked against
        n_sites: views of the piece's slab, one where every line of the
        slices was a record."""
        nonlocal s
        if piece is None:
            return []
        slab, parts = piece
        runs = []   # [first row, end row) of the records
        for off, length, f in parts:
            got, last_end, err = f.result()
            if err is not None:
                # read_geno stops at its n_sites-th record, before this line
                raise (strict.StrictError("read_geno", err) if s + got < n
                       else _not_eof_error())
            if s + got > n or (s + got == n and last_end < length):
                raise _not_eof_error()
            s += got
            if runs and runs[-1][1] == off:
                runs[-1][1] = off + got
            elif got:
                runs.append([off, off + got])
        return [slab[r0:r1] for r0, r1 in runs]

    def submit(buf, base, body):
        """Parse buf[:body] (whole lines): the head up to the file's first
        record here, the rest in slices on the pool, each into its rows of
        one slab sized by the slices' lines. Returns (the head's slab, the
        piece for take())."""
        nonlocal s
        head, a = [], 0
        if s == 0:
            out, addr = alloc(1)
            got, last_end, err = parse(base, body, 0, addr, 1)
            if err is not None:
                raise strict.StrictError("read_geno", err)
            a = last_end if got else body
            if got:
                head, s = [out], 1
        if a == body:
            return head, None
        q = max(1, min(n_threads, (body - a) // floor))
        edges = [a]
        for i in range(1, q):
            nl = buf.find(b"\n", a + (body - a) * i // q - 1, body)
            if nl < 0 or nl + 1 >= body:
                break
            if nl + 1 > edges[-1]:
                edges.append(nl + 1)
        edges.append(body)
        lines = [count_lines_native(base + e0, e1 - e0)
                 for e0, e1 in zip(edges, edges[1:])]
        slab, addr = alloc(sum(lines))
        parts, off = [], 0
        for e0, e1, rows in zip(edges, edges[1:], lines):
            parts.append((off, e1 - e0, pool.submit(
                parse_slice, buf, slab, base + e0, e1 - e0, s,
                addr + off * rec_bytes, rows)))
            off += rows
        log.count("parse_slices", len(parts))
        return head, (slab, parts)

    bufs = [bytearray(piece_bytes + 1) for _ in range(2)]
    pool = ThreadPoolExecutor(n_threads, thread_name_prefix=thread_name)
    piece = None   # the slices of the last piece, still parsing
    try:
        with strict.open_maybe_gz(pars.in_geno, "rb") as fh:
            k, c = 0, 0   # the piece, the bytes carried into its buffer
            while True:
                buf = bufs[k % 2]
                with span("load: read"):   # the inflate included
                    end, eof = _fill(fh, buf, c)
                    while not eof and buf.rfind(b"\n", 0, end) < 0:
                        # a line longer than the buffer
                        buf = bytearray(2 * len(buf) - 1)
                        buf[:end] = bufs[k % 2][:end]
                        bufs[k % 2] = buf
                        end, eof = _fill(fh, buf, end)
                body = end if eof else buf.rfind(b"\n", 0, end) + 1
                with span("load: parse"):
                    slabs, piece = take(piece), None
                    if body:
                        if s >= n:
                            raise _not_eof_error()
                        base = np.frombuffer(buf, np.uint8).ctypes.data
                        head, piece = submit(buf, base, body)
                        slabs += head
                yield from slabs
                if eof:
                    break
                k += 1
                c = end - body
                nxt = bufs[k % 2]
                if len(nxt) < len(buf):
                    nxt = bufs[k % 2] = bytearray(len(buf))
                nxt[:c] = buf[body:end]
            with span("load: parse"):
                slabs = take(piece)
            yield from slabs
            if s < n:
                raise _eof_error()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


# host bytes of one slab of the ring loader: the loader's host memory is
# O(one slab), whatever the table's size (NGSLD_SLAB_BYTES overrides)
RING_SLAB_BYTES = 16 << 20


def _ring_sharded_tables(pars, n_dev, B, Sp, np_dt, log, device, m=None,
                         spare=0):
    """Site-sharded table load for --ring (loaders._ring_sharded_tables of
    the reference): the (Sp, n_ind, 3) table as n_dev blocks of B rows,
    one a site block of the mesh. This rank loads its own block only
    (block m.pi; block 0 without a mesh), and under --shard_ind only its
    n_ind / shard_ind individual columns (slice m.ii). The block is
    allocated on the device once, with `spare` rows past it (the gather
    steppers' visiting slots), and filled slab by slab from the GENO file
    into its rows: binary input seeks straight to the block's first
    record, text input is parsed once and the other blocks' records are
    dropped as they parse. Host memory is O(one slab), never O(table) or
    O(block). Rows past n_sites, and the spare rows, are pad rows: a
    uniform record in the file's space.

    Returns (gl, raw): raw=True means the records are UNNORMALISED file
    values (binary fast path) and preprocess must run with raw=True,
    in_log=pars.in_logscale; raw=False means log-normalised (gz-text
    parse, or the strict.read_geno fallback, whose host memory is
    O(table) and which logs a note). The three routes keep the
    reference's read semantics and error surface (read_data.cpp:13-116):
    a NaN is checked on whole records, all individuals, of this block.
    """
    n, m_ind = pars.n_sites, pars.n_ind
    k = 0 if m is None else m.pi
    n_is = 1 if m is None else m.shard_ind
    assert Sp == B * n_dev and (m is None or m.shard == n_dev)
    cols = slice(None)
    if n_is > 1:
        ipl = m_ind // n_is
        cols = slice(m.ii * ipl, (m.ii + 1) * ipl)
    lo = k * B                         # the block's first site
    rows = max(0, min(B, n - lo))      # its real sites
    device = torch.device(device)
    gl = torch.empty((B + spare, m_ind // n_is, 3), dtype=torch.from_numpy(
        np.empty(0, np_dt)).dtype, device=device)
    pad_log = np_dt(np.log(1.0 / 3.0))
    slab_bytes = int(os.environ.get("NGSLD_SLAB_BYTES", RING_SLAB_BYTES))

    def put(s, a):
        """global sites [s, s + len(a)) from a host slab of whole records,
        where they fall in this block"""
        a0, a1 = max(s, lo), min(s + len(a), lo + rows)
        if a1 > a0:
            gl[a0 - lo:a1 - lo].copy_(torch.from_numpy(
                np.ascontiguousarray(a[a0 - s:a1 - s, cols], dtype=np_dt)))

    if _StreamedGLLoader.applicable(pars):
        # binary fast path: RAW f64 records, narrowed and NaN-checked slab
        # by slab (the checks of _StreamedGLLoader), normalised on device;
        # pad rows must normalise to a harmless uniform record in whichever
        # space the RAW file is in
        gl[rows:].fill_(float(pad_log) if pars.in_logscale else 1.0 / 3.0)
        rec = m_ind * 3
        slab_sites = max(1, slab_bytes // (rec * 8))
        with open(pars.in_geno, "rb") as fh:
            fh.seek(lo * rec * 8)
            s = lo
            while s < lo + rows:
                cnt = min(slab_sites, lo + rows - s)
                a = np.fromfile(fh, dtype=np.float64,
                                count=cnt * rec).reshape(cnt, m_ind, 3)
                a = a.astype(np_dt, copy=False)
                bad = np.isnan(a).any() or np.isposinf(a).any()
                if not bad:
                    bad = (np.isneginf(a).all(axis=-1).any()
                           if pars.in_logscale else bool((a < 0).any()))
                if bad:
                    raise _nan_error()
                put(s, a)
                del a
                s += cnt
        return gl, True

    gl[rows:].fill_(float(pad_log))
    if _StreamedTextLoader.applicable(pars):
        # gz-text: the text loader's parallel parse of the whole file
        # (records arrive log-normalised); this block's records go
        # straight into their rows, the others are dropped as they parse
        s = 0
        for a in _text_slabs(pars, np_dt, min(
                slab_bytes, _StreamedTextLoader.CHUNK_BYTES), log,
                "ngsld-ring-parse"):
            put(s, a)
            s += len(a)
        return gl, False

    # fallback: the strict reader (the reference's exact error surface);
    # this DOES hold the table on the host, logged so at-scale users notice
    log.log(2, "==> ring: input not stream-shardable; using the strict "
               "reader (host memory O(table))")
    geno_log = strict.read_geno(pars.in_geno, pars.in_bin, pars.in_probs,
                                pars.in_logscale, m_ind, n)
    step = max(1, slab_bytes // (m_ind * 3 * 8))
    for s in range(lo, lo + rows, step):
        put(s, geno_log[s:min(s + step, lo + rows)])
    return gl, False


class _OverlapIngest:
    """Slab-wise upload and preprocess UNDER the block sweep
    (ngsld_tpu/loaders.py::_OverlapIngest).

    The serial chain join() -> preprocess(whole table) -> sweep puts the
    whole host->device GL transfer before the first block. Here one ingest
    thread takes the binary loader's raw host slabs (np_slabs(), file
    order; pinned by the reader on a CUDA device), and for each: copies it
    to the device with a non-blocking copy on its own CUDA stream, narrows
    and checks it there (narrow_check into the table's dtype, the run's
    bad-record flag), runs the engine's preprocess (`pre`, raw=True) on it,
    writes the results into the slab's rows of full-size device tables,
    and pulls the slab's MAF into maf_host as f64 and the flag beside it.
    That pull waits for the slab's whole chain on the side stream; only
    after it, and only with the flag clear, does the thread raise the
    coverage (sites resident) and wake the waiters, so a sweep that has
    passed wait(need) launches on its own stream only reads rows that are
    written, and never a site of a slab with a bad record. Each site's preprocess reads its own row
    alone (ops.preprocess.site_sum), so the tables are the monolithic
    preprocess's byte for byte.

    The tables (gn (S, I, 3), maf (S,), eg (S, I) in `dt`) are allocated
    once, on the sweep's stream, before the thread starts; the slabs'
    temporaries are allocated and freed on the side stream. On the CPU the
    same thread runs without a stream.

    maf_host: the MAF (f64), filled slab by slab: read a site's value only
    after a wait() or join_all() that covers it. failed: the ingest raised
    (the reader's NaN error, a premature end, anything else), after which
    the engine truncates a partial output (the reference prints nothing on
    bad input, read_data.cpp:44). Every waiter is woken on failure. log:
    the run's RunLog, which gets the thread's spans (ingest: slab wait,
    upload, preprocess, maf pull).
    """

    def __init__(self, loader, pars, dt, pre, device, log):
        n, m = pars.n_sites, pars.n_ind
        device = torch.device(device)
        self._log = log
        self._loader = loader
        self._pre = pre
        self._in_log = pars.in_logscale
        self._n = n
        self.maf_host = np.zeros(n, np.float64)
        self.failed = False
        self.n_slabs = 0
        self._err = None
        self._cov = 0
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self.tables = (torch.empty((n, m, 3), dtype=dt, device=device),
                       torch.empty(n, dtype=dt, device=device),
                       torch.empty((n, m), dtype=dt, device=device))
        self._stream = None
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
            # the allocator may hand the tables memory that work queued
            # earlier on the sweep's stream still reads
            self._stream.wait_stream(torch.cuda.current_stream(device))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ngsld-ingest")
        self._thread.start()

    def _run(self):
        gn, maf, eg = self.tables
        span = self._log.span
        off = 0
        try:
            with (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext()):
                # the bad-record flag, ORed by every slab's check, and its
                # host copy
                flag = torch.zeros(1, dtype=torch.int32, device=gn.device)
                flag_h = torch.zeros(1, dtype=torch.int32,
                                     pin_memory=self._stream is not None)
                for slab in self._log.spans_of("ingest: slab wait",
                                               self._loader.np_slabs()):
                    if self._stop.is_set():
                        break
                    k = len(slab)
                    with span("ingest: upload"):
                        t = (torch.from_numpy(slab)
                             if isinstance(slab, np.ndarray)
                             else slab.to(gn.device, non_blocking=True))
                    with span("ingest: preprocess"):
                        gs, ms, es = self._pre(
                            narrow_check(t, gn.dtype, self._in_log, flag))
                        gn[off:off + k].copy_(gs)
                        maf[off:off + k].copy_(ms)
                        eg[off:off + k].copy_(es)
                    # the pull synchronises the side stream: every write
                    # above, and the flag's copy, has landed when it returns
                    with span("ingest: maf pull"):
                        flag_h.copy_(flag, non_blocking=True)
                        self.maf_host[off:off + k] = ms.cpu().numpy()
                    del t, gs, ms, es
                    if flag_h.item():
                        raise _nan_error()
                    off += k
                    with self._cv:
                        self._cov = off
                        self.n_slabs += 1
                        self._cv.notify_all()
            if self._stop.is_set():
                self._loader.drain()
            elif off != self._n:   # the reader stopped early without raising
                raise _eof_error()
        except BaseException as e:
            with self._cv:
                self._err = e
                self.failed = True
                self._cv.notify_all()
            self._loader.drain()

    def wait(self, need: int):
        """Block until the first `need` sites are in the tables; returns
        the (gn, maf, eg) device tables. Raises the ingest's error if it
        failed short of them (the reference's NaN and EOF semantics)."""
        with self._cv:
            while self._cov < need and self._err is None:
                self._cv.wait()
            if self._cov < need:
                raise self._err
        return self.tables

    def join_all(self):
        """Wait for the whole table (the strip sweep; the end of a run, so
        that a tail-of-file read error surfaces); returns the tables."""
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self.tables

    def stop(self):
        """A run that ends without join_all(): the thread stops after the
        slab in hand, and the reader's queue is drained. Joins nothing."""
        self._stop.set()

