"""Host->device input loaders of the torch engine (ngsld_tpu/loaders.py).

Three streaming paths, all with the reference's exact read semantics
(read_data.cpp:13-116):
  * _StreamedGLLoader    binary doubles: slab reader + uploader threads
  * _StreamedTextLoader  gz text through the native chunk parser
  * _ring_sharded_tables this rank's block of the --ring table, filled
                         slab by slab into its rows of one device tensor

Each replaces read -> f64 normalise -> f32 narrow -> one monolithic upload
(three serial passes over the data) with a pipeline: a reader thread
produces slabs at the engine's precision, an uploader thread copies each
to the device, join() concatenates them there. On a CUDA device a slab
crosses from pinned host memory with a non-blocking copy on a side stream;
join() synchronises that stream before the table is handed over.

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
from .utils.logging import RunLog


class _SlabUploader:
    """The part both loaders share: a bounded queue of host slabs, an
    uploader thread, and join(); or, with stream_np=True, no uploader and
    the host slabs handed out by np_slabs(). log: the run's RunLog, which
    gets the threads' spans (load: read, parse, queue wait, upload) and
    the GENO file's bytes as stored (counter load_bytes)."""

    def __init__(self, pars, np_dtype, device, name: str, stream_np=False,
                 log=None):
        self._log = RunLog(0) if log is None else log
        self._pars = pars
        self._dt = np_dtype
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device)
                        if self._cuda and not stream_np else None)
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

    def _upload(self):
        try:
            while True:
                a = self._q.get()
                if a is None:
                    return
                with self._log.span("load: upload"):
                    t = torch.from_numpy(a)
                    if self._cuda:
                        # the copy runs on the side stream while the reader
                        # fills the next slab; the pinned slab must outlive
                        # it
                        t = t.pin_memory()
                        with torch.cuda.stream(self._stream):
                            self._slabs.append(
                                t.to(self._device, non_blocking=True))
                        self._pinned.append(t)
                    else:
                        self._slabs.append(t)
        except BaseException as e:
            self._err.append(e)
            # drain so the reader never blocks on a full queue
            while self._q.get() is not None:
                pass

    def np_slabs(self):
        """stream_np mode: yield the host slabs in file order (the reader
        keeps at most 2 queued); raises the reader's error (the reference's
        NaN and EOF semantics) after the stream ends."""
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
        reader's error (the reference's NaN and EOF semantics)."""
        self._reader.join()
        self._uploader.join()
        if self._err:
            raise self._err[0]
        if self._cuda:
            self._stream.synchronize()
            self._pinned.clear()
            # later work runs on the current stream
            torch.cuda.current_stream(self._device).wait_stream(self._stream)
        self.n_slabs = len(self._slabs)
        out = (torch.cat(self._slabs, dim=0) if self.n_slabs > 1
               else self._slabs[0])
        self._slabs = []
        return out


class _StreamedGLLoader(_SlabUploader):
    """Binary GL fast path: np.fromfile slabs in a reader thread, uploads in
    an uploader thread, one device-side concatenate at join().

    The records arrive UNNORMALISED; normalisation moves into the device
    preprocess (ops.preprocess raw=True). Only used when the file size
    matches exactly (ngsLD.cpp:55 semantics): anything else goes through
    strict.read_geno, which raises the reference's exact errors.

    NaN parity: the reference errors on NaN after post_prob
    (read_data.cpp:44-45). Raw NaN inputs are checked per slab; all-(-inf)
    log-scale records (which post_prob turns into NaN) are too.
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
        super().__init__(pars, np_dtype, device, "gl", stream_np, log)

    def _read(self):
        p = self._pars
        n, m = p.n_sites, p.n_ind
        # NGSLD_SLAB_BYTES: test/tuning override (small values force the
        # multi-slab path on tiny fixtures)
        slab_bytes = int(os.environ.get("NGSLD_SLAB_BYTES", self.SLAB_BYTES))
        slab_sites = max(1, slab_bytes // (m * 3 * 8))
        span = self._log.span
        with open(p.in_geno, "rb") as fh:
            s = 0
            while s < n:
                k = min(slab_sites, n - s)
                with span("load: read"):
                    a = np.fromfile(fh, dtype=np.float64, count=k * m * 3)
                with span("load: parse"):
                    a = a.reshape(k, m, 3).astype(self._dt, copy=False)
                    # NaN parity checks on the NARROWED slab (half the
                    # bytes), mirroring the reference's NaN-after-post_prob
                    # error (read_data.cpp:42-45): raw NaN; +inf anywhere
                    # (inf - inf in the normalise); log-scale all-(-inf)
                    # records (-inf - -inf); linear-scale negatives (log ->
                    # NaN). Linear zeros are FINE: conv_space clamps the
                    # -inf to a finite -INF (gen_func.cpp:127-128). The one
                    # deviation: a finite f64 > f32-max narrows to +inf and
                    # errors here where the f64 reference would accept it;
                    # use --precision f64 for such (pathological) inputs.
                    bad = np.isnan(a).any() or np.isposinf(a).any()
                    if not bad:
                        if p.in_logscale:
                            bad = np.isneginf(a).all(axis=-1).any()
                        else:
                            bad = bool((a < 0).any())
                if bad:
                    raise strict.StrictError(
                        "read_geno", "NaN found! Is the file format correct?")
                self._put(a)
                s += k


class _StreamedTextLoader(_SlabUploader):
    """gz-text GL fast path (Beagle probs / called-genotype formats):
    decompressed chunks parse through the native line parser in a reader
    thread while an uploader thread copies the slabs to the device. Records
    arrive already log-normalised (the parser is the code path of the
    native read_geno), so the engine's standard (raw=False) preprocess
    applies.

    EOF parity with read_geno (read_data.cpp:33,106-109): fewer lines than
    n_sites -> 'premature EOF'; ANY byte after the n_sites-th record ->
    'not at EOF'. NGSLD_NO_FASTTEXT=1 opts out."""

    CHUNK_BYTES = 48 << 20

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
        from .native import parse_geno_text_native
        p = self._pars
        n = p.n_sites
        # NGSLD_SLAB_BYTES caps the decompressed bytes parsed at once, as
        # it caps the binary loader's slab (small values force several
        # slabs on tiny fixtures)
        chunk_bytes = min(self.CHUNK_BYTES, int(os.environ.get(
            "NGSLD_SLAB_BYTES", self.CHUNK_BYTES)))
        span = self._log.span
        with strict.open_maybe_gz(p.in_geno, "rb") as fh:
            carry = b""
            s = 0
            leftover = b""
            while True:
                with span("load: read"):   # the inflate included
                    data = fh.read(chunk_bytes)
                eof = not data
                buf = carry + data
                if eof:
                    if not buf:
                        break
                    chunk, carry = buf + b"\n", b""  # final bare line
                else:
                    cut = buf.rfind(b"\n")
                    if cut < 0:
                        carry = buf
                        continue
                    chunk, carry = buf[:cut + 1], buf[cut + 1:]
                if s >= n:
                    leftover = chunk
                    break
                with span("load: parse"):
                    recs, used = parse_geno_text_native(
                        chunk, p.in_probs, p.in_logscale, p.n_ind, s,
                        min(chunk.count(b"\n"), n - s))
                    if len(recs):
                        recs = np.ascontiguousarray(recs, dtype=self._dt)
                if len(recs):
                    self._put(recs)
                s += len(recs)
                if used < len(chunk):
                    leftover = chunk[used:]
                    break
                if eof:
                    break
            if s < n:
                raise strict.StrictError(
                    "read_geno", "GENO file at premature EOF. "
                    "Check GENO file and number of sites!")
            if leftover or carry or fh.read(1):
                raise strict.StrictError(
                    "read_geno", "GENO file not at EOF. "
                    "Check GENO file and number of sites!")


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
                    raise strict.StrictError(
                        "read_geno", "NaN found! Is the file format correct?")
                put(s, a)
                del a
                s += cnt
        return gl, True

    gl[rows:].fill_(float(pad_log))
    if _StreamedTextLoader.applicable(pars):
        # gz-text: native chunked parse of the whole file (records arrive
        # log-normalised); this block's records go straight into their
        # rows, the others are dropped as soon as they parse
        from .native import parse_geno_text_native
        chunk_bytes = min(slab_bytes, _StreamedTextLoader.CHUNK_BYTES)
        with strict.open_maybe_gz(pars.in_geno, "rb") as fh:
            carry = b""
            s = 0
            leftover = b""
            while True:
                data = fh.read(chunk_bytes)
                eof = not data
                buf = carry + data
                if eof:
                    if not buf:
                        break
                    chunk, carry = buf + b"\n", b""
                else:
                    cut = buf.rfind(b"\n")
                    if cut < 0:
                        carry = buf
                        continue
                    chunk, carry = buf[:cut + 1], buf[cut + 1:]
                if s >= n:
                    leftover = chunk
                    break
                recs, used = parse_geno_text_native(
                    chunk, pars.in_probs, pars.in_logscale, m_ind, s,
                    min(chunk.count(b"\n"), n - s))
                put(s, recs)
                s += len(recs)
                del recs
                if used < len(chunk):
                    leftover = chunk[used:]
                    break
                if eof:
                    break
            if s < n:
                raise strict.StrictError(
                    "read_geno", "GENO file at premature EOF. "
                    "Check GENO file and number of sites!")
            if leftover or carry or fh.read(1):
                raise strict.StrictError(
                    "read_geno", "GENO file not at EOF. "
                    "Check GENO file and number of sites!")
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
    thread takes the binary loader's host slabs (np_slabs(), file order),
    and for each: pins it, copies it to the device with a non-blocking copy
    on its own CUDA stream, runs the engine's preprocess (`pre`, raw=True)
    on it there, writes the results into the slab's rows of full-size
    device tables, and pulls the slab's MAF into maf_host as f64. That pull
    waits for the slab's whole chain on the side stream; only after it does
    the thread raise the coverage (sites resident) and wake the waiters, so
    a sweep that has passed wait(need) launches on its own stream only
    reads rows that are written. Each site's preprocess reads its own row
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
                for slab in self._log.spans_of("ingest: slab wait",
                                               self._loader.np_slabs()):
                    if self._stop.is_set():
                        break
                    k = len(slab)
                    with span("ingest: upload"):
                        t = torch.from_numpy(slab)
                        if self._stream is not None:
                            t = t.pin_memory().to(gn.device,
                                                  non_blocking=True)
                    with span("ingest: preprocess"):
                        gs, ms, es = self._pre(t)
                        gn[off:off + k].copy_(gs)
                        maf[off:off + k].copy_(ms)
                        eg[off:off + k].copy_(es)
                    # the pull synchronises the side stream: every write
                    # above has landed when it returns
                    with span("ingest: maf pull"):
                        self.maf_host[off:off + k] = ms.cpu().numpy()
                    del t, gs, ms, es
                    off += k
                    with self._cv:
                        self._cov = off
                        self.n_slabs += 1
                        self._cv.notify_all()
            if self._stop.is_set():
                self._loader.drain()
            elif off != self._n:   # the reader stopped early without raising
                raise strict.StrictError(
                    "read_geno", "GENO file at premature EOF. "
                    "Check GENO file and number of sites!")
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

