"""Native host runtime: build-on-demand C++ library, ctypes bindings.

Provides fast paths for the reference's host-native components (gz GL
parsing, TSV formatting). Falls back silently to the pure-Python
implementations when no compiler/zlib is available — correctness never
depends on this module, only throughput.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from ..utils.logging import PROCESS

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ngsld_native.cpp")
# build outputs live in the package's .build/ (with the CUDA kernels'),
# never beside the source
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), ".build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build() -> str | None:
    """Compile the shared library into .build/ (cached by mtime)."""
    so = os.path.join(_BUILD_DIR, "_ngsld_native.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    # PID-unique tmp: concurrent first builders (multi-process tests,
    # multi-host pods on shared storage) must not interleave writes into
    # one tmp file; os.replace makes the winner atomic either way
    tmp = f"{so}.tmp.{os.getpid()}"
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # -march=native lets the lane-parallel strict EM vectorize (8 f64
    # lanes on AVX-512 hosts); -ffp-contract=off keeps it bit-exact by
    # forbidding mul+add -> fma contraction (per-lane IEEE ops are
    # otherwise identical to scalar). Falls back to the portable build
    # on toolchains that reject the flags.
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            _SRC, "-lz", "-o", tmp]
    for extra in (["-march=native", "-ffp-contract=off"], []):
        cmd = base[:1] + extra + base[1:]
        try:
            with PROCESS.span("init: native build"):
                subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
            return so
        except subprocess.CalledProcessError:
            continue
        except Exception as e:  # no compiler / no zlib headers
            sys.stderr.write(f"ngsld: native build unavailable ({e}); "
                             "using pure-Python host path\n")
            return None
    sys.stderr.write("ngsld: native build unavailable (compile failed); "
                     "using pure-Python host path\n")
    return None


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        with PROCESS.span("init: native lib"):
            lib = ctypes.CDLL(so)
        i64 = ctypes.c_int64
        lib.ngsld_read_geno_text.restype = ctypes.c_int
        lib.ngsld_read_geno_text.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, i64, i64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_long]
        lib.ngsld_read_geno_bin.restype = ctypes.c_int
        lib.ngsld_read_geno_bin.argtypes = [
            ctypes.c_char_p, ctypes.c_int, i64, i64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_long]
        lib.ngsld_read_pos.restype = ctypes.c_int
        lib.ngsld_read_pos.argtypes = [
            ctypes.c_char_p, i64, i64, ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p, i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.c_char_p, ctypes.c_long]
        lib.ngsld_format_rows_mt.restype = i64
        lib.ngsld_format_rows_mt.argtypes = [
            i64, ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_char),
            i64, ctypes.c_int]
        f32p = ctypes.POINTER(ctypes.c_float)
        dp_t = ctypes.POINTER(ctypes.c_double)
        i32p_t = ctypes.POINTER(ctypes.c_int32)
        for name, vt in (("ngsld_format_rows_derive32", f32p),
                         ("ngsld_format_rows_derive64", dp_t)):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [
                i64, ctypes.c_char_p, ctypes.POINTER(i64),
                ctypes.POINTER(i64), ctypes.POINTER(i64), dp_t, vt, vt,
                ctypes.c_int, i32p_t, dp_t, dp_t, i32p_t,
                i32p_t, dp_t, f32p, i32p_t, i32p_t,   # override columns
                ctypes.POINTER(ctypes.c_char), i64, ctypes.c_int]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for name, vt in (("ngsld_tier_scan32", f32p),
                         ("ngsld_tier_scan64", dp_t)):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [i64, vt, i64, ctypes.c_int, u8p]
        lib.ngsld_pearson_r2.restype = None
        lib.ngsld_pearson_r2.argtypes = [dp_t, dp_t, i64, i64, dp_t]
        lib.ngsld_format_rows_mt32.restype = i64
        lib.ngsld_format_rows_mt32.argtypes = [
            i64, ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_double),
            f32p, f32p, f32p, f32p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            f32p, f32p, f32p, f32p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_char), i64, ctypes.c_int]
        lib.ngsld_fmt_batch.restype = None
        lib.ngsld_fmt_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), i64, ctypes.c_int,
            ctypes.c_char_p]
        lib.ngsld_parse_geno_text.restype = i64
        lib.ngsld_parse_geno_text.argtypes = [
            ctypes.POINTER(ctypes.c_char), i64, ctypes.c_int, ctypes.c_int,
            i64, i64, ctypes.POINTER(ctypes.c_double), i64,
            ctypes.POINTER(i64), ctypes.c_char_p, ctypes.c_long]
        vp = ctypes.c_void_p
        lib.ngsld_parse_geno_text_to.restype = i64
        lib.ngsld_parse_geno_text_to.argtypes = [
            vp, i64, ctypes.c_int, ctypes.c_int, i64, i64, vp, ctypes.c_int,
            i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_long]
        lib.ngsld_count_lines.restype = i64
        lib.ngsld_count_lines.argtypes = [vp, i64]
        u64 = ctypes.c_uint64
        lib.ngsld_child_seeds.restype = None
        lib.ngsld_child_seeds.argtypes = [u64, i64, ctypes.POINTER(u64)]
        lib.ngsld_strict_siteprep.restype = ctypes.c_int
        lib.ngsld_strict_siteprep.argtypes = [
            ctypes.POINTER(ctypes.c_double), i64, i64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.ngsld_strict_pair_em.restype = None
        lib.ngsld_strict_pair_em.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, i64, i64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.ngsld_strict_siteprep_mt.restype = ctypes.c_int
        lib.ngsld_strict_siteprep_mt.argtypes = \
            lib.ngsld_strict_siteprep.argtypes + [ctypes.c_int]
        lib.ngsld_strict_pair_em_mt.restype = None
        lib.ngsld_strict_pair_em_mt.argtypes = \
            lib.ngsld_strict_pair_em.argtypes + [ctypes.c_int]
        lib.ngsld_plan_slab.restype = i64
        lib.ngsld_plan_slab.argtypes = [
            i64, i64, ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.POINTER(i64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_double,
            ctypes.POINTER(u64), ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(ctypes.c_double)]
        _LIB = lib
        return _LIB


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def read_geno_native(path: str, in_bin: bool, in_probs: bool,
                     in_logscale: bool, n_ind: int, n_sites: int):
    """Native read_geno; returns (n_sites, n_ind, 3) float64 log-normalized
    array, or None if the native library is unavailable. Raises StrictError
    on malformed input (same messages as the Python reader)."""
    lib = get_lib()
    if lib is None:
        return None
    from ..strict import StrictError
    out = np.empty((n_sites, n_ind, 3), dtype=np.float64)
    err = ctypes.create_string_buffer(256)
    if in_bin:
        rc = lib.ngsld_read_geno_bin(path.encode(), int(in_logscale),
                                     n_ind, n_sites, _dp(out), err, 256)
    else:
        rc = lib.ngsld_read_geno_text(path.encode(), int(in_probs),
                                      int(in_logscale), n_ind, n_sites,
                                      _dp(out), err, 256)
    if rc != 0:
        raise StrictError("read_geno", err.value.decode())
    return out


def child_seeds_native(master_seed: int, n_sites: int):
    """Per-anchor taus child seeds via the native master stream, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n_sites, np.uint64)
    lib.ngsld_child_seeds(
        ctypes.c_uint64(master_seed & 0xFFFFFFFFFFFFFFFF), n_sites,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def plan_slab_native(s_start: int, s_end: int, counts, maf, min_maf: float,
                     contig, pos, rnd_sample: float, seeds, cap: int):
    """Banded pair enumeration for one anchor slab, or None if the native
    library is unavailable. Returns (a, b, dist) kept arrays."""
    lib = get_lib()
    if lib is None:
        return None
    i64 = ctypes.c_int64
    a = np.empty(cap, np.int64)
    b = np.empty(cap, np.int64)
    d = np.empty(cap, np.float64)

    def ip(x):
        return np.ascontiguousarray(x, np.int64).ctypes.data_as(
            ctypes.POINTER(i64))

    seeds_p = (np.ascontiguousarray(seeds, np.uint64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint64)) if seeds is not None
        else ctypes.POINTER(ctypes.c_uint64)())
    k = lib.ngsld_plan_slab(
        s_start, s_end, ip(counts), _dp(np.ascontiguousarray(maf, np.float64)),
        min_maf, ip(contig), _dp(np.ascontiguousarray(pos, np.float64)),
        rnd_sample, seeds_p, ip(a), ip(b), _dp(d))
    return a[:k], b[:k], d[:k]


class LabelBlob:
    """Site labels backed by a NUL-separated bytes blob + offsets (the
    native read_pos output). Indexing decodes on demand; RowWriter uses the
    blob directly, skipping a million-string Python round trip."""

    __slots__ = ("blob", "off")

    def __init__(self, blob: bytes, off: np.ndarray):
        self.blob = blob
        self.off = off

    def __len__(self):
        return len(self.off)

    def __getitem__(self, i):
        o = int(self.off[i])
        return self.blob[o:self.blob.index(b"\0", o)].decode()

    def __iter__(self):
        for i in range(len(self.off)):
            yield self[i]

    def __eq__(self, other):
        try:
            return len(other) == len(self) and all(
                a == b for a, b in zip(self, other))
        except TypeError:
            return NotImplemented


_READ_POS_WHERE = {1: "read_file", 2: "read_dist", 3: "read_split",
                   4: "read_dist", 5: "read_dist", 6: "read_dist"}


def parse_geno_text_native(chunk: bytes, in_probs: bool, in_logscale: bool,
                           n_ind: int, s_global: int, max_sites: int):
    """Parse a decompressed text-GL chunk of WHOLE '\\n'-terminated lines
    into at most max_sites log-normalized site records (the streaming
    loader's per-chunk step; semantics identical to ngsld_read_geno_text).
    Returns (records (got, n_ind, 3) float64, bytes_consumed) or None if
    the native library is unavailable. Raises StrictError on bad input."""
    lib = get_lib()
    if lib is None:
        return None
    from ..strict import StrictError
    i64 = ctypes.c_int64
    # writable copy with one spare byte: the C parser NUL-terminates the
    # final line at data[len] when the chunk does not end in '\n'
    data = np.frombuffer(bytearray(chunk) + b"\0", dtype=np.uint8)
    out = np.empty((max(max_sites, 1), n_ind, 3), np.float64)
    consumed = i64(0)
    err = ctypes.create_string_buffer(256)
    got = lib.ngsld_parse_geno_text(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), len(chunk),
        int(in_probs), int(in_logscale), n_ind, s_global, _dp(out),
        max_sites, ctypes.byref(consumed), err, 256)
    if got < 0:
        raise StrictError("read_geno", err.value.decode())
    return out[:got], int(consumed.value)


def count_lines_native(addr: int, length: int) -> int:
    """The lines of the `length` bytes at address `addr`: its '\\n's, and
    one more for a last line without one (the native library must be
    loaded)."""
    return get_lib().ngsld_count_lines(addr, length)


def parse_geno_text_to(addr: int, length: int, in_probs: bool,
                       in_logscale: bool, n_ind: int, s_global: int,
                       out_addr: int, out_f32: bool, max_sites: int):
    """parse_geno_text_native on the `length` bytes at address `addr`
    (whole lines, mutated as that parse does; a last line without '\\n'
    needs one writable byte past them), the records written to the
    C-contiguous table at out_addr, float32 when out_f32 else float64 (the
    same bits as narrowing the f64 records). The ctypes call releases the
    GIL, so slices of one text parse on several threads. Returns (records,
    bytes up to the end of the last record's line, the error's text or
    None): an error stops the parse at its line, with the records before
    it written (the native library must be loaded)."""
    i64 = ctypes.c_int64
    consumed, last_end, rc = i64(0), i64(0), ctypes.c_int(0)
    err = ctypes.create_string_buffer(256)
    got = get_lib().ngsld_parse_geno_text_to(
        addr, length, int(in_probs), int(in_logscale), n_ind, s_global,
        out_addr, int(out_f32), max_sites, ctypes.byref(consumed),
        ctypes.byref(last_end), ctypes.byref(rc), err, 256)
    return got, int(last_end.value), (err.value.decode() if rc.value
                                      else None)


def read_pos_native(path: str, header: bool, n_sites: int):
    """Native read_pos; returns (pos_dist float64 (n_sites,), LabelBlob),
    or None if the native library is unavailable (or the file is missing —
    the Python path raises the natural error). Raises StrictError on
    malformed input with the strict reader's messages."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fsz = os.path.getsize(path)
    except OSError:
        return None
    from ..strict import StrictError
    i64 = ctypes.c_int64
    pos = np.empty(n_sites, np.float64)
    off = np.zeros(max(n_sites, 1), np.int64)
    err = ctypes.create_string_buffer(256)
    used = i64(0)
    # labels <= file bytes (+1 NUL per line, newline traded for NUL);
    # gz files start at 8x compressed and grow on rc==-2
    cap = max(4096, fsz + n_sites + 16)
    if path.endswith(".gz"):
        cap = max(cap, fsz * 8)
    while True:
        blob = ctypes.create_string_buffer(cap)
        rc = lib.ngsld_read_pos(
            path.encode(), 1 if header else 0, n_sites, _dp(pos), blob,
            cap, off.ctypes.data_as(ctypes.POINTER(i64)),
            ctypes.byref(used), err, 256)
        if rc == -2:
            cap *= 2
            continue
        break
    if rc != 0:
        raise StrictError(_READ_POS_WHERE.get(rc, "read_pos"),
                          err.value.decode())
    return pos, LabelBlob(blob.raw[:used.value], off)


def _i64p(a):
    return np.ascontiguousarray(a, np.int64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return np.ascontiguousarray(a, np.int32).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int32))


def _f64p(a):
    return np.ascontiguousarray(a, np.float64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_double))


def _f32p(a):
    return np.ascontiguousarray(a, np.float32).ctypes.data_as(
        ctypes.POINTER(ctypes.c_float))


class OutPool:
    """Free np.uint8 output buffers for the bulk formatters, kept for the
    life of the process. The block engine's emit formats each block into
    a leased buffer and hands the write stage a view of it, so after the
    first blocks of a process no block's bytes land in fresh memory; the
    other callers lease one for the call and get a bytes copy. The pool
    holds what is given back and never more than were out at once (with
    one emit pipeline 4: the block fmt formats, the one it holds back, one
    queued and the write stage's). A lease never waits: with no free
    buffer large enough it allocates one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free = []

    def _take(self, nbytes: int):
        """A free buffer of at least nbytes, or a new one -> (buf, new)."""
        with self._lock:
            # by position: list.remove would compare arrays with ==
            self._free.sort(key=len)
            for i, buf in enumerate(self._free):
                if len(buf) >= nbytes:
                    return self._free.pop(i), False
            if self._free:  # outgrown: the smallest goes for a larger one
                self._free.pop(0)
        # a power of two, so that blocks of about one size share buffers;
        # pages past what a block writes are never touched
        return np.empty(1 << (max(nbytes, 4096) - 1).bit_length(),
                        np.uint8), True

    def _give(self, buf):
        with self._lock:
            self._free.append(buf)


class OutLease:
    """One block's output buffer from an OutPool: format_rows_derive(...,
    out=lease) takes it at the size it needs (growing it on a retry),
    right before its native call; release() gives it back once the view
    it returned has been written. A lease that is never released is
    dropped with its buffer. `fresh`: the buffer was allocated or grown
    for this lease. on_take: called once, at the first take."""

    __slots__ = ("pool", "buf", "fresh", "on_take")

    def __init__(self, pool: OutPool, on_take=None):
        self.pool, self.buf, self.fresh = pool, None, False
        self.on_take = on_take

    def take(self, nbytes: int) -> np.ndarray:
        if self.on_take is not None:
            hook, self.on_take = self.on_take, None
            hook()
        if self.buf is None or len(self.buf) < nbytes:
            self.buf, new = self.pool._take(nbytes)
            self.fresh |= new
        return self.buf

    def release(self):
        if self.buf is not None:
            self.pool._give(self.buf)
            self.buf = None


# module-level so that it outlives the emit's threads and the jobs
OUT_POOL = OutPool()


def _format_with_retry(call, n, labels_blob, label_off, extend, out=None):
    """Shared grow-and-retry protocol for the bulk formatters.

    Worst-case row budget: 2 labels + 17 numeric fields ("-0.000001",
    "inf", "%.0f" dists up to ~1e15) at <=24 bytes each, tabs + newline.
    The C path returns -1 on would-overflow (double and retry; a tight
    estimate only risks one retry, never corruption) and -2 on allocation
    failure (raise MemoryError). With an OutLease `out` the rows are
    formatted into its buffer and a memoryview of them is returned; else
    into a buffer leased from OUT_POOL for the call, and a bytes copy is
    returned."""
    max_lab = int(np.diff(np.r_[label_off, len(labels_blob)]).max()) \
        if len(label_off) else 16
    per_row = 2 * max_lab + (17 if extend else 5) * 24 + 32
    cap = max(4096, n * per_row + 1024)
    # a core is left free: the block engine's emit writes the block before
    # while this one formats (the other callers write after the call)
    n_threads = min(max((os.cpu_count() or 1) - 1, 1), 8)
    lease = OutLease(OUT_POOL) if out is None else out
    try:
        while True:
            buf = lease.take(cap)
            w = call(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
                     len(buf), n_threads)
            if w >= 0:
                return memoryview(buf)[:w] if out is not None \
                    else buf[:w].tobytes()
            if w == -2:
                raise MemoryError("native row formatter: allocation failed")
            cap = len(buf) * 2
    finally:
        if out is None:
            lease.release()


def format_rows_native(labels_blob: bytes, label_off: np.ndarray,
                       s1, s2, dist, r2p, D, Dp, r2, extend: bool,
                       n_used=None, maf1=None, maf2=None, hap=None,
                       hmaf1=None, hmaf2=None, chi2=None, n_iter=None):
    """Bulk-format rows into bytes via the native printf path, or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(s1)
    # float32 value columns skip a full-block float64 conversion pass:
    # float->double is exact, so the C path's output bytes are identical
    vals = [r2p, D, Dp, r2] + ([hap, hmaf1, hmaf2] if extend else [])
    f32_vals = all(np.asarray(a).dtype == np.float32 for a in vals)
    vp = _f32p if f32_vals else _f64p
    fmt_fn = lib.ngsld_format_rows_mt32 if f32_vals \
        else lib.ngsld_format_rows_mt
    null_i32 = _i32p(np.zeros(1))
    null_f = _f32p(np.zeros(1))
    null_v = vp(np.zeros(1, np.float32 if f32_vals else np.float64))
    null_d = _f64p(np.zeros(1))

    def call(bufp, cap, n_threads):
        return fmt_fn(
            n, labels_blob, _i64p(label_off), _i64p(s1), _i64p(s2),
            _f64p(dist), vp(r2p), vp(D), vp(Dp), vp(r2), int(extend),
            _i32p(n_used) if extend else null_i32,
            _f64p(maf1) if extend else null_d,
            _f64p(maf2) if extend else null_d,
            vp(hap.reshape(-1)) if extend else null_v,
            vp(hmaf1) if extend else null_v,
            vp(hmaf2) if extend else null_v,
            _f32p(chi2) if extend else null_f,
            _i32p(n_iter) if extend else null_i32,
            bufp, cap, n_threads)

    return _format_with_retry(call, n, labels_blob, label_off, extend)


def format_rows_derive(labels_blob: bytes, label_off: np.ndarray,
                       s1, s2, dist, r2p, f, maf1, maf2, n_used, n_iter,
                       extend: bool, overrides=None, out=None):
    """Derive D/D'/r2/hap-MAFs/chi2 from the hap freqs AND format, all in
    the native worker threads. r2p and f must share a float32/float64
    dtype; bytes are identical to deriving via engine._stats_host/_chi2_host
    first. Returns the rows' bytes, or None if the native library is
    unavailable.

    out: an OutLease (OutLease(OUT_POOL)) to format into; the rows then come
    back as a memoryview of its buffer, valid until the lease is released.

    overrides: optional (idx, cols) for refined degenerate rows — idx are
    ascending row indices whose columns are NOT derived but taken from
    cols (the engine's refine/rederive output): a dict with f64 arrays
    r2p, D, Dp, r2, maf1, maf2, f (n,4), hmaf1, hmaf2, plus chi2 (f32)
    and n_used/n_iter (i32). Replaces the bulk-format + splice path."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(s1)
    f = np.ascontiguousarray(f)
    r2p = np.ascontiguousarray(r2p)
    if f.dtype != r2p.dtype or f.dtype not in (np.float32, np.float64):
        return None
    fn = (lib.ngsld_format_rows_derive32 if f.dtype == np.float32
          else lib.ngsld_format_rows_derive64)
    ct = ctypes.c_float if f.dtype == np.float32 else ctypes.c_double
    null_i32 = _i32p(np.zeros(1))
    null_d = _f64p(np.zeros(1))
    f_flat = f.reshape(-1)
    if overrides is not None:
        idx, oc = overrides
        over_rank = np.full(n, -1, np.int32)
        over_rank[idx] = np.arange(len(idx), dtype=np.int32)
        o_cols = np.empty((len(idx), 12), np.float64)
        for k, key in enumerate(("r2p", "D", "Dp", "r2", "maf1", "maf2")):
            o_cols[:, k] = oc[key]
        o_cols[:, 6:10] = oc["f"]
        o_cols[:, 10] = oc["hmaf1"]
        o_cols[:, 11] = oc["hmaf2"]
        over_args = (_i32p(over_rank), _f64p(o_cols), _f32p(oc["chi2"]),
                     _i32p(oc["n_used"]), _i32p(oc["n_iter"]))
    else:
        over_args = (None, null_d, _f32p(np.zeros(1, np.float32)),
                     null_i32, null_i32)

    def call(bufp, cap, n_threads):
        return fn(n, labels_blob, _i64p(label_off), _i64p(s1), _i64p(s2),
                  _f64p(dist), r2p.ctypes.data_as(ctypes.POINTER(ct)),
                  f_flat.ctypes.data_as(ctypes.POINTER(ct)), int(extend),
                  _i32p(n_used) if extend else null_i32,
                  _f64p(maf1) if extend else null_d,
                  _f64p(maf2) if extend else null_d,
                  _i32p(n_iter) if extend else null_i32,
                  *over_args,
                  bufp, cap, n_threads)

    return _format_with_retry(call, n, labels_blob, label_off, extend, out)


def tier_scan_native(f: np.ndarray, f32_prec: bool):
    """Native degenerate_tiers hot path: (P, >=4) float array whose first
    4 row elements are the hap freqs (inner stride must be 1 element —
    column-sliced views like fm[:, 1:5] qualify without a copy). Returns
    (tiers uint8, n_nonzero) or None if unavailable."""
    if os.environ.get("NGSLD_NO_NATIVE") == "1":
        return None
    lib = get_lib()
    if lib is None:
        return None
    if f.ndim != 2 or f.shape[1] < 4 or f.dtype not in (np.float32,
                                                        np.float64):
        return None
    it = f.dtype.itemsize
    if f.strides[1] != it or f.strides[0] % it != 0 or f.strides[0] < 0:
        return None
    stride = f.strides[0] // it
    tiers = np.empty(len(f), np.uint8)
    ct = ctypes.c_float if f.dtype == np.float32 else ctypes.c_double
    fn = (lib.ngsld_tier_scan32 if f.dtype == np.float32
          else lib.ngsld_tier_scan64)
    nz = fn(len(f), f.ctypes.data_as(ctypes.POINTER(ct)), stride,
            int(bool(f32_prec)),
            tiers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return tiers, int(nz)


def pearson_r2_native(x: np.ndarray, y: np.ndarray):
    """Batch squared gsl_stats_correlation with long double accumulators,
    bit-identical to strict.pearson_r2_batch. x, y: (P, n) float64
    C-contiguous. Returns (P,) f64 or None if unavailable."""
    if os.environ.get("NGSLD_NO_NATIVE") == "1":
        return None
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    P, n = x.shape
    out = np.empty(P, np.float64)
    lib.ngsld_pearson_r2(_f64p(x), _f64p(y), P, n, _f64p(out))
    return out


def make_labels_blob(labels):
    """Concatenate labels with NULs; returns (bytes, offsets int64)."""
    off = np.empty(len(labels), dtype=np.int64)
    parts = []
    pos = 0
    for i, lab in enumerate(labels):
        b = lab.encode()
        off[i] = pos
        parts.append(b + b"\0")
        pos += len(b) + 1
    return b"".join(parts), off


def strict_siteprep_native(rows, in_logscale: bool, text_norm: bool,
                           call_geno: bool, N_thresh: float,
                           call_thresh: float, ignore_miss: bool):
    """Native strict site preparation (post_prob/call_geno/est_maf/E[G]),
    bit-identical to the strict.py pipeline. rows (m, I, 3) f64 — raw
    binary records (text_norm=False) or log-normalized text-parser
    records (True); MUTATED in place to the post-call log rows. Returns
    (gn, maf, eg) or None if the native library is unavailable. Raises
    StrictError on the reference's NaN error."""
    lib = get_lib()
    if lib is None:
        return None
    from ..strict import StrictError
    rows = np.ascontiguousarray(rows, np.float64)
    m, I, _ = rows.shape
    gn = np.empty_like(rows)
    maf = np.empty(m, np.float64)
    eg = np.empty((m, I), np.float64)
    rc = lib.ngsld_strict_siteprep_mt(
        _dp(rows), m, I, int(in_logscale), int(text_norm), int(call_geno),
        N_thresh, call_thresh, int(ignore_miss), _dp(gn), _dp(maf),
        _dp(eg), min(os.cpu_count() or 1, 8))
    if rc != 0:
        raise StrictError("read_geno",
                          "NaN found! Is the file format correct?")
    return gn, maf, eg


def strict_pair_em_native(gn1, gn2, maf1, maf2, ignore_miss: bool):
    """Native bit-exact pair_freq_iter batch (mirrors
    strict.pair_em_batch). Returns (f, n_iter, n_used) or None."""
    lib = get_lib()
    if lib is None:
        return None
    gn1 = np.ascontiguousarray(gn1, np.float64)
    gn2 = np.ascontiguousarray(gn2, np.float64)
    k, I, _ = gn1.shape
    f = np.empty((k, 4), np.float64)
    n_iter = np.empty(k, np.int32)
    n_used = np.empty(k, np.int32)
    lib.ngsld_strict_pair_em_mt(
        _dp(gn1), _dp(gn2), _dp(np.ascontiguousarray(maf1, np.float64)),
        _dp(np.ascontiguousarray(maf2, np.float64)), int(ignore_miss),
        k, I, _dp(f),
        n_iter.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_used.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        min(os.cpu_count() or 1, 8))
    return f, n_iter.astype(np.int64), n_used.astype(np.int64)
