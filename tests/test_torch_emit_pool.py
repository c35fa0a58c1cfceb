"""The emit's output buffers on the CPU: native.OutPool and OutLease, and
the native formatter's per-worker scratch that outlives a call. A leased
buffer gives the bytes of a fresh one at every block size, in f32 and
f64, with and without override rows; formatters on many threads at once
each print their own rows; the block engine's emit (engine_block._Emit)
writes the same bytes through the pool to a binary sink, a text handle
and a checkpoint, allocates at most one buffer for each block in flight
in a process's first run and none in its second, and a stage that fails
ends the run without a wait on the pool."""

import functools
import io
import os
import sys
import threading

import numpy as np
import pytest
import torch

from ngsld_tpu_torch import engine_block, native
from ngsld_tpu_torch.checkpoint import _Checkpoint
from ngsld_tpu_torch.config import Params
from ngsld_tpu_torch.io.writer import RowWriter
from ngsld_tpu_torch.plan.band import PairBlock
from ngsld_tpu_torch.refine import degenerate_tiers
from ngsld_tpu_torch.utils.logging import RunLog

N_SITES = 2000
# every label 8 characters: an --extend_out row's budget is 458 bytes, so
# blocks of 2,400-4,400 rows lease buffers of one size (2 MiB)
LABELS = [f"1:{100000 + 37 * i}" for i in range(N_SITES)]
EMIT_ROWS = (2400, 4400, 3000, 4000, 2600, 4200, 3500, 2800)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blob():
    if native.get_lib() is None:
        pytest.skip("no g++/zlib on this host: pure-Python host paths")
    return native.make_labels_blob(LABELS)


def _cols(n, seed, dt):
    rng = np.random.default_rng(seed)
    s1 = np.sort(rng.integers(0, N_SITES - 60, n)).astype(np.int64)
    s2 = s1 + rng.integers(1, 60, n)
    f = rng.dirichlet([1.0, 0.8, 0.8, 0.5], n).astype(dt)
    f[::97] = np.nan
    maf = rng.uniform(0.05, 0.5, N_SITES)
    return dict(s1=s1, s2=s2, dist=(s2 - s1) * 37.0,
                r2p=rng.random(n).astype(dt), f=f, maf1=maf[s1],
                maf2=maf[s2], n_used=rng.integers(1, 100, n).astype(np.int32),
                n_iter=rng.integers(1, 100, n).astype(np.int32))


def _overrides(n, seed):
    rng = np.random.default_rng(seed)
    idx = np.unique(rng.integers(0, n, max(n // 20, 1)))
    k = len(idx)
    oc = dict(r2p=rng.uniform(0, 1, k), D=rng.normal(size=k),
              Dp=rng.normal(size=k), r2=rng.uniform(0, 1, k),
              maf1=rng.uniform(0, 0.5, k), maf2=rng.uniform(0, 0.5, k),
              f=rng.dirichlet([1.0] * 4, k), hmaf1=rng.uniform(0, 1, k),
              hmaf2=rng.uniform(0, 1, k),
              chi2=rng.uniform(0, 50, k).astype(np.float32),
              n_used=rng.integers(1, 100, k).astype(np.int32),
              n_iter=rng.integers(1, 100, k).astype(np.int32))
    oc["Dp"][0] = np.nan
    return idx, oc


def _fmt(blob, c, extend, overrides=None, out=None):
    return native.format_rows_derive(
        *blob, c["s1"], c["s2"], c["dist"], c["r2p"], c["f"], c["maf1"],
        c["maf2"], c["n_used"], c["n_iter"], extend, overrides=overrides,
        out=out)


def _one_worker(monkeypatch, *a, **k):
    """The formatter's single-worker path, which writes straight into the
    caller's buffer: no scratch, no pool."""
    with monkeypatch.context() as mp:
        mp.setattr(native.os, "cpu_count", lambda: 1)
        return _fmt(*a, **k)


@pytest.mark.parametrize("over", [False, True], ids=["derived", "overrides"])
@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_leased_buffers_print_the_bytes_of_fresh_ones(blob, monkeypatch, dt,
                                                      over):
    """Blocks that grow, shrink and grow again, each formatted into a
    lease of one pool, into a fresh bytes and by one worker: the same
    bytes. Leases taken one after another share one buffer, grown only
    when a block outgrows it; a second pass allocates nothing."""
    pool = native.OutPool()
    sizes = (500, 6000, 40, 9000, 3000, 12000, 1)
    for rep in range(2):
        fresh = []
        for k, n in enumerate(sizes):
            c = _cols(n, 10 * k + 1, dt)
            ov = _overrides(n, k) if over else None
            for extend in (True, False):
                want = _one_worker(monkeypatch, blob, c, extend, ov)
                assert want.count(b"\n") == n
                assert _fmt(blob, c, extend, ov) == want
                lease = native.OutLease(pool)
                got = _fmt(blob, c, extend, ov, out=lease)
                assert isinstance(got, memoryview) and bytes(got) == want
                assert np.shares_memory(np.frombuffer(got, np.uint8),
                                        lease.buf)
                fresh.append((n, lease.fresh))
                lease.release()
        if rep == 0:
            # the first lease allocates; after it only a block larger than
            # every one before may grow the buffer
            assert fresh[0][1] and 2 <= sum(f for _, f in fresh) <= 4
            assert all(n > max(m for m, _ in fresh[:i])
                       for i, (n, f) in enumerate(fresh) if i and f)
        else:
            assert not any(f for _, f in fresh)
    assert len(pool._free) == 1


def test_formatters_on_many_threads_at_once(blob, monkeypatch):
    """More formatter threads than cores, each formatting its own blocks
    over and over into leases and into bytes, while the others hold the
    kept scratch: every call prints its own block's rows."""
    n_threads = max(12, 2 * (os.cpu_count() or 1))
    blocks = [(_cols(2000 + 700 * t, 100 + t, (np.float32, np.float64)[t % 2]),
               t % 3 != 0) for t in range(n_threads)]
    want = [_one_worker(monkeypatch, blob, c, ext) for c, ext in blocks]
    pool = native.OutPool()
    bad, errors = [], []
    start = threading.Barrier(n_threads)

    def work(t):
        try:
            c, ext = blocks[t]
            start.wait(timeout=60)
            for rep in range(6):
                if rep % 2:
                    got = bytes(_fmt(blob, c, ext))
                else:
                    lease = native.OutLease(pool)
                    got = bytes(_fmt(blob, c, ext, out=lease))
                    lease.release()
                if got != want[t]:
                    bad.append((t, rep))
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert not errors and not bad
    assert len(pool._free) <= n_threads


def test_bytes_calls_lease_from_the_process_pool(blob, monkeypatch):
    """A call without out= formats into a buffer leased from
    native.OUT_POOL for the call and gives it back: the next call of no
    larger size takes the same buffer, and each call's bytes are a copy
    that the later calls leave as they were."""
    pool = native.OutPool()
    monkeypatch.setattr(native, "OUT_POOL", pool)
    a, b = _cols(3000, 1, np.float32), _cols(2000, 2, np.float64)
    first = _fmt(blob, a, True)
    assert isinstance(first, bytes) and len(pool._free) == 1
    kept = pool._free[0]
    second = _fmt(blob, b, False)
    assert len(pool._free) == 1 and pool._free[0] is kept
    assert first == _one_worker(monkeypatch, blob, a, True)
    assert second == _one_worker(monkeypatch, blob, b, False)
    assert len(pool._free) == 1 and pool._free[0] is kept


class _Sink(io.RawIOBase):
    """A binary output kept in memory, as a benchmark's sink keeps it."""

    def __init__(self):
        super().__init__()
        self.buf = bytearray()

    def writable(self):
        return True

    def write(self, data):
        self.buf += data
        return len(data)


def _emit_blocks(prec):
    """Blocks of EMIT_ROWS rows as the pull stage hands them to fmt, with
    no degenerate pair (those take refine's path, not the pool's)."""
    out, rng = [], np.random.default_rng(7)
    dt = np.float32 if prec == "f32" else np.float64
    for n in EMIT_ROWS:
        while True:
            s1 = np.sort(rng.integers(0, N_SITES - 60, 2 * n))
            s2 = s1 + rng.integers(1, 60, 2 * n)
            fm = np.column_stack([
                rng.random(2 * n),
                rng.dirichlet([1.0, 0.8, 0.8, 0.5], 2 * n)]).astype(dt)
            keep = np.flatnonzero(degenerate_tiers(fm[:, 1:5], prec) == 0)
            if len(keep) >= n:
                keep = keep[:n]
                break
        im = np.column_stack([rng.integers(1, 100, n),
                              np.full(n, 99)]).astype(np.int16)
        out.append((PairBlock(s1=s1[keep].astype(np.int64),
                              s2=s2[keep].astype(np.int64),
                              dist=(s2[keep] - s1[keep]) * 37.0),
                    fm[keep], im))
    return out


def _no_refiner():
    raise AssertionError("no block here has a degenerate pair")


def _emit_run(blocks, fmt_rows, out_fh=None, ckpt=None):
    log = RunLog(verbose=0)
    emit = engine_block._Emit(log, None, functools.partial(fmt_rows, log=log),
                              ckpt, out_fh)
    for bi, (blk, fm, im) in enumerate(blocks):
        emit.q.put((bi, blk, (torch.from_numpy(fm), torch.from_numpy(im)),
                    None, None, None, None))
    emit.close()
    return emit, log.counters


@pytest.mark.parametrize("sink", ["binary", "text", "checkpoint"])
def test_emit_writes_through_the_pool(blob, monkeypatch, tmp_path, sink):
    """Two emit runs in one process over the same blocks, with the pool
    the emit leases from: each writes the bytes of the blocks' formats
    into fresh bytes, in order; the first allocates at most one buffer a
    block in flight (fmt's, two queued, write's) and the second none."""
    monkeypatch.setattr(engine_block, "OUT_POOL", native.OutPool())
    prec = "f32"
    pars = Params(n_ind=99, n_sites=N_SITES, extend_out=True, verbose=0,
                  checkpoint=str(tmp_path / "ckpt"))
    rng = np.random.default_rng(3)
    maf = rng.uniform(0.05, 0.5, N_SITES)
    rw = RowWriter(None, native.LabelBlob(*blob), True)

    def fmt_rows(blk, fm, im, rung=None, out=None, *, log):
        return engine_block.format_rows(rw, maf, pars, prec, _no_refiner,
                                        log, blk, fm, im, rung, out=out)

    blocks = _emit_blocks(prec)
    want = [fmt_rows(blk, fm, im, log=RunLog(verbose=0))
            for blk, fm, im in blocks]
    assert all(isinstance(w, bytes) for w in want)
    for run in range(2):
        if sink == "checkpoint":
            ckpt = _Checkpoint(pars.checkpoint, pars, RunLog(verbose=0))
            emit, counters = _emit_run(blocks, fmt_rows, ckpt=ckpt)
            got = []
            for bi in range(len(blocks)):
                with open(ckpt.path(bi), "rb") as fh:
                    got.append(fh.read())
                os.unlink(ckpt.path(bi))
            assert got == want
        else:
            fh = _Sink() if sink == "binary" else io.StringIO()
            emit, counters = _emit_run(blocks, fmt_rows, out_fh=fh)
            got = fh.buf if sink == "binary" else fh.getvalue().encode()
            assert got == b"".join(want)
        assert not emit.err
        alloc = counters.get("emit_buf_alloc", 0)
        assert alloc + counters.get("emit_buf_reuse", 0) == len(blocks)
        assert alloc <= 4 if run == 0 else alloc == 0, (run, counters)
    assert 1 <= len(engine_block.OUT_POOL._free) <= 4


def test_a_failed_write_ends_the_run_and_the_pool_still_serves(
        blob, monkeypatch):
    """A write that raises ends the emit with its error and drops the
    leases in flight; the pool never waits for them, and the next run
    writes every row."""
    monkeypatch.setattr(engine_block, "OUT_POOL", native.OutPool())
    pars = Params(n_ind=99, n_sites=N_SITES, extend_out=True, verbose=0)
    maf = np.random.default_rng(4).uniform(0.05, 0.5, N_SITES)
    rw = RowWriter(None, native.LabelBlob(*blob), True)

    def fmt_rows(blk, fm, im, rung=None, out=None, *, log):
        return engine_block.format_rows(rw, maf, pars, "f32", _no_refiner,
                                        log, blk, fm, im, rung, out=out)

    class Broken(_Sink):
        def write(self, data):
            if len(self.buf):
                raise OSError("disk full")
            return super().write(data)

    blocks = _emit_blocks("f32")
    emit, _ = _emit_run(blocks, fmt_rows, out_fh=Broken())
    assert [type(e) for e in emit.err] == [OSError]
    fh = _Sink()
    emit, counters = _emit_run(blocks, fmt_rows, out_fh=fh)
    assert not emit.err and fh.buf.count(b"\n") == sum(EMIT_ROWS)
    assert len(engine_block.OUT_POOL._free) <= 4


def test_a_block_is_written_while_the_next_one_formats(monkeypatch):
    """fmt hands a block to the write stage when the next block's native
    format starts (its lease's first take), so a write that holds the GIL
    for its whole copy runs beside that format, and not beside the next
    block's Python part, which would wait on it. Here the block before
    is not written while a format has not taken its lease, and is
    written while the format that took it has not returned."""
    monkeypatch.setattr(engine_block, "OUT_POOL", native.OutPool())
    written, early, late = [], [], []
    arrived = threading.Condition()

    class Sink(_Sink):
        def write(self, data):
            with arrived:
                written.append(bytes(data))
                arrived.notify_all()
            return len(data)

    def fmt_rows(blk, fm, im, rung=None, out=None):
        k = int(blk.s1[0])
        with arrived:
            early.append(arrived.wait_for(lambda: len(written) >= k,
                                          timeout=0.1))
        out.take(64)
        with arrived:
            late.append(arrived.wait_for(lambda: len(written) >= k,
                                         timeout=20))
        return b"block %d\n" % k

    log = RunLog(verbose=0)
    emit = engine_block._Emit(log, None, fmt_rows, None, Sink())
    for k in range(5):
        blk = PairBlock(s1=np.array([k]), s2=np.array([k + 1]),
                        dist=np.array([1.0]))
        emit.q.put((k, blk, (torch.zeros(1, 5), torch.zeros(1, 2)), None,
                    None, None, None))
    emit.close()
    assert not emit.err and all(late) and len(late) == 5
    assert early == [True] + [False] * 4
    assert written == [b"block %d\n" % k for k in range(5)]
    # each hand-off is a span of its own inside the next block's format
    spans = log.span_record()["spans"]
    hand = [s for s in spans if s[0] == "sweep: fmt/hand-off"]
    assert len(hand) == 4
    assert all(spans[s[2]][0] == "sweep: format" for s in hand)
