"""Leveled stderr narration, phase timing and spans.

Mirrors the reference's --verbose contract (phase banners at >=1,
progress at >=3, data dumps at >=6/7; ngsLD.cpp:46,86,102,118,151,194 and
parse_args.cpp:135-161) and adds what it lacks: spans of the run's work
on every thread (name, thread, parent, start, end), their sums by name,
and run counters (pairs evaluated, EM iteration histogram).

A span is stamped on time.perf_counter_ns(); each RunLog takes one
anchor (time.time_ns(), time.perf_counter_ns()) when it is made, so a
reader places a span on the Unix clock, and so beside a torch.profiler
trace (its baseTimeNanoseconds + ts * 1000), as unix_ns + (t - perf_ns).
While a profiler runs, a span that encloses no other span of its thread
also enters torch.profiler.record_function(name); with no profiler
running none is entered (it costs about 12 us, the span itself well
under 1 us).
"""

from __future__ import annotations

import sys
import threading
import time


def _profiling() -> bool:
    """A torch.profiler runs in this process (the flag torch.profiler
    sets for every thread; torch.autograd._profiler_enabled() is the
    calling thread's view, and reads False on the main thread under
    profile_all_threads)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


# the threads that have opened a record_function range
_RF_READY = threading.local()


def _ready_record_function() -> None:
    """Open and close one range on this thread: a thread's first range
    spends its set-up (up to ms for a process's first) before the profiler
    stamps it, which would move that event off its span."""
    from torch.profiler import record_function
    with record_function("ngsld: profiler thread set-up"):
        pass
    _RF_READY.done = True


class _Span:
    """One open span of a RunLog (RunLog.span, RunLog.phase)."""

    __slots__ = ("log", "name", "phase", "annotate", "rec", "rf", "t0")

    def __init__(self, log, name, phase, annotate):
        self.log, self.name = log, name
        self.phase, self.annotate = phase, annotate
        self.rf = None

    def __enter__(self):
        log = self.log
        stack = log._stack()
        parent = stack[-1] if stack else -1
        with log._lock:
            if len(log.spans) < log.MAX_SPANS:
                self.rec = [self.name, log._local.thread, parent, None,
                            None]
                stack.append(len(log.spans))
                log.spans.append(self.rec)
            else:
                self.rec = None
                stack.append(-1)
                log.spans_dropped += 1
        if self.annotate and _profiling():
            if not getattr(_RF_READY, "done", False):
                _ready_record_function()
            from torch.profiler import record_function
            self.rf = record_function(self.name)
        # stamped right before the range opens and right before it closes,
        # as near to the profiler's own stamps as this thread gets
        self.t0 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__enter__()
        if self.rec is not None:
            self.rec[3] = self.t0
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        log = self.log
        log._local.stack.pop()
        if self.rec is not None:
            self.rec[4] = t1
        seconds = (t1 - self.t0) / 1e9
        with log._lock:
            if self.phase:
                log.timings.append((self.name, seconds))
            else:
                log.time_counters[self.name] = \
                    log.time_counters.get(self.name, 0.0) + seconds
        return False


class RunLog:
    """rank: this process's rank in a multi-device run. Only rank 0
    prints; each rank keeps its own spans, timings and counters
    (dump_json). Spans may open and close on any thread."""

    # spans kept a run; past it the sums go on and spans_dropped counts
    MAX_SPANS = 10_000

    def __init__(self, verbose: int = 1, rank: int = 0):
        self.verbose = verbose
        self.rank = rank
        self.timings: list = []        # (phase, seconds), in order
        self.counters: dict = {}
        self.time_counters: dict = {}  # stage -> seconds, summed
        self.hists: dict = {}
        # [name, thread, parent index or -1, t0_ns, t1_ns]; None while
        # not yet stamped
        self.spans: list = []
        self.spans_dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self.unix_ns, self.perf_ns = time.time_ns(), time.perf_counter_ns()

    def log(self, level: int, msg: str) -> None:
        if self.verbose >= level and self.rank == 0:
            sys.stderr.write(msg + "\n")

    def _stack(self) -> list:
        """This thread's open spans (indices into self.spans)."""
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack = []
            loc.thread = threading.current_thread().name
        return loc.stack

    def span(self, name: str) -> _Span:
        """A span of work on the calling thread; its seconds sum into the
        stage `name` (dump_json's "stages"). Its parent is the thread's
        innermost open span."""
        return _Span(self, name, False, True)

    def phase(self, name: str, level: int = 1, encloses: bool = False):
        """A span that prints its banner at `level` and whose seconds go
        to the phase `name` (dump_json's "phases"; the last of a repeated
        name wins). encloses: the phase holds other spans of its thread,
        so it enters no record_function (a gap's label is the host event
        that overlaps it longest, which an enclosing phase would be)."""
        self.log(level, f"==> {name}")
        return _Span(self, name, True, not encloses)

    def spans_of(self, name: str, it):
        """Iterate `it`, each next() a span `name` on the thread that
        iterates."""
        it = iter(it)
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def count_time(self, key: str, seconds: float) -> None:
        """Add seconds that another object summed (a mesh's collectives,
        the refiner's sub-stages) to the stage `key`."""
        with self._lock:
            self.time_counters[key] = \
                self.time_counters.get(key, 0.0) + seconds

    def hist(self, key: str, counts) -> None:
        """Accumulate an integer histogram (e.g. EM iterations per pair)."""
        import numpy as np
        prev = self.hists.get(key)
        counts = np.asarray(counts, dtype=np.int64)
        if prev is None:
            self.hists[key] = counts.copy()
        else:
            n = max(len(prev), len(counts))
            out = np.zeros(n, np.int64)
            out[:len(prev)] += prev
            out[:len(counts)] += counts
            self.hists[key] = out

    def span_record(self) -> dict:
        """clock, spans and counters: "clock" is the anchor (unix_ns,
        perf_ns) and dump_us, when this was taken; "spans" rows are
        [name, thread, parent index or -1, t0_us, t1_us] relative to the
        anchor (t1_us null for a span still open)."""
        p = self.perf_ns

        def us(t):
            return None if t is None else round((t - p) / 1e3, 1)

        with self._lock:
            spans = [[n, th, par, us(t0), us(t1)]
                     for n, th, par, t0, t1 in self.spans]
            counters = dict(self.counters)
            if self.spans_dropped:
                counters["spans_dropped"] = self.spans_dropped
        return {"clock": {"unix_ns": self.unix_ns, "perf_ns": p,
                          "dump_us": round(
                              (time.perf_counter_ns() - p) / 1e3, 1)},
                "spans": spans, "counters": counters}

    def dump_json(self) -> None:
        """Write the run's phases, stages (sums of spans by name, and the
        sums count_time added), counters, spans with their clock, and the
        process's set-up spans (PROCESS) as JSON to $NGSLD_TIMINGS_JSON
        (if set). Rank r > 0 of a multi-device run writes
        $NGSLD_TIMINGS_JSON.rank<r>."""
        import json
        import os
        path = os.environ.get("NGSLD_TIMINGS_JSON")
        if not path:
            return
        if self.rank:
            path = f"{path}.rank{self.rank}"
        try:
            with self._lock:
                timings = list(self.timings)
                stages = sorted(self.time_counters.items())
            rec = self.span_record()
            payload = {
                "phases": {n: round(t, 3) for n, t in timings},
                # to the microsecond, as the spans: a stage of a fast
                # thread (a small file's reads) is not lost to rounding
                "stages": {k: round(v, 6) for k, v in stages},
                "counters": rec.pop("counters"),
                **rec,
                "process": PROCESS.span_record(),
            }
            with open(path, "w") as fh:
                json.dump(payload, fh)
        except OSError:
            pass

    def summary(self) -> None:
        self.dump_json()
        if self.verbose < 1 or self.rank:
            return
        total = sum(t for _, t in self.timings)
        sys.stderr.write("==> Phase timings:\n")
        for name, t in self.timings:
            sys.stderr.write(f"\t{name}: {t:.3f}s ({100*t/max(total,1e-9):.0f}%)\n")
        for name, t in sorted(self.time_counters.items()):
            sys.stderr.write(f"\t  [{name}: {t:.3f}s]\n")
        if self.counters:
            sys.stderr.write("==> Counters:\n")
            for k, v in sorted(self.counters.items()):
                sys.stderr.write(f"\t{k}: {v}\n")
        for k, h in sorted(self.hists.items()):
            nz = [i for i, c in enumerate(h) if c]
            if not nz:
                continue
            tot = int(h.sum())
            # quartiles over the iteration distribution
            cum = h.cumsum()
            qs = [int((cum >= q * tot).argmax()) for q in (0.5, 0.9, 0.99)]
            sys.stderr.write(
                f"==> {k}: min {nz[0]}, p50 {qs[0]}, p90 {qs[1]}, "
                f"p99 {qs[2]}, max {nz[-1]}\n")


# the process's set-up, which no run's RunLog sees: the port's import,
# the native and kernel libraries' loads and builds (every run's
# dump_json writes it under "process")
PROCESS = RunLog(0)


def echo_config(pars, engine_info: str = "") -> None:
    """Startup config echo — field-for-field the reference's stderr block
    (parse_args.cpp:135-159), incl. glibc's "(null)" for NULL strings and
    the >4 debugging note; the engine line is appended as an extension."""
    from .. import __version__

    def s(v):
        return "(null)" if v is None else str(v)

    def b(v):
        return "true" if v else "false"

    lines = [
        "==> Input Arguments:",
        f"\tgeno: {s(pars.in_geno)}",
        f"\tprobs: {b(pars.in_probs)}",
        f"\tlog_scale: {b(pars.in_logscale)}",
        f"\tn_ind: {pars.n_ind}",
        f"\tn_sites: {pars.n_sites}",
        f"\tpos: {s(pars.in_pos)} ({'WITH' if pars.in_pos_header else 'WITHOUT'} header)",
        f"\tmax_kb_dist (kb): {pars.max_kb_dist}",
        f"\tmax_snp_dist: {pars.max_snp_dist}",
        f"\tmin_maf: {pars.min_maf:f}",
        f"\tignore_miss_data: {b(pars.ignore_miss_data)}",
        f"\tcall_geno: {b(pars.call_geno)}",
        f"\tN_thresh: {pars.N_thresh:f}",
        f"\tcall_thresh: {pars.call_thresh:f}",
        f"\trnd_sample: {pars.rnd_sample:f}",
        f"\tseed: {pars.seed}",
        f"\textend_out: {b(pars.extend_out)}",
        f"\tout: {s(pars.out)}",
        f"\tn_threads: {pars.n_threads}",
        f"\tverbose: {pars.verbose}",
        f"\tversion: {__version__} (ngsld-tpu)",
        "",
        f"\tengine: {pars.engine} {engine_info}",
        "",
    ]
    sys.stderr.write("\n".join(lines))
    if pars.verbose > 4:
        sys.stderr.write("==> Verbose values greater than 4 for debugging "
                         "purpose only. Expect large amounts of info on "
                         "screen\n")
