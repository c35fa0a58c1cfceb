"""Graceful-stop signal handling for long sweeps.

The reference carries SIGINT/SIGTERM machinery (handler + 3-strikes force
exit, gen_func.cpp:21-52) but never installs it in ngsLD's main. Here it
is installed for real and paired with checkpoint/resume: on the first
signal the sweep finishes its in-flight block, commits it, and exits
cleanly (a --checkpoint run then resumes from the next block); a third
signal force-exits immediately.
"""

from __future__ import annotations

import signal
import sys


class GracefulStop:
    """Context manager: arms SIGINT/SIGTERM, exposes .stopped."""

    FORCE_AFTER = 3

    def __init__(self, log=None):
        self.stopped = False
        self._count = 0
        self._log = log
        self._prev = {}

    def _handler(self, signum, frame):
        self._count += 1
        self.stopped = True
        name = signal.Signals(signum).name
        if self._count >= self.FORCE_AFTER:
            sys.stderr.write(f"\n==> {name} x{self._count}: force exit\n")
            sys.exit(128 + signum)
        sys.stderr.write(
            f"\n==> {name}: finishing current block, then stopping "
            f"({self.FORCE_AFTER - self._count} more to force exit)\n")

    def __enter__(self):
        for s in (signal.SIGINT, signal.SIGTERM):
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False
