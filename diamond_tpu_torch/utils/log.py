"""Tracing, phase timers, and statistics counters.

Reference: src/util/log_stream.h:27-115 (message/verbose/log streams,
TaskTimer), src/basic/statistics.h:25-58 (counter enum, thread-local
accumulate + final dump), double_indexed.cpp:778-780 (exit summary).

Three levels: message (default, stderr), verbose (-v), log (--log file,
timestamped).  TaskTimer logs phase durations at the chosen verbosity;
Statistics counts pipeline events and prints a final table under -v.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict

QUIET, MESSAGE, VERBOSE, LOG = 0, 1, 2, 3

_level = MESSAGE
_log_file = None
_t0 = time.time()


def set_level(verbose: bool = False, quiet: bool = False,
              log_path: str | None = None):
    global _level, _log_file
    if quiet:
        _level = QUIET
    elif verbose:
        _level = VERBOSE
    if log_path:
        _log_file = open(log_path, "a")
        _level = LOG


def message(s: str, level: int = MESSAGE):
    if _log_file is not None:
        _log_file.write(f"[{time.time() - _t0:.3f}] {s}\n")
        _log_file.flush()
    if level <= _level:
        print(s, file=sys.stderr)


class TaskTimer:
    """Scoped phase timer (reference util/log_stream.h:32-115): prints the
    phase name at start and the elapsed time at finish."""

    def __init__(self, name: str | None = None, level: int = VERBOSE):
        self.level = level
        self.name = None
        self.start = None
        if name:
            self.go(name)

    def go(self, name: str):
        self.finish()
        self.name = name
        self.start = time.perf_counter()
        message(f"{name}... ", self.level)

    def finish(self):
        if self.name is None:
            return
        dt = time.perf_counter() - self.start
        message(f"{self.name} [{dt:.3f}s]", self.level)
        self.name = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


class Statistics:
    """Event counters accumulated across the run (reference
    basic/statistics.h)."""

    def __init__(self):
        self.counts = defaultdict(int)

    def inc(self, key: str, n: int = 1):
        self.counts[key] += n

    def print(self):
        for k in sorted(self.counts):
            message(f"{k} = {self.counts[k]}", VERBOSE)


statistics = Statistics()


# ---------------------------------------------------------------------------
# micro-phase profiler (DIAMOND_TPU_PROF=1): accumulates wall time per label
# across the run; dump_prof() prints the sorted table.  Near-zero overhead
# when disabled (one truthiness check per call).
# ---------------------------------------------------------------------------

import contextlib
import os

prof = defaultdict(float)
prof_calls = defaultdict(int)
_PROF = bool(os.environ.get("DIAMOND_TPU_PROF"))


@contextlib.contextmanager
def _ptimer_on(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        prof[label] += time.perf_counter() - t0
        prof_calls[label] += 1


@contextlib.contextmanager
def _ptimer_off(label: str):
    yield


def ptimer(label: str):
    return _ptimer_on(label) if _PROF else _ptimer_off(label)


perf_counter = time.perf_counter


def padd(label: str, t0: float) -> float:
    """ptimer for a span that is no one block: adds the time since t0 (a
    perf_counter() reading) to label and returns perf_counter(), the start
    of the next span."""
    now = time.perf_counter()
    if _PROF:
        prof[label] += now - t0
        prof_calls[label] += 1
    return now


def pcount(label: str, n):
    """Accumulate a quantity (cells, jobs, bytes) under the profiler."""
    if _PROF:
        prof_calls[label] += int(n)


if _PROF:
    import atexit

    atexit.register(lambda: dump_prof())


def dump_prof(out=None):
    if not prof and not prof_calls:
        return
    out = out or sys.stderr
    total = sum(prof.values())
    print(f"--- prof ({total:.3f}s accounted) ---", file=out)
    for k in sorted(prof, key=prof.get, reverse=True):
        print(f"{prof[k]:9.3f}s {prof_calls[k]:8d}x  {k}", file=out)
    for k in sorted(prof_calls):
        if k not in prof:  # pcount-only quantities
            print(f"{prof_calls[k]:16d}  {k}", file=out)
