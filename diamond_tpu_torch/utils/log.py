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
# spans (DIAMOND_TPU_PROF=1 at import, or enable(True) later): ptimer(label)
# times a block.  Each span keeps its label, start and end on
# time.perf_counter, its id, its parent's id (the innermost span open at its
# start) and its request id (its root's id) in a bounded buffer (spans());
# it adds its time to prof[label] and a call to prof_calls[label], which
# dump_prof() prints as a sorted table; while a torch.profiler session
# records, it is also a record_function range (one per span).  Off, a site
# costs one check and allocates nothing.
# ---------------------------------------------------------------------------

import itertools
import os
from collections import deque

prof = defaultdict(float)
prof_calls = defaultdict(int)
SPAN_CAP = 1 << 19          # spans kept, newest last (~100 MB at most)
_spans = deque(maxlen=SPAN_CAP)
_open = []                  # the spans open now, innermost last
_ids = itertools.count(1)
_on = bool(os.environ.get("DIAMOND_TPU_PROF"))
dropped = 0                 # spans pushed out of the full buffer


def enable(flag: bool = True):
    """Turn the spans and counters on or off."""
    global _on
    _on = bool(flag)


def enabled() -> bool:
    return _on


def _profiling() -> bool:
    """Whether a torch.profiler session records (read without a call into
    torch)."""
    ap = sys.modules.get("torch.autograd.profiler")
    return ap is not None and getattr(ap, "_is_profiler_enabled", False)


class Span:
    """One timed block.  A kernel span (kspan) also holds the call's work
    under named fields (``fields``) and, on a CUDA device, a CUDA event
    pair around all of the block (``events``; ms() after a sync)."""

    __slots__ = ("label", "t0", "t1", "id", "parent", "request", "fields",
                 "events", "ranged", "_rf", "_stream")

    def __init__(self, label: str, device=None, ranged: bool = True):
        self.label = label
        self.ranged = ranged
        self.fields = self.events = self._rf = self._stream = self.t1 = None
        if device is not None and device.type == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)

    def __enter__(self):
        if self._stream is not None:
            import torch

            self.events = (torch.cuda.Event(enable_timing=True),)
            self.events[0].record(self._stream)
        up = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.request = self.id if up is None else up.request
        _open.append(self)
        if self.ranged and _profiling():
            import torch

            self._rf = torch.profiler.record_function(self.label)
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global dropped
        self.t1 = t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _open.remove(self)
        prof[self.label] += t1 - self.t0
        prof_calls[self.label] += 1
        if len(_spans) == SPAN_CAP:
            dropped += 1
        _spans.append(self)
        if self._stream is not None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self.events = (self.events[0], ev)
            self._stream = None
        return False

    def ms(self) -> float:
        """CUDA-event time of a kernel span (after a sync)."""
        return self.events[0].elapsed_time(self.events[1])


class _Off:
    """The context of every site while the spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _ptimer_on(label: str):
    """ptimer's span while on.  A tracer may wrap this entry; a wrapped
    entry's span leaves the profiler range to the wrapper (perfbench's
    tracer opens one of its own), so that each span is one range."""
    return Span(label, ranged=False)


_own_ptimer_on = _ptimer_on


def ptimer(label: str):
    if not _on:
        return _OFF
    if _ptimer_on is _own_ptimer_on:
        return Span(label)
    return _ptimer_on(label)


def kspan(label: str, device):
    """ptimer of a kernel call on ``device`` (a torch.device): enter gives
    the Span (None while off), to hold the call's work in ``fields``."""
    return Span(label, device) if _on else _OFF


def spans(window=None, prefix=None) -> list:
    """The finished spans kept, oldest first; those that overlap ``window``
    (start, end on perf_counter) and whose label starts with ``prefix``."""
    out = list(_spans)
    if window is not None:
        a, b = window
        out = [s for s in out if s.t1 > a and s.t0 < b]
    if prefix is not None:
        out = [s for s in out if s.label.startswith(prefix)]
    return out


def pcount(label: str, n):
    """Accumulate a quantity (cells, jobs, bytes) under the profiler."""
    if _on:
        prof_calls[label] += int(n)


if _on:
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
