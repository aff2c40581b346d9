"""What a traced run (``--trace 1``) records, from the benchmark's own
files around the program's calls:

- the program's ``DIAMOND_TPU_PROF`` timers as spans: its accumulator
  ``utils.log.prof`` is swapped for one that keeps each addition's
  interval (end now, start now minus the time added), and each timer
  block is also a ``torch.profiler.record_function`` range, so the
  profiler's trace shows what the host was doing;
- CUDA events around the kernel calls that each ``kernels/<name>.py``
  names in its ``WRAP`` (module, attribute, the function that keeps what
  the call's work is read from), and that work (``work``) after the
  window: today ``DeviceDP.launch`` (K1), the traceback fill-and-walk
  ``tb_launch`` and its ``tb_compact`` (D4), the full-matrix
  ``full_swipe`` (K2);
- a ``torch.profiler`` trace of the window: the device's busy time, its
  busiest operations and its longest idle gaps.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict

import importlib

import numpy as np

import finder
import roofline

HERE = os.path.dirname(os.path.abspath(__file__))


class SpanDict(defaultdict):
    """``utils.log.prof`` that keeps every addition as a span."""

    def __init__(self, spans):
        super().__init__(float)
        self.spans = spans

    def __setitem__(self, key, value):
        now = time.perf_counter()
        dt = value - self.get(key, 0.0)
        if dt > 0:
            self.spans.append((key, now - dt, now))
        super().__setitem__(key, value)


def kernel_table(base: str = HERE) -> dict:
    """kernel name -> its module (``kernels/<name>.py``: ``WRAP``,
    ``work``)."""
    return {n: finder.load(base, "kernels", n)
            for n in finder.names(base, "kernels")}


def resolve(module: str, attr: str):
    """(object, name) of a dotted attribute of a module."""
    obj = importlib.import_module(module)
    *outer, name = attr.split(".")
    for a in outer:
        obj = getattr(obj, a)
    return obj, name


class Tracer:
    def __init__(self, torch, base: str = HERE):
        self.torch = torch
        self.kernels = kernel_table(base)
        self.spans = []
        self.launches = defaultdict(list)   # kernel -> [(ev0, ev1, info)]
        self.undo = []
        self.prof = None

    # -- instrumentation ------------------------------------------------
    def _patch(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def _timed(self, kernel, fn, info):
        torch = self.torch
        launches = self.launches[kernel]

        @functools.wraps(fn)  # and its launch count, which it adds to
        def wrapper(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            launches.append((ev[0], ev[1], info(a, kw, out)))
            return out
        return wrapper

    def install(self):
        from diamond_tpu_torch.utils import log

        torch = self.torch
        self._patch(log, "prof", SpanDict(self.spans))
        on = log._ptimer_on

        @contextlib.contextmanager
        def annotated(label):
            with torch.profiler.record_function(label), on(label):
                yield
        self._patch(log, "_ptimer_on", annotated)

        for kernel, mod in self.kernels.items():
            for module, attr, info in mod.WRAP:
                obj, name = resolve(module, attr)
                self._patch(obj, name,
                            self._timed(kernel, getattr(obj, name), info))

    def uninstall(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)
        self.undo.clear()

    # -- the profiler ---------------------------------------------------
    def start_profiler(self):
        P = self.torch.profiler
        self.prof = P.profile(activities=[P.ProfilerActivity.CPU,
                                          P.ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop_profiler(self, workdir):
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        path = os.path.join(workdir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        self.prof = None
        return events

    # -- reductions -----------------------------------------------------
    def kernel_work(self):
        """kernel -> dict(ms, least_ms, calls, ops, bytes), every launch of
        the window read back: its CUDA-event time, and the least time, the
        operations and the bytes of its work (the kernel's ``work``)."""
        out = {}
        for kernel, launches in self.launches.items():
            k = dict(ms=0.0, least_ms=0.0, calls=0, ops=0, bytes=0)
            for ev0, ev1, info in launches:
                k["ms"] += ev0.elapsed_time(ev1)
                if info is None:
                    continue
                ops, nb = self.kernels[kernel].work(info)
                k["calls"] += 1
                k["ops"] += int(ops)
                k["bytes"] += int(nb)
                k["least_ms"] += roofline.least_s(ops, nb) * 1e3
            out[kernel] = k
        return out

    def event_busy_s(self):
        return sum(e0.elapsed_time(e1) for ls in self.launches.values()
                   for e0, e1, _ in ls) / 1e3


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_breakdown(events):
    """(busy seconds, device_ops, idle_gaps) of a chrome trace: the union
    of the device's operations, the ten that took most time by name, and
    the ten longest gaps between them, each named by the innermost host
    annotation (a program timer) that covers its middle."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?"))
           for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    busy = union_s([(a, b) for a, b, _ in dev]) / 1e6
    by_name = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    notes = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    gaps, end = [], None
    for a, b, _ in sorted(dev):
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    named = defaultdict(float)
    for dur, a, b in sorted(gaps, reverse=True)[:200]:
        mid = 0.5 * (a + b)
        cover = [n for s, e, n in notes if s <= mid <= e]
        named[cover[-1] if cover else "outside the program's timers"] = max(
            named[cover[-1] if cover else "outside the program's timers"],
            dur / 1e6)
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return busy, [[n, s] for n, s in ops], [[n, s] for n, s in idle]


def spans_s(spans, prefixes, window):
    """Seconds of the window covered by spans whose label starts with one
    of ``prefixes`` (nested spans counted once)."""
    a0, a1 = window
    return union_s([(max(a, a0), min(b, a1)) for n, a, b in spans
                    if n.startswith(prefixes) and b > a0 and a < a1])


def share(ctx, prefixes):
    """Share of the window under the program's timers of some prefixes
    (nested timers counted once); None when none of them ran."""
    if "spans" not in ctx or not any(n.startswith(prefixes)
                                     for n, _, _ in ctx["spans"]):
        return None
    return spans_s(ctx["spans"], prefixes, ctx["window"]) / ctx["window_s"]


def roofline_share(ctx, kernel):
    """Percent of a kernel's CUDA-event time that its work's least time
    fills, over the window's launches; None without a launch."""
    k = ctx.get("kernels", {}).get(kernel)
    if not k or not k["calls"] or k["ms"] <= 0:
        return None
    return 100.0 * k["least_ms"] / k["ms"]


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of the values, linear between ranks."""
    return float(np.percentile(np.asarray(values, np.float64), q))
