#!/usr/bin/env python3
"""One traced run of a benchmark cell (``perfbench/run.py --trace 1``), and
what the program's own spans (``diamond_tpu_torch.utils.log``) say of its
traced window:

- each label's total and self time (its time less the union of its direct
  children, through the parent ids), as shares of the window;
- the gaps under ``cli.request`` that no child covers, summed by the spans
  around them;
- K1's, D4's and K2's shares of their rooflines from the kernel spans
  (``kernel.k1``, ``kernel.d4`` with ``kernel.d4_compact``, ``kernel.k2``:
  the work under named fields, a CUDA event pair) next to the harness's,
  which wraps the same calls from outside;
- every kernel span's calls and CUDA-event time (``kernel.mask`` too);
- the program's counters of the traced window (``mask.card_letters``,
  ``mask.host_letters``, ...);
- the queries per second of the untraced window (spans on, no profiler)
  and of the traced one.

    python3 tools/span_report.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file.json>] [--root <dir>] [--cpu]

``--root`` holds the BENCHMARK.json to read (the repo's by default);
``--cpu`` runs without a card (with DIAMOND_TPU_TORCH_DEVICE=cpu) and
without the harness's kernel wraps.

Prints the run's result line, then the report as one JSON line (also
written to ``--out``).
"""
import argparse
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
sys.path[:0] = [BENCH, ROOT]

import finder  # noqa: E402
import run  # noqa: E402
import roofline  # noqa: E402
import tracing  # noqa: E402


def self_times(spans, window):
    """label -> (total s, self s) over the window (clipped to it)."""
    a0, a1 = window
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)
    out = defaultdict(lambda: [0.0, 0.0])
    for s in spans:
        a, b = max(s.t0, a0), min(s.t1, a1)
        if b <= a:
            continue
        inner = tracing.union_s([(max(k.t0, a), min(k.t1, b))
                                 for k in kids[s.id]
                                 if min(k.t1, b) > max(k.t0, a)])
        out[s.label][0] += b - a
        out[s.label][1] += b - a - inner
    return out


def request_gaps(spans):
    """(before, after) -> seconds under cli.request that no direct child
    covers, named by the children that end before and start after."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s)
    gaps = defaultdict(float)
    for r in spans:
        if r.label != "cli.request":
            continue
        end, before = r.t0, "<start>"
        for k in sorted(kids[r.id], key=lambda k: k.t0):
            if k.t0 > end:
                gaps[(before, k.label)] += k.t0 - end
            if k.t1 > end:
                end, before = k.t1, k.label
        if r.t1 > end:
            gaps[(before, "<end>")] += r.t1 - end
    return gaps


def span_rooflines(spans):
    """kernel -> percent of its CUDA-event time that its work's least time
    fills, from the program's kernel spans (None without a launch)."""
    mods = {n: finder.load(BENCH, "kernels", n) for n in ("k1", "d4", "k2")}
    timed = {"k1": ("kernel.k1",), "d4": ("kernel.d4", "kernel.d4_compact"),
             "k2": ("kernel.k2",)}
    out = {}
    for k, labels in timed.items():
        ms = least = 0.0
        calls = 0
        for s in spans:
            if s.label not in labels or s.events is None:
                continue
            ms += s.ms()
            if s.label == labels[0]:
                ops, nb = mods[k].work(s.fields)
                least += roofline.least_s(ops, nb) * 1e3
                calls += 1
        out[k] = dict(calls=calls, ms=ms, least_ms=least,
                      roofline=100.0 * least / ms if calls and ms else None)
    return out


def kernel_spans(spans):
    """kernel span label -> (calls, summed CUDA-event ms)."""
    out = defaultdict(lambda: [0, 0.0])
    for s in spans:
        if s.label.startswith("kernel.") and s.events is not None:
            out[s.label][0] += 1
            out[s.label][1] += s.ms()
    return dict(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    seen = {}
    reader = run.metric_reader

    def keep_ctx(name, base=run.HERE):
        read = reader(name, base)
        if read is None:
            return None

        def wrapped(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return wrapped
    requests = []
    run_request = run.run_request

    def counted(cli_main, argv, sync):
        n = 0
        if "-q" in argv:
            with open(argv[argv.index("-q") + 1]) as f:
                n = sum(1 for line in f if line.startswith(">"))
        t0 = run.time.perf_counter()
        rc = run_request(cli_main, argv, sync)
        requests.append((t0, run.time.perf_counter(), n))
        return rc
    run.metric_reader = keep_ctx
    run.run_request = counted
    if args.cpu:  # the harness's kernel wraps record CUDA events
        tracing.kernel_table = lambda base=None: {}
    try:
        result, _ = run.run(["--workload", args.workload, "--seed", args.seed,
                             "--seconds", args.seconds, "--trace", "1"],
                            require_card=not args.cpu, root=args.root)
    finally:
        run.metric_reader = reader
        run.run_request = run_request
    print(json.dumps(result))
    from diamond_tpu_torch.utils import log

    ctx = seen["ctx"]
    window = ctx["window"]
    w = ctx["window_s"]
    spans = log.spans(window)
    st = self_times(spans, window)
    gaps = request_gaps(spans)
    n_req = sum(1 for s in spans if s.label == "cli.request")
    traced_q = sum(n for a, b, n in requests
                   if a >= window[0] and b <= window[1])
    harness = {k: dict(v, roofline=tracing.roofline_share(ctx, k))
               for k, v in ctx.get("kernels", {}).items()}
    report = dict(
        workload=args.workload, seed=args.seed, window_s=w,
        spans=len(spans), requests=n_req, dropped=log.dropped,
        untraced_queries_per_s=ctx["queries"] / ctx["queries_window_s"],
        traced_queries_per_s=traced_q / w,
        labels={k: dict(total=v[0] / w, self=v[1] / w)
                for k, v in sorted(st.items(), key=lambda kv: -kv[1][1])},
        request_gaps=[[a, b, s / w] for (a, b), s in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:15]],
        rooflines=dict(spans=span_rooflines(spans), harness=harness),
        kernel_spans=kernel_spans(spans), counters=ctx.get("counts", {}))
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
