#!/usr/bin/env python3
"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (``setup_s``): torch and the port, the card, the port's CUDA and
native libraries (built once a checkout, into ``diamond_tpu_torch/build/``
and ``.perfbench_cache/``), the target database from the seed with its
``makedb``, the request pool of the cell's traffic mix, one warm request.
Window: one caller runs the pool's requests back to back, each an
in-process ``diamond_tpu_torch.cli.main([<command>, ...])`` call writing
``-f 6`` (the command word and options from the configuration), until the
first request that ends ``--seconds`` after the start.  Then the
comparison (the configuration's ``judges/<module>.py``) on requests drawn
from the seed, and one JSON line on standard output, last.  ``--trace 1``
reports the per-layer metrics instead of the end-to-end ones: it runs an
untraced window first (the request latencies), then a traced one of the
same length (``tracing.py``; ``metrics/<name>.py``, ``kernels/<name>.py``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".perfbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "diamond_tpu")
sys.path[:0] = [HERE, ROOT]  # the harness's modules, the program

import finder  # noqa: E402


class RunError(Exception):
    """A run that prints no result: its exit code and why."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def load_spec(workload: str, root: str = ROOT):
    """(benchmark, cell, configuration, traffic, base) of a cell, each file
    found by its name: the configuration at its ``file``, the traffic mix
    at ``<base>/traffic/<traffic>.json``, base the benchmark's folder
    (``paths[0]``), where metrics, kernels and judges are found too."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError(2, f"no BENCHMARK.json at {root}")
    with open(path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(2, f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    base = os.path.join(root, bench["paths"][0])
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(base, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic, base


def metric_reader(name: str, base: str = HERE):
    """``read`` of ``metrics/<name>.py``, else of the reader of its longest
    dotted prefix (``request_p90_s.<cell>`` -> ``request_p90_s.py``); None
    if none."""
    parts = name.split(".")
    while parts:
        mod = finder.load(base, "metrics", ".".join(parts))
        if mod is not None:
            return mod.read
        parts.pop()
    return None


def judge_module(config, base: str = HERE):
    """The configuration's judge, ``judges/<judge.module>.py``."""
    name = config["judge"]["module"]
    mod = finder.load(base, "judges", name)
    if mod is None:
        raise RunError(2, f"no judge {name!r} under {base}/judges")
    return mod


def cell_metrics(bench, cell, kind: str):
    """The end-to-end or per-layer metrics this cell reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e_names)]


def smi(query: str) -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def request_argv(config, query_path, db_path, out_path):
    """One request's command line: the configuration's ``command`` word,
    the query file, the database, the output, its ``outfmt`` and
    ``args``."""
    return [config["command"], "-q", query_path, "-d", db_path, "-o",
            out_path, "-f", *config["outfmt"], *config["args"]]


def run_request(cli_main, argv, sync):
    """Exit code of one in-process CLI call (an exception is 1)."""
    try:
        rc = cli_main(argv) or 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    except Exception as e:  # a failed request is counted, the window goes on
        print(f"request failed: {type(e).__name__}: {e}", file=sys.stderr)
        rc = 1
    sync()
    return rc


def run(argv=None, require_card=True, control=False, root=ROOT):
    """A run; returns (result dict, compared numbers).  ``require_card``
    False skips the look for a card (the tests drive the rest of a run on
    the CPU with DIAMOND_TPU_TORCH_DEVICE=cpu); ``control`` judges the
    control's lines in place of the program's (the judge's ``judge``);
    ``root`` holds the BENCHMARK.json to read."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = T_START if require_card else time.perf_counter()
    bench, cell, config, traffic, base = load_spec(args.workload, root)
    trace = bool(args.trace)
    if trace:
        os.environ["DIAMOND_TPU_PROF"] = "1"  # read when the port is imported
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    on_card = require_card
    if require_card:
        if not torch.cuda.is_available():
            raise RunError(3, "no CUDA card: torch.cuda.is_available() is "
                              "false")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(3, f"the cell needs {cell['chips']} card(s), "
                              f"{torch.cuda.device_count()} found")
        torch.cuda.init()
    try:
        import diamond_tpu_torch  # noqa: F401
        from diamond_tpu_torch import cli, native
        from diamond_tpu_torch.utils import log
    except ImportError as e:
        raise RunError(4, f"the program is not here: {e}")
    import numpy as np

    import gen

    judge = judge_module(config, base)
    # the port's native host library builds under tempfile.gettempdir():
    # give that first build a fixed home in the checkout
    native_dir = os.path.join(CACHE, "native")
    os.makedirs(native_dir, exist_ok=True)
    tempfile.tempdir = native_dir
    try:
        native.lib()
    finally:
        tempfile.tempdir = None
    if on_card:
        from diamond_tpu_torch.ops import _cuda

        _cuda.build(sorted(f[:-3] for f in os.listdir(_cuda.CSRC_DIR)
                           if f.endswith(".cu")))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    workdir = tempfile.mkdtemp(prefix="perfbench_")
    tracer = None
    try:
        db_seed, pool_seed, judge_seed = gen.split_seed(args.seed, 3)
        db = gen.make_db(config["db"], db_seed)
        db_fa = os.path.join(workdir, "db.faa")
        gen.write_fasta(db_fa, db)
        db_path = os.path.join(workdir, "db")
        if run_request(cli.main, ["makedb", "--in", db_fa, "-d", db_path],
                       sync):
            raise RunError(5, "makedb failed")
        db_path += ".dmnd"
        pool = gen.make_pool(db, traffic, pool_seed)
        paths = []
        for r, req in enumerate(pool):
            p = os.path.join(workdir, f"req{r:04d}.faa")
            gen.write_fasta(p, [(q[0], q[1]) for q in req])
            paths.append(p)
        warm_out = os.path.join(workdir, "warm.tsv")
        if run_request(cli.main, request_argv(config, paths[-1], db_path,
                                              warm_out), sync):
            raise RunError(5, "the warm request failed")
        pool, paths = pool[:-1], paths[:-1]
        gc.collect()
        setup_s = time.perf_counter() - t_start

        rcs, outs = [], []   # every request of the run, in order

        def window():
            """Requests back to back until the first that ends --seconds
            after the start: (latencies, queries, start, end)."""
            lat, queries = [], 0
            t_w0 = t1 = time.perf_counter()
            while t1 - t_w0 < args.seconds:
                r = len(rcs)
                out = os.path.join(workdir, f"out{r:05d}.tsv")
                t0 = time.perf_counter()
                rcs.append(run_request(cli.main, request_argv(
                    config, paths[r % len(paths)], db_path, out), sync))
                t1 = time.perf_counter()
                lat.append(t1 - t0)
                outs.append(out)
                queries += len(pool[r % len(pool)])
            return lat, queries, t_w0, t1

        # -- the window (untraced; in a traced run, the latencies) ---------
        lat, queries, t_w0, t1 = window()
        window_s = t1 - t_w0
        ctx = dict(window_s=window_s, latencies=lat, queries=queries,
                   queries_window_s=window_s, setup_s=setup_s)
        breakdown = None
        if trace:
            # -- the traced window ------------------------------------------
            import tracing as tr

            tracer = tr.Tracer(torch, base)
            if on_card:  # the profiler's first start sets up CUPTI: not here
                tracer.start_profiler()
                tracer.stop_profiler(workdir)
            log.prof.clear()
            log.prof_calls.clear()
            tracer.install()
            if on_card:
                tracer.start_profiler()
            _, _, t_w0, t1 = window()
            tracer.uninstall()
            window_s = t1 - t_w0
            ctx.update(window_s=window_s, spans=tracer.spans,
                       window=(t_w0, t1), counts=dict(log.prof_calls),
                       kernels=tracer.kernel_work() if on_card else {})
            busy = tracer.event_busy_s() if on_card else 0.0
            if on_card:
                got = tr.device_breakdown(tracer.stop_profiler(workdir))
                if got is not None:
                    busy, ops, gaps = got
                    breakdown = dict(device_ops=ops, idle_gaps=gaps)
                else:
                    print("the profiler's trace holds no device operation: "
                          "busy time from CUDA events", file=sys.stderr)
            ctx["busy_s"] = busy
            # the program's timers print at exit when they hold anything
            log.prof.clear()
            log.prof_calls.clear()
        n_req = len(rcs)
        device = dict(platform="gpu" if on_card else "cpu",
                      kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                      count=int(cell["chips"]) if on_card else 0,
                      memory_peak_bytes=int(torch.cuda.max_memory_allocated())
                      if on_card else 0)
        if trace:
            device.update(busy_s=ctx["busy_s"], window_s=window_s)
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in cell_metrics(bench, cell, kind):
            reader = metric_reader(m["name"], base)
            value = None if reader is None else reader(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        tracer = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # -- the comparison -------------------------------------------------
        jcfg = dict(config["judge"], **traffic["judge"])
        rng = np.random.default_rng(judge_seed)
        done = [r for r in range(n_req) if rcs[r] == 0]
        pick = sorted(rng.choice(done, size=min(int(jcfg["requests"]),
                                                 len(done)), replace=False)
                      .tolist()) if done else []
        judged = []
        for r in pick:
            req = pool[r % len(pool)]
            n = min(int(jcfg["queries"]), len(req))
            keep = set(rng.choice(len(req), size=n, replace=False).tolist())
            sample = [q for k, q in enumerate(req) if k in keep]
            names = {q[0] for q in sample}
            with open(outs[r]) as f:
                text = "".join(line for line in f
                               if line.split("\t", 1)[0] in names)
            judged.append((sample, text))
        numbers, details = judge.judge(judged, db, jcfg,
                                       device="cuda" if on_card else "cpu",
                                       control=control)
        numbers["failed_requests"] = sum(1 for rc in rcs if rc)
        for kind_, items in (("wrong", details["wrong"]),
                             ("missed", details["missed"])):
            for item in items[:10]:
                print(f"{kind_}: {item}", file=sys.stderr)
        correct = bool(pick) and all(
            numbers[k] <= judge.LIMITS[k] for k in judge.LIMITS)
        failed = numbers["failed_requests"] + len(details["bad_requests"])
        q = sorted(lat)
        print(f"latencies: {len(lat)} requests, min {q[0]:.3f} median "
              f"{q[len(q) // 2]:.3f} max {q[-1]:.3f} s; in order "
              + " ".join(f"{x:.3f}" for x in lat[:60]), file=sys.stderr)
        print(judge.summary(details) + f"; {len(pick)} requests judged of "
              f"{n_req}; the last window {window_s:.3f} s", file=sys.stderr)
    finally:
        if tracer is not None:
            tracer.uninstall()
        shutil.rmtree(workdir, ignore_errors=True)

    loaded = sorted({m.split(".", 1)[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        raise RunError(6, f"modules loaded that must not be: {loaded}")
    checks = {k: dict(value=numbers[k], limit=judge.LIMITS[k])
              for k in judge.LIMITS}
    result = dict(correct=correct, attempted=n_req, failed=failed,
                  metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


def main(argv=None):
    try:
        result, checks = run(argv)
    except RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    if result["device"]["platform"] == "gpu":
        print(f"card: {result['device']['kind']}, "
              f"{smi('power.limit')} power limit", file=sys.stderr)
    for k, v in checks.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
