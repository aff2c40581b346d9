"""The port's spans (``diamond_tpu_torch.utils.log``): one primitive with
parent and request ids, turned on and off at any time, no torch call while
off, a ``torch.profiler`` range while a profiler records; the labels of the
phase timers it replaced; ``mask.block`` on both blastp routes; the kernel
spans' work; and the benchmark's two readers of the span records
(``perfbench/metrics/mask.share.py``, ``request.self_share.py``) in a small
traced run on the CPU."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from diamond_tpu_torch import cli
from diamond_tpu_torch.utils import log
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "perfbench")
Q2 = os.path.join(REPO, "tests", "goldens", "q2.faa")


@pytest.fixture
def spans_on(monkeypatch):
    """Spans on, the port on the CPU (every fitting DP job on its plain
    kernels); the earlier on/off state back afterwards."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    was = log.enabled()
    log.enable(True)
    yield
    log.enable(was)


def _blastp(tmp_path, *extra, name="out.tsv"):
    """(spans of one in-process blastp of q2 against itself, its rc)."""
    t0 = time.perf_counter()
    rc = cli.main(["blastp", "-q", Q2, "-d", Q2, "-f", "6", "-o",
                   str(tmp_path / name), *extra])
    return log.spans((t0, time.perf_counter())), rc


def test_span_tree_one_request_per_cli_main(spans_on, tmp_path):
    t0 = time.perf_counter()
    for k in range(2):
        assert cli.main(["blastp", "-q", Q2, "-d", Q2, "-f", "6", "-o",
                         str(tmp_path / f"o{k}.tsv")]) == 0
    got = log.spans((t0, time.perf_counter()))
    by_id = {s.id: s for s in got}
    roots = [s for s in got if s.label == "cli.request"]
    assert len(roots) == 2
    assert all(r.parent is None and r.request == r.id for r in roots)
    assert roots[0].t1 <= roots[1].t0
    for s in got:
        if s.label == "cli.request":
            continue
        root = by_id[s.request]
        assert root.label == "cli.request"
        assert root.t0 <= s.t0 <= s.t1 <= root.t1  # inside its request
        up = by_id[s.parent]
        assert up.request == s.request
        assert up.t0 <= s.t0 and s.t1 <= up.t1
    labels = {s.label for s in got}
    assert {"cli.args", "cli.load", "cli.config", "search.setup",
            "mask.block", "search.motif", "cli.write"} <= labels
    assert any(s.label.startswith("seed.") for s in got)
    assert any(s.label.startswith("ext.") for s in got)


def test_spans_turned_on_after_the_port_is_imported(tmp_path):
    code = (
        "import sys\n"
        "from diamond_tpu_torch import cli\n"
        "from diamond_tpu_torch.utils import log\n"
        "assert not log.enabled()\n"
        "argv = ['blastp', '-q', sys.argv[1], '-d', sys.argv[1], '-o',\n"
        "        sys.argv[2]]\n"
        "cli.main(argv)\n"
        "assert not log.spans() and not log.prof\n"
        "log.enable(True)\n"
        "cli.main(argv)\n"
        "print(sorted({s.label for s in log.spans()}))\n"
        "log.enable(False)\n")
    env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    env.pop("DIAMOND_TPU_PROF", None)
    r = subprocess.run([sys.executable, "-c", code, Q2,
                        str(tmp_path / "o.tsv")], capture_output=True,
                       text=True, env=env, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    labels = eval(r.stdout.strip().splitlines()[-1])
    assert "cli.request" in labels and "mask.block" in labels


def test_nesting_ids_and_prof_table():
    was = log.enabled()
    log.enable(True)
    try:
        with log.ptimer("t.outer") as outer:
            with log.ptimer("t.inner") as inner:
                pass
        with log.ptimer("t.next") as nxt:
            pass
    finally:
        log.enable(was)
    assert inner.parent == outer.id and inner.request == outer.id
    assert outer.parent is None and outer.request == outer.id
    assert nxt.parent is None and nxt.request == nxt.id != outer.id
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    got = log.spans(prefix="t.")
    assert [s.label for s in got[-3:]] == ["t.inner", "t.outer", "t.next"]
    assert log.prof_calls["t.outer"] >= 1 and log.prof["t.outer"] > 0
    import io

    out = io.StringIO()
    log.dump_prof(out)
    assert "t.outer" in out.getvalue()


def test_spans_off_record_nothing_and_call_no_profiler(monkeypatch):
    was = log.enabled()
    log.enable(False)

    def refused(*a, **kw):
        raise AssertionError("torch.profiler called while the spans are off")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    try:
        before = len(log.spans())
        calls = dict(log.prof_calls)
        P = torch.profiler
        with P.profile(activities=[P.ProfilerActivity.CPU]):
            off = log.ptimer("t.off")
            assert off is log.ptimer("t.other")  # one object: no allocation
            with off as sp, log.kspan("kernel.t", torch.device("cpu")) as k:
                assert sp is None and k is None
            log.pcount("t.count", 5)
        assert len(log.spans()) == before and dict(log.prof_calls) == calls
    finally:
        log.enable(was)


def test_spans_are_profiler_ranges_while_a_profiler_records():
    was = log.enabled()
    log.enable(True)
    P = torch.profiler
    try:
        with log.ptimer("t.unprofiled") as sp:
            assert sp._rf is None  # no profiler: no call into torch
        with P.profile(activities=[P.ProfilerActivity.CPU]) as prof:
            with log.ptimer("t.profiled"):
                torch.ones(4).sum()
    finally:
        log.enable(was)
    names = [e.name for e in prof.events()]
    assert names.count("t.profiled") == 1 and "t.unprofiled" not in names


def test_the_harness_tracer_reads_each_span_once(monkeypatch):
    """perfbench's tracer wraps ``log._ptimer_on`` in a range of its own
    and swaps ``log.prof``: the span is still recorded, its time reaches
    the swap, and the profiler holds one range for it, not two."""
    sys.path.insert(0, BENCH)
    try:
        import tracing
    finally:
        sys.path.remove(BENCH)
    monkeypatch.setattr(tracing, "kernel_table", lambda base=None: {})
    was = log.enabled()
    log.enable(True)
    tracer = tracing.Tracer(torch, BENCH)
    P = torch.profiler
    try:
        tracer.install()
        with P.profile(activities=[P.ProfilerActivity.CPU]) as prof:
            with log.ptimer("t.wrapped"):
                torch.ones(4).sum()
    finally:
        tracer.uninstall()
        log.enable(was)
    names = [e.name for e in prof.events()]
    assert names.count("t.wrapped") == 1
    assert [n for n, _, _ in tracer.spans] == ["t.wrapped"]
    assert log.spans(prefix="t.wrapped")


# the phase timers that were ``padd`` calls, with the route that runs them
PADD_LABELS = [
    (["--swipe"], {}, ("swipe.mask", "swipe.dispatch", "swipe.host_tail",
                       "swipe.finish")),
    ([], {}, ("ext.tb_card_up", "ext.tb_card_kernel", "ext.tb_card_back",
              "ext.tb_card_results")),
    ([], {"DIAMOND_TPU_TORCH_STAGE12": "1"},
     ("seed.s12_upload", "seed.s12_card", "seed.s12_rows")),
]


@pytest.mark.parametrize("extra,env,labels", PADD_LABELS,
                         ids=["swipe", "tb_card", "stage12"])
def test_padd_labels_still_reach_prof(spans_on, tmp_path, monkeypatch,
                                      extra, env, labels):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {k: log.prof_calls.get(k, 0) for k in labels}
    got, rc = _blastp(tmp_path, *extra)
    assert rc == 0
    for k in labels:
        assert log.prof_calls[k] > calls[k], k
        assert any(s.label == k and s.parent is not None for s in got), k


@pytest.mark.parametrize("route", ["default", "swipe"])
def test_mask_block_on_both_routes(spans_on, tmp_path, route):
    """mask.block on both blastp routes; on the CPU the native scan masks,
    so no kernel.mask span (inside mask.block on a card:
    tests/test_torch_gpu.py::test_tantan_mask_kernel_matches_native_on_gpu)."""
    got, rc = _blastp(tmp_path, *(["--swipe"] if route == "swipe" else []))
    assert rc == 0
    by_id = {s.id: s for s in got}
    masks = [s for s in got if s.label == "mask.block"]
    assert len(masks) == 2  # the DB and the queries
    want = "swipe.mask" if route == "swipe" else "cli.request"
    assert all(by_id[s.parent].label == want for s in masks)
    assert not [s for s in got if s.label == "kernel.mask"]


def _kernels():
    sys.path.insert(0, BENCH)
    try:
        import finder
    finally:
        sys.path.remove(BENCH)
    return {n: finder.load(BENCH, "kernels", n) for n in ("k1", "k2")}


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_kernel_spans_hold_their_work(spans_on, tmp_path, kernel):
    """On the CPU a kernel span holds the call's work under the names the
    benchmark's kernel readers take (no CUDA events there)."""
    got, rc = _blastp(tmp_path, *(["--swipe"] if kernel == "k2" else []))
    assert rc == 0
    ks = [s for s in got if s.label == "kernel." + kernel]
    assert ks and all(s.events is None for s in ks)
    sys.path.insert(0, BENCH)
    try:
        ops, nbytes = zip(*(_kernels()[kernel].work(s.fields) for s in ks))
    finally:
        sys.path.remove(BENCH)
    assert sum(ops) > 0 and sum(nbytes) > 0


class _Rec:
    def __init__(self, label, t0, t1, id, parent):
        self.label, self.t0, self.t1, self.id = label, t0, t1, id
        self.parent = parent
        self.request = id if parent is None else None


def _reader(name):
    sys.path.insert(0, BENCH)
    try:
        import run
        return run.metric_reader(name)
    finally:
        sys.path.remove(BENCH)


def test_span_readers_hand_worked(monkeypatch):
    recs = [_Rec("cli.request", 0.0, 10.0, 1, None),
            _Rec("cli.load", 1.0, 3.0, 2, 1),
            _Rec("mask.block", 2.0, 5.0, 3, 1),
            _Rec("seed.join", 2.5, 4.0, 4, 3),   # not a direct child
            _Rec("mask.block", 7.0, 8.0, 5, 1),
            _Rec("cli.request", 10.5, 12.0, 6, None)]

    def spans(window=None, prefix=None):
        a, b = window
        return [s for s in recs if s.t1 > a and s.t0 < b and
                (prefix is None or s.label.startswith(prefix))]
    monkeypatch.setattr(log, "spans", spans)
    ctx = dict(window=(0.0, 11.0), window_s=11.0)
    # request 1: 10 s less its children's union (1-5, 7-8: 5 s); request 2
    # clipped to the window: 0.5 s, no child
    assert _reader("request.self_share")(ctx) == pytest.approx(5.5 / 11)
    assert _reader("mask.share")(ctx) == pytest.approx(4.0 / 11)
    assert _reader("mask.share")(dict(ctx, window=(8.5, 11.0))) is None
    monkeypatch.delattr(log, "spans")  # a program that keeps no spans
    assert _reader("request.self_share")(ctx) is None
    assert _reader("mask.share")(ctx) is None


@pytest.fixture
def small_root(tmp_path):
    """Built as perfbench/tests/conftest.small_root: the benchmark with its
    configurations cut to 300 database sequences, requests of 6 close
    family members (12 there)."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(tmp_path / "perfbench" / "configs")
    os.makedirs(tmp_path / "perfbench" / "traffic")
    for part in ("metrics", "kernels", "judges"):
        shutil.copytree(os.path.join(BENCH, part),
                        tmp_path / "perfbench" / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        conf["db"].update(sequences=300, families=75)
        c["file"] = f"perfbench/configs/{c['name']}.json"
        with open(tmp_path / c["file"], "w") as f:
            json.dump(conf, f)
    with open(os.path.join(BENCH, "traffic", "q8.json")) as f:
        traffic = json.load(f)
    traffic.update(queries_per_request=6, pool_requests=3,
                   identity=[0.85, 0.95], judge={"requests": 1, "queries": 6})
    with open(tmp_path / "perfbench" / "traffic" / "small.json", "w") as f:
        json.dump(traffic, f)
    bench["workloads"] = [
        dict(name="default.small", config="blastp-default", traffic="small",
             chips=1, why="test"),
        dict(name="swipe.small", config="blastp-swipe", traffic="small",
             chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(tmp_path)


_TRACED = """
import json, sys
sys.path[:0] = [sys.argv[1]]
import run, tracing
from diamond_tpu_torch.utils import log
tracing.kernel_table = lambda base=None: {}
log.enable(True)
result, _ = run.run(["--workload", sys.argv[2], "--seed", "8100000031",
                     "--seconds", "1", "--trace", "1"], require_card=False,
                    root=sys.argv[3])
print(json.dumps(result))
"""


@pytest.mark.parametrize("cell,share", [("default.small", "seed.share"),
                                        ("swipe.small", "swipe.share")])
def test_small_traced_run_reports_the_span_shares(small_root, cell, share):
    """``--trace 1`` on the CPU, in a process of its own (the harness
    refuses a process that holds JAX): the two new readers next to the
    shares that the harness reads from its swap of ``log.prof``.  The
    harness's kernel wraps record CUDA events, which the CPU has not: none
    here; the spans are turned on at the start (run.py's DIAMOND_TPU_PROF
    acts at the port's import)."""
    env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _TRACED, BENCH, cell,
                        small_root], capture_output=True, text=True, env=env,
                       timeout=900, cwd=small_root)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    m = result["metrics"]
    assert result["correct"] and result["failed"] == 0
    for k in ("mask.share", "request.self_share", share, "cli_io.share"):
        assert 0 < m[k]["value"] < 1, k
    assert m["mask.share"]["unit"] == "share"
