"""The harness finds configurations, traffic mixes and metric readers by
name, loads nothing it must not, and decides ``correct`` by the judge:
true on a sound run, false for the control and for each planted fault."""
import json
import os
import subprocess
import sys

import pytest

import run
import tracing

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_every_cell_finds_its_files_and_readers():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        b, c, config, traffic, base = run.load_spec(cell["name"])
        assert config["db"]["sequences"] > 0 and traffic["queries_per_request"]
        assert run.judge_module(config, base).LIMITS
        assert run.request_argv(config, "q", "d", "o")[0] == config["command"]
        for kind in ("end_to_end", "per_layer"):
            ms = run.cell_metrics(b, c, kind)
            assert ms, (cell["name"], kind)
            for m in ms:
                assert run.metric_reader(m["name"]) is not None, m["name"]
        assert "setup_s" in {m["name"] for m in
                             run.cell_metrics(b, c, "end_to_end")}


def test_metric_reader_falls_back_to_the_dotted_prefix():
    read = run.metric_reader("request_p90_s.some-new.cell")
    assert read({"latencies": list(range(1, 11))}) == pytest.approx(9.1)
    assert run.metric_reader("no_such_metric") is None


def test_unknown_workload_is_refused():
    with pytest.raises(run.RunError):
        run.load_spec("no.such.cell")


def test_span_shares_count_nested_spans_once():
    spans = [("seed.stage12", 0.0, 4.0), ("seed.s12_card", 1.0, 2.0),
             ("ext.tb_multi", 5.0, 7.0), ("ext.tb_card", 5.5, 6.0),
             ("seed.join", 9.0, 11.0)]
    assert tracing.spans_s(spans, ("seed.",), (0.0, 10.0)) == 5.0
    assert tracing.spans_s(spans, ("ext.",), (0.0, 10.0)) == 2.0
    read = run.metric_reader("extend.share")
    assert read(dict(spans=spans, window=(0.0, 10.0), window_s=10.0)) == 0.2
    assert run.metric_reader("swipe.share")(
        dict(spans=spans, window=(0.0, 10.0), window_s=10.0)) is None


def test_device_breakdown_of_a_chrome_trace():
    ev = [dict(ph="X", cat="kernel", name="k", ts=0, dur=10),
          dict(ph="X", cat="kernel", name="k", ts=5, dur=10),
          dict(ph="X", cat="gpu_memcpy", name="copy", ts=40, dur=5),
          dict(ph="X", cat="user_annotation", name="seed.join", ts=14,
               dur=30)]
    busy, ops, gaps = tracing.device_breakdown(ev)
    assert busy == pytest.approx(20e-6)
    assert ops[0] == ["k", pytest.approx(20e-6)]
    assert gaps == [["seed.join", pytest.approx(25e-6)]]


def test_the_harness_loads_no_jax_and_no_jax_package():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import run, gen, reference, roofline, tracing\n"
            "tracing.kernel_table()\n"
            "run.judge_module({'judge': {'module': 'blastp'}})\n"
            "import diamond_tpu_torch.cli, diamond_tpu_torch.ops.swipe_device\n"
            "import diamond_tpu_torch.ops.traceback_device\n"
            "for n in ('queries_per_s', 'k1_roofline', 'seed.share'):\n"
            "    run.metric_reader(n)\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "set(run.FORBIDDEN))\n"
            "print(bad)\n") % (BENCH, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "diamond_tpu")


def _run(root, cell="default.small", seed=2**35 + 11, **kw):
    result, checks = run.run(["--workload", cell, "--seed", str(seed),
                              "--seconds", "1"], require_card=False,
                             root=root, **kw)
    return result, {k: v["value"] for k, v in checks.items()}


def test_a_sound_run_is_correct(small_root):
    result, checks = _run(small_root)
    assert result["correct"], checks
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert list(result)[-1] == "checks"
    assert {"queries_per_s", "setup_s"} <= set(result["metrics"])


def test_the_control_is_not_correct(small_root):
    for cell in ("default.small", "swipe.small"):
        result, checks = _run(small_root, cell, control=True)
        assert not result["correct"] and checks["wrong_hits"] > 0, checks


def _patch_results(monkeypatch, change):
    from diamond_tpu_torch.search import pipeline

    search = pipeline.Pipeline.search

    def faulty(self):
        return change(search(self))
    monkeypatch.setattr(pipeline.Pipeline, "search", faulty)


def test_half_of_the_batch_left_out_is_not_correct(small_root, monkeypatch):
    _patch_results(monkeypatch, lambda res: {
        q: m for k, (q, m) in enumerate(sorted(res.items())) if k % 2})
    result, checks = _run(small_root)
    assert not result["correct"] and checks["missed_members"] > 0, checks


def test_an_answer_altered_where_it_is_made_is_not_correct(small_root,
                                                           monkeypatch):
    def alter(res):
        for matches in res.values():
            for m in matches:
                m.hsp[0].score += 1
                return res
        return res
    _patch_results(monkeypatch, alter)
    result, checks = _run(small_root)
    # one altered hit a judged request
    assert not result["correct"] and checks["wrong_hits"] >= 1, checks


def test_every_kernels_calls_resolve():
    for name, mod in tracing.kernel_table().items():
        assert mod.WRAP, name
        for module, attr, info in mod.WRAP:
            obj, fn = tracing.resolve(module, attr)
            assert callable(getattr(obj, fn)) and callable(info), (name, attr)
        assert run.metric_reader(name + "_roofline") is not None, name


LATER = {
    "configs/blastx-longreads.json": dict(
        command="blastx", args=["-F", "15", "--range-culling", "--top", "10"],
        outfmt=["6"], db=dict(sequences=200, families=50,
                              size_seed=3),
        judge=dict(module="blastx_frames")),
    "traffic/r300.json": dict(
        queries="reads", queries_per_request=4, pool_requests=2,
        related_share=0.7, identity=[0.6, 0.95], length_lognormal=[300, 0.7],
        length_clip=[30, 3000], read_length=[2000, 8000], indels_per_kb=3.0,
        subst=0.01, size_seed=300, judge=dict(requests=1, queries=4)),
}
LATER_CODE = {
    "metrics/k3_roofline.py": "import tracing\n\n\ndef read(ctx):\n"
                              "    return tracing.roofline_share(ctx, 'k3')\n",
    "kernels/k3.py": "WRAP = [('diamond_tpu_torch.ops.swipe3_device', "
                     "'banded_swipe3', lambda a, kw, out: None)]\n\n\n"
                     "def work(info):\n    return 0, 0\n",
    "judges/blastx_frames.py": "LIMITS = {'wrong_hits': 0}\n\n\n"
                               "def judge(requests, db, cfg, device='cpu', "
                               "control=False):\n"
                               "    return dict(wrong_hits=0), {}\n",
}


def test_a_later_cell_is_new_files_and_entries_only(tmp_path):
    """A blastx cell with its configuration, traffic of reads, a kernel's
    calls, its roofline and its judge: new files and new BENCHMARK.json
    entries, no existing file of the harness edited."""
    import hashlib
    import shutil

    import gen

    base = tmp_path / "perfbench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))

    def digest():
        return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(base.rglob("*")) if p.is_file()}
    before = digest()
    for rel, obj in LATER.items():
        (base / rel).write_text(json.dumps(obj))
    for rel, code in LATER_CODE.items():
        (base / rel).write_text(code)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(
        name="blastx-longreads", source="MEGAN-LR",
        file="perfbench/configs/blastx-longreads.json", reduced=[], why="t"))
    bench["workloads"].append(dict(
        name="blastx-longreads.r300", config="blastx-longreads",
        traffic="r300", chips=1, why="t"))
    bench["per_layer"].append(dict(
        name="k3_roofline", unit="%", better="higher", source="device_trace",
        layer="kernels", moves="queries_per_s",
        workloads=["blastx-longreads.r300"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest()
    assert {k: v for k, v in after.items() if k in before} == before

    b, cell, config, traffic, got = run.load_spec("blastx-longreads.r300",
                                                  str(tmp_path))
    assert got == str(base)
    assert run.request_argv(config, "q", "d", "o")[:2] == ["blastx", "-q"]
    assert run.judge_module(config, got).LIMITS == {"wrong_hits": 0}
    names = {m["name"] for m in run.cell_metrics(b, cell, "per_layer")}
    assert "k3_roofline" in names
    read = run.metric_reader("k3_roofline", got)
    assert read({"kernels": {"k3": dict(ms=2.0, least_ms=1.0, calls=1)}}) \
        == 50.0
    table = tracing.kernel_table(got)
    assert {"k1", "d4", "k2", "k3"} <= set(table)
    module, attr, _ = table["k3"].WRAP[0]
    assert callable(getattr(*tracing.resolve(module, attr)))
    pool = gen.make_pool(gen.make_db(config["db"], 5), traffic, 6)
    assert all(set(q[1]) <= set("ACGT") for r in pool for q in r)
