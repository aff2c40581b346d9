"""Fixtures of the benchmark's own tests: a small copy of the benchmark
(its configurations cut to 300 database sequences, requests of 12
queries of close family members) that a CPU run can hold, and the card
fixture."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    """A root holding a BENCHMARK.json with the cells ``default.small``
    and ``swipe.small``; the port runs on the CPU."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(tmp_path / "perfbench" / "configs")
    os.makedirs(tmp_path / "perfbench" / "traffic")
    for part in ("metrics", "kernels", "judges"):
        shutil.copytree(os.path.join(BENCH, part),
                        tmp_path / "perfbench" / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        conf["db"].update(sequences=300, families=75)
        c["file"] = f"perfbench/configs/{c['name']}.json"
        with open(tmp_path / c["file"], "w") as f:
            json.dump(conf, f)
    with open(os.path.join(BENCH, "traffic", "q8.json")) as f:
        traffic = json.load(f)
    # close members, so that most related queries have family pairs that
    # the default sensitivity must find (``must_find``): a fault that drops
    # results shows on every seed
    traffic.update(queries_per_request=12, pool_requests=3,
                   identity=[0.85, 0.95], judge={"requests": 2, "queries": 12})
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


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
