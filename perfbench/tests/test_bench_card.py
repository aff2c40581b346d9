"""On the card (``-m gpu``): one short run of a cell through the real
command, untraced and traced, and the control at the cell's own size."""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _cell(cell, seed, trace, seconds=4):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["blastp-swipe.q8", "blastp-default.q20"])
def test_cell_runs_correct_on_the_card(card, cell):
    res = _cell(cell, 2**33 + 5, 0)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["kind"] == card
    assert res["device"]["memory_peak_bytes"] > 0
    assert {"queries_per_s", "setup_s"} <= set(res["metrics"])
    res = _cell(cell, 2**33 + 6, 1)
    assert res["correct"], res["checks"]
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert "device.idle_share" in res["metrics"]
    for name, m in res["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100, (name, m)


@pytest.mark.gpu
def test_control_is_not_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "control.py"), "--workload",
         "blastp-swipe.q8", "--seconds", "3", "7"], capture_output=True,
        text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert not line["correct"] and line["checks"]["wrong_hits"]["value"] > 0
