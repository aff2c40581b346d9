"""The port's ``benchmark`` command against diamond_tpu's: the same rows in
the same order (TPU machinery renamed to the port's), the device e-value
twin against ``evalue_jax`` (float32, rtol 1e-5: the two frameworks round
erfc and exp differently in the last bits), and no silent CPU run.

The kernels' card timings come from ``chip_smoke.py`` on the card.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

import jax.numpy as jnp  # noqa: E402

from diamond_tpu.stats.evalue import evalue_jax  # noqa: E402
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.benchmark import run_benchmark  # noqa: E402
from diamond_tpu_torch.stats.evalue_device import evalue_torch  # noqa: E402
from diamond_tpu_torch.stats.score_matrix import ScoreMatrix as PortMatrix  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"(pallas)": "(cuda)", "(XLA one-hot)": "(torch one-hot)",
           "(MXU)": "(matmul)", "(slot-packed)": "(DeviceDP)"}


def _reference_rows():
    """Row names of diamond_tpu/benchmark.py in source order, renamed."""
    with open(os.path.join(REPO, "diamond_tpu", "benchmark.py")) as f:
        names = re.findall(r'rows\.append\(\(\s*"([^"]+)"', f.read())
    out = []
    for n in names:
        for a, b in RENAMED.items():
            n = n.replace(a, b)
        out.append(n)
    return out


def test_benchmark_rows_match_reference(capsys):
    rows = run_benchmark(device="cpu", small=True)
    text = capsys.readouterr().out
    want = _reference_rows()
    assert len(want) == 21
    assert [n for n, _, _ in rows] == want
    assert all(c > 0 and 0 < dt < float("inf") for _, c, dt in rows)
    lines = text.splitlines()
    assert lines[0] == "Device: cpu (cpu)"
    assert lines[1].split() == ["kernel", "ps/cell", "GCUPS"]
    assert [ln[:30].rstrip() for ln in lines[2:]] == want


def test_evalue_torch_matches_jax():
    m, pm = ScoreMatrix("BLOSUM62"), PortMatrix("BLOSUM62")
    rng = np.random.default_rng(9)
    s = rng.integers(30, 300, 4096).astype(np.int64)
    t = rng.integers(100, 2000, 4096).astype(np.int64)
    want = np.asarray(evalue_jax(m.gumbel, jnp.asarray(s), 480, jnp.asarray(t)))
    got = evalue_torch(pm.gumbel, torch.from_numpy(s), 480, torch.from_numpy(t))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_cli_benchmark_without_card_exits(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DIAMOND_TPU_TORCH_DEVICE", None)
    if torch.cuda.is_available():  # hide the card from the subprocess
        env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "diamond_tpu_torch.cli",
                        "benchmark"], capture_output=True, text=True, env=env,
                       timeout=300, cwd=str(tmp_path))
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""
