"""The port imports neither jax nor diamond_tpu, and never hides the device.

A subprocess imports every module of diamond_tpu_torch (and chip_smoke.py),
runs a tiny blastp on the CPU and checks sys.modules; a static scan checks
the sources; the CLI without a card, and without a request for the CPU,
must exit non-zero saying so.
"""
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "diamond_tpu_torch")
Q2 = os.path.join(REPO, "tests", "goldens", "q2.faa")

_PROBE = """
import importlib, pkgutil, sys
import diamond_tpu_torch
sys.path.insert(0, {repo!r})
import chip_smoke
for m in pkgutil.walk_packages(diamond_tpu_torch.__path__, "diamond_tpu_torch."):
    importlib.import_module(m.name)
from diamond_tpu_torch.cli import main
main(["blastp", "-q", {q2!r}, "-d", {q2!r}, "-o", {out!r}])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "diamond_tpu" or m.startswith("diamond_tpu."))
print("BAD=" + ",".join(bad))
"""


def _is_reference(mod):
    return mod == "diamond_tpu" or mod.startswith("diamond_tpu.")


def test_port_process_loads_no_jax(tmp_path):
    out = tmp_path / "o.tsv"
    env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c",
                        _PROBE.format(repo=REPO, q2=Q2, out=str(out))],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD=\n" in r.stdout, r.stdout
    assert len(out.read_text().splitlines()) == 4


def test_sources_import_no_jax():
    imp = re.compile(r"^\s*(?:from\s+([\w.]+)\s+import|import\s+([\w., ]+))",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            src = f.read()
        for m in imp.finditer(src):
            mods = [m.group(1)] if m.group(1) else \
                [x.split()[0] for x in m.group(2).split(",")]
            for mod in mods:
                assert not (mod == "jax" or mod.startswith("jax.")), (path, mod)
                assert not _is_reference(mod), (path, mod)


def test_cli_without_card_exits_with_message(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DIAMOND_TPU_TORCH_DEVICE", None)
    if torch.cuda.is_available():  # hide the card from the subprocess
        env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "diamond_tpu_torch.cli",
                        "blastp", "-q", Q2, "-d", Q2],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""


def test_cli_names_roadmap_item_for_unported_options(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu")
    for extra in (["-g", "1"], ["-b", "1"], ["--target-indexed"],
                  ["--mesh", "2"], ["--masking", "seg"], ["--iterate"]):
        r = subprocess.run([sys.executable, "-m", "diamond_tpu_torch.cli",
                            "blastp", "-q", Q2, "-d", Q2, *extra],
                           capture_output=True, text=True, env=env,
                           timeout=300, cwd=str(tmp_path))
        assert r.returncode != 0, extra
        assert "ROADMAP.md" in r.stderr, (extra, r.stderr)
