"""Run diamond_tpu's CLI or the port's in a subprocess, for the port's
byte-for-byte CLI tests: ``from torch_cli import run_cli, synthetic_set``.

diamond_tpu runs under JAX on the CPU with its host DP; the port runs on the
CPU it is asked for, every fitting DP job through DeviceDP's plain
version, with one torch thread, and reports
DeviceDP's dispatch count on stderr as ``DISPATCHES=N``.  Both CLIs see the
same argv[0].
"""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
PORT = "diamond_tpu_torch"

_LAUNCH = """
import sys
from {pkg}.cli import main
sys.argv = ["diamond"] + sys.argv[1:]
try:
    rc = main(sys.argv[1:])
finally:
    if "{pkg}" == "diamond_tpu_torch":
        from diamond_tpu_torch.ops import swipe_device as sd
        print(f"DISPATCHES={{sd.dispatch_count}}", file=sys.stderr)
sys.exit(rc)
"""


def cli_env(pkg, extra=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("DIAMOND_TPU_TORCH_STAGE12", "DIAMOND_TPU_STAGE12",
              "DIAMOND_TPU_TORCH_DEVICE_DP"):
        env.pop(k, None)
    if pkg == PORT:
        env.update(DIAMOND_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    else:
        env.update(JAX_PLATFORMS="cpu", DIAMOND_TPU_DEVICE_DP="0")
    env.update(extra or {})
    return env


def cli_argv(pkg, args):
    return [sys.executable, "-c", _LAUNCH.format(pkg=pkg), *args]


def run_cli(pkg, args, cwd, extra_env=None, check=True):
    """(returncode, stdout bytes, stderr text, DeviceDP dispatches or
    None)."""
    r = subprocess.run(cli_argv(pkg, args), capture_output=True,
                       env=cli_env(pkg, extra_env), timeout=600,
                       cwd=str(cwd))
    err = r.stderr.decode()
    if check:
        assert r.returncode == 0, err[-2000:]
    return r.returncode, r.stdout, err, dispatches(err)


def dispatches(err):
    m = re.search(r"DISPATCHES=(\d+)", err)
    return int(m.group(1)) if m else None


def synthetic_set(d, n_seqs=60, n_families=15, n_queries=20, seed=5):
    """A seeded protein set from chip_smoke.py's generator written to
    d/db.faa, its first n_queries to d/q.faa; returns the records."""
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import make_proteins, write_fasta
    finally:
        sys.path.remove(REPO)
    recs = make_proteins(n_seqs=n_seqs, n_families=n_families, seed=seed)
    write_fasta(os.path.join(d, "db.faa"), recs)
    write_fasta(os.path.join(d, "q.faa"), recs[:n_queries])
    return recs
