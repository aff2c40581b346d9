"""End to end: ``blastp`` of the port (diamond_tpu_torch) byte for byte against
diamond_tpu's, in subprocesses.

The port runs on the CPU with every fitting DP job routed through DeviceDP's
plain version and must make DeviceDP dispatches; diamond_tpu runs its host
DP under JAX on the CPU.  Both CLIs see the same argv[0], so the SAM
header's command line matches too.  With
stage 1/2 on the device (DIAMOND_TPU_TORCH_STAGE12=1: Stage12Device, D1's
plain version on the CPU) the port must equal diamond_tpu's device route
(DIAMOND_TPU_STAGE12=1) and its own host route, dispatch to Stage12Device
and never fork.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")

# runs a package's cli.main with argv[0] = "diamond"; the port's run reports
# DeviceDP's dispatch count on stderr
_LAUNCH = """
import sys
from {pkg}.cli import main
sys.argv = ["diamond"] + sys.argv[1:]
rc = main(sys.argv[1:])
if "{pkg}" == "diamond_tpu_torch":
    from diamond_tpu_torch.ops import swipe_device as sd
    print(f"DISPATCHES={{sd.dispatch_count}}", file=sys.stderr)
sys.exit(rc)
"""

# the port with stage 1/2 on the device: forking raises (children must not
# touch the device), and the run reports Stage12Device's dispatch count
_LAUNCH_S12 = """
import multiprocessing
import sys
_get_context = multiprocessing.get_context
def _no_fork(method=None):
    if method == "fork":
        raise RuntimeError("forked while stage 1/2 runs on the device")
    return _get_context(method)
multiprocessing.get_context = _no_fork
from diamond_tpu_torch.cli import main
sys.argv = ["diamond"] + sys.argv[1:]
rc = main(sys.argv[1:])
from diamond_tpu_torch.ops import stage12_device as d1
print(f"S12_DISPATCHES={d1.dispatch_count}", file=sys.stderr)
sys.exit(rc)
"""


def _run(pkg, args, tmp_path, stage12=False):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DIAMOND_TPU_TORCH_STAGE12", None)
    env.pop("DIAMOND_TPU_STAGE12", None)
    if pkg == "diamond_tpu_torch":
        # one torch thread: the plain versions' tiny ops crawl when the
        # suite's parallel workers oversubscribe the cores
        env.update(DIAMOND_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
        env.pop("DIAMOND_TPU_TORCH_DEVICE_DP", None)
    else:
        env.update(JAX_PLATFORMS="cpu", DIAMOND_TPU_DEVICE_DP="0")
    launch = _LAUNCH.format(pkg=pkg)
    if stage12:
        env["DIAMOND_TPU_TORCH_STAGE12" if pkg == "diamond_tpu_torch"
            else "DIAMOND_TPU_STAGE12"] = "1"
        if pkg == "diamond_tpu_torch":
            launch = _LAUNCH_S12
    r = subprocess.run([sys.executable, "-c", launch, *args],
                       capture_output=True, env=env, timeout=600,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout, r.stderr.decode()


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """~300 sequences from chip_smoke.py's generator (a query subset of 60
    against all of them)."""
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import make_proteins, write_fasta
    finally:
        sys.path.remove(REPO)
    d = tmp_path_factory.mktemp("syn")
    recs = make_proteins(n_seqs=300, n_families=75, seed=5)
    write_fasta(d / "db.faa", recs)
    write_fasta(d / "q.faa", recs[:60])
    return str(d / "q.faa"), str(d / "db.faa")


@pytest.fixture(scope="module")
def j2_db(tmp_path_factory):
    """q2.faa and j2.faa in one database (j2.faa alone against q2.faa
    finds nothing)."""
    path = tmp_path_factory.mktemp("j2") / "q2j2.faa"
    with open(path, "w") as f:
        for name in ("q2.faa", "j2.faa"):
            with open(os.path.join(GOLD, name)) as g:
                f.write(g.read())
    return str(path)


@pytest.fixture(scope="module")
def q2_dmnd(tmp_path_factory):
    """q2.faa as a .dmnd made by the reference's makedb (j2.faa holds an
    empty sequence, which makedb refuses)."""
    d = tmp_path_factory.mktemp("dmnd")
    _run("diamond_tpu", ["makedb", "--in", f"{GOLD}/q2.faa", "-d",
                         str(d / "q2")], d)
    return str(d / "q2.dmnd")


# (input, -f, further options, whether round 1 goes through DeviceDP)
CASES = [pytest.param(inp, fmt, (), True, id=f"{inp}-{fmt}")
         for inp in ("q2-self", "j2-q2", "synthetic")
         for fmt in ("6", "0", "5", "101")]
# formats and options beyond the defaults, on j2.faa against q2 + j2, and
# q2.faa against itself as a .dmnd from the reference's makedb
CASES += [pytest.param("j2-q2", fmt, extra, dp, id=f"j2-q2-{fmt}-{label}")
          for fmt, extra, dp, label in (
              ("103", (), True, "default"), ("104", (), True, "default"),
              ("6", ("--fast",), True, "fast"),
              ("6", ("--sensitive",), True, "sensitive"),
              ("6", ("--ultra-sensitive",), True, "ultra-sensitive"),
              ("6", ("--comp-based-stats", "0"), True, "cbs0"),
              ("6", ("--comp-based-stats", "2"), True, "cbs2"),
              ("6", ("--comp-based-stats", "3"), True, "cbs3"),
              # a matrix adjusted per target: the DP runs on the host, as
              # in the reference
              ("6", ("--comp-based-stats", "4"), False, "cbs4"),
              ("6", ("--masking", "0"), True, "masking0"),
              ("6", ("-k", "1", "--evalue", "1e-5"), True, "k1-evalue"),
              ("6", ("--id", "40", "--query-cover", "50"), True,
               "id-qcover"),
              ("6", ("--max-hsps", "0"), True, "max-hsps0"))]
CASES += [pytest.param("q2-dmnd", fmt, (), True, id=f"q2-dmnd-{fmt}")
          for fmt in ("6", "0")]


@pytest.mark.parametrize("inp,fmt,extra,dp", CASES)
def test_blastp_port_matches_reference(inp, fmt, extra, dp, synthetic, j2_db,
                                       request, tmp_path):
    q, d = {"q2-self": (f"{GOLD}/q2.faa", f"{GOLD}/q2.faa"),
            "j2-q2": (f"{GOLD}/j2.faa", j2_db),
            "synthetic": synthetic}.get(inp) or (
        f"{GOLD}/q2.faa", request.getfixturevalue("q2_dmnd"))
    args = ["blastp", "-q", q, "-d", d, "-f", fmt, *extra]
    port, log = _run("diamond_tpu_torch", args, tmp_path)
    ref, _ = _run("diamond_tpu", args, tmp_path)
    assert port.strip(), "empty output"
    assert port == ref
    dispatches = int(log.rsplit("DISPATCHES=", 1)[1].split()[0])
    assert dispatches > 0 if dp else dispatches == 0


# stage 1/2 on the device: both inputs at three sensitivities, and -p 4
S12_CASES = [pytest.param(inp, extra, id=f"{inp}-{label}")
             for inp in ("j2-q2", "synthetic")
             for extra, label in (((), "default"), (("--faster",), "faster"),
                                  (("--sensitive",), "sensitive"))]
S12_CASES += [pytest.param("synthetic", ("-p", "4"), id="synthetic-p4")]


@pytest.mark.parametrize("inp,extra", S12_CASES)
def test_blastp_stage12_on_device_matches_reference_and_host(
        inp, extra, synthetic, j2_db, tmp_path):
    """DIAMOND_TPU_TORCH_STAGE12=1 (the port, CPU) == DIAMOND_TPU_STAGE12=1
    (diamond_tpu) == the port's host route, byte for byte; the port's run
    dispatched stage 1/2 to Stage12Device and did not fork.  (Neither
    CLI passes -p on to SearchConfig.threads, so -p 4 forks nothing in
    either package; tests/test_torch_stage12.py drives the fork guard
    through Pipeline with 4 threads.)"""
    q, d = {"j2-q2": (f"{GOLD}/j2.faa", j2_db), "synthetic": synthetic}[inp]
    args = ["blastp", "-q", q, "-d", d, "-f", "6", *extra]
    port, log = _run("diamond_tpu_torch", args, tmp_path, stage12=True)
    ref, _ = _run("diamond_tpu", args, tmp_path, stage12=True)
    host, _ = _run("diamond_tpu_torch", args, tmp_path)
    assert port.strip(), "empty output"
    assert port == ref
    assert port == host
    assert int(log.rsplit("S12_DISPATCHES=", 1)[1].split()[0]) > 0
