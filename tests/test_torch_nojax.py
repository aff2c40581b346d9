"""The port imports neither jax nor diamond_tpu, and never hides the device.

A subprocess imports every module of diamond_tpu_torch (and chip_smoke.py),
runs a tiny blastp on the CPU, also blocked (``-b``), with ``--iterate``,
``--masking seg``, ``--target-indexed`` after ``makeidx`` and ``--mesh 2``,
and ``cluster``, ``blastn`` and a tool command, and checks sys.modules
(``--custom-matrix`` stays out for its minute of ALP: the static scan
covers stats/alp_exact.py); a static scan checks the sources; the CLI
without a card, and without a request for the CPU, must exit non-zero
saying so; the options that once named a ROADMAP item all run.
"""
import os
import re
import shutil
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
# the search drivers and a cluster cascade load no jax either
main(["blastp", "-q", {q2!r}, "-d", {q2!r}, "-b", "0.0000005",
      "-o", {out!r} + ".b"])
main(["blastp", "-q", {q2!r}, "-d", {q2!r}, "--iterate", "-o", {out!r} + ".i"])
main(["cluster", "-d", {q2!r}, "-o", {out!r} + ".c"])
# the last modules ported: seg, the seed index, the mesh, blastn, a tool
main(["blastp", "-q", {q2!r}, "-d", {q2!r}, "--masking", "seg",
      "-o", {out!r} + ".seg"])
main(["makeidx", "-d", {db!r}])
main(["blastp", "-q", {q2!r}, "-d", {db!r}, "--target-indexed",
      "-o", {out!r} + ".ti"])
main(["blastp", "-q", {q2!r}, "-d", {q2!r}, "--mesh", "2",
      "-o", {out!r} + ".m"])
main(["blastn", "-q", {dna!r}, "-d", {dna!r}, "-o", {out!r} + ".n"])
main(["reverse", "-q", {q2!r}, "-o", {out!r} + ".r"])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "diamond_tpu" or m.startswith("diamond_tpu."))
print("BAD=" + ",".join(bad))
"""


def _is_reference(mod):
    return mod == "diamond_tpu" or mod.startswith("diamond_tpu.")


def test_port_process_loads_no_jax(tmp_path):
    out = tmp_path / "o.tsv"
    db = tmp_path / "db.faa"
    shutil.copy(Q2, db)
    dna = tmp_path / "dna.fna"
    dna.write_text(">a\nACGTTGCAGGCATTACGATTACGGCATGCAAGTCCGTAGGCTAGCTAGG"
                   "ATCCATGCAACGTTGCAGGCATTACG\n")
    env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu")
    r = subprocess.run([sys.executable, "-c",
                        _PROBE.format(repo=REPO, q2=Q2, out=str(out),
                                      db=str(db), dna=str(dna))],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD=\n" in r.stdout, r.stdout
    assert len(out.read_text().splitlines()) == 4
    for ext in (".b", ".i", ".ti", ".m"):
        assert (tmp_path / f"o.tsv{ext}").read_text() == out.read_text()
    assert len((tmp_path / "o.tsv.c").read_text().splitlines()) == 4
    assert len((tmp_path / "o.tsv.seg").read_text().splitlines()) >= 4
    assert (tmp_path / "o.tsv.n").read_text().startswith("a\ta\t100")
    reverse = (tmp_path / "o.tsv.r").read_text().splitlines()
    assert sum(ln.startswith(">") for ln in reverse) == 4


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


def test_cli_runs_the_options_once_refused(tmp_path):
    """Each option set the port once refused runs on the CPU and writes
    output; --custom-matrix (whose full run is tests/test_torch_custom_
    matrix.py's) gives the two refusals the reference keeps."""
    from diamond_tpu_torch.parallel.dist_worker import free_port, run_all

    env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    shutil.copy(Q2, tmp_path / "db.faa")
    cli = [sys.executable, "-m", "diamond_tpu_torch.cli"]
    search = cli + ["blastp", "-q", Q2, "-d", "db.faa"]

    def run(argv, ok=True):
        r = subprocess.run(argv, capture_output=True, text=True, env=env,
                           timeout=300, cwd=str(tmp_path))
        assert (r.returncode == 0) == ok, (argv, r.stderr[-2000:])
        return r

    assert run(cli + ["makeidx", "-d", "db.faa"]).stdout
    for extra in (["--target-indexed"], ["--mesh", "2"], ["--masking", "seg"],
                  ["-b", "1", "--mesh", "2"]):
        assert len(run(search + extra).stdout.splitlines()) >= 4, extra
    port = free_port()
    outs = run_all([search + ["--coordinator", f"127.0.0.1:{port}",
                              "--num-procs", "2", "--proc-id", str(i)]
                    for i in range(2)], env=env, timeout_s=120,
                   cwd=str(tmp_path))
    for i, o in enumerate(outs):
        assert f"rank {i} of 2 joined over gloo" in o
        assert o.count("\t") >= 4 * 11
    for extra, msg in ((["--custom-matrix", Q2], "require setting the "
                         "--gapopen and --gapextend"),
                       (["--custom-matrix", Q2, "--gapopen", "11",
                         "--gapextend", "1", "--comp-based-stats", "2"],
                        "not supported with a custom matrix")):
        r = run(search + extra, ok=False)
        assert msg in r.stderr and "ROADMAP" not in r.stderr
