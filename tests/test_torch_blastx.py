"""End to end: ``blastx`` (six-frame, ``-F 15``, ``--long-reads``, ``--swipe``)
and ``blastp --swipe`` of the port (diamond_tpu_torch) byte for byte against
diamond_tpu's, in subprocesses.

The port runs on the CPU, where its ``-F`` and ``--swipe`` routes go through
the plain versions of the 3-frame kernel and the full-matrix sweep and must
make dispatches (the 3-frame round fewer than one per read: a block's reads
share its launches); diamond_tpu runs its host DP under JAX on the CPU.  Inputs
are small synthetic read sets from chip_smoke.make_reads (FASTQ for the
six-frame case) against chip_smoke.make_proteins(n_seqs=300).
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs a package's cli.main with argv[0] = "diamond"; the port's run reports
# the 3-frame and full-sweep dispatch counts on stderr
_LAUNCH = """
import sys
from {pkg}.cli import main
sys.argv = ["diamond"] + sys.argv[1:]
rc = main(sys.argv[1:])
if "{pkg}" == "diamond_tpu_torch":
    from diamond_tpu_torch.ops import swipe3_device as s3, swipe_device as sd
    print(f"K3={{s3.dispatch_count}} SWEEP={{sd.dispatch_count}}",
          file=sys.stderr)
sys.exit(rc)
"""


def _run(pkg, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    if pkg == "diamond_tpu_torch":
        # one torch thread: the plain versions' tiny ops crawl when the
        # suite's parallel workers oversubscribe the cores
        env.update(DIAMOND_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
        env.pop("DIAMOND_TPU_TORCH_DEVICE_DP", None)
    else:
        env.update(JAX_PLATFORMS="cpu", DIAMOND_TPU_DEVICE_DP="0")
    r = subprocess.run([sys.executable, "-c", _LAUNCH.format(pkg=pkg), *args],
                       capture_output=True, env=env, timeout=600,
                       cwd=str(cwd))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout, r.stderr.decode()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import (make_proteins, make_reads, write_fasta,
                                write_fastq)
    finally:
        sys.path.remove(REPO)
    d = tmp_path_factory.mktemp("bx")
    prots = make_proteins(n_seqs=300, n_families=75, seed=5)
    write_fasta(d / "db.faa", prots)
    write_fasta(d / "q8.faa", prots[:8])
    write_fastq(d / "short.fq", make_reads(prots, 24, 300, 1200, seed=2))
    write_fasta(d / "short4.fna", make_reads(prots, 4, 300, 600, seed=3))
    write_fasta(d / "long.fna", make_reads(prots, N_LONG, 2000, 4000,
                                           indels_per_kb=1.0, seed=1))
    return d


N_LONG = 6  # reads of long.fna

# case -> (argv, the dispatch count that must be > 0, second format); the
# reference's pairwise writer (-f 0) fails on translated queries, so the
# blastx cases take SAM (-f 101, the reference's blastx SAM) instead
CASES = {
    "blastx": (["blastx", "-q", "short.fq"], None, "101"),
    # -k 2: the score-only 3-frame round runs only when a read has more
    # targets than -k (or with --top)
    "blastx-F15": (["blastx", "-q", "long.fna", "-F", "15", "-k", "2"], "K3",
                   "101"),
    "blastx-long-reads": (["blastx", "-q", "long.fna", "--long-reads"], "K3",
                          "101"),
    "blastx-swipe": (["blastx", "-q", "short4.fna", "--swipe"], None, "101"),
    "blastp-swipe": (["blastp", "-q", "q8.faa", "--swipe"], "SWEEP", "0"),
}


@pytest.mark.parametrize("case,fmt", [(c, f) for c in CASES
                                      for f in ("6", CASES[c][2])])
def test_port_matches_reference(case, fmt, inputs):
    argv, kernel, _ = CASES[case]
    args = argv + ["-d", "db.faa", "-f", fmt]
    port, log = _run("diamond_tpu_torch", args, inputs)
    ref, _ = _run("diamond_tpu", args, inputs)
    assert port.strip(), "empty output"
    assert port == ref
    counts = dict(kv.split("=") for kv in log.strip().splitlines()[-1].split())
    if kernel:
        assert int(counts[kernel]) > 0, counts
    if kernel == "K3":  # the block's reads share launches (one per class)
        assert int(counts[kernel]) < N_LONG, counts


def test_blastx_pairwise_fails_as_reference(inputs):
    """blastx -f 0: the reference's pairwise writer indexes the translated
    context with source coordinates and raises; the port's copy does the
    same (ROADMAP.md section 3), rather than print something else."""
    args = ["blastx", "-q", "short.fq", "-d", "db.faa", "-f", "0"]
    last = []
    for pkg in ("diamond_tpu_torch", "diamond_tpu"):
        env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu",
                   JAX_PLATFORMS="cpu", DIAMOND_TPU_DEVICE_DP="0")
        r = subprocess.run([sys.executable, "-m", f"{pkg}.cli", *args],
                           capture_output=True, text=True, env=env,
                           timeout=600, cwd=str(inputs))
        assert r.returncode != 0
        last.append(r.stderr.strip().splitlines()[-1])
    assert last[0] == last[1] and last[0].startswith("IndexError")
