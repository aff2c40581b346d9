"""``--custom-matrix`` of the port byte for byte against diamond_tpu's CLI.

A custom matrix's gapped Gumbel parameters come from the exact ALP
evaluer (stats/alp_exact.py), about a minute of host code for a 20 x 20
matrix, cached per (file, penalties, seed) under
``$TMPDIR/diamond_tpu_alp_<uid>/``: a directory name both packages share.
Each CLI therefore runs with an empty TMPDIR of its own, so a pass proves
the port computed its own parameters rather than reading the reference's;
the two run at once.  This file holds the ALP run alone, so that the
parallel test run (``--dist loadfile``) gives it a worker of its own.
"""
import json
import os
import subprocess

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_cli import GOLD, PORT, cli_argv, cli_env, dispatches  # noqa: E402

REF = "diamond_tpu"
Q2, J2 = os.path.join(GOLD, "q2.faa"), os.path.join(GOLD, "j2.faa")
CUSTOM = os.path.join(GOLD, "custom_blosum62_20x20.txt")
VEC = os.path.join(os.path.dirname(__file__), "..", "tools", "alp_vectors")


def test_custom_matrix_matches_reference_each_computing_its_alp(tmp_path):
    db = tmp_path / "db.faa"
    db.write_text(open(Q2).read() + open(J2).read())
    args = ["blastp", "-q", J2, "-d", str(db), "--custom-matrix", CUSTOM,
            "--gapopen", "11", "--gapextend", "1", "-f", "6"]
    procs = {}
    for pkg in (REF, PORT):
        tmpdir = tmp_path / f"tmp_{pkg}"
        tmpdir.mkdir()
        procs[pkg] = (tmpdir, subprocess.Popen(
            cli_argv(pkg, args), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, cwd=str(tmp_path),
            env=cli_env(pkg, {"TMPDIR": str(tmpdir)})))
    out, caches = {}, {}
    try:
        for pkg, (tmpdir, p) in procs.items():
            o, e = p.communicate(timeout=600)
            assert p.returncode == 0, e.decode()[-2000:]
            out[pkg] = (o, dispatches(e.decode()))
            cached = [os.path.join(r, f) for r, _, fs in os.walk(tmpdir)
                      for f in fs if f.endswith(".json")]
            assert len(cached) == 1, cached  # this process ran its own ALP
            assert os.path.basename(os.path.dirname(cached[0])) == \
                f"diamond_tpu_alp_{os.getuid()}"
            caches[pkg] = json.load(open(cached[0]))
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert out[REF][0].strip()
    assert out[PORT][0] == out[REF][0]
    assert out[PORT][1] > 0  # K1's plain version scored with the matrix
    assert caches[PORT] == caches[REF]


@pytest.mark.parametrize("extra,msg", [
    ([], "Custom scoring matrices require setting the --gapopen and "
         "--gapextend options."),
    (["--gapopen", "11", "--gapextend", "1", "--comp-based-stats", "2"],
     "This mode of composition based stats is not supported with a custom "
     "matrix."),
])
def test_custom_matrix_refusals_match_reference(tmp_path, extra, msg):
    args = ["blastp", "-q", J2, "-d", Q2, "--custom-matrix", CUSTOM, *extra]
    got = {}
    for pkg in (REF, PORT):
        r = subprocess.run(cli_argv(pkg, args), capture_output=True,
                           cwd=str(tmp_path), timeout=300,
                           env=cli_env(pkg, {"TMPDIR": str(tmp_path)}))
        err = [ln for ln in r.stderr.decode().splitlines()
               if not ln.startswith(("DISPATCHES=", "Total time"))]
        got[pkg] = (r.returncode, r.stdout, err)
    assert got[PORT] == got[REF]
    assert got[PORT][0] == 1 and got[PORT][2] == [msg]


def test_alp_rng_stream_and_gapless_params():
    """The port's copy against the numbers tests/test_alp_oracle.py pins
    (the reference's njn_random stream with seed 1; LocalMaxStatMatrix's
    gapless a and alpha on BLOSUM62)."""
    from diamond_tpu_torch.stats.alp_exact import _Rand, gapless_a_alpha

    r = _Rand(1)
    assert [r.number() for _ in range(5)] == [
        73902710, 1005518751, 421776705, 756398104, 1668674573]
    v = [r.ran2() for _ in range(3)]
    assert v[0] == pytest.approx(0.43868380619151692, abs=0, rel=1e-15)
    assert v[1] == pytest.approx(0.11401660140325157, abs=0, rel=1e-15)
    M = np.loadtxt(os.path.join(VEC, "blosum62.txt"), dtype=np.int64)
    bg = np.loadtxt(os.path.join(VEC, "bg.txt"))
    bgn = bg / bg.sum()
    a, alpha = gapless_a_alpha(M, list(bgn), list(bgn))
    assert a == pytest.approx(0.76221604082034389, rel=1e-12)
    assert alpha == pytest.approx(4.5270357589121266, rel=1e-12)
