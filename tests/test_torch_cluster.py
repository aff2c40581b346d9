"""The clustering commands of the port (``cluster``, ``deepclust``,
``linclust``, ``cluster --cluster-algo mcl``, ``realign``,
``greedy-vertex-cover``) byte for byte against diamond_tpu's CLI, in
subprocesses; MCL's dense step (D3) against the reference's; and the fork
guard of the cascade's searches.

Every cluster round is a Pipeline on the resolved device: on the CPU the
port scores its extension rounds with DeviceDP's plain version and must make
DeviceDP dispatches.  ``mcl_cluster`` runs components of 128 nodes and more
through jax on the reference's side and through the torch step on the
port's.
"""
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference (absent on a card host)

from torch_threads import one_torch_thread  # noqa: E402,F401
from torch_cli import (PORT, REPO, cli_env, run_cli,  # noqa: E402
                       synthetic_set)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The synthetic set (60 proteins; its first 20 for the slower
    linclust and deepclust), the reference's clustering of it, and a seeded
    edge list over its ids for greedy-vertex-cover."""
    d = tmp_path_factory.mktemp("cluster")
    recs = synthetic_set(str(d))
    db = str(d / "db.faa")
    _, out, _, _ = run_cli("diamond_tpu", ["cluster", "-d", db], d)
    (d / "clusters.tsv").write_bytes(out)
    ids = [r[0].split()[0] for r in recs]
    (d / "ids.txt").write_text("".join(f"{i}\tx\n" for i in ids))
    rng = np.random.default_rng(4)
    rows, trip = [], []
    for _ in range(300):
        a, b = rng.integers(0, len(ids), 2)
        qc, tc, w = rng.integers(40, 101, 2).tolist() + [
            int(rng.integers(30, 500))]
        rows.append(f"{ids[a]}\t{ids[b]}\t{qc}\t{tc}\t{w}\n")
        trip.append(f"{ids[a]}\t{ids[b]}\t{w}\n")
    (d / "edges.tsv").write_text("".join(rows))
    (d / "triplets.tsv").write_text("".join(trip))
    return {"db": db, "q": str(d / "q.faa"),
            "clusters": str(d / "clusters.tsv"),
            "ids": str(d / "ids.txt"), "edges": str(d / "edges.tsv"),
            "triplets": str(d / "triplets.tsv")}


# name -> (argv with {db}/{clusters}/... filled from the fixture, files the
# command writes, whether DeviceDP scores); linclust, realign and
# greedy-vertex-cover run host code only, as in the reference
CASES = {
    "cluster": (["cluster", "-d", "{db}", "-o", "c.tsv", "--reps", "r.faa"],
                ["c.tsv", "r.faa"], True),
    "deepclust": (["deepclust", "-d", "{q}"], [], True),
    "cluster-approx-id": (["cluster", "-d", "{db}", "--approx-id", "60",
                           "--member-cover", "50"], [], True),
    "linclust": (["linclust", "-d", "{q}"], [], False),
    "mcl": (["cluster", "-d", "{db}", "--cluster-algo", "mcl"], [], True),
    "realign": (["realign", "-d", "{db}", "--clusters", "{clusters}"], [],
                False),
    "gvc": (["greedy-vertex-cover", "-d", "{ids}", "--edges", "{edges}",
             "--centroid-out", "cent.txt"], ["cent.txt"], False),
    "gvc-triplet": (["greedy-vertex-cover", "-d", "{ids}", "--edges",
                     "{triplets}", "--edge-format", "triplet",
                     "--symmetric"], [], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_port_matches_reference(case, data, tmp_path):
    argv, files, dp = CASES[case]
    args = [a.format(**data) for a in argv]
    got = {}
    for pkg in ("diamond_tpu", PORT):
        d = tmp_path / pkg
        d.mkdir()
        _, out, err, n = run_cli(pkg, args, d)
        got[pkg] = (out, [(d / f).read_bytes() for f in files],
                    [ln for ln in err.splitlines() if ln.startswith("#")])
    assert got[PORT] == got["diamond_tpu"]
    out, written, _ = got[PORT]
    assert out or all(written), case  # a non-empty comparison
    assert (n > 0) == dp, f"DeviceDP dispatches {n}"


def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.mark.parametrize("seed,sizes", [(1, (130,)), (2, (200, 60)),
                                        (3, (300, 150, 5))])
def test_mcl_cluster_matches_reference(seed, sizes, monkeypatch):
    """Components of 128 nodes and more take the dense device step: jax in
    the reference, torch (the CPU asked for) in the port."""
    from diamond_tpu.cluster import mcl as ref
    from diamond_tpu_torch.cluster import mcl as port

    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    n, edges = _smoke().mcl_graph(seed, sizes)
    calls = []
    step = port.mcl_dense_torch
    monkeypatch.setattr(port, "mcl_dense_torch",
                        lambda M, *a: calls.append(len(M)) or step(M, *a))
    want = ref.mcl_cluster(n, edges)
    got = port.mcl_cluster(n, edges)
    assert sorted(calls) == sorted(s for s in sizes if s >= 128)
    assert np.array_equal(got, want)
    assert len(np.unique(got)) > len(sizes)  # the families split


def test_mcl_dense_step_matches_numpy_loop():
    """The torch step on the CPU against the reference's numpy loop on one
    column-stochastic matrix: equal attractors, matrices within 1e-5."""
    from diamond_tpu.cluster.mcl import _clusters_from_matrix
    from diamond_tpu.cluster.mcl import _mcl_dense as ref_dense
    from diamond_tpu_torch.cluster.mcl import mcl_dense_torch

    smoke = _smoke()
    M = smoke.mcl_matrix(*smoke.mcl_graph(7, (256,)))
    want = ref_dense(M.copy(), 2, 2.0, 100, use_jax=False)
    got = mcl_dense_torch(M.copy(), 2, 2.0, 100, "cpu")
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-5
    assert np.array_equal(_clusters_from_matrix(got),
                          _clusters_from_matrix(want))


def test_can_fork_refuses_with_stage12_on_device(monkeypatch):
    from diamond_tpu_torch.search import pipeline

    monkeypatch.delenv("DIAMOND_TPU_TORCH_STAGE12", raising=False)
    assert pipeline._can_fork()
    monkeypatch.setenv("DIAMOND_TPU_TORCH_STAGE12", "1")
    assert not pipeline._can_fork()


# the port's cluster with -p 4: every process forked after the parent has
# started counts itself, and any call into torch.cuda from a forked child
# is reported (the children must run host code only)
_FORK_PROBE = """
import os, sys
import torch
parent = os.getpid()
log = sys.argv[1]
def note(what):
    with open(log, "a") as f:
        f.write(what + "\\n")
os.register_at_fork(after_in_child=lambda: note("child"))
for name in ("is_available", "device_count", "current_device", "init",
             "_lazy_init", "synchronize", "get_device_name"):
    fn = getattr(torch.cuda, name)
    def spy(*a, _fn=fn, _name=name, **kw):
        if os.getpid() != parent:
            note("cuda " + _name)
        return _fn(*a, **kw)
    setattr(torch.cuda, name, spy)
from diamond_tpu_torch.cli import main
sys.argv = ["diamond"] + sys.argv[2:]
sys.exit(main(sys.argv[1:]))
"""


def test_cluster_forks_touch_no_cuda_state(data, tmp_path):
    """cluster -p 4 forks host stage 1/2 in every round after the first
    round's DeviceDP has run; no child touches torch.cuda, and the output
    equals the reference's."""
    log = tmp_path / "fork.log"
    args = ["cluster", "-d", data["db"], "-p", "4"]
    r = subprocess.run([sys.executable, "-c", _FORK_PROBE, str(log), *args],
                       capture_output=True, env=cli_env(PORT), timeout=600,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    notes = log.read_text().splitlines()
    assert notes.count("child") >= 4, notes
    assert [x for x in notes if x != "child"] == []
    _, want, _, _ = run_cli("diamond_tpu", args, tmp_path)
    assert r.stdout == want
