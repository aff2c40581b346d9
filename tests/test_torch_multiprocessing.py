"""``--multiprocessing`` of the port against diamond_tpu's, and the host
modules under it (parallel/mp.py, parallel/match_codec.py,
utils/external_sort.py).

Blocked blastp: ``--mp-init``, then two port workers at once on one
``--parallel-tmpdir`` (each a process of its own that resolves its device),
must print what one reference worker prints, and what the port's
single-process blocked search prints; a worker that dies holding a combo
is finished by ``--mp-recover``.  ``cluster --multiprocessing`` with two
port workers must write the reference's clustering.
"""
import os
import pickle
import subprocess

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_threads import one_torch_thread  # noqa: E402,F401
from torch_cli import (PORT, cli_argv, cli_env, dispatches,  # noqa: E402
                       run_cli, synthetic_set)

BLOCK = "0.000005"  # 5,000 letters: 2 query blocks x 5 target blocks


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp")
    synthetic_set(str(d))
    return {"q": str(d / "q.faa"), "db": str(d / "db.faa")}


def _workers(pkg, args, cwd, n, extra_env=None):
    """n CLI processes at once; [(returncode, stdout, stderr)]."""
    procs = [subprocess.Popen(cli_argv(pkg, args), cwd=str(cwd),
                              env=cli_env(pkg, extra_env),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(n)]
    out = []
    for p in procs:
        o, e = p.communicate(timeout=600)
        out.append((p.returncode, o, e.decode()))
    return out


def _blastp(data, *extra):
    return ["blastp", "-q", data["q"], "-d", data["db"], "-b", BLOCK, *extra]


@pytest.fixture(scope="module")
def reference_mp(data, tmp_path_factory):
    """One reference worker after --mp-init: the output to match."""
    d = tmp_path_factory.mktemp("ref_mp")
    tmpdir = str(d / "work")
    run_cli("diamond_tpu", _blastp(data, "--mp-init", "--parallel-tmpdir",
                                   tmpdir), d)
    _, out, _, _ = run_cli("diamond_tpu", _blastp(
        data, "--multiprocessing", "--parallel-tmpdir", tmpdir), d)
    assert out
    return out


def test_two_port_workers_equal_reference(data, reference_mp, tmp_path):
    tmpdir = str(tmp_path / "work")
    _, out, _, _ = run_cli(PORT, _blastp(data, "--mp-init",
                                         "--parallel-tmpdir", tmpdir),
                           tmp_path)
    assert out == b""
    assert len(os.listdir(tmpdir)) >= 2  # the TODO stack and the shape
    runs = _workers(PORT, _blastp(data, "--multiprocessing",
                                  "--parallel-tmpdir", tmpdir), tmp_path, 2)
    for rc, _, err in runs:
        assert rc == 0, err[-2000:]
    # the worker that checkpoints the last combo prints the join (both
    # may, if they finish together)
    printed = [o for _, o, _ in runs if o]
    assert printed and all(o == reference_mp for o in printed)
    assert sum(dispatches(e) for _, _, e in runs) > 0
    combos = [f for f in os.listdir(tmpdir) if f.startswith("combo_")]
    assert len(combos) == 2 * 5
    # one process of the port's blocked search prints the same
    _, one, _, _ = run_cli(PORT, _blastp(data), tmp_path)
    assert one == reference_mp


def test_mp_recover_finishes_a_dead_workers_combo(data, reference_mp,
                                                  tmp_path):
    tmpdir = str(tmp_path / "work")
    run_cli(PORT, _blastp(data, "--mp-init", "--parallel-tmpdir", tmpdir),
            tmp_path)
    args = _blastp(data, "--multiprocessing", "--parallel-tmpdir", tmpdir)
    rc, _, _, _ = run_cli(PORT, args, tmp_path, check=False,
                          extra_env={"DIAMOND_TPU_MP_DIE_ON_CLAIM": "2"})
    assert rc == 17  # died holding its second claim
    with open(os.path.join(tmpdir, "wip.stack")) as f:
        assert f.read().strip()
    _, out, _, _ = run_cli(PORT, args + ["--mp-recover"], tmp_path)
    assert out == reference_mp


def test_cluster_two_port_workers_equal_reference(data, tmp_path):
    def args(tag):
        return ["cluster", "-d", data["db"], "-o",
                str(tmp_path / f"{tag}.tsv"), "--multiprocessing",
                "--parallel-tmpdir",
                str(tmp_path / f"work_{tag}"), "-b", "0.00002"]

    run_cli("diamond_tpu", args("ref"), tmp_path)
    runs = _workers(PORT, args("port"), tmp_path, 2)
    for rc, _, err in runs:
        assert rc == 0, err[-2000:]
    want = (tmp_path / "ref.tsv").read_bytes()
    assert len(want.splitlines()) == 60  # one line per input record
    assert (tmp_path / "port.tsv").read_bytes() == want
    assert sum(dispatches(e) for _, _, e in runs) > 0


def test_filestack_and_counter_match_reference(tmp_path):
    from diamond_tpu.parallel import mp as ref
    from diamond_tpu_torch.parallel import mp as port

    for mod, tag in ((ref, "ref"), (port, "port")):
        st = mod.FileStack(str(tmp_path / f"{tag}.stack"))
        st.push("a")
        st.push("b")
        assert st.pop() == "b"
        st.push("c")
        assert sorted(st.lines()) == ["a", "c"]
        assert st.remove("a") and not st.remove("a")
        assert st.pop() == "c" and st.pop() is None
        c = mod.AtomicCounter(str(tmp_path / f"{tag}.count"))
        assert (c.fetch_add(), c.fetch_add(5), c.get()) == (0, 1, 6)
    for name in ("stack", "count"):
        assert (tmp_path / f"ref.{name}").read_bytes() == \
            (tmp_path / f"port.{name}").read_bytes()


def test_mp_init_and_recover_match_reference(tmp_path):
    from diamond_tpu.parallel import mp as ref
    from diamond_tpu_torch.parallel import mp as port

    for mod, tag in ((ref, "ref"), (port, "port")):
        d = str(tmp_path / tag)
        mod.mp_init(d, 2, 3)
        wip = mod.FileStack(os.path.join(d, "wip.stack"))
        todo = mod.FileStack(os.path.join(d, "todo.stack"))
        for line in ("0 1", "1 2"):
            wip.push(line)
            todo.remove(line)
        with open(os.path.join(d, "combo_1_2.pkl"), "wb") as f:
            pickle.dump({}, f)
        assert mod.mp_recover(d) == 1  # only the unsaved combo requeued
        assert not mod.mp_done(d)
    for name in ("todo.stack", "wip.stack", "shape.txt"):
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()


@pytest.mark.parametrize("cap", [1 << 30, 1024])  # in memory; spilled runs
def test_sort_edges_matches_reference(cap, tmp_path):
    from diamond_tpu.utils import external_sort as ref
    from diamond_tpu_torch.utils import external_sort as port

    rng = np.random.default_rng(11)
    edges = [(int(a), int(b), float(w)) for a, b, w in zip(
        rng.integers(0, 500, 20_000), rng.integers(0, 500, 20_000),
        rng.integers(1, 400, 20_000))]
    xs = port.ExternalSorter(port.EDGE_DTYPE, mem_cap_bytes=cap,
                             tmpdir=str(tmp_path))
    for lo in range(0, len(edges), 3000):
        xs.push(np.array(edges[lo:lo + 3000], dtype=port.EDGE_DTYPE))
    assert (xs.spilled_runs > 0) == (cap == 1024)
    got = np.concatenate(list(xs.sorted_chunks()))
    want = np.sort(np.array(edges, dtype=ref.EDGE_DTYPE), kind="stable")
    assert got.tobytes() == want.tobytes()
    a = ref.sort_edges(list(edges), mem_cap_bytes=cap, tmpdir=str(tmp_path))
    b = port.sort_edges(list(edges), mem_cap_bytes=cap, tmpdir=str(tmp_path))
    assert np.concatenate(list(a)).tobytes() == \
        np.concatenate(list(b)).tobytes()


def test_match_codec_round_trip_matches_reference(data, monkeypatch):
    """The port's blocked search encodes to the reference's bytes for the
    same search, and decodes back to the same output lines."""
    from diamond_tpu.parallel import match_codec as ref_codec
    from diamond_tpu.search.blocked import blocked_search as ref_search
    from diamond_tpu.search.config import SearchConfig as RefConfig
    from diamond_tpu.stats.score_matrix import ScoreMatrix as RefMatrix
    from diamond_tpu_torch.data.fasta import read_seqs
    from diamond_tpu_torch.output.tabular import (DEFAULT_FIELDS,
                                                  format_match_line)
    from diamond_tpu_torch.parallel import match_codec as codec
    from diamond_tpu_torch.search.blocked import blocked_search
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DIAMOND_TPU_DEVICE_DP", "0")

    def seqs(path):
        recs = list(read_seqs(path))
        return [r[1].upper() for r in recs], [r[0] for r in recs]

    (qs, qi), (ts, ti) = seqs(data["q"]), seqs(data["db"])
    res = blocked_search(SearchConfig(matrix=ScoreMatrix("BLOSUM62")),
                         qs, qi, ts, ti, float(BLOCK))
    want = ref_search(RefConfig(matrix=RefMatrix("BLOSUM62")),
                      qs, qi, ts, ti, float(BLOCK))
    assert sum(len(v) for v in res.values()) > 20
    blob = codec.encode(res)
    assert blob == ref_codec.encode(want)

    def lines(r):
        return [format_match_line(str(q), str(t), h, DEFAULT_FIELDS)
                for q in sorted(r) for t, m in r[q] for h in m.hsp]

    back = codec.decode(blob)
    assert lines(back) == lines(res)
    assert codec.encode(back) == blob
