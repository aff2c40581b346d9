"""Multi-process search of the port over torch.distributed, two ranks over
Gloo on the CPU (the counterpart of tests/test_distributed.py, whose
jax.distributed processes read a database that is not here).

Every child process has a timeout of 120 s and the first to fail kills the
others (``parallel/dist_worker.run_all``), so a rendezvous that hangs fails
one test, not the suite.
"""
import hashlib
import re
import sys

import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_cli import PORT, REPO, cli_argv, cli_env, run_cli  # noqa: E402

REF = "diamond_tpu"
N_QUERIES, N_TARGETS = 20, 60


def _env():
    env = cli_env(PORT)
    env["PYTHONPATH"] = REPO
    return env


def test_two_rank_sharded_scores_equal_the_host_dp():
    from diamond_tpu_torch.parallel.dist_worker import spawn_workers

    outs = spawn_workers(2, env=_env(), timeout_s=120)
    assert all("OK" in o and "over 2 ranks" in o and "gloo" in o
               for o in outs), outs


@pytest.mark.parametrize("nproc", [1, 2])
def test_dist_search_equals_one_process_and_reference(tmp_path, nproc,
                                                      monkeypatch):
    """N = k ranks give the single-process blocked search's output and the
    reference's ``blastp -b`` at the same block size; N = 1 gives it too."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    from diamond_tpu_torch.parallel.dist_search import (_data,
                                                        block_size_gb,
                                                        single_process_reference,
                                                        spawn)

    outs = spawn(nproc, N_QUERIES, N_TARGETS, env=_env(), timeout_s=120)
    shas = {re.search(r"sha (\w+)", o).group(1) for o in outs}
    assert len(shas) == 1, outs
    sha, lines = single_process_reference(N_QUERIES, N_TARGETS, 2)
    assert len(lines) >= N_QUERIES
    assert shas == {sha}
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import write_fasta
    finally:
        sys.path.remove(REPO)
    q_ids, q_seqs, t_ids, t_seqs = _data(N_QUERIES, N_TARGETS)
    write_fasta(tmp_path / "q.faa", list(zip(q_ids, q_seqs)))
    write_fasta(tmp_path / "db.faa", list(zip(t_ids, t_seqs)))
    _, ref, _, _ = run_cli(REF, ["blastp", "-q", "q.faa", "-d", "db.faa",
                                 "-b", f"{block_size_gb(t_seqs, 2):.9f}"],
                           tmp_path)
    assert hashlib.sha256(ref.rstrip(b"\n")).hexdigest()[:16] == sha


@pytest.mark.parametrize("extra", [[], ["--mesh", "2"]])
def test_two_cli_ranks_each_write_one_process_output(tmp_path, extra):
    """blastp with --coordinator/--num-procs 2/--proc-id i: each rank runs
    the search and writes what one process writes (with --mesh 2 the two
    ranks split each DeviceDP batch and all-gather the scores)."""
    from diamond_tpu_torch.parallel.dist_worker import free_port, run_all
    from torch_cli import synthetic_set

    synthetic_set(str(tmp_path))
    args = ["blastp", "-q", "q.faa", "-d", "db.faa"]
    _, one, _, _ = run_cli(PORT, args, tmp_path)
    port = free_port()
    outs = run_all([cli_argv(PORT, args + [
        "--coordinator", f"127.0.0.1:{port}", "--num-procs", "2",
        "--proc-id", str(i), "-o", f"rank{i}.out", *extra])
        for i in range(2)], env=_env(), timeout_s=120, cwd=tmp_path)
    for i, o in enumerate(outs):
        assert f"rank {i} of 2 joined over gloo" in o
        assert int(re.search(r"DISPATCHES=(\d+)", o).group(1)) > 0
        assert (tmp_path / f"rank{i}.out").read_bytes() == one
    assert one.strip()


def test_world_that_cannot_form_raises(tmp_path):
    """A rank whose peers never come raises after the timeout; it does not
    carry on as one process."""
    from diamond_tpu_torch.parallel.dist_worker import free_port, run_all

    env = dict(_env(), DIAMOND_TPU_TORCH_DIST_TIMEOUT="3")
    with pytest.raises(RuntimeError, match="exited"):
        run_all([[sys.executable, "-m", "diamond_tpu_torch.cli", "blastp",
                  "-q", "x.faa", "-d", "x.faa", "--coordinator",
                  f"127.0.0.1:{free_port()}", "--num-procs", "2",
                  "--proc-id", "1"]], env=env, timeout_s=60)
