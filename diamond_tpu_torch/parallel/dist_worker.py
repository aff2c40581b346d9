"""One process of a multi-process (torch.distributed) sharded scoring check.

The counterpart of ``diamond_tpu/parallel/dist_worker.py``: every process
joins one process group (``utils/device.init_distributed``), the mesh holds
one shard per rank, each rank scores its shard of a target block with the
uniform-band kernel (K4; its plain version on the CPU) and the scores cross
the ranks by all_gather.  Every rank checks the gathered scores against the
single-process host DP, so the collectives carry real search traffic, not
just a barrier.

    python -m diamond_tpu_torch.parallel.dist_worker PID NPROC PORT [N_SEQS]

The targets are ``chip_smoke.make_proteins``' seeded set (N_SEQS sequences,
default 4 x NPROC + 3, so the shards need padding); the query is its second
sequence.  ``spawn_workers`` starts NPROC of them on localhost.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def synthetic_proteins(n_seqs: int, seed: int):
    """chip_smoke.make_proteins' seeded set (ids, letters) at n_seqs."""
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import make_proteins
    finally:
        sys.path.remove(REPO)
    return make_proteins(n_seqs=n_seqs, n_families=max(n_seqs // 4, 1),
                         seed=seed)


def main(pid: int, nproc: int, port: str, n_seqs: int | None = None) -> None:
    from diamond_tpu_torch.utils.device import init_distributed

    if not init_distributed(f"127.0.0.1:{port}", nproc, pid):
        raise RuntimeError("no process group formed")
    import numpy as np
    import torch.distributed as dist

    if dist.get_world_size() != nproc:
        raise RuntimeError(f"world of {dist.get_world_size()}, not {nproc}")

    from diamond_tpu_torch.constants.alphabet import encode
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.parallel.sharded import (make_mesh,
                                                    sharded_full_scores)
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    recs = synthetic_proteins(n_seqs or 4 * nproc + 3, seed=9)
    tblock = Block.from_sequences([encode(s) for _, s in recs],
                                  [i for i, _ in recs])
    q = tblock.seq(1)
    mesh = make_mesh()  # one shard per rank
    scores = sharded_full_scores(mesh, q, None, tblock, m.matrix32,
                                 m.gap_open, m.gap_extend)
    jobs = [(tblock.seq(t), -(len(tblock.seq(t)) - 1), len(q))
            for t in range(len(tblock))]
    ref = np.array([s for s, _, _ in banded_swipe_batch_np(
        q, None, jobs, m.matrix32, m.gap_open, m.gap_extend)])
    if not np.array_equal(scores, ref):
        raise RuntimeError(f"sharded scores differ from the host DP: "
                           f"{scores[:8]} against {ref[:8]}")
    print(f"dist worker {pid}/{nproc} OK: {len(ref)} targets sharded over "
          f"{len(mesh)} ranks ({mesh[pid]}, {dist.get_backend()}); K4 "
          f"launches {sud.banded_swipe_uniform_cuda.launches}", flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_all(argvs, env=None, timeout_s: float = 120.0, cwd=None):
    """Start one process per argv at once (in ``cwd``) and wait for all of
    them; the first to fail, or the timeout, kills the others and raises.
    Returns their standard outputs (standard error merged)."""
    import subprocess
    import tempfile
    import time

    logs = [tempfile.TemporaryFile(mode="w+") for _ in argvs]
    procs = [subprocess.Popen(a, env=env, stdout=lg, cwd=cwd,
                              stderr=subprocess.STDOUT, text=True)
             for a, lg in zip(argvs, logs)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll()]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        outs = []
        for p, lg in zip(procs, logs):
            lg.seek(0)
            outs.append(lg.read())
        failed = [(i, p.poll()) for i, p in enumerate(procs)
                  if p.poll() != 0]
        if failed:
            i, rc = failed[0]
            what = "timed out" if rc is None else f"exited {rc}"
            raise RuntimeError(f"process {i} {what}: {outs[i][-2000:]}")
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for lg in logs:
            lg.close()


def spawn_workers(nproc: int = 2, n_seqs: int | None = None, env=None,
                  timeout_s: float = 120.0):
    """nproc dist_worker processes on localhost; their standard outputs."""
    port = str(free_port())
    extra = [] if n_seqs is None else [str(n_seqs)]
    return run_all([[sys.executable, "-m",
                     "diamond_tpu_torch.parallel.dist_worker", str(i),
                     str(nproc), port, *extra] for i in range(nproc)],
                   env=env, timeout_s=timeout_s)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
         int(sys.argv[4]) if len(sys.argv) > 4 else None)
