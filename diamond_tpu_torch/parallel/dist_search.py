"""Full blastp search split across torch.distributed processes.

The counterpart of ``diamond_tpu/parallel/dist_search.py`` (reference
src/run/double_indexed.cpp:346-430 with the N=1 == N=k output contract of
src/output/join_blocks.cpp): the target set is split into one letter-capped
block per process, every process runs the complete pipeline (masking,
seeding, stage 1/2, extension; its DP on the resolved device) on its block
with global database statistics, the per-block match sets are exchanged as
``match_codec`` rows (the reference's IntermediateRecord streams) by an
all_gather of byte tensors, and every process joins them exactly as the
single-process blocked driver does, so the output equals one process's
``blastp -b <the same cap>``.

    python -m diamond_tpu_torch.parallel.dist_search PID NPROC PORT \\
        [N_QUERIES N_TARGETS]

The proteins are ``chip_smoke.make_proteins``' seeded set of N_TARGETS
sequences (default 1,000), the queries its first N_QUERIES (default 200).
Each process prints its line count and the output's sha.
"""
import sys


def _gather_bytes(payload: bytes):
    """All-gather variable-length byte strings across the process group
    (lengths first, then the payloads padded to the longest)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    world = dist.get_world_size()
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(x.item()) for x in lens]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    buf[:len(payload)] = torch.from_numpy(
        np.frombuffer(payload, dtype=np.uint8).copy())
    buf = buf.to(dev)
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return [parts[p][:lens[p]].cpu().numpy().tobytes() for p in range(world)]


def _data(n_queries: int, n_targets: int):
    from diamond_tpu_torch.parallel.dist_worker import synthetic_proteins

    recs = synthetic_proteins(n_targets, seed=0)
    t_ids = [i for i, _ in recs]
    t_seqs = [s for _, s in recs]
    return t_ids[:n_queries], t_seqs[:n_queries], t_ids, t_seqs


def block_size_gb(t_seqs, nproc: int) -> float:
    """One process's target block as ``blastp -b`` reads it: its letters
    (an nproc-th of the set, rounded up) in billions, to 9 decimals."""
    return float(f"{(sum(len(s) for s in t_seqs) // nproc + 1) / 1e9:.9f}")


def _render(joined, q_seqs, q_ids, t_seqs, t_ids):
    import hashlib

    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.output.tabular import format_results

    qb = Block.from_sequences(q_seqs, q_ids)
    tb_all = Block.from_sequences(t_seqs, t_ids)
    results = {qid: [type(m)(target_block_id=goid, hsp=m.hsp,
                             filter_evalue=m.filter_evalue,
                             filter_score=m.filter_score)
                     for goid, m in items]
               for qid, items in joined.items()}
    lines = list(format_results(results, qb, tb_all))
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16], lines


def run_worker(pid: int, nproc: int, port: str, n_queries: int = 200,
               n_targets: int = 1000) -> str:
    from diamond_tpu_torch.utils.device import init_distributed

    if not init_distributed(f"127.0.0.1:{port}", nproc, pid):
        raise RuntimeError("no process group formed")
    import torch.distributed as dist

    if dist.get_world_size() != nproc:
        raise RuntimeError(f"world of {dist.get_world_size()}, not {nproc}")

    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.parallel.match_codec import decode, encode
    from diamond_tpu_torch.search.blocked import _join, _run_combo, split_blocks
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    q_ids, q_seqs, t_ids, t_seqs = _data(n_queries, n_targets)
    total_letters = sum(len(s) for s in t_seqs)
    # one letter-capped target block per process (the single-process
    # blocked driver's boundary rule, so the chunking is identical)
    t_blocks, t_bases = split_blocks(
        t_seqs, t_ids, int(block_size_gb(t_seqs, nproc) * 1e9))
    if len(t_blocks) != nproc:
        raise RuntimeError(f"{len(t_blocks)} target blocks for {nproc} "
                           f"processes")
    cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"), sensitivity="default")
    cfg.matrix.set_db_letters(total_letters)
    qb = Block.from_sequences(q_seqs, q_ids)
    res = _run_combo(cfg, qb, t_blocks[pid], total_letters)
    local = {qid: [(t_bases[pid] + m.target_block_id, m) for m in matches]
             for qid, matches in res.items()}
    merged: dict[int, list] = {}
    for blob in _gather_bytes(encode(local)):
        for gqid, items in decode(blob).items():
            merged.setdefault(gqid, []).extend(items)
    sha, lines = _render(_join(cfg, merged), q_seqs, q_ids, t_seqs, t_ids)
    print(f"dist search {pid}/{nproc} OK ({dist.get_backend()}): "
          f"{len(lines)} lines sha {sha}", flush=True)
    dist.destroy_process_group()
    return sha


def single_process_reference(n_queries: int = 200, n_targets: int = 1000,
                             nproc: int = 2):
    """The N=1 side of the contract: the blocked driver over the same
    blocks in one process; (sha, lines)."""
    from diamond_tpu_torch.search.blocked import blocked_search
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    q_ids, q_seqs, t_ids, t_seqs = _data(n_queries, n_targets)
    cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"), sensitivity="default")
    joined = blocked_search(cfg, q_seqs, q_ids, t_seqs, t_ids,
                            block_size_gb(t_seqs, nproc))
    return _render(joined, q_seqs, q_ids, t_seqs, t_ids)


def spawn(nproc: int = 2, n_queries: int = 200, n_targets: int = 1000,
          env=None, timeout_s: float = 120.0):
    """nproc full-search processes on localhost; their standard outputs."""
    from diamond_tpu_torch.parallel.dist_worker import free_port, run_all

    port = str(free_port())
    return run_all([[sys.executable, "-m",
                     "diamond_tpu_torch.parallel.dist_search", str(i),
                     str(nproc), port, str(n_queries), str(n_targets)]
                    for i in range(nproc)], env=env, timeout_s=timeout_s)


def main(argv) -> None:
    pid, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    sizes = [int(x) for x in argv[3:5]]
    run_worker(pid, nproc, port, *sizes)


if __name__ == "__main__":
    main(sys.argv[1:])
