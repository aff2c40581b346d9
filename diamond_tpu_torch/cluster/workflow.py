"""Cascaded clustering workflows (cluster / linclust / deepclust).

Single-process re-design of the reference cascaded clustering (reference
src/cluster/multinode/multinode.cpp:186-289, cluster/cascaded/helpers.cpp):
rounds of self-search at increasing sensitivity over current representatives,
greedy vertex cover over accepted alignment edges, assignments composed
across rounds.  The multi-node file-based coordination becomes device-mesh
sharding (per-shard search + gathered edge lists); N=1 semantics identical.
"""
from __future__ import annotations

import sys

import numpy as np

from diamond_tpu_torch.cluster.gvc import EdgeGraph, greedy_vertex_cover
from diamond_tpu_torch.data.block import Block


def cluster_steps(approx_id: float, linear: bool):
    """reference cluster/cascaded/helpers.cpp:32-57."""
    v = ["faster_lin"]
    if approx_id < 90:
        v.append("fast_lin")
    if approx_id < 40:
        v.append("linclust-20_lin")
    elif approx_id < 80:
        v.append("linclust-40_lin")
    if linear:
        return v
    if approx_id < 80:
        v.append("default")
    else:
        v.append("fast")
    if approx_id < 50:
        v.append("more-sensitive")
    return v


def _round_edges(block: Block, rep_ids, sensitivity: str, matrix_name: str,
                 member_cover: float, approx_id: float, threads: int = 1,
                 mutual_cover: float | None = None):
    """Self-search of the representative subset; returns directed edges
    (rep_candidate, member, weight=bitscore)."""
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.search.pipeline import Pipeline
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    sub = Block.from_sequences([block.seq(i).copy() for i in rep_ids],
                               [block.ids[i] for i in rep_ids])
    tub = Block.from_sequences([block.seq(i).copy() for i in rep_ids],
                               [block.ids[i] for i in rep_ids])
    lin = sensitivity.endswith("_lin")
    sens = sensitivity[:-4] if lin else sensitivity
    cfg = SearchConfig(matrix=ScoreMatrix(matrix_name), sensitivity=sens,
                       max_target_seqs=2 ** 31 - 1, threads=threads,
                       lin_stage1_target=lin)
    if lin:
        # linearized rounds keep one target occurrence per seed, favoring
        # the longest sequence (reference search.cpp:75-106 linear rounds,
        # double_indexed.cpp:112-114 length-sorted block)
        tub, order = tub.length_sorted()
    pipe = Pipeline(cfg, sub, tub)
    results = pipe.search()
    if lin:
        remap = {i: order[i] for i in range(len(order))}
        for matches in results.values():
            for m in matches:
                m.target_block_id = remap[m.target_block_id]
    edges = []
    for qid, matches in results.items():
        qlen = int(sub.lengths[qid])
        for m in matches:
            t = m.target_block_id
            if t == qid:
                continue
            for h in m.hsp:
                qcov = (h.query_range[1] - h.query_range[0]) * 100.0 / qlen
                tlen = int(tub.lengths[t])
                scov = (h.subject_range[1] - h.subject_range[0]) * 100.0 / tlen
                if approx_id > 0 and h.length and \
                        h.identities * 100.0 / h.length < approx_id:
                    continue
                if mutual_cover is not None:
                    # --mutual-cover: both sequences covered (reference
                    # recluster.cpp:55-63, config 'mutual-cover')
                    if qcov >= mutual_cover and scov >= mutual_cover:
                        edges.append((t, qid, h.bit_score))
                        edges.append((qid, t, h.bit_score))
                    continue
                # the member must be covered to member_cover
                if qcov >= member_cover:
                    edges.append((t, qid, h.bit_score))
                if scov >= member_cover:
                    edges.append((qid, t, h.bit_score))
    return edges


def cluster_block(block: Block, steps, matrix_name: str = "BLOSUM62",
                  member_cover: float = 80.0, approx_id: float = 0.0,
                  threads: int = 1, verbose: bool = True,
                  mutual_cover: float | None = None):
    """Run the cascade; returns centroid assignment per block sequence."""
    n = len(block)
    assignment = np.arange(n, dtype=np.int64)  # global centroid per seq
    reps = list(range(n))
    for step in steps:
        if len(reps) <= 1:
            break
        if verbose:
            print(f"Clustering round: {step} ({len(reps)} sequences)",
                  file=sys.stderr)
        edges = _round_edges(block, reps, step, matrix_name, member_cover,
                             approx_id, threads, mutual_cover)
        g = EdgeGraph(len(reps), edges)
        local = greedy_vertex_cover(g)
        # compose via one vectorized remap (old centroid -> new centroid);
        # the per-member scan this replaces was O(n * members)
        remap = np.arange(n, dtype=np.int64)
        new_reps = []
        for li, rep_li in enumerate(local):
            gi = reps[li]
            remap[gi] = reps[rep_li]
            if rep_li == li:
                new_reps.append(gi)
        assignment = remap[assignment]
        reps = new_reps
    return assignment


def run_cluster(args):
    """CLI entry for cluster/linclust/deepclust."""
    from diamond_tpu_torch.data.dmnd import is_dmnd, read_dmnd
    from diamond_tpu_torch.data.fasta import read_seqs

    if getattr(args, "multiprocessing", False):
        return _run_cluster_multinode(args)

    if is_dmnd(args.db):
        ids, dseqs = read_dmnd(args.db)
        seqs = [s & 31 for s in dseqs]
        titles = ids
    else:
        recs = list(read_seqs(args.db))
        seqs = [r[1].upper() for r in recs]
        titles = [r[0] for r in recs]
    approx_id = args.approx_id if args.approx_id is not None else 0.0
    if args.command == "deepclust":
        approx_id = 0.0
    if getattr(args, "cluster_algo", None) == "mcl":
        from diamond_tpu_torch.cluster.mcl import (DEFAULT_THRESHOLD, mcl_cluster,
                                             mcl_edges_from_search)
        from diamond_tpu_torch.data.block import Block

        block = Block.from_sequences(seqs, titles)
        thr = args.cluster_threshold
        edges = mcl_edges_from_search(
            block, threshold=DEFAULT_THRESHOLD if thr is None else thr,
            threads=args.threads)
        assignment = mcl_cluster(
            len(block), edges,
            expansion=args.mcl_expansion, inflation=args.mcl_inflation,
            max_iter=args.mcl_max_iterations,
            symmetric=not args.mcl_nonsymmetric)
        out = sys.stdout if args.out == "-" else open(args.out, "w")
        for i in range(len(block)):
            out.write(f"{block.seq_id(int(assignment[i]))}\t"
                      f"{block.seq_id(i)}\n")
        if out is not sys.stdout:
            out.close()
        _write_reps(args, seqs, titles,
                    {block.seq_id(int(c)) for c in np.unique(assignment)})
        return
    if args.command == "linclust":
        from diamond_tpu_torch.cluster.linclust import linclust

        pairs = linclust(seqs, titles, approx_id=approx_id,
                         member_cover=args.member_cover,
                         steps=getattr(args, "cluster_steps", None),
                         kmer_ranking=getattr(args, "kmer_ranking", False))
        out = sys.stdout if args.out == "-" else open(args.out, "w")
        for rep, member in pairs:
            out.write(f"{rep}\t{member}\n")
        if out is not sys.stdout:
            out.close()
        _write_reps(args, seqs, titles, {rep for rep, _ in pairs})
        return
    from diamond_tpu_torch.data.block import Block

    block = Block.from_sequences(seqs, titles)
    steps = getattr(args, "cluster_steps", None) or \
        cluster_steps(approx_id, linear=False)
    assignment = cluster_block(block, steps, member_cover=args.member_cover,
                               approx_id=approx_id, threads=args.threads,
                               mutual_cover=getattr(args, "mutual_cover",
                                                    None))
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for i in range(len(block)):
        out.write(f"{block.seq_id(int(assignment[i]))}\t{block.seq_id(i)}\n")
    if out is not sys.stdout:
        out.close()
    _write_reps(args, seqs, titles,
                {block.seq_id(int(c)) for c in np.unique(assignment)})


def _write_reps(args, seqs, titles, rep_ids):
    """--reps FASTA: id + sequence only (reference config.cpp:359,
    cluster/output.cpp)."""
    if not getattr(args, "reps", None):
        return
    from diamond_tpu_torch.data.taxonomy import seqid
    from diamond_tpu_torch.tools_cmds import decode

    with open(args.reps, "w") as f:
        for t, s in zip(titles, seqs):
            sid = seqid(t)
            if sid in rep_ids:
                seq_str = decode(s) if not isinstance(s, (str, bytes)) \
                    else (s.decode() if isinstance(s, bytes) else s)
                f.write(f">{sid}\n{seq_str}\n")


def _run_cluster_multinode(args):
    """--multiprocessing --parallel-tmpdir: out-of-core multi-worker
    clustering (reference cluster/multinode); each invocation is one
    worker."""
    import sys

    from diamond_tpu_torch.cluster.multinode import multinode_cluster
    from diamond_tpu_torch.data.dmnd import is_dmnd, read_dmnd
    from diamond_tpu_torch.data.fasta import read_seqs
    from diamond_tpu_torch.tools_cmds import decode

    if not getattr(args, "parallel_tmpdir", None):
        raise SystemExit("--multiprocessing requires --parallel-tmpdir")
    if args.out == "-":
        raise SystemExit("--multiprocessing requires -o FILE")
    if is_dmnd(args.db):
        # DMND input: the format is offset-indexed, but the reader loads
        # whole blocks; clustering-scale inputs arrive as FASTA
        ids, dseqs = read_dmnd(args.db)
        base = [(i, decode(s & 31)) for i, s in zip(ids, dseqs)]

        def records():
            return iter(base)
    else:
        # streaming reader: the input FASTA/FASTQ is re-scanned per pass
        # and never fully resident (gzip included — read_seqs streams)
        def records():
            return ((i, s.decode() if isinstance(s, bytes) else s)
                    for i, s in read_seqs(args.db))
    approx_id = args.approx_id if args.approx_id is not None else 0.0
    if args.command == "deepclust":
        approx_id = 0.0
    steps = getattr(args, "cluster_steps", None) or \
        cluster_steps(approx_id, linear=args.command == "linclust")
    bs = getattr(args, "block_size", None)
    max_letters = int(bs * 1e9) if bs else 50_000_000
    multinode_cluster(records, args.out, steps, args.parallel_tmpdir,
                      max_letters=max_letters,
                      member_cover=args.member_cover, approx_id=approx_id,
                      mutual_cover=getattr(args, "mutual_cover", None),
                      reps_out=getattr(args, "reps", None),
                      recover=getattr(args, "mp_recover", False))
