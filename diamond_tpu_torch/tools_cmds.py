"""Utility tool commands (reference src/run/tools.cpp, src/tools/tools.cpp,
run/main.cpp:145-234 command switch): random-seqs, mask, fastq2fasta, info,
reverse, smith-waterman, split, hashseqs, listseeds.
"""
from __future__ import annotations

import sys

import numpy as np

from diamond_tpu_torch.constants.alphabet import (AMINO_ACID_ALPHABET as ALPHABET,
                                             MASK_LETTER, encode)
from diamond_tpu_torch.data.fasta import read_seqs


def decode(seq: np.ndarray) -> str:
    return "".join(ALPHABET[c & 31] for c in seq)


def _out(path):
    return sys.stdout if path == "-" else open(path, "w")


def _load_db(path):
    from diamond_tpu_torch.cli import load_block

    return load_block(path)


def cmd_getseq(args):
    """Print selected (1-based --seq numbers) or all db sequences as FASTA
    (reference run/tools.cpp:47-59, sequence_file.cpp:382-430 get_seq)."""
    block = _load_db(args.db)
    picks = ([int(s) - 1 for s in args.seq] if args.seq
             else range(len(block)))
    out = _out(args.out)
    for i in picks:
        out.write(f">{block.ids[i]}\n{decode(block.seq(int(i)))}\n")
    if out is not sys.stdout:
        out.close()


def cmd_random_seqs(args):
    """Sample N random sequences (reference run/tools.cpp:61-88
    random_seqs: numeric ids, deterministic sampling)."""
    block = _load_db(args.db)
    print(f"Sequences = {len(block)}")
    rng = np.random.default_rng(0)
    count = min(args.seqs, len(block))
    picks = sorted(rng.choice(len(block), size=count, replace=False))
    out = _out(args.out)
    for j, i in enumerate(picks):
        out.write(f">{j}\n{decode(block.seq(int(i)))}\n")
    if out is not sys.stdout:
        out.close()


def cmd_mask(args):
    """tantan-mask a FASTA file (reference run/tools.cpp:90-124
    run_masker: masked letters print as the mask char)."""
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    masker = Tantan(ScoreMatrix("BLOSUM62").matrix32)
    out = _out(args.out)
    n_seqs = 0
    n_masked_seqs = 0
    n_letters = 0
    for rid, seq in read_seqs(args.query):
        s = encode(seq.decode() if isinstance(seq, bytes) else seq)
        prob = masker.repeat_prob(s)
        masked = np.where(prob >= masker.p_mask, MASK_LETTER, s)
        out.write(f">{rid}\n{decode(masked)}\n")
        n = int((masked == MASK_LETTER).sum() - (s == MASK_LETTER).sum())
        n_letters += n
        n_masked_seqs += 1 if n > 0 else 0
        n_seqs += 1
    print(f"#Sequences: {n_masked_seqs}/{n_seqs}, #Letters: {n_letters}",
          file=sys.stderr)
    if out is not sys.stdout:
        out.close()


def cmd_fastq2fasta(args):
    """FASTQ -> FASTA (reference run/tools.cpp:126-140)."""
    from diamond_tpu_torch.data.fasta import read_fastq

    out = _out(args.out)
    for rid, seq in read_fastq(args.query):
        s = seq.decode() if isinstance(seq, bytes) else seq
        out.write(f">{rid}\n{s}\n")
    if out is not sys.stdout:
        out.close()


def cmd_info(args):
    """Platform info (reference run/tools.cpp:142-165): torch, CUDA and
    the card."""
    import torch

    print("diamond-tpu version 0.1.0 (reference compatibility: 2.2.2)")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"Backend: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices: {n}")
    for i in range(n):
        print(f"Device {i}: {torch.cuda.get_device_name(i)}")


def cmd_reverse(args):
    """Reverse every sequence (reference run/tools.cpp:217-239)."""
    out = _out(args.out)
    for rid, seq in read_seqs(args.query):
        s = seq.decode() if isinstance(seq, bytes) else seq
        out.write(f">{rid}\n{s[::-1]}\n")
    if out is not sys.stdout:
        out.close()


def cmd_hashseqs(args):
    """Per-sequence murmur3 x64-128 hashes (reference tools/tools.cpp:84-98
    hash_seqs; hashes the encoded letters)."""
    from diamond_tpu_torch.data.taxonomy import seqid
    from diamond_tpu_torch.utils.murmur3 import murmur3_x64_128

    for rid, seq in read_seqs(args.query):
        s = encode(seq.decode() if isinstance(seq, bytes) else seq)
        h = murmur3_x64_128(s.astype(np.int8).tobytes())
        print(f"{seqid(rid)}\t{h.hex()}")


def cmd_split(args):
    """Split input into letter-capped FASTA volumes n.faa(.gz) (reference
    tools/tools.cpp:51-82; the reference writes zstd, unavailable here)."""
    import gzip

    from diamond_tpu_torch.data.taxonomy import seqid

    cap = int(args.chunk_size * 1e9)
    f = 0
    n = 0

    def open_part(i):
        return gzip.open(f"{args.prefix}{i}.faa.gz", "wt")

    out = open_part(f)
    for rid, seq in read_seqs(args.query):
        s = seq.decode() if isinstance(seq, bytes) else seq
        if n >= cap:
            out.close()
            f += 1
            out = open_part(f)
            n = 0
        out.write(f">{seqid(rid)}\n{s}\n")
        n += len(s)
    out.close()


def cmd_listseeds(args):
    """Top-N most frequent seeds of the first default shape over the
    tantan-masked DB (reference tools/tools.cpp:107-160 list_seeds; seeds
    use the 20-letter (no) reduction)."""
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.search import stages
    from diamond_tpu_torch.seed.reduction import NO_REDUCTION
    from diamond_tpu_torch.seed.shapes import SHAPE_CODES, ShapeConfig
    from diamond_tpu_torch.search.pipeline import mask_block
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    block = _load_db(args.db)
    mask_block(block, Tantan(ScoreMatrix("BLOSUM62").matrix32))
    shapes = ShapeConfig(SHAPE_CODES["default"])
    shape = shapes[0]
    keys, _ = stages.enumerate_seeds(block, shape, NO_REDUCTION)
    uniq, counts = np.unique(keys, return_counts=True)
    order = np.lexsort((uniq, counts))[::-1]
    n = min(args.count, len(order))
    for k in order[:n]:
        key = int(uniq[k])
        letters = []
        for _ in range(shape.weight):
            letters.append(ALPHABET[key % 20])
            key //= 20
        print(f"{int(counts[k])}\t{''.join(reversed(letters))}")


def cmd_smith_waterman(args):
    """Pairwise DNA Smith-Waterman over consecutive sequence pairs
    (reference run/tools.cpp:167-215 pairwise: rows of
    target_id, query_id, subject_pos, query_pos, query_char for matches and
    subject_pos, -1, '-' for deletions)."""
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_np
    from diamond_tpu_torch.data.taxonomy import seqid

    recs = list(read_seqs(args.query))
    # DNA scoring: reward/penalty with affine gaps
    # (reference ScoreMatrix("DNA", 5, 2), config match/mismatch defaults)
    reward, penalty = args.reward, args.penalty
    m = np.full((32, 32), penalty, dtype=np.int32)
    np.fill_diagonal(m, reward)
    NT = {c: i for i, c in enumerate("ACGT")}
    for i in range(0, len(recs) - 1, 2):
        rid, rseq = recs[i]
        qid, qseq = recs[i + 1]
        r = np.array([NT.get(chr(c) if isinstance(c, int) else c, 4)
                      for c in (rseq.decode() if isinstance(rseq, bytes)
                                else rseq).upper()], dtype=np.int8)
        q = np.array([NT.get(chr(c) if isinstance(c, int) else c, 4)
                      for c in (qseq.decode() if isinstance(qseq, bytes)
                                else qseq).upper()], dtype=np.int8)
        res = banded_swipe_np(q, r, -(len(r) - 1), len(q), m, None,
                              args.gapopen + args.gapextend, args.gapextend,
                              traceback=True)
        qp = res.query_range[0]
        sp = res.subject_range[0]
        qs = (qseq.decode() if isinstance(qseq, bytes) else qseq).upper()
        # only substitutions and deletions are reported (reference
        # tools.cpp:185-191)
        for op, val in res.transcript:
            if op == "M":
                qp += 1
                sp += 1
            elif op == "S":
                print(f"{seqid(rid)}\t{seqid(qid)}\t{sp}\t{qp}\t{qs[qp]}")
                qp += 1
                sp += 1
            elif op == "I":  # query letters vs subject gap: not reported
                qp += val
            else:  # "D": gap in query
                print(f"{seqid(rid)}\t{seqid(qid)}\t{sp}\t-1\t-")
                sp += 1


def cmd_greedy_vertex_cover(args):
    """Standalone greedy vertex cover over an alignment edge list
    (reference tools/greedy_vertex_cover.cpp:276-361): -d maps seqids to
    oids (one per line, first tab field); --edges rows are either
    'query target qcov tcov weight' (default) or 'node1 node2 weight'
    (--edge-format triplet); coverage cutoff gates edge directions."""
    import sys

    from diamond_tpu_torch.cluster.linclust import greedy_vertex_cover_edges

    acc2oid = {}
    with open(args.db) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            acc = line.split("\t")[0]
            if acc in acc2oid:
                raise SystemExit("Duplicate sequence id found in database "
                                 "file")
            acc2oid[acc] = len(acc2oid)
    acc = [None] * len(acc2oid)
    for a, o in acc2oid.items():
        acc[o] = a

    triplets = args.edge_format == "triplet"
    cov = args.member_cover
    edges = []
    with open(args.edges) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            t = line.split("\t")
            q, s = acc2oid[t[0]], acc2oid[t[1]]
            if q == s:
                continue
            if triplets:
                w = float(t[2])
                edges.append((s, q, w))
                if args.symmetric:
                    edges.append((q, s, w))
            else:
                qcov, tcov, w = float(t[2]), float(t[3]), float(t[4])
                if tcov >= cov:
                    edges.append((q, s, w))
                if qcov >= cov:
                    edges.append((s, q, w))
    clustering = greedy_vertex_cover_edges(len(acc), edges)
    out = _out(args.out)
    n_reps = 0
    centroids = open(args.centroid_out, "w") if args.centroid_out else None
    for i in range(len(acc)):
        c = int(clustering[i])
        if c == i:
            n_reps += 1
            if centroids:
                centroids.write(acc[i] + "\n")
        out.write(f"{acc[c]}\t{acc[i]}\n")
    if centroids:
        centroids.close()
    if out is not sys.stdout:
        out.close()
    print(f"#Clusters: {n_reps}", file=sys.stderr)
