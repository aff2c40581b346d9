"""Realign workflow: align cluster members back to their centroids
(reference src/cluster/realign.cpp, cluster/output.cpp:66-123).

Per centroid (ascending database oid), every member aligns against the
centroid with a FULL-matrix Smith-Waterman (Hauser bias, default CBS) and is
reported with the fields qseqid sseqid approx_pident qstart qend sstart send
evalue bitscore; no e-value cutoff (config.max_evalue = DBL_MAX).

approx_pident is the score-derived approximation
clamp(score / max(range_q, range_s) * 16.56 + 11.41, 0, 100)
(reference stats/stats.cpp:113-118; the stats DP path never takes the
is_identity shortcut because begin coordinates are not yet known when the
value is computed, full_swipe.h:130).
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.output.format import format_double, print_e


def approx_id(score: int, range1: int, range2: int) -> float:
    m = max(range1, range2)
    if m == 0:
        return 100.0
    # std::fma single-rounding semantics (no math.fma before Python 3.13):
    # emulate with exact Fraction arithmetic rounded once to float64
    from fractions import Fraction

    a = Fraction(score / m)  # the division IS rounded (a double)
    v = float(a * Fraction(16.56) + Fraction(11.41))
    return min(max(v, 0.0), 100.0)


def realign(seqs, titles, cluster_lines, matrix_name: str = "BLOSUM62"):
    """cluster_lines: iterable of 'centroid\\tmember' seqid pairs.
    Yields output lines."""
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.cbs import hauser_bias_i8
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    block = Block.from_sequences(seqs, titles)
    name2oid = {block.seq_id(i): i for i in range(len(block))}
    clusters: dict[int, list] = {}
    for line in cluster_lines:
        rep, member = line.split("\t")
        clusters.setdefault(name2oid[rep], []).append(name2oid[member])

    m = ScoreMatrix(matrix_name)
    m.set_db_letters(block.n_letters)
    out = []
    for centroid in sorted(clusters):
        members = sorted(clusters[centroid])
        q = block.seq(centroid)
        qlen = len(q)
        bias = hauser_bias_i8(q, m.matrix32, m.background_scores)
        jobs = [(block.seq(t), -(int(block.lengths[t]) - 1), qlen)
                for t in members]
        res = banded_swipe_batch_np(q, bias, jobs, m.matrix32, m.gap_open,
                                    m.gap_extend, traceback=True)
        for t, r in zip(members, res):
            if r.score <= 0:
                continue
            tlen = int(block.lengths[t])
            ev = float(m.evalue(r.score, qlen, tlen))
            aid = approx_id(r.score, r.query_range[1] - r.query_range[0],
                            r.subject_range[1] - r.subject_range[0])
            out.append("\t".join([
                block.seq_id(centroid), block.seq_id(t), format_double(aid),
                str(r.query_range[0] + 1), str(r.query_range[1]),
                str(r.subject_range[0] + 1), str(r.subject_range[1]),
                print_e(ev), format_double(float(m.bitscore(r.score))),
            ]))
    return out
