"""Linear-time clustering (linclust) — reference-exact single-host pipeline.

Re-design of the reference multi-node linclust (reference
src/cluster/multinode/{multinode,search,len_sort,output}.cpp,
src/tools/greedy_vertex_cover.cpp, src/search/hamming/kernel_lin.h,
src/search/kmer_ranking.{h,cpp}):

  1. length-sort the input (len desc, original oid desc —
     len_sort.cpp:242 greater<pair<Loc,OId>>)
  2. cascade of linear rounds (faster_lin, fast_lin, linclust-20_lin for
     approx-id < 40; cascaded/helpers.cpp:41-50); each round:
       - self-search of the current representatives with LINEARIZED stage 1:
         per seed, only the longest query occurrence (ties: smallest
         original oid — kmer_ranking.h:35-52 with RANK_BY_SEQID) is matched
         against all target occurrences; no left-most filter
       - FULL-matrix extension of candidate targets, -k unlimited,
         coverage gate max(qcov, tcov) >= member_cover
         (multinode/search.cpp:115-121 query_or_target_cover)
       - edges (rep_candidate -> member) weighted by corrected bitscore
       - greedy vertex cover with lazy max-degree queue, weight-based
         reassignment and recursive centroid merging
         (tools/greedy_vertex_cover.cpp:96-125)
  3. compose round assignments; output (rep, member) sorted by
     (rep oid, member oid) in length-sorted oid space
     (multinode/output.cpp AccMapping::operator<).

The multi-node shared-filesystem coordination (Atomic/FileStack work queues)
becomes a single driver here; block combos shard over a device mesh in the
TPU deployment (see diamond_tpu.parallel).
"""
from __future__ import annotations

import heapq
import sys

import numpy as np

from diamond_tpu_torch.data.block import Block

NIL = -1


# ---------------------------------------------------------------------------
# reference-exact seed keys + sketch
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def murmur64(h: np.ndarray) -> np.ndarray:
    """MurmurHash finalizer (reference util/hash_function.h:21-31)."""
    h = h.astype(np.uint64).copy()
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return h


def exact_seed_keys(reduced: np.ndarray, shape, base: int):
    """Reference even/odd packed seed keys (reference
    basic/shape.h:114-152 set_seed_reduced).  Returns (keys u64, valid)."""
    L = len(reduced)
    n = L - shape.length + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    r = reduced.astype(np.int64)
    W = shape.weight
    letters = np.empty((W, n), dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for k, p in enumerate(shape.positions):
        w = r[p : p + n]
        valid &= (w >= 0) & (w < base)
        letters[k] = np.where((w >= 0) & (w < base), w, 0).astype(np.uint64)
    s2 = np.uint64(base * base)
    size = np.uint64(base)
    E = letters[0].copy()
    O = letters[1].copy()
    i = 2
    while i + 1 < W:
        E = (E * s2 + letters[i]) & np.uint64(_MASK64)
        O = (O * s2 + letters[i + 1]) & np.uint64(_MASK64)
        i += 2
    if W % 2 == 0:
        keys = (E * size + O) & np.uint64(_MASK64)
    else:
        E = (E * s2 + letters[W - 1]) & np.uint64(_MASK64)
        keys = (E + O * size) & np.uint64(_MASK64)
    return keys, valid


def sketch_select(keys: np.ndarray, valid: np.ndarray, n: int):
    """Positions of the n smallest-murmur seeds (reference SketchIterator,
    seed_iterator.h:161-200; std::sort by hash, first n kept)."""
    pos = np.nonzero(valid)[0]
    if len(pos) == 0:
        return pos
    h = murmur64(keys[pos])
    order = np.argsort(h, kind="stable")
    return pos[order[:n]]


# ---------------------------------------------------------------------------
# greedy vertex cover (tools/greedy_vertex_cover.cpp semantics)
# ---------------------------------------------------------------------------

def greedy_vertex_cover_edges(n: int, edges, merge_recursive=True,
                              reassign=True):
    """edges: iterable of (node1=rep_candidate, node2=member, weight).
    Returns clustering array (len n): centroid per node, self for
    singletons.

    Bucket-phased greedy (reference tools/greedy_vertex_cover.cpp
    edge_pass_two/three/four): nodes enter the queue in descending
    RAW-degree buckets, and each bucket drains only down to the next
    bucket's degree — so a loaded node whose effective degree dropped can
    still become a rep before lower-degree buckets load.  That phasing
    (not pure greedy-by-current-degree) decides tie-rich families."""
    by_node: dict[int, dict] = {}
    for n1, n2, w in edges:
        if n1 == n2:
            continue
        m = by_node.setdefault(n1, {})
        if n2 not in m:
            m[n2] = w
    members = {k: sorted(v.items()) for k, v in by_node.items()}

    clustering = np.full(n, NIL, dtype=np.int64)
    weights = np.full(n, -np.inf)

    def assign(node):
        clustering[node] = node
        for m, w in members[node]:
            if (clustering[m] == NIL
                    or (reassign and weights[m] < w and clustering[m] != m)
                    or (merge_recursive and clustering[m] == m)):
                clustering[m] = node
                weights[m] = w

    # raw-degree buckets, highest first
    buckets: dict[int, list] = {}
    for k, v in members.items():
        buckets.setdefault(len(v), []).append(k)
    degrees = sorted(buckets, reverse=True)
    # max-heap on (current degree, node): ties -> larger node
    # (PotentialRep::operator<)
    heap: list = []
    for bi, d in enumerate(degrees):
        for node in buckets[d]:
            if clustering[node] != NIL:
                continue
            deg = sum(1 for m, _ in members[node] if clustering[m] == NIL)
            heapq.heappush(heap, (-deg, -node))
        next_degree = degrees[bi + 1] if bi + 1 < len(degrees) else 0
        while heap:
            _stale, nk = heapq.heappop(heap)
            node = -nk
            if clustering[node] != NIL:
                continue
            deg = sum(1 for m, _ in members[node] if clustering[m] == NIL)
            if heap and -heap[0][0] > deg:
                heapq.heappush(heap, (-deg, -node))
                continue
            if deg < next_degree:
                heapq.heappush(heap, (-deg, -node))
                break
            assign(node)
    # flatten merge chains (fix_assignment)
    for i in range(n):
        while clustering[i] != NIL and clustering[clustering[i]] != clustering[i]:
            clustering[i] = clustering[clustering[i]]
    clustering[clustering == NIL] = np.nonzero(clustering == NIL)[0]
    return clustering


# ---------------------------------------------------------------------------
# linear round: linearized seeding + FULL-matrix extension -> edges
# ---------------------------------------------------------------------------

def _lin_round_edges(block: Block, rep_oids, orig_oids, step: str, cfg):
    """Self-search of the representatives; returns (n1, n2, weight) edges in
    length-sorted oid space."""
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.search import stages
    from diamond_tpu_torch.search.pipeline import (apply_ranges, motif_mask_ranges,
                                             restore_ranges)
    from diamond_tpu_torch.constants.alphabet import MASK_LETTER

    sub = Block.from_sequences([block.seq(i).copy() for i in rep_oids],
                               [block.ids[i] for i in rep_oids])
    mat = cfg.matrix
    # clustering masks tantan SOFTLY: repeats are hidden from seeding only;
    # filters and DP see the unmasked letters (reference
    # cluster/helpers.cpp:159-162 soft_masking="tantan", masking="0")
    masker = Tantan(mat.matrix32)
    soft = []
    from diamond_tpu_torch import native

    probs_all = native.tantan_repeat_prob_many(
        sub.letters, sub.starts, sub.lengths, masker.ratios,
        float(masker.p_repeat), float(masker.p_repeat_end),
        float(masker.repeat_growth))
    if probs_all is not None:
        # one block-wide pass; run-extraction over the global mask
        mask_all = probs_all >= masker.p_mask
        d = np.diff(np.concatenate([[0], mask_all.view(np.int8), [0]]))
        for b, e in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            soft.append((int(b), int(e)))
    else:
        for i in range(len(sub)):
            s = int(sub.starts[i])
            L = int(sub.lengths[i])
            prob = masker.repeat_prob(sub.letters[s : s + L])
            mask = prob >= masker.p_mask
            if mask.any():
                d = np.diff(np.concatenate([[0], mask.view(np.int8), [0]]))
                for b, e in zip(np.nonzero(d == 1)[0],
                                np.nonzero(d == -1)[0]):
                    soft.append((s + int(b), s + int(e)))
    motif = motif_mask_ranges(sub) if cfg.motif_masking else []
    motif = soft + motif
    lengths = sub.lengths
    rep_orig = np.array([orig_oids[i] for i in rep_oids], dtype=np.int64)

    # hits: (query local id, target local id, stage2 score)
    hits: dict[int, dict] = {}
    seed_mask = np.zeros(len(sub.letters), dtype=bool)
    for sid in range(len(cfg.shapes)):
        shape = cfg.shapes[sid]
        saved = apply_ranges(sub.letters, motif)
        if cfg.traits.sketch:
            keys_list, pos_list = [], []
            for i in range(len(sub)):
                s = int(sub.starts[i])
                L = int(lengths[i])
                red = cfg.reduction(sub.letters[s : s + L])
                keys, valid = exact_seed_keys(red, shape, cfg.reduction.size)
                sel = sketch_select(keys, valid, cfg.traits.sketch)
                keys_list.append(keys[sel])
                pos_list.append(sel + s)
            q_keys = np.concatenate(keys_list) if keys_list else np.zeros(0, np.uint64)
            q_pos = np.concatenate(pos_list).astype(np.int64) if pos_list else np.zeros(0, np.int64)
        else:
            q_keys, q_pos = stages.enumerate_seeds(sub, shape, cfg.reduction)
        restore_ranges(sub.letters, saved)

        join = stages.seed_join(q_keys, q_pos, q_keys, q_pos)
        join, masked_pos = _complexity(join, shape, cfg)
        if len(masked_pos):
            seed_mask[masked_pos] = True

        # --kmer-ranking: rank sequences by accumulated sqrt(seed group
        # size) over this shape's join instead of by length (reference
        # kmer_ranking.cpp:40-66: counts[q] += sqrt(|ref-side group|) per
        # query occurrence, float32, group order)
        kmer_ranks = None
        if getattr(cfg, "kmer_ranking", False) and len(join.keys):
            contrib = np.sqrt(
                np.diff(join.s_start).astype(np.float32))
            qi_all, _ = sub.global_to_local(join.q_pos)
            kmer_ranks = np.zeros(len(sub), dtype=np.float32)
            np.add.at(kmer_ranks, qi_all,
                      np.repeat(contrib, np.diff(join.q_start)))

        # linearized stage 1: one query occurrence per seed
        n_groups = len(join.keys)
        for g in range(n_groups):
            q_lo, q_hi = int(join.q_start[g]), int(join.q_start[g + 1])
            s_lo, s_hi = int(join.s_start[g]), int(join.s_start[g + 1])
            qpos = join.q_pos[q_lo:q_hi]
            spos = join.s_pos[s_lo:s_hi]
            qi, qoff = sub.global_to_local(qpos)
            # highest ranking = longest seq (or --kmer-ranking counts),
            # ties smallest numeric seqid; len_sort renumbers titles to
            # length-sorted oids (kmer_ranking.h:35-52, len_sort.cpp:144)
            ranks = kmer_ranks[qi] if kmer_ranks is not None else lengths[qi]
            best = 0
            for k in range(1, len(qi)):
                if (ranks[k] > ranks[best]
                        or (ranks[k] == ranks[best]
                            and rep_oids[qi[k]] < rep_oids[qi[best]])):
                    best = k
            qp = np.full(len(spos), qpos[best], dtype=np.int64)
            keep1 = stages.stage1_filter(sub.letters, sub.letters, qp,
                                         spos.astype(np.int64),
                                         cfg.hamming_filter_id)
            qpk, spk = qp[keep1], spos[keep1].astype(np.int64)
            if len(qpk) == 0:
                continue
            ti, toff = sub.global_to_local(spk)
            if cfg.traits.ungapped_evalue == 0:
                # no ungapped filter: all hamming survivors pass
                # (reference stage2.h:45-46 returns cutoff 0, the SIMD scan
                # is skipped and scores stay at their sentinel)
                scores = np.full(len(qpk), 0xFFFF, dtype=np.int32)
                keep2 = ti != qi[best]  # self=true
            else:
                qlens = np.full(len(qpk), lengths[qi[best]])
                cutoffs = _cutoffs(cfg, qlens)
                scores = stages.stage2_scores(sub.letters, sub.letters, qpk,
                                              spk, mat.matrix32)
                keep2 = (scores > cutoffs) & (ti != qi[best])
            qid = int(qi[best])
            for k in np.nonzero(keep2)[0]:
                t = int(ti[k])
                d = hits.setdefault(qid, {})
                d[t] = max(d.get(t, 0), int(scores[k]))

    # FULL-matrix extension per query; emit edges
    edges = []
    for qid in sorted(hits):
        edges.extend(_full_extend_edges(sub, qid, hits[qid], cfg, rep_oids))
    return edges


def _complexity(join, shape, cfg):
    from diamond_tpu_torch.search.stages import _csr_gather, complexity_mask

    kept = complexity_mask(join, shape, cfg.reduction, cfg.seed_complexity_cut)
    if len(kept.keys) == len(join.keys):
        return kept, np.zeros(0, dtype=np.int64)
    erased = np.setdiff1d(join.keys, kept.keys, assume_unique=True)
    idx = np.searchsorted(join.keys, erased)
    counts = np.diff(join.q_start)[idx]
    _, masked = _csr_gather(join.q_start[idx], counts, join.q_pos)
    return kept, masked


def _cutoffs(cfg, qlens):
    from diamond_tpu_torch.search.stages import CutoffTable

    if cfg.traits.ungapped_evalue <= 0:
        return np.zeros(len(qlens), dtype=np.int32)
    if not hasattr(cfg, "_lin_cutoffs"):
        cfg._lin_cutoffs = CutoffTable(cfg.matrix, cfg.traits.ungapped_evalue)
    out = cfg._lin_cutoffs(qlens)
    return np.where(qlens <= 60, cfg.matrix.rawscore(25.0), out)


def _full_extend_edges(sub: Block, qid: int, target_scores: dict, cfg,
                       rep_oids):
    """FULL-matrix extension of candidate targets; returns GVC edges
    (node1=potential rep, node2=member) in length-sorted oid space
    (reference search.cpp:115-121 + tools/greedy_vertex_cover.cpp:155-172:
    tcov >= cov -> (q, t); qcov >= cov -> (t, q))."""
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.cbs import hauser, hauser_bias_i8

    mat = cfg.matrix
    q = sub.seq(qid)
    qlen = len(q)
    bias = None
    if hauser(cfg.comp_based_stats):
        bias = hauser_bias_i8(q, mat.matrix32, mat.background_scores)
    tids = sorted(target_scores)
    jobs = []
    for t in tids:
        tgt = sub.seq(t)
        jobs.append((tgt, -(len(tgt) - 1), qlen))
    res = banded_swipe_batch_np(q, bias, jobs, mat.matrix32, mat.gap_open,
                                mat.gap_extend)
    survivors = []
    for t, (score, mc, mr) in zip(tids, res):
        tlen = int(sub.lengths[t])
        if score <= 0:
            continue
        ev = float(mat.evalue(score, qlen, tlen))
        if mat.report_cutoff(score, ev, cfg.max_evalue, cfg.min_bit_score):
            survivors.append(t)
    edges = []
    if not survivors:
        return edges
    jobs = [(sub.seq(t), -(int(sub.lengths[t]) - 1), qlen) for t in survivors]
    res = banded_swipe_batch_np(q, bias, jobs, mat.matrix32, mat.gap_open,
                                mat.gap_extend, traceback=True)
    cov = cfg.query_or_target_cover
    for t, r in zip(survivors, res):
        tlen = int(sub.lengths[t])
        ev = float(mat.evalue(r.score, qlen, tlen))
        if not (r.score > 0 and mat.report_cutoff(r.score, ev, cfg.max_evalue,
                                                  cfg.min_bit_score)):
            continue
        qcov = (r.query_range[1] - r.query_range[0]) * 100.0 / qlen
        tcov = (r.subject_range[1] - r.subject_range[0]) * 100.0 / tlen
        if max(qcov, tcov) < cov:
            continue
        w = float(mat.bitscore_corrected(r.score, qlen, tlen))
        gq, gt = rep_oids[qid], rep_oids[t]
        if tcov >= cov:
            edges.append((gq, gt, w))
        if qcov >= cov:
            edges.append((gt, gq, w))
    return edges


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def linclust(seqs, titles, approx_id: float = 0.0, member_cover: float = 80.0,
             matrix_name: str = "BLOSUM62", verbose: bool = False,
             steps=None, kmer_ranking: bool = False):
    """Returns list of (rep_title, member_title) lines in the reference's
    output order.  steps overrides the default cascade (--cluster-steps)."""
    from diamond_tpu_torch.cluster.workflow import cluster_steps
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    n = len(seqs)
    # len_sort: length desc, original oid desc (len_sort.cpp:242)
    order = sorted(range(n), key=lambda i: (-len(seqs[i]), -i))
    block = Block.from_sequences([seqs[i] for i in order],
                                 [titles[i] for i in order])
    orig_oids = np.array(order, dtype=np.int64)
    total_letters = sum(len(s) for s in seqs)

    clustering = np.arange(n, dtype=np.int64)
    reps = list(range(n))
    if steps is None:
        steps = cluster_steps(approx_id, linear=True)
    for step in steps:
        if len(reps) <= 1:
            break
        if verbose:
            print(f"linclust round {step}: {len(reps)} sequences",
                  file=sys.stderr)
        sens = step[:-4] if step.endswith("_lin") else step
        cfg = SearchConfig(matrix=ScoreMatrix(matrix_name), sensitivity=sens,
                           max_target_seqs=0, self_search=True,
                           kmer_ranking=kmer_ranking)
        cfg.matrix.set_db_letters(total_letters)
        cfg.query_or_target_cover = member_cover
        edges = _lin_round_edges(block, reps, orig_oids, step, cfg)
        local = greedy_vertex_cover_edges(n, edges)
        for i in reps:
            if local[i] != i:
                clustering[clustering == i] = local[i]
        reps = [i for i in reps if local[i] == i]
    # output sorted by (rep, member) in len-sorted oid space
    out = []
    pairs = sorted((int(clustering[i]), i) for i in range(n))
    for rep, member in pairs:
        out.append((block.seq_id(rep), block.seq_id(member)))
    return out
