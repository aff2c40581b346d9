"""Multi-block (out-of-core) search: query blocks x reference blocks with a
k-way merged join.

TPU-native reshaping of the reference's block-swap driver (reference
src/run/double_indexed.cpp:697-749 master_thread, src/output/join_blocks.cpp
BlockJoiner): the reference pages blocks through RAM and joins per-block
intermediate files; here blocks page through device memory and the join is
an in-memory merge.  Semantics preserved: block boundaries cut after the
sequence that reaches the letter cap (reference sequence_file.cpp:202-240
load_twopass `letters < max_letters`), per-block extension runs the full
adaptive-ranking pipeline, and the join re-culls globally by (evalue,
score desc, target oid) (reference join_blocks.cpp:126-140 cmp_evalue).
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.search.config import SearchConfig
from diamond_tpu_torch.search.pipeline import Pipeline


def split_blocks(seqs, ids, max_letters: int):
    """Greedy letter-capped split (reference load_twopass boundary rule)."""
    blocks = []
    cur_s, cur_i, letters = [], [], 0
    base = 0
    bases = []
    for s, i in zip(seqs, ids):
        if letters >= max_letters and cur_s:
            blocks.append(Block.from_sequences(cur_s, cur_i))
            bases.append(base)
            base += len(cur_s)
            cur_s, cur_i, letters = [], [], 0
        cur_s.append(s)
        cur_i.append(i)
        letters += len(s)
    if cur_s:
        blocks.append(Block.from_sequences(cur_s, cur_i))
        bases.append(base)
    return blocks, bases


def split_bounds(lengths, max_letters: int):
    """Greedy letter-capped split over a length array only (same
    boundary rule as split_blocks; the blocks themselves materialize
    lazily from a provider)."""
    bounds = []
    lo = 0
    letters = 0
    n = len(lengths)
    for k in range(n):
        if letters >= max_letters and k > lo:
            bounds.append((lo, k))
            lo = k
            letters = 0
        letters += int(lengths[k])
    if lo < n:
        bounds.append((lo, n))
    return bounds


def blocked_search(cfg: SearchConfig, query_seqs, query_ids, target_seqs,
                   target_ids, block_size_gb: float, taxonomy=None,
                   taxon_k: int = 0, target_provider=None):
    """Returns ({global_query_id: [(global_target_id, Match)]}, n_queries).

    target_provider (data/dmnd.DmndProvider or ListProvider): when
    given, target blocks materialize lazily per block and are freed
    after their combos — the out-of-core memory contract of the
    reference block swap (double_indexed.cpp:417-422 loads one ref
    block at a time).  The block loop is inverted (targets outer) so
    every target block is loaded and tantan-masked ONCE regardless of
    the query block count (the reference masks per ref-chunk visit,
    double_indexed.cpp:122-127)."""
    cap = int(block_size_gb * 1e9)
    if target_provider is not None:
        total_letters = int(target_provider.total_letters)
    else:
        total_letters = sum(len(s) for s in target_seqs)
    cfg.matrix.set_db_letters(total_letters)

    q_blocks, q_bases = split_blocks(query_seqs, query_ids, cap)

    if target_provider is not None:
        if cfg.global_ranking:
            raise ValueError("provider path does not drive -g (use the "
                             "materialized path)")
        import gc

        t_bounds = split_bounds(target_provider.lengths, cap)
        merged: dict[int, list] = {}
        for lo, hi in t_bounds:
            tb = target_provider.load_block(lo, hi)
            for qb, q_base in zip(q_blocks, q_bases):
                res = _run_combo(cfg, qb, tb, total_letters)
                for qid, matches in res.items():
                    bucket = merged.setdefault(q_base + qid, [])
                    for m in matches:
                        bucket.append((lo + m.target_block_id, m))
                del res
            del tb
            if not taxon_k:
                _trim_merged(cfg, merged)
            # per-block working sets are hundreds of MB; collect cycles
            # NOW so the next block's peak does not stack on garbage,
            # and hand freed arenas back to the OS (large seed/DP
            # transients fragment glibc arenas otherwise)
            gc.collect()
            try:
                import ctypes

                ctypes.CDLL("libc.so.6").malloc_trim(0)
            except Exception:
                pass
        return _join(cfg, merged, taxonomy, taxon_k)

    t_blocks, t_bases = split_blocks(target_seqs, target_ids, cap)

    if cfg.global_ranking:
        return _blocked_global_ranking(cfg, q_blocks, q_bases, t_blocks,
                                       t_bases, target_seqs, target_ids)

    merged: dict[int, list] = {}
    for qb, q_base in zip(q_blocks, q_bases):
        for tb, t_base in zip(t_blocks, t_bases):
            res = _run_combo(cfg, qb, tb, total_letters)
            for qid, matches in res.items():
                bucket = merged.setdefault(q_base + qid, [])
                for m in matches:
                    bucket.append((t_base + m.target_block_id, m))
    return _join(cfg, merged, taxonomy, taxon_k)


def _run_combo(cfg, qb, tb, total_letters):
    pipe = Pipeline(cfg, qb, tb)
    pipe.cfg.matrix.set_db_letters(total_letters)  # keep global stats
    return pipe.search()


def _trim_merged(cfg, merged):
    """Incremental per-query culling between target blocks: the join's
    final selection is a top-k by a total order (evalue, -score, goid)
    or a best-relative --top cutoff, so trimming each query's candidate
    list after every block keeps memory bounded by k*n_queries without
    changing the final output (the cutoff only rises as later blocks
    arrive; the role of the reference's streamed block join,
    join_blocks.cpp:169-338, without its temp files)."""
    for gqid, items in merged.items():
        if cfg.toppercent is not None:
            items.sort(key=lambda tm: (-tm[1].filter_score, tm[0]))
            if items:
                from diamond_tpu_torch.align.extend import _top_cutoff_score

                cutoff = max(_top_cutoff_score(
                    float(cfg.matrix.bitscore(items[0][1].filter_score)),
                    cfg.toppercent), 1.0)
                merged[gqid] = [t for t in items
                                if float(cfg.matrix.bitscore(
                                    t[1].filter_score)) >= cutoff]
        elif len(items) > cfg.max_target_seqs:
            items.sort(key=lambda tm: (tm[1].filter_evalue,
                                       -tm[1].filter_score, tm[0]))
            del items[cfg.max_target_seqs :]


def _join(cfg, merged, taxonomy=None, taxon_k=0):
    # global join culling (reference join_blocks.cpp join_query)
    out: dict[int, list] = {}
    for gqid, items in merged.items():
        if cfg.toppercent is not None:
            items.sort(key=lambda tm: (-tm[1].filter_score, tm[0]))
            if items:
                from diamond_tpu_torch.align.extend import _top_cutoff_score

                cutoff = max(_top_cutoff_score(
                    float(cfg.matrix.bitscore(items[0][1].filter_score)),
                    cfg.toppercent), 1.0)
                items = [t for t in items
                         if float(cfg.matrix.bitscore(t[1].filter_score))
                         >= cutoff]
        else:
            items.sort(key=lambda tm: (tm[1].filter_evalue,
                                       -tm[1].filter_score, tm[0]))
            if taxon_k:
                # per-species cap during the join (reference
                # join_blocks.cpp:223-272 w/ GlobalCulling taxon counts,
                # target_culling.h:50-57,91-93)
                from diamond_tpu_torch.data.taxonomy import RANK_SPECIES

                counts: dict[int, int] = {}
                kept = []
                for goid, m in items:
                    if len(kept) >= cfg.max_target_seqs:
                        break
                    rank_ids = taxonomy.rank_taxids(taxonomy.taxids(goid),
                                                    RANK_SPECIES)
                    # all() over an empty rank set is True -> NEXT, matching
                    # the reference's taxons_exceeded == size() comparison
                    if kept and all(counts.get(r, 0) >= taxon_k
                                    for r in rank_ids):
                        continue
                    for r in rank_ids:
                        counts[r] = counts.get(r, 0) + 1
                    kept.append((goid, m))
                items = kept
            else:
                items = items[: cfg.max_target_seqs]
        out[gqid] = items
    return out


def blocked_search_mp(cfg: SearchConfig, query_seqs, query_ids, target_seqs,
                      target_ids, block_size_gb: float, tmpdir: str,
                      init_only: bool = False, recover: bool = False):
    """--multiprocessing blocked search: block combos are claimed from a
    shared-FS work queue; each combo's result file is the checkpoint
    (reference double_indexed.cpp:346-430; see parallel/mp.py).

    Returns the joined results when this worker finishes the last combo,
    else None (another worker holds outstanding combos, or init-only)."""
    from diamond_tpu_torch.parallel import mp

    cap = int(block_size_gb * 1e9)
    total_letters = sum(len(s) for s in target_seqs)
    t_blocks, t_bases = split_blocks(target_seqs, target_ids, cap)
    q_blocks, q_bases = split_blocks(query_seqs, query_ids, cap)

    if init_only:
        mp.mp_init(tmpdir, len(q_blocks), len(t_blocks))
        return None
    if recover:
        mp.mp_recover(tmpdir)

    def run_combo(qi, ti):
        res = _run_combo(cfg, q_blocks[qi], t_blocks[ti], total_letters)
        return {q_bases[qi] + qid: [(t_bases[ti] + m.target_block_id, m)
                                    for m in matches]
                for qid, matches in res.items()}

    mp.mp_worker(tmpdir, run_combo)
    if not mp.mp_done(tmpdir):
        return None
    merged: dict[int, list] = {}
    for combo in mp.mp_collect(tmpdir).values():
        for gqid, items in combo.items():
            merged.setdefault(gqid, []).extend(items)
    return _join(cfg, merged)


def _blocked_global_ranking(cfg, q_blocks, q_bases, t_blocks, t_bases,
                            target_seqs, target_ids):
    """Global ranking over the block swap: the ranking table (keyed by
    global query id / target oid) merges across (query block, ref block)
    combos, then a single full-matrix extension runs over the ranked
    targets (reference double_indexed.cpp:439-446
    GlobalRanking::extend after the block loops)."""
    from diamond_tpu_torch.align.global_ranking import RankingTable, extend_ranked
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.search.pipeline import mask_block
    from diamond_tpu_torch.stats.cbs import hauser_bias_i8

    total_letters = sum(len(s) for s in target_seqs)
    n_queries = sum(len(b) for b in q_blocks)
    table = RankingTable(n_queries, cfg.global_ranking)
    for qb, q_base in zip(q_blocks, q_bases):
        for tb, t_base in zip(t_blocks, t_bases):
            pipe = Pipeline(cfg, qb, tb, ranking_table=table, q_base=q_base,
                            t_base=t_base)
            pipe.cfg.matrix.set_db_letters(total_letters)  # keep global stats
            pipe.search()

    # final extension: block of ranked targets, tantan-masked like the
    # reference's re-load + mask (global_ranking/extend.cpp:192-197)
    oids = table.ranked_oids()
    final_block = Block.from_sequences([target_seqs[o] for o in oids],
                                       [target_ids[o] for o in oids])
    if cfg.masking == "tantan":
        mask_block(final_block, Tantan(cfg.matrix.matrix32))
    oid2block = {o: i for i, o in enumerate(oids)}

    # global query id -> (block, local id); blocks are already masked
    def locate(src):
        for qb, q_base in zip(q_blocks, q_bases):
            if q_base <= src < q_base + len(qb):
                return qb, src - q_base
        raise IndexError(src)

    def contexts_fn(src):
        qb, lid = locate(src)
        return [(0, qb.seq(lid))]

    def biases_fn(src):
        qb, lid = locate(src)
        i8 = hauser_bias_i8(qb.seq(lid), cfg.matrix.matrix32,
                                  cfg.matrix.background_scores)
        return {0: i8}

    results = extend_ranked(table, contexts_fn, biases_fn, final_block,
                            oid2block, cfg)
    return {src: [(oids[m.target_block_id], m) for m in matches]
            for src, matches in results.items()}
