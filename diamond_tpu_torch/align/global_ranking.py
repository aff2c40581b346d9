"""Global ranking mode (-g N).

Search keeps only a per-query table of the N best targets by ungapped
re-extension score; extension runs once at the end, full-matrix, over the
ranked targets only.

Reference: src/align/global_ranking/global_ranking.h:30-86 (Hit ordering),
table.cpp:41-189 (per-shape table update: get_query_hits_reextend /
target_score / merge_hits), extend.cpp:123-234 (final full-matrix
extension), run/double_indexed.cpp:185-193,439-446 (per-shape buffer /
final extend call), search/setup.cpp:378-379 (global ranking forces
extension mode FULL).
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.align.chain import xdrop_ungapped
from diamond_tpu_torch.align.extend import (MAX_SWIPE_DP, Hsp, Match,
                                      _cull_matches, _output_range,
                                      _target_sort_key, apply_reversed_stats,
                                      load_hits)
from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
from diamond_tpu_torch.stats import cbs as cbs_mod

MAX_SCORE = 65535  # table scores are uint16 (reference global_ranking.h:66)


class RankingTable:
    """Per-source-query top-N (oid, score, context) rows, kept sorted by
    (score desc, oid asc) (reference Hit::operator<, merge_hits
    table.cpp:128-145)."""

    def __init__(self, n_queries: int, n: int):
        self.n = n
        self.rows: list[list] = [[] for _ in range(n_queries)]

    def merge(self, query: int, new_hits):
        """new_hits: [(oid, score, context)].  Dedupe by oid keeping the max
        score (CmpOidScore sort + unique), re-rank, cap at N."""
        combined = self.rows[query] + list(new_hits)
        combined.sort(key=lambda h: (h[0], -h[1]))
        dedup = []
        last_oid = None
        for h in combined:
            if h[0] != last_oid:
                dedup.append(h)
                last_oid = h[0]
        dedup.sort(key=lambda h: (-h[1], h[0]))
        self.rows[query] = dedup[: self.n]

    def ranked_oids(self):
        """All oids present in any row (reference extend.cpp:165-171
        db_filter)."""
        oids = set()
        for row in self.rows:
            for oid, _, _ in row:
                oids.add(oid)
        return sorted(oids)


def _target_score(group, ctx_views, matrix32, xdrop):
    """Max x-drop ungapped re-extension over a target's seed hits
    (reference table.cpp:85-111): hits sorted by (diag, j); a hit inside the
    last extension on the same diagonal is skipped; no Hauser bias."""
    hits = sorted(group, key=lambda h: (h.diag, h.j))
    h0 = hits[0]
    d = xdrop_ungapped(ctx_views[h0.frame][0], None, ctx_views[h0.frame][1],
                       h0.i, h0.j, matrix32, xdrop)
    score, context = d.score, h0.frame
    for h in hits[1:]:
        if d.diag == h.diag and d.subject_end >= h.j:
            continue
        d = xdrop_ungapped(ctx_views[h.frame][0], None, ctx_views[h.frame][1],
                           h.i, h.j, matrix32, xdrop)
        if d.score > score:
            score, context = d.score, h.frame
    return min(score, MAX_SCORE), context


def update_table(table: RankingTable, shape_hits, qblock, tblock, cfg,
                 q_base: int = 0, t_base: int = 0):
    """One per-shape table update (reference table.cpp:147-189 update_table,
    called per shape at double_indexed.cpp:185-193).

    shape_hits: [(context_id, subject_gpos, seed_offset, score)].
    """
    contexts = 6 if cfg.translated else 1
    by_source: dict[int, list] = {}
    for cid, sgpos, soff, score in shape_hits:
        by_source.setdefault(cid // contexts, []).append(
            (sgpos, soff, score, cid % contexts))
    m = cfg.matrix.matrix32
    for src, qhits in sorted(by_source.items()):
        ctx_views = {}
        for f in range(contexts):
            cid = src * contexts + f
            qs = int(qblock.starts[cid])
            # padded views: out-of-sequence reads hit delimiters
            ctx_views[f] = (qblock.letters[qs:], None)
        tids, groups, _ = load_hits(qhits, tblock)
        new = []
        for tid, group in zip(tids, groups):
            ts = int(tblock.starts[tid])
            views = {f: (q, tblock.letters[ts:]) for f, (q, _) in
                     ctx_views.items()}
            score, context = _target_score(group, views, m, cfg.xdrop_raw)
            new.append((t_base + tid, score, context))
        table.merge(q_base + src, new)


def extend_ranked(table: RankingTable, contexts_fn, biases_fn, final_block,
                  oid2block, cfg):
    """Final full-matrix extension over ranked targets (reference
    extend.cpp:123-162 extend_query with flags FULL_MATRIX, mode FULL).

    contexts_fn(src) -> [(frame, qseq)], biases_fn(src) -> {frame: bias}.
    oid2block maps table oids to block ids in final_block.
    Returns {source_query_id: [Match]} with Match.target_block_id indexing
    final_block.
    """
    mat = cfg.matrix
    use_h = None
    results = {}
    for src, row in enumerate(table.rows):
        if not row:
            continue
        ctxs = dict(contexts_fn(src))
        biases = biases_fn(src)

        # first round: full-matrix score-only per (stored context, target)
        by_frame: dict[int, list] = {}
        for oid, score, context in row:
            q = ctxs.get(context)
            if q is None or len(q) == 0:
                continue
            by_frame.setdefault(context, []).append(oid)
        per_target: dict[int, Hsp] = {}
        for frame, oids in by_frame.items():
            q = ctxs[frame]
            qlen = len(q)
            bias = biases[frame] if cbs_mod.hauser(cfg.comp_based_stats) else None
            jobs = []
            metas = []
            for oid in oids:
                bid = oid2block[oid]
                tgt = final_block.seq(bid)
                tlen = len(tgt)
                if tlen == 0:
                    continue
                jobs.append((tgt, -(tlen - 1), qlen))
                metas.append(bid)
            if not jobs:
                continue
            res = banded_swipe_batch_np(q, bias, jobs, mat.matrix32,
                                        mat.gap_open, mat.gap_extend)
            for (score, mc, mr), bid in zip(res, metas):
                tlen = int(final_block.lengths[bid])
                ev = (float(mat.evalue(score, qlen, tlen)) if score > 0
                      else float("inf"))
                if score > 0 and mat.report_cutoff(score, ev, cfg.max_evalue,
                                                   cfg.min_bit_score):
                    h = Hsp(score=score, evalue=ev,
                            bit_score=float(mat.bitscore(score)),
                            d_begin=-(tlen - 1), d_end=qlen)
                    h.frame = frame
                    prev = per_target.get(bid)
                    if prev is None or h.sort_key() < prev.sort_key():
                        per_target[bid] = h

        aligned = sorted(per_target.items(), key=_target_sort_key(cfg))
        aligned = aligned[: _output_range(aligned, cfg)]

        # second round: traceback on survivors
        matches = []
        tb_by_frame: dict[int, list] = {}
        for bid, h in aligned:
            tb_by_frame.setdefault(h.frame, []).append((bid, h))
        for frame, items in tb_by_frame.items():
            q = ctxs[frame]
            qlen = len(q)
            bias = biases[frame] if cbs_mod.hauser(cfg.comp_based_stats) else None
            frame_survivors = []
            jobs = [(final_block.seq(bid), h.d_begin, h.d_end)
                    for bid, h in items]
            res = banded_swipe_batch_np(q, bias, jobs, mat.matrix32,
                                        mat.gap_open, mat.gap_extend,
                                        traceback=True)
            for (bid, h), r in zip(items, res):
                tlen = int(final_block.lengths[bid])
                ev = float(mat.evalue(r.score, qlen, tlen))
                if not (r.score > 0 and mat.report_cutoff(
                        r.score, ev, cfg.max_evalue, cfg.min_bit_score)):
                    continue
                hsp = Hsp(score=r.score, evalue=ev,
                          bit_score=float(mat.bitscore(r.score)),
                          d_begin=h.d_begin, d_end=h.d_end,
                          query_range=r.query_range,
                          subject_range=r.subject_range,
                          identities=r.identities, mismatches=r.mismatches,
                          positives=r.positives,
                          gap_openings=r.gap_openings, gaps=r.gaps,
                          length=r.length, transcript=r.transcript,
                          backtraced=True)
                hsp.frame = frame
                mm = Match(target_block_id=bid, hsp=[hsp])
                mm.set_filter()
                matches.append(mm)
                # FULL_MATRIX dp_size gate is qlen*tlen (reference
                # gapped_final.cpp add_dp_targets), not banded cells
                if qlen * tlen > MAX_SWIPE_DP:
                    frame_survivors.append((hsp, final_block.seq(bid), bid))
            # large-matrix stats come from the reversed BackwardCell pass
            # (reference swipe_wrapper.cpp:364-430), whose cooptimal-path
            # tie resolution differs from the forward trace walk
            apply_reversed_stats(frame_survivors, q, bias, mat, {})
        _cull_matches(matches, cfg)
        if matches:
            results[src] = matches
    return results
