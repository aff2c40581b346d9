"""Full-matrix SWIPE search (--swipe): every query vs every DB sequence.

Reference: src/align/full_db.cpp via extend.cpp:332-333 (full_db_align),
dp/swipe/full_swipe.h.  No seeding — each (query context, target) pair runs
a full Smith-Waterman, implemented as banded SW with the full band
[-(tlen-1), qlen), which computes the identical matrix.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.align.extend import Hsp, Match, _cull_matches, _output_range, _target_sort_key
from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
from diamond_tpu_torch.stats import cbs as cbs_mod


_MESH = None


def _mesh_for(cfg):
    """Cached device mesh for --mesh N sharded scoring (None when off)."""
    global _MESH
    if not getattr(cfg, "mesh_devices", 0):
        return None
    if _MESH is None or len(_MESH) != cfg.mesh_devices:
        from diamond_tpu_torch.parallel.sharded import make_mesh

        _MESH = make_mesh(cfg.mesh_devices)
    return _MESH


# (the device cap lives at ops/swipe_device.FullSweep.MAX_LEN; sequences
# above it take the host striped engine)


def _device_swipe_dispatch(qblock, tblock, cfg):
    """Dispatch the round-1 full-matrix device sweep for EVERY
    (query, target) pair under the device caps, batched across all
    queries with the row-indexed FullSweep kernel (the chip's natural
    --swipe form: 100% DP, the DB letter block device-resident across
    every query's calls).  Returns (q_rows {qi: row}, t_order ndarray,
    pending) or None when no device; pending.wait() yields the
    [nqd, ntd] score matrix — host work runs while the chip computes."""
    from diamond_tpu_torch.utils.device import device_dp_enabled, resolve_device

    if not device_dp_enabled():
        return None
    from diamond_tpu_torch.ops.swipe_device import FullSweep
    from diamond_tpu_torch.stats.cbs import hauser_bias_i8

    m = cfg.matrix
    use_h = cbs_mod.hauser(cfg.comp_based_stats)
    sweep = FullSweep(m.matrix32, m.gap_open, m.gap_extend,
                      device=resolve_device())
    tl = tblock.lengths
    t_order = np.nonzero((tl > 0) & (tl <= FullSweep.MAX_LEN))[0]
    queries = []
    q_rows = {}
    for qi in range(len(qblock)):
        q = qblock.seq(qi)
        qlen = len(q)
        if qlen == 0 or qlen > FullSweep.MAX_ROW_LEN or (q == 23).all():
            continue
        bias = (hauser_bias_i8(q, m.matrix32, m.background_scores)
                if use_h else None)
        q_rows[qi] = len(queries)
        queries.append((q, bias))
    if not queries or not len(t_order):
        return None
    return q_rows, t_order, sweep.dispatch_block(queries, tblock, t_order)


def swipe_all_protein(qblock, tblock, cfg) -> dict:
    """--swipe blastp: every query vs every DB sequence, no seeding
    (reference align/full_db.cpp via extend.cpp:332-333)."""
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.search.pipeline import mask_block
    from diamond_tpu_torch.stats.cbs import hauser_bias_i8
    from diamond_tpu_torch.utils.log import padd, perf_counter

    t0 = perf_counter()
    cfg.matrix.set_db_letters(cfg.db_letters or tblock.n_letters)
    if cfg.masking == "tantan":
        masker = Tantan(cfg.matrix.matrix32)
        mask_block(tblock, masker)
        if qblock is not tblock:
            mask_block(qblock, masker)
    t0 = padd("swipe.mask", t0)
    m = cfg.matrix
    disp = _device_swipe_dispatch(qblock, tblock, cfg)
    t0 = padd("swipe.dispatch", t0)
    host_pre = None
    if disp is not None:
        # host long-sequence tail runs WHILE the chip computes the
        # sweep: every pallas call above is already in flight
        q_rows, t_order, pending = disp
        tlens = tblock.lengths.astype(np.int64)
        in_dev = np.zeros(len(tblock), dtype=bool)
        in_dev[t_order] = True
        tail = np.nonzero(~in_dev & (tlens > 0))[0]
        all_t = np.nonzero(tlens > 0)[0]
        use_h = cbs_mod.hauser(cfg.comp_based_stats)
        host_pre = {}
        for qi in range(len(qblock)):
            q = qblock.seq(qi)
            if len(q) == 0 or (q == 23).all():
                continue
            metas_h = tail if qi in q_rows else all_t
            if len(metas_h) == 0:
                host_pre[qi] = (metas_h, np.zeros(0, dtype=np.int64))
                continue
            bias = (hauser_bias_i8(q, m.matrix32, m.background_scores)
                    if use_h else None)
            jobs = [(tblock.seq(t), -(int(tlens[t]) - 1), len(q))
                    for t in metas_h]
            res_h = banded_swipe_batch_np(q, bias, jobs, m.matrix32,
                                          m.gap_open, m.gap_extend)
            host_pre[qi] = (metas_h, np.fromiter(
                (int(np.asarray(r).flat[0]) for r in res_h),
                dtype=np.int64, count=len(metas_h)))
        padd("swipe.host_tail", t0)
        S = pending.wait()
    t0 = perf_counter()
    results = {}
    for qi in range(len(qblock)):
        q = qblock.seq(qi)
        i8 = hauser_bias_i8(q, m.matrix32, m.background_scores)
        dev_q = None
        if host_pre is not None and qi in host_pre:
            tail_q, tail_scores = host_pre[qi]
            if qi in q_rows:
                dev_q = (t_order, S[q_rows[qi]], tail_q, tail_scores)
            else:
                dev_q = (np.zeros(0, dtype=np.int64),
                         np.zeros(0, dtype=np.int32), tail_q, tail_scores)
        matches = swipe_all_query(
            [(0, q)], len(q), {0: i8}, tblock, cfg, dev_scores=dev_q)
        if matches:
            results[qi] = matches
    padd("swipe.finish", t0)  # e-values, culling, traceback per query
    return results


def swipe_all_query(contexts, source_len, biases, tblock, cfg,
                    dev_scores=None) -> list:
    """contexts: list of (frame, letters) translated/protein query contexts.
    Returns culled Matches with traceback Hsps (frame-aware).

    dev_scores: (t_order, score_row, tail_idx, tail_scores): round-1
    scores precomputed for frame 0 — device sweep scores for t_order
    plus host-computed scores for the long-sequence tail (computed
    while the device sweep was in flight)."""
    mat = cfg.matrix
    n_targets = len(tblock)
    mesh = _mesh_for(cfg)
    tlens_all = tblock.lengths.astype(np.int64)

    # first round: score-only full SW for all (frame, target)
    per_target: dict[int, list] = {}
    for frame, q in contexts:
        qlen = len(q)
        if qlen == 0 or (q == 23).all():
            continue
        bias = biases[frame] if cbs_mod.hauser(cfg.comp_based_stats) else None
        pre = dev_scores if (dev_scores is not None and frame == 0) else None
        if pre is not None:
            t_order, srow, tail, tail_scores = pre
            metas = np.concatenate([t_order, tail])
            scores_a = np.concatenate([np.asarray(srow, dtype=np.int64),
                                       tail_scores])
        elif mesh is not None:
            # device-sharded scoring round: DB shards over the mesh's 'db'
            # axis, per-shard banded SW, all_gather merge — exact int32
            # parity with the host path (parallel/sharded.py)
            from diamond_tpu_torch.parallel.sharded import sharded_full_scores

            metas = np.nonzero(tlens_all > 0)[0]
            scores = sharded_full_scores(mesh, q, bias, tblock, mat.matrix32,
                                         mat.gap_open, mat.gap_extend)
            scores_a = np.asarray([int(scores[t]) for t in metas],
                                  dtype=np.int64)
        else:
            metas = np.nonzero(tlens_all > 0)[0]
            jobs = [(tblock.seq(t), -(int(tlens_all[t]) - 1), qlen)
                    for t in metas]
            res = banded_swipe_batch_np(q, bias, jobs, mat.matrix32,
                                        mat.gap_open, mat.gap_extend)
            scores_a = np.fromiter(
                (int(np.asarray(r).flat[0]) for r in res),
                dtype=np.int64, count=len(metas))
        # vectorized e-value/report-cutoff pass over the whole DB
        # (bit-identical twins; pinned by tests/test_stats.py)
        pos_k = np.nonzero(scores_a > 0)[0]
        if len(pos_k):
            metas_a = np.asarray(metas, dtype=np.int64)
            tlens_a = tblock.lengths.astype(np.int64)[metas_a[pos_k]]
            evs = np.atleast_1d(mat.evalue(scores_a[pos_k], qlen, tlens_a))
            bits = np.atleast_1d(mat.bitscore(scores_a[pos_k]))
            keepm = (bits >= cfg.min_bit_score if cfg.min_bit_score != 0
                     else evs <= cfg.max_evalue)
            for x in np.nonzero(keepm)[0]:
                k = int(pos_k[x])
                t = int(metas[k])
                tlen = int(tlens_a[x])
                h = Hsp(score=int(scores_a[k]), evalue=float(evs[x]),
                        bit_score=float(bits[x]),
                        d_begin=-(tlen - 1), d_end=qlen)
                h.frame = frame
                per_target.setdefault(t, []).append(h)

    # per-target best hsp (max_hsps == 1), culling
    aligned = []
    for t, hsps in per_target.items():
        hsps.sort(key=lambda h: h.sort_key())
        aligned.append((t, hsps[0]))
    aligned.sort(key=_target_sort_key(cfg))
    aligned = aligned[: _output_range(aligned, cfg)]

    # second round: traceback on survivors
    matches = []
    by_frame: dict[int, list] = {}
    for t, h in aligned:
        by_frame.setdefault(h.frame, []).append((t, h))
    results: dict[int, tuple] = {}
    for frame, items in by_frame.items():
        q = dict(contexts)[frame]
        qlen = len(q)
        bias = biases[frame] if cbs_mod.hauser(cfg.comp_based_stats) else None
        jobs = [(tblock.seq(t), h.d_begin, h.d_end) for t, h in items]
        res = banded_swipe_batch_np(q, bias, jobs, mat.matrix32,
                                    mat.gap_open, mat.gap_extend, traceback=True)
        for (t, h), r in zip(items, res):
            tlen = int(tblock.lengths[t])
            ev = float(mat.evalue(r.score, qlen, tlen))
            if not (r.score > 0 and mat.report_cutoff(r.score, ev, cfg.max_evalue,
                                                      cfg.min_bit_score)):
                continue
            hsp = Hsp(score=r.score, evalue=ev,
                      bit_score=float(mat.bitscore(r.score)),
                      d_begin=h.d_begin, d_end=h.d_end,
                      query_range=r.query_range, subject_range=r.subject_range,
                      identities=r.identities, mismatches=r.mismatches,
                      positives=r.positives, gap_openings=r.gap_openings,
                      gaps=r.gaps, length=r.length, transcript=r.transcript,
                      backtraced=True)
            hsp.frame = h.frame
            m = Match(target_block_id=t, hsp=[hsp])
            m.set_filter()
            matches.append(m)
    _cull_matches(matches, cfg)
    # reversed BackwardCell stats for large matrices (stats-only formats
    # report these counts; reference swipe_wrapper.cpp:364-430 — same
    # fixup the seeded pipeline applies in _traceback_round)
    from diamond_tpu_torch.align.extend import apply_reversed_stats

    by_frame2: dict[int, list] = {}
    for m2 in matches:
        by_frame2.setdefault(m2.hsp[0].frame, []).append(m2)
    for frame, ms in by_frame2.items():
        q = dict(contexts)[frame]
        bias = biases[frame] if cbs_mod.hauser(cfg.comp_based_stats) else None
        # FULL_MATRIX bin gate: dp_size = qlen * tlen (reference
        # swipe_wrapper.cpp:77-97; NOT the banded cols*band estimate)
        from diamond_tpu_torch.align.extend import MAX_SWIPE_DP

        survivors = [(m2.hsp[0], tblock.seq(m2.target_block_id),
                      m2.target_block_id) for m2 in ms
                     if len(q) * int(tblock.lengths[m2.target_block_id])
                     > MAX_SWIPE_DP]
        apply_reversed_stats(survivors, q, bias, mat, always=True)
    return matches
