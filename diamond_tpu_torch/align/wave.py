"""Wave extension driver: cross-query batched DP on the accelerator.

The reference parallelizes extension with a thread pool over query
partitions (reference src/align/align.cpp:203-269).  On TPU the analog is
batching: this driver advances the extension coroutines of a whole wave of
queries in lockstep, pools every coroutine's score-only banded-DP jobs
into one device mega-batch per round (ops/swipe_device.DeviceDP), and
pools the traceback jobs into one cross-query native C++ batch
(banded_swipe_tb_multi) — one host call per wave round instead of one per
query; on the card route the jobs within the device DP's band cap go to
the card instead (ops/traceback_device).  Adjusted-matrix jobs keep their per-job host path (each carries
its own 32x32 matrix).

Output is collected per query id, so ordering (and therefore the byte
output) is identical to the serial driver.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.align.extend import (DpRequest, _run_dp_jobs,
                                      extend_query_gen)
from diamond_tpu_torch.ops.banded_swipe import (banded_swipe_batch_np,
                                          tb_multi_results)
from diamond_tpu_torch.utils.log import ptimer

# ops.swipe_device imports torch: import it only on the device path —
# host-only runs never pay it
def job_fits_device(tlen, d0, d1):
    from diamond_tpu_torch.ops.swipe_device import job_fits_device as f

    return f(tlen, d0, d1)


class _WaveState:
    """Per-wave scratch: the block-aligned int32 bias array consumed by
    the cross-query native traceback batch, plus the fused-round-1
    traceback cache (tb_cache[(qid, tid, d0, d1)] = BandedResult, or
    False when the walk failed and the job must refill)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.bias_all = None
        self.filled = set()
        self.tb_cache = {}

    def fill_bias(self, qid, bias):
        if qid in self.filled:
            return
        self.filled.add(qid)
        if self.bias_all is None:
            self.bias_all = np.zeros(len(self.ctx.query_block.letters),
                                     dtype=np.int32)
        qs = int(self.ctx.query_block.starts[qid])
        self.bias_all[qs : qs + len(bias)] = bias


class _PackedJobs:
    """Flat arrays for a cross-query native DP batch (score or traceback):
    the per-request job lists of a whole wave round packed into the
    (concatenated-targets, offsets, lengths, diagonals) layout the native
    multi-job entry points consume."""

    __slots__ = ("jobs_flat", "n", "t_cat", "t_off", "t_len", "q_off",
                 "q_len", "use_bias", "d_begins", "bands", "bias_base")


def _pack_jobs(items, state):
    """Pack every listed (qid, req, job-indices) into one _PackedJobs.

    items: [(qid, req, job_indices, out)].  Returns None when there are
    no jobs.  Targets that are views into the target block's letters are
    referenced zero-copy (offsets by pointer arithmetic, t_cat IS the
    block array); anything else falls back to an explicit concat."""
    qblock = state.ctx.query_block
    p = _PackedJobs()
    jobs_flat = []   # (qid, k, tgt, d0, d1, use_bias, tid)
    for qid, req, ks, _out in items:
        if req.bias is not None:
            state.fill_bias(qid, req.bias)
        for k in ks:
            t, d0, d1 = req.jobs[k]
            jobs_flat.append((qid, k, t, d0, d1, req.bias is not None,
                              req.job_meta[k][0]))
    p.jobs_flat = jobs_flat
    p.n = n = len(jobs_flat)
    if n == 0:
        return None
    t_len = np.fromiter((len(j[2]) for j in jobs_flat), dtype=np.int64,
                        count=n)
    base = state.ctx.target_block.letters
    base_addr = base.__array_interface__["data"][0]
    t_cat = base
    t_off = np.empty(n, dtype=np.int64)
    for k, j in enumerate(jobs_flat):
        t = j[2]
        a = t.__array_interface__["data"][0] - base_addr
        if 0 <= a <= base.nbytes - len(t) and t.dtype == np.int8:
            t_off[k] = a
        else:
            t_off = None
            break
    if t_off is None:
        t_off = np.zeros(n, dtype=np.int64)
        np.cumsum(t_len[:-1], out=t_off[1:])
        t_cat = np.empty(int(t_len.sum()), dtype=np.int8)
        for k, j in enumerate(jobs_flat):
            t_cat[t_off[k] : t_off[k] + t_len[k]] = np.asarray(
                j[2], dtype=np.int8)
    p.t_cat, p.t_off, p.t_len = t_cat, t_off, t_len
    p.q_off = np.fromiter((int(qblock.starts[j[0]]) for j in jobs_flat),
                          dtype=np.int64, count=n)
    p.q_len = np.fromiter((int(qblock.lengths[j[0]]) for j in jobs_flat),
                          dtype=np.int64, count=n)
    p.use_bias = np.fromiter((j[5] for j in jobs_flat), dtype=np.uint8,
                             count=n)
    p.d_begins = np.fromiter((j[3] for j in jobs_flat), dtype=np.int64,
                             count=n)
    p.bands = np.fromiter((j[4] - j[3] for j in jobs_flat), dtype=np.int64,
                          count=n)
    p.bias_base = state.bias_all if p.use_bias.any() else None
    if p.bias_base is None and p.use_bias.any():
        p.bias_base = np.zeros(len(qblock.letters), dtype=np.int32)
    return p


def _count_cells(p, prefix):
    from diamond_tpu_torch.utils.log import pcount

    j0 = np.maximum(0, -p.d_begins - p.bands + 1)
    j1 = np.minimum(p.t_len, p.q_len - p.d_begins)
    pcount(prefix + "_cells", int((np.maximum(j1 - j0, 0) * p.bands).sum()))
    pcount(prefix + "_jobs", p.n)


def _tb_multi(items, mat, state, device=None):
    """One native DP+traceback call for the std jobs of every traceback
    request in the round.  items: [(qid, req, std_idx, out_list)].
    Returns a set of qids whose batch failed (caller responds None).
    On the card route (device a DeviceDP on one device) the jobs within
    its band cap go to D4 (ops/traceback_device) instead, the rest to the
    native call; results merge in job order."""
    from diamond_tpu_torch import native

    qblock = state.ctx.query_block
    p = _pack_jobs(items, state)
    if p is None:
        return set()
    jobs_flat = p.jobs_flat
    results = [None] * p.n
    ok = np.ones(p.n, dtype=bool)
    card = np.zeros(p.n, dtype=bool)
    if device is not None and device.device is not None:
        from diamond_tpu_torch.ops import traceback_device as tbd

        card = tbd.jobs_fit_device(p.t_len, p.bands)
    for sel, on_card in ((np.flatnonzero(card), True),
                         (np.flatnonzero(~card), False)):
        if not len(sel):
            continue
        sub = _subset(p, sel)
        _count_cells(sub, "ext.tb_card" if on_card else "ext.tb")
        args = (qblock.letters, sub.bias_base, sub.q_off, sub.q_len,
                sub.use_bias, sub.t_cat, sub.t_off, sub.t_len, sub.d_begins,
                sub.bands, mat.matrix32, mat.gap_open + mat.gap_extend,
                mat.gap_extend)
        if on_card:
            with ptimer("ext.tb_card"):
                r = tbd.tb_multi_device(*args, device.device)
        else:
            r = tb_multi_results(*args)
        if r is None:
            return None  # native unavailable: caller uses the per-query path
        _out_arr, stats_arr, res = r
        ok[sel] = stats_arr[:, 11] != 0
        for k, rk in zip(sel, res):
            results[k] = rk
    failed = {jobs_flat[k][0] for k in np.nonzero(~ok)[0]}
    by_req = {}
    for (qid, k, *_rest), res in zip(jobs_flat, results):
        by_req.setdefault(qid, []).append((k, res))
    for qid, req, std_idx, out in items:
        if qid in failed:
            continue
        for k, res in by_req.get(qid, []):
            out[k] = res
    return failed


def _subset(p, sel):
    """The jobs ``sel`` of a _PackedJobs (the letters shared)."""
    s = _PackedJobs()
    s.jobs_flat = [p.jobs_flat[k] for k in sel]
    s.n = len(sel)
    s.t_cat, s.bias_base = p.t_cat, p.bias_base
    for name in ("t_off", "t_len", "q_off", "q_len", "use_bias", "d_begins",
                 "bands"):
        setattr(s, name, getattr(p, name)[sel])
    return s


def _score_multi(items, mat, state):
    """One native score-only DP call for the host-routed std jobs of every
    request in the round.  items: [(qid, req, ks, out)].  Returns False if
    the native library is unavailable (caller falls back per request)."""
    from diamond_tpu_torch import native

    if native.lib() is None:
        return False
    qblock = state.ctx.query_block
    p = _pack_jobs(items, state)
    if p is None:
        return True
    jobs_flat = p.jobs_flat
    _count_cells(p, "ext.score")
    res = native.banded_swipe_score_multi_native(
        qblock.letters, p.bias_base, p.q_off, p.q_len, p.use_bias, p.t_cat,
        p.t_off, p.t_len, p.d_begins, p.bands, mat.matrix32,
        mat.gap_open + mat.gap_extend, mat.gap_extend)
    if res is None:
        return False
    by_req = {}
    for (qid, k, *_rest), row in zip(jobs_flat, res):
        by_req.setdefault(qid, []).append((k, (int(row[0]), int(row[1]),
                                               int(row[2]))))
    for qid, req, ks, out in items:
        for k, v in by_req.get(qid, []):
            out[k] = v
    return True


def _score_multi_fused(items, mat, state):
    """Round-1 host DP with fused trace-plane emission and eager walk.

    One native fill+walk call (banded_swipe_tb_multi) scores every
    host-routed std job AND retains its full traceback result in
    state.tb_cache, so the second (traceback) round becomes a cache
    lookup instead of a DP refill.  The reference refills the winning
    band in its traceback stage (reference gapped_final.cpp:80-158);
    here the round-1 fill pays ~1.3x for mask emission and the refill
    disappears — a net win because most round-1 targets survive to the
    traceback round on typical workloads.  Bit-identical: the mask-
    emitting fill shares the score fill's tie rules, and the walk is
    independent of culling, so a cached result equals what the refill
    would produce.  Returns False when the native library is missing
    (caller falls back to the score-only path)."""
    from diamond_tpu_torch import native

    if native.lib() is None:
        return False
    qblock = state.ctx.query_block
    p = _pack_jobs(items, state)
    if p is None:
        return True
    jobs_flat = p.jobs_flat
    _count_cells(p, "ext.score")
    r = tb_multi_results(
        qblock.letters, p.bias_base, p.q_off, p.q_len, p.use_bias, p.t_cat,
        p.t_off, p.t_len, p.d_begins, p.bands, mat.matrix32,
        mat.gap_open + mat.gap_extend, mat.gap_extend)
    if r is None:
        return False
    out_arr, stats, results = r
    cache = state.tb_cache
    by_req = {}
    for (qid, k, _t, d0, d1, _ub, tid), res, st in zip(jobs_flat, results,
                                                       stats):
        by_req.setdefault(qid, []).append(
            (k, (res.score, res.max_col, res.max_row)))
        if res.score > 0:
            cache[(qid, tid, int(d0), int(d1))] = res if st[11] else False
    for qid, req, ks, out in items:
        for k, v in by_req.get(qid, []):
            out[k] = v
    return True


def _fused_enabled() -> bool:
    import os

    return not os.environ.get("DIAMOND_TPU_NO_FUSED_TB")


def _execute_round(reqs: dict, mat, device,
                   state: _WaveState):
    """Execute one round of DpRequests; returns {qid: response}."""
    responses = {}
    dev_requests = []   # (query, bias, jobs) triples for the device
    dev_scatter = []    # (qid, [job indices])
    tb_items = []       # (qid, req, std_idx, out)
    score_items = []    # (qid, req, host_std_idx, out)
    for qid, r in reqs.items():
        out = [None] * len(r.jobs)
        responses[qid] = out
        if not r.jobs:
            continue
        std = [k for k, (tid, *_rest) in enumerate(r.job_meta)
               if tid not in r.tgt_matrices]
        std_set = set(std)
        adj = [k for k in range(len(r.jobs)) if k not in std_set]
        if r.traceback:
            failed = False
            for k in adj:
                tm = r.tgt_matrices[r.job_meta[k][0]]
                try:
                    res = banded_swipe_batch_np(r.q, None, [r.jobs[k]], tm,
                                                mat.gap_open, mat.gap_extend,
                                                traceback=True)
                except RuntimeError:
                    failed = True
                    break
                out[k] = res[0]
            if failed:
                responses[qid] = None
                continue
            # fused round-1 results: winners' tracebacks are already in
            # the cache; only cache misses (device-scored jobs, failed
            # walks) refill
            cache = state.tb_cache
            miss = []
            for k in std:
                key = (qid, r.job_meta[k][0], int(r.jobs[k][1]),
                       int(r.jobs[k][2]))
                res = cache.pop(key, None)
                if res is not None and res is not False:
                    out[k] = res
                else:
                    miss.append(k)
            if miss:
                tb_items.append((qid, r, miss, out))
            continue
        if device is not None:
            small = [k for k in std
                     if job_fits_device(len(r.jobs[k][0]), r.jobs[k][1],
                                        r.jobs[k][2])]
        else:
            small = []
        small_set = set(small)
        large = [k for k in std if k not in small_set]
        if large:
            score_items.append((qid, r, large, out))
        for k in adj:
            tm = r.tgt_matrices[r.job_meta[k][0]]
            res = banded_swipe_batch_np(r.q, None, [r.jobs[k]], tm,
                                        mat.gap_open, mat.gap_extend,
                                        traceback=False)
            out[k] = res[0]
        if small:
            dev_requests.append((r.q, r.bias, [r.jobs[k] for k in small]))
            dev_scatter.append((qid, small))
    from diamond_tpu_torch.utils.log import ptimer

    if score_items:
        with ptimer("ext.score_multi"):
            if _fused_enabled():
                ok = _score_multi_fused(score_items, mat, state)
            else:
                ok = _score_multi(score_items, mat, state)
        if not ok:
            for qid, r, ks, out in score_items:
                res = banded_swipe_batch_np(r.q, r.bias,
                                            [r.jobs[k] for k in ks],
                                            mat.matrix32, mat.gap_open,
                                            mat.gap_extend, traceback=False)
                for k, v in zip(ks, res):
                    out[k] = v
    if tb_items:
        with ptimer("ext.tb_multi"):
            failed = _tb_multi(tb_items, mat, state, device)
        if failed is None:
            # no native library: per-request host fallback
            for qid, r, _std, _out in tb_items:
                try:
                    responses[qid] = _run_dp_jobs(r.q, r.bias, r.jobs,
                                                  r.job_meta, r.tgt_matrices,
                                                  mat, True)
                except RuntimeError:
                    responses[qid] = None
        else:
            for qid in failed:
                responses[qid] = None
    if dev_requests:
        with ptimer("ext.device_dp"):
            results = device.run_many(dev_requests)
        for (qid, idx), res in zip(dev_scatter, results):
            for k, v in zip(idx, res):
                responses[qid][k] = v
    return responses


def extend_wave(ctx, by_query, qids, device=None):
    """Extend all queries with cross-query batching: device=None runs
    everything through the cross-query native host batches (the wave
    structure amortizes per-call overhead either way).

    Returns {qid: [Match, ...]} — byte-identical to the serial
    extend_query loop (exact int32 device scores, same ordering)."""
    mat = ctx.cfg.matrix
    state = _WaveState(ctx)
    gens = {}
    pending = {}
    results = {}

    def step(qid, send_val):
        try:
            req = gens[qid].send(send_val)
            pending[qid] = req
        except StopIteration as e:
            results[qid] = e.value

    from diamond_tpu_torch.utils.log import ptimer

    with ptimer("ext.gen_first"):
        for qid in qids:
            gens[qid] = extend_query_gen(qid, by_query[qid], ctx)
            step(qid, None)

    while pending:
        current, pending = pending, {}
        with ptimer("wave.round"):
            responses = _execute_round(current, mat, device, state)
        with ptimer("ext.gen_step"):
            for qid in current:
                step(qid, responses[qid])

    return results
