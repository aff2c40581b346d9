"""Extension pipeline: adaptive ranking, banded DP, culling, traceback.

Faithful re-design of the reference extension driver:
  - target grouping and stage-2 score ranking (reference
    src/align/load_hits.h:43-175, extend.cpp:226-344)
  - ungapped x-drop + chaining stage (reference align/ungapped.cpp:62-150)
  - band computation and merging (reference align/gapped_score.cpp:41-160)
  - first-round score-only banded SW, e-value filter, culling
    (reference gapped_score.cpp:185-246, culling.cpp)
  - second-round traceback DP on survivors (reference gapped_final.cpp:80-158)

The banded DP runs through the numpy oracle here; the batched jax/pallas
path plugs in via the same band lists (see diamond_tpu.ops).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.align.chain import ApproxHsp, chain, xdrop_ungapped
from diamond_tpu_torch.align.chaining_graph import chain_graph
from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np, banded_swipe_np
from diamond_tpu_torch.stats import cbs as cbs_mod

MIN_CHUNK_SIZE = 128
MAX_CHUNK_SIZE = 400
UNIFIED_TARGET_LEN = 50
MIN_STEP = 16


def make_multiple(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def ranking_chunk_size(target_count: int, ref_letters: int, max_target_seqs: int,
                       sensitivity_rank: int = 1, toppercent=None) -> int:
    """reference extend.cpp:79-92."""
    default_letters = 800e6 if sensitivity_rank >= 10 else 2e9
    block_mult = max(int(round(ref_letters / default_letters)), 1)
    if toppercent is not None:
        return MIN_CHUNK_SIZE * block_mult
    return max(MIN_CHUNK_SIZE,
               min(make_multiple(max_target_seqs, 32), MAX_CHUNK_SIZE)) * block_mult


def band(query_len: int, mode: str) -> int:
    """Band width by query length (reference gapped_score.cpp:41-71)."""
    if mode == "banded-fast":
        if query_len < 50:
            return 12
        if query_len < 100:
            return 16
        if query_len < 250:
            return 30
        if query_len < 350:
            return 40
        return 64
    else:
        if query_len < 50:
            return 15
        if query_len < 100:
            return 20
        if query_len < 150:
            return 30
        if query_len < 200:
            return 50
        if query_len < 250:
            return 60
        if query_len < 350:
            return 100
        if query_len < 500:
            return 120
        return 150


@dataclass
class Hsp:
    score: int = 0
    evalue: float = float("inf")
    bit_score: float = 0.0
    d_begin: int = 0
    d_end: int = 0
    query_range: tuple = (0, 0)
    subject_range: tuple = (0, 0)
    identities: int = 0
    mismatches: int = 0
    positives: int = 0
    gap_openings: int = 0
    gaps: int = 0
    length: int = 0
    transcript: list | None = None
    backtraced: bool = False
    frame: int = 0
    # counts from the reversed stats pass (reference BackwardCell), used by
    # formats that don't request the transcript (default -f6)
    mismatches_stats: int | None = None
    gap_openings_stats: int | None = None

    def sort_key(self):
        # Hsp::operator< (reference match.h:199-202)
        return (-self.score, self.d_begin, self.query_range[0])


@dataclass
class Match:
    target_block_id: int
    hsp: list = field(default_factory=list)
    filter_evalue: float = float("inf")
    filter_score: int = 0

    def set_filter(self):
        if self.hsp:
            self.filter_evalue = self.hsp[0].evalue
            self.filter_score = self.hsp[0].score
        else:
            self.filter_evalue = float("inf")
            self.filter_score = 0


@dataclass
class SeedHit:
    i: int
    j: int
    score: int
    frame: int = 0

    @property
    def diag(self):
        return self.i - self.j


def load_hits(hits, target_block):
    """Group per-query hits by target (reference load_hits.h:43-139).

    hits: array of (subject_global_pos, seed_offset, score[, frame]) for one
    source query.  Returns (target_ids, seed_hit_groups, target_scores) with
    targets in ascending subject-position order."""
    if len(hits) == 0:
        return [], [], []
    a = np.asarray(hits, dtype=np.int64)  # [N,3/4]: gpos, seed_off, score[, frame]
    if a.shape[1] >= 5:
        a = a[:, :3]  # pipeline-resolved tid/j columns (blastp), not frames
    order = np.lexsort((a[:, 1], a[:, 0]))  # CmpSubject (same query)
    a = a[order]
    t_all, j_all = target_block.global_to_local(a[:, 0])
    has_frame = a.shape[1] > 3
    tids, groups, scores = [], [], []
    cur_t = -1
    for k in range(len(a)):
        t = int(t_all[k])
        if t != cur_t:
            tids.append(t)
            groups.append([])
            scores.append(0)
            cur_t = t
        groups[-1].append(SeedHit(i=int(a[k, 1]), j=int(j_all[k]),
                                  score=int(a[k, 2]),
                                  frame=int(a[k, 3]) if has_frame else 0))
        scores[-1] = max(scores[-1], int(a[k, 2]))
    return tids, groups, scores


class HitArrays:
    """Array form of load_hits for the batched first-round stage: one
    CSR over targets instead of per-target SeedHit object lists (same
    grouping and order as load_hits; reference load_hits.h:43-139)."""

    __slots__ = ("tids", "gstart", "hi", "hj", "hscore", "tscores")

    def __init__(self, tids, gstart, hi, hj, hscore, tscores):
        self.tids = tids
        self.gstart = gstart
        self.hi = hi
        self.hj = hj
        self.hscore = hscore
        self.tscores = tscores

    def group(self, t):
        """Materialize SeedHit objects for target index t (slow paths:
        seed-only matches, gapped filter, Python oracle)."""
        g0, g1 = int(self.gstart[t]), int(self.gstart[t + 1])
        return [SeedHit(i=int(self.hi[k]), j=int(self.hj[k]),
                        score=int(self.hscore[k]), frame=0)
                for k in range(g0, g1)]


def load_hits_arrays(hits, target_block, presorted: bool = False):
    """load_hits as flat CSR arrays (blastp path; no frame column).

    presorted: rows already in (subject_gpos, seed_offset) order — the
    pipeline sorts the whole hit table once with the query as the major
    key, so per-query slices skip this lexsort."""
    if len(hits) == 0:
        return None
    a = np.asarray(hits, dtype=np.int64)
    if not presorted:
        order = np.lexsort((a[:, 1], a[:, 0]))  # CmpSubject (same query)
        a = a[order]
    if presorted and a.shape[1] >= 5:
        # pipeline pre-resolved target ids / local offsets (cols 3/4)
        t_all, j_all = a[:, 3], a[:, 4]
    else:
        t_all, j_all = target_block.global_to_local(a[:, 0])
    change = np.empty(len(a), dtype=bool)
    change[0] = True
    np.not_equal(t_all[1:], t_all[:-1], out=change[1:])
    gidx = np.nonzero(change)[0]
    gstart = np.append(gidx, len(a)).astype(np.int64)
    scores = np.ascontiguousarray(a[:, 2])
    # int64 tids: the native chunk-select stage reads them as int64
    return HitArrays(t_all[gidx].astype(np.int64), gstart,
                     np.ascontiguousarray(a[:, 1]),
                     np.ascontiguousarray(j_all, dtype=np.int64), scores,
                     np.maximum.reduceat(scores, gidx))


def _extend_hits(qpad, use_bias, tpad, hits, m, xdrop):
    """Per-target seed extension loop with the chaining skip rule
    (reference align/ungapped.cpp:62-150).  Batched through one native
    call (xdrop_ungapped_chain) when available; the Python loop below is
    the bit-identical fallback and test oracle."""
    if (len(hits) > 1 and qpad.dtype == np.int8 and tpad.dtype == np.int8
            and getattr(m, "dtype", None) == np.int32):
        from diamond_tpu_torch import native
        from diamond_tpu_torch.align.chain import DiagSegment

        hi = np.fromiter((h.i for h in hits), dtype=np.int64, count=len(hits))
        hj = np.fromiter((h.j for h in hits), dtype=np.int64, count=len(hits))
        r = native.xdrop_chain_native(qpad, use_bias, tpad, hi, hj, m, xdrop)
        if r is not None:
            kept, oi, oj, ol, osc = r
            return [DiagSegment(i=int(oi[k]), j=int(oj[k]), len=int(ol[k]),
                                score=int(osc[k])) for k in range(kept)]
    segments = []
    for h in hits:
        if segments and segments[-1].diag == h.diag and segments[-1].subject_end >= h.j:
            continue
        d = xdrop_ungapped(qpad, use_bias, tpad, h.i, h.j, m, xdrop)
        if d.score > 0:
            segments.append(d)
    return segments


@dataclass
class WorkTarget:
    block_id: int
    hsps: list  # ApproxHsp list (chained)
    ungapped_score: int
    matrix: object = None  # adjusted 32x32 [query, target] or None


def ungapped_stage(query_letters, q_start, bias, target_block, block_id, seed_hits,
                   cfg, query_comp=None, query_true_aa=0,
                   full: bool = False, qlen: int | None = None) -> WorkTarget:
    """x-drop extension + chaining for one target
    (reference align/ungapped.cpp:62-150), plus per-target compositional
    matrix adjustment (reference WorkTarget ctor, ungapped.cpp:44-59).

    full=True: Mode::FULL (reference ungapped.cpp:71-76) — no xdrop or
    chaining, just the max hit score; the DP covers the whole matrix."""
    hits = sorted(seed_hits, key=lambda h: (h.diag, h.j))
    t_start = int(target_block.starts[block_id])
    m = cfg.matrix.matrix32
    use_bias = bias if cbs_mod.hauser(cfg.comp_based_stats) else None

    target_matrix = None
    if cbs_mod.matrix_adjust(cfg.comp_based_stats) and query_comp is not None:
        from diamond_tpu_torch.stats import matrix_adjust as ma

        tlen = int(target_block.lengths[block_id])
        tlet = target_block.letters[t_start : t_start + tlen]
        rule = cbs_mod.adjust_rule(query_comp, query_true_aa,
                                   cfg.comp_based_stats, tlet,
                                   cfg.matrix.background_freqs)
        if rule != ma.RULE_DONT:
            r = cbs_mod.target_matrix(cfg.matrix, query_comp, query_true_aa,
                                      cfg.comp_based_stats, tlet, rule)
            if r is not None:
                target_matrix = r[0]
    if full:
        ungapped_score = max(h.score for h in hits)
        return WorkTarget(block_id=block_id, hsps=None,
                          ungapped_score=ungapped_score, matrix=target_matrix)
    ungapped_score = max(h.score for h in hits)
    qpad_v = query_letters[q_start:]
    tpad_v = target_block.letters[t_start:]
    segments = _extend_hits(qpad_v, use_bias, tpad_v, hits, m, cfg.xdrop_raw)
    tlen_true = int(target_block.lengths[block_id])
    if qlen is None:
        qlen = len(query_letters) - q_start
    hsps = chain_graph(segments, qpad_v, tpad_v, m, cfg.matrix.gap_open,
                       cfg.matrix.gap_extend, query_len=qlen,
                       subject_len=tlen_true)
    return WorkTarget(block_id=block_id, hsps=hsps,
                      ungapped_score=ungapped_score, matrix=target_matrix)


def _target_adjust_matrix(target_block, block_id, cfg, query_comp,
                          query_true_aa):
    """Per-target compositional matrix adjustment (reference WorkTarget
    ctor, ungapped.cpp:44-59); None when the rule says keep the base
    matrix."""
    from diamond_tpu_torch.stats import matrix_adjust as ma

    t_start = int(target_block.starts[block_id])
    tlen = int(target_block.lengths[block_id])
    tlet = target_block.letters[t_start : t_start + tlen]
    rule = cbs_mod.adjust_rule(query_comp, query_true_aa,
                               cfg.comp_based_stats, tlet,
                               cfg.matrix.background_freqs)
    if rule == ma.RULE_DONT:
        return None
    r = cbs_mod.target_matrix(cfg.matrix, query_comp, query_true_aa,
                              cfg.comp_based_stats, tlet, rule)
    return r[0] if r is not None else None


def ungapped_stage_chunk(query_letters, q_start, bias, tblock, ha: HitArrays,
                         chunk, cfg, query_comp=None, query_true_aa=0,
                         qlen: int | None = None):
    """Batched first-round stage over a ranking chunk: one native call
    runs hit sort + x-drop chaining + DiagGraph + HSP merge for every
    chunk target (native/src/chaining.cc ungapped_stage_many); falls back
    to the per-target Python path (the bit-identical oracle) without the
    native library.  Returns [(t, WorkTarget)] in chunk order."""
    from diamond_tpu_torch import native

    if qlen is None:
        qlen = len(query_letters) - q_start
    use_bias = bias if cbs_mod.hauser(cfg.comp_based_stats) else None
    from diamond_tpu_torch.utils.log import ptimer

    r = None
    if native.lib() is not None and chunk:
        with ptimer("ext.un_native"):
            chunk_arr = np.asarray(chunk, dtype=np.int64)
            total = int((ha.gstart[chunk_arr + 1]
                         - ha.gstart[chunk_arr]).sum())
            lens64 = getattr(tblock, "_lengths64", None)
            if lens64 is None or len(lens64) != len(tblock.lengths):
                lens64 = tblock._lengths64 =                     tblock.lengths.astype(np.int64)
            r = native.ungapped_stage_chunk_sel_native(
                query_letters[q_start:], use_bias, tblock.letters,
                chunk_arr, ha.tids, tblock.starts, lens64,
                ha.gstart, ha.hi, ha.hj, ha.hscore,
                cfg.matrix.matrix32, cfg.xdrop_raw, cfg.matrix.gap_open,
                cfg.matrix.gap_extend, qlen, total)
    out = []
    if r is not None:
        usc, out_start, rows = r
        for k, t in enumerate(chunk):
            r0, r1 = int(out_start[k]), int(out_start[k + 1])
            hsps = [ApproxHsp(d_min=int(rows[x, 0]), d_max=int(rows[x, 1]),
                              score=int(rows[x, 2]),
                              query_begin=int(rows[x, 3]),
                              query_end=int(rows[x, 4]),
                              subject_begin=int(rows[x, 5]),
                              subject_end=int(rows[x, 6]))
                    for x in range(r0, r1)]
            if not hsps:
                continue
            matrix = None
            if (cbs_mod.matrix_adjust(cfg.comp_based_stats)
                    and query_comp is not None):
                matrix = _target_adjust_matrix(tblock, int(ha.tids[t]), cfg,
                                               query_comp, query_true_aa)
            out.append((t, WorkTarget(block_id=int(ha.tids[t]), hsps=hsps,
                                      ungapped_score=int(usc[k]),
                                      matrix=matrix)))
        return out
    for t in chunk:
        work = ungapped_stage(query_letters, q_start, bias, tblock,
                              int(ha.tids[t]), ha.group(t), cfg, query_comp,
                              query_true_aa, qlen=qlen)
        if work.hsps:
            out.append((t, work))
    return out


def _csr_take(gstart, chunk, counts, total):
    """Flat indices selecting the CSR rows of `chunk` in order."""
    idx = np.empty(total, dtype=np.int64)
    p = 0
    for t, c in zip(chunk, counts):
        c = int(c)
        g0 = int(gstart[t])
        idx[p : p + c] = np.arange(g0, g0 + c)
        p += c
    return idx


def merged_bands(work: WorkTarget, qlen: int, tlen: int, base_band: int):
    """Band merging (reference gapped_score.cpp:130-180, min_band_overlap=0:
    any overlap merges)."""
    if not work.hsps:
        return []
    hsps = sorted(work.hsps, key=lambda h: (h.d_min, h.d_max))
    out = []
    d0, d1 = None, None
    for h in hsps:
        b0 = max(h.d_min - base_band, -(tlen - 1))
        b1 = min(h.d_max + 1 + base_band, qlen)
        if d0 is not None and min(d1, b1) - max(d0, b0) > 0:
            d0 = min(d0, b0)
            d1 = max(d1, b1)
        else:
            if d0 is not None:
                out.append((d0, d1))
            d0, d1 = b0, b1
    out.append((d0, d1))
    return out



@dataclass
class DpRequest:
    """A batch of banded-DP jobs yielded by the extension coroutine.

    The coroutine protocol lets one driver serve many queries: the direct
    driver (extend_query) executes each request on host immediately; the
    wave driver (align/wave.py) pools score-only requests from a whole
    wave of queries into one device mega-batch — the TPU-native form of
    the reference's thread-parallel align_queries partition (reference
    src/align/align.cpp:203-269)."""
    q: np.ndarray
    bias: np.ndarray | None
    jobs: list            # [(target_letters, d_begin, d_end)]
    job_meta: list        # [(tid, tlen)]
    tgt_matrices: dict    # tid -> adjusted 32x32 matrix
    traceback: bool


def execute_dp_request(req: DpRequest, mat):
    """Host execution of one DpRequest (the direct, single-query driver)."""
    if req.traceback:
        try:
            return _run_dp_jobs(req.q, req.bias, req.jobs, req.job_meta,
                                req.tgt_matrices, mat, True)
        except RuntimeError:
            return None  # rare spill-tie in shared-band masks; use oracle
    return _run_dp_jobs(req.q, req.bias, req.jobs, req.job_meta,
                        req.tgt_matrices, mat, False)


def drive(gen, mat):
    """Run an extension coroutine to completion on host."""
    resp = None
    while True:
        try:
            req = gen.send(resp)
        except StopIteration as e:
            return e.value
        resp = execute_dp_request(req, mat)


def _run_dp_jobs(q, use_bias, jobs, job_meta, tgt_matrices, mat, traceback):
    """Run banded DP jobs, splitting adjusted-matrix targets into their own
    single-job batches (the adjusted matrix replaces the profile and the
    Hauser bias is not applied; reference swipe profile setup,
    banded_swipe.h:252-266).  Every job runs on the host DP: the device
    DP is the wave driver's (align/wave.py)."""
    out = [None] * len(jobs)
    std_idx = [k for k, (tid, _) in enumerate(job_meta) if tid not in tgt_matrices]
    adj_idx = [k for k, (tid, _) in enumerate(job_meta) if tid in tgt_matrices]
    if std_idx:
        std_jobs = [jobs[k] for k in std_idx]
        res = banded_swipe_batch_np(q, use_bias, std_jobs,
                                    mat.matrix32, mat.gap_open,
                                    mat.gap_extend, traceback=traceback)
        for k, r in zip(std_idx, res):
            out[k] = r
    for k in adj_idx:
        tm = tgt_matrices[job_meta[k][0]]
        res = banded_swipe_batch_np(q, None, [jobs[k]], tm,
                                    mat.gap_open, mat.gap_extend,
                                    traceback=traceback)
        out[k] = res[0]
    return out


def extend_query(query_id: int, query_hits, ctx) -> list:
    """Full per-query extension (reference extend.cpp:226-388,
    gapped_final.cpp:80-158).  ctx: PipelineContext."""
    return drive(extend_query_gen(query_id, query_hits, ctx), ctx.cfg.matrix)


def extend_query_gen(query_id: int, query_hits, ctx):
    """Coroutine form of extend_query: yields DpRequest, receives results."""
    cfg = ctx.cfg
    qblock = ctx.query_block
    tblock = ctx.target_block
    q_start = int(qblock.starts[query_id])
    qlen = int(qblock.lengths[query_id])
    query_letters = qblock.letters
    bias = ctx.query_bias(query_id)

    from diamond_tpu_torch.utils.log import ptimer

    # whole-wave precomputed round 1 (pipeline._precompute_round1): the
    # ungapped stage already ran for this query in the batched native
    # call; tids/tscores/worklist come from the global group arrays
    pre = getattr(ctx, "_pre_round1", None)
    prb = pre["bounds"].get(query_id) if pre is not None else None
    if prb is not None:
        p_lo, p_hi = prb
        tids = pre["g_tid"][p_lo:p_hi]
        tscores = pre["g_score"][p_lo:p_hi]
        n = p_hi - p_lo
        ha = None
    else:
        with ptimer("ext.load_hits"):
            ha = load_hits_arrays(query_hits, tblock,
                                  presorted=getattr(ctx, "hits_presorted",
                                                    False))
        if ha is None:
            return []
        tids, tscores = ha.tids, ha.tscores
        n = len(tids)
    if n == 0:
        return []

    if cfg.ext_mode == "none":
        return _seed_only_matches(tids, [ha.group(t) for t in range(n)],
                                  tscores, cfg)

    chunk_size = ranking_chunk_size(n, tblock.n_letters, cfg.max_target_seqs,
                                toppercent=cfg.toppercent)
    order = list(range(n))
    if chunk_size < n:
        order.sort(key=lambda t: (-tscores[t], t))  # TargetScore::operator<

    base_band = band(qlen, cfg.ext_mode)
    mat = cfg.matrix

    gf = None
    if cfg.gapped_filter_evalue > 0.0 and (not cfg.translated or qlen >= 85):
        from diamond_tpu_torch.align.gapped_filter import GappedFilter

        gf_bias = bias if cbs_mod.hauser(cfg.comp_based_stats) else None
        gf = GappedFilter(cfg, query_letters[q_start : q_start + qlen], gf_bias)

    query_comp = None
    query_true_aa = 0
    if cbs_mod.matrix_adjust(cfg.comp_based_stats):
        qseq = query_letters[q_start : q_start + qlen]
        query_comp = cbs_mod.composition(qseq)
        from diamond_tpu_torch.constants.alphabet import TRUE_AA

        query_true_aa = int(((qseq & 31) < TRUE_AA).sum())

    matches: list[Match] = []
    all_matrices: dict = {}
    # reference extend.cpp:272: with HSP filters active (and no --top) the
    # first round only sorts — targets are not cut to max_target_seqs
    # before the filters ran on their tracebacks
    first_round_culling = (not _filters_active(cfg)
                           or cfg.toppercent is not None)
    i0 = 0
    i1 = min(chunk_size, n)
    new_hits_ev = False
    tail_score = 0
    prev_tail = 0

    while True:
        aligned: list[tuple] = []  # (block_id, first-round Hsp)
        while True:
            # --- extend chunk: ungapped + chaining + first-round DP ---
            chunk = order[i0:i1]
            use_bias = bias if cbs_mod.hauser(cfg.comp_based_stats) else None
            q = query_letters[q_start : q_start + qlen]
            jobs = []       # (target_letters, d0, d1)
            job_meta = []   # (tid, tlen)
            if gf is not None:
                chunk = [t for t in chunk if gf.target_passes(
                    ha.group(t), tblock.seq(tids[t]))]
            tgt_matrices = {}
            full = cfg.ext_mode == "full"
            if full:
                worklist = []
                for t in chunk:
                    usc = int(tscores[t])  # max hit score of the group
                    if usc == 0:
                        continue
                    matrix = None
                    if (cbs_mod.matrix_adjust(cfg.comp_based_stats)
                            and query_comp is not None):
                        matrix = _target_adjust_matrix(
                            tblock, int(tids[t]), cfg, query_comp,
                            query_true_aa)
                    worklist.append((t, WorkTarget(
                        block_id=int(tids[t]), hsps=None,
                        ungapped_score=usc, matrix=matrix)))
            elif prb is not None:
                # precomputed whole-wave round 1 covers this (single)
                # chunk: build DP jobs straight from the global rows —
                # the single-HSP band is computed vectorized, only
                # multi-HSP targets walk merged_bands
                o_s, rows = pre["out_start"], pre["rows"]
                with ptimer("ext.bands"):
                    starts_t = o_s[p_lo : p_hi + 1]
                    counts_t = np.diff(starts_t)
                    t_sel = np.nonzero(counts_t)[0]
                    tid_sel = tids[t_sel]
                    tl64 = tblock.lengths
                    tlen_sel = tl64[tid_sel]
                    tst_sel = tblock.starts[tid_sel]
                    first = starts_t[t_sel]
                    b0_a = np.maximum(rows[first, 0] - base_band,
                                      -(tlen_sel - 1))
                    b1_a = np.minimum(rows[first, 1] + 1 + base_band, qlen)
                    letters_t = tblock.letters
                    for x in range(len(t_sel)):
                        t = int(t_sel[x])
                        tid = int(tid_sel[x])
                        tlen = int(tlen_sel[x])
                        ts = int(tst_sel[x])
                        tgt = letters_t[ts : ts + tlen]
                        if counts_t[t] == 1:
                            jobs.append((tgt, int(b0_a[x]), int(b1_a[x])))
                            job_meta.append((tid, tlen))
                            continue
                        r0, r1 = int(starts_t[t]), int(starts_t[t + 1])
                        hsps = [ApproxHsp(d_min=int(rows[y, 0]),
                                          d_max=int(rows[y, 1]),
                                          score=int(rows[y, 2]),
                                          query_begin=int(rows[y, 3]),
                                          query_end=int(rows[y, 4]),
                                          subject_begin=int(rows[y, 5]),
                                          subject_end=int(rows[y, 6]))
                                for y in range(r0, r1)]
                        work = WorkTarget(block_id=tid, hsps=hsps,
                                          ungapped_score=0, matrix=None)
                        for d0, d1 in merged_bands(work, qlen, tlen,
                                                   base_band):
                            jobs.append((tgt, d0, d1))
                            job_meta.append((tid, tlen))
                worklist = []
            else:
                worklist = ungapped_stage_chunk(query_letters, q_start,
                                                bias, tblock, ha, chunk,
                                                cfg, query_comp,
                                                query_true_aa, qlen=qlen)
            with ptimer("ext.bands"):
                for t, work in worklist:
                    tid = int(tids[t])
                    tlen = int(tblock.lengths[tid])
                    t_start = int(tblock.starts[tid])
                    tgt = tblock.letters[t_start : t_start + tlen]
                    if work.matrix is not None:
                        tgt_matrices[tid] = work.matrix
                        all_matrices[tid] = work.matrix
                    if full:
                        jobs.append((tgt, -(tlen - 1), qlen))
                        job_meta.append((tid, tlen))
                        continue
                    for d0, d1 in merged_bands(work, qlen, tlen, base_band):
                        jobs.append((tgt, d0, d1))
                        job_meta.append((tid, tlen))
            v = []
            if jobs:
                res = yield DpRequest(q, use_bias, jobs, job_meta,
                                      tgt_matrices, False)
                with ptimer("ext.postdp"):
                    best_by_tid: dict[int, Hsp] = {}
                    if len(job_meta) >= 16:
                        # vectorized e-value pass (bit-identical twins,
                        # pinned by tests/test_stats.py); worth it only
                        # for target-rich responses
                        nj = len(job_meta)
                        scores_a = np.fromiter((r[0] for r in res),
                                               dtype=np.int64, count=nj)
                        pos = np.nonzero(scores_a > 0)[0]
                        kit = []
                        if len(pos):
                            tlens_a = np.fromiter(
                                (job_meta[int(x)][1] for x in pos),
                                dtype=np.int64, count=len(pos))
                            evs = np.atleast_1d(mat.evalue(
                                scores_a[pos], qlen, tlens_a))
                            bits = np.atleast_1d(mat.bitscore(scores_a[pos]))
                            keepm = (bits >= cfg.min_bit_score
                                     if cfg.min_bit_score != 0
                                     else evs <= cfg.max_evalue)
                            kit = [(int(pos[x]), float(evs[x]),
                                    float(bits[x]))
                                   for x in np.nonzero(keepm)[0]]
                    else:
                        # scalar fast path for the few-job common case
                        kit = []
                        for k, ((tid, tlen), r) in enumerate(
                                zip(job_meta, res)):
                            if r[0] <= 0:
                                continue
                            ev = mat.evalue(r[0], qlen, tlen)
                            if mat.report_cutoff(r[0], ev, cfg.max_evalue,
                                                 cfg.min_bit_score):
                                kit.append((k, ev,
                                            float(mat.bitscore(r[0]))))
                    for k, ev, bits_k in kit:
                        tid, tlen = job_meta[k]
                        score, max_col, max_row = res[k]
                        h = Hsp(score=score, evalue=ev, bit_score=bits_k,
                                d_begin=jobs[k][1], d_end=jobs[k][2],
                                query_range=(0, max_row + 1),
                                subject_range=(0, max_col + 1))
                        prev = best_by_tid.get(tid)
                        if prev is None or h.sort_key() < prev.sort_key():
                            best_by_tid[tid] = h
                    # preserve chunk target order
                    seen = set()
                    for tid, _ in job_meta:
                        if tid in best_by_tid and tid not in seen:
                            v.append((tid, best_by_tid[tid]))
                            seen.add(tid)
            new_hits = len(v) > 0
            new_hits_ev = new_hits_ev or new_hits
            multi_chunk = (i1 - i0) < n
            if multi_chunk:
                new_hits = _append_hits(aligned, v, cfg, mat)
            else:
                aligned = v
            i0 = i1
            i1 += min(chunk_size, n - i1)
            prev_tail = tail_score
            if new_hits and i1 > 0:
                tail_score = tscores[order[i1 - 1]]
            if not (i0 < n and not _ranking_terminate(
                    new_hits, prev_tail, tscores[order[i1 - 1]] if i1 > 0 else 0,
                    cfg, mat)):
                break

        # first-round culling (sort-only when HSP filters defer the cut)
        aligned.sort(key=_target_sort_key(cfg))
        if first_round_culling:
            aligned = aligned[: _output_range(aligned, cfg)]

        # --- second round: traceback DP (reference gapped_final.cpp) ---
        round_matches = yield from _traceback_round(
            aligned, query_letters, q_start, qlen, bias, tblock, ctx,
            all_matrices, query_id=query_id,
            first_round_culling=first_round_culling,
            previous_matches=len(matches))
        matches.extend(round_matches)

        if not (cfg.toppercent is None and len(matches) < cfg.max_target_seqs
                and i0 < n and new_hits_ev):
            break

    _cull_matches(matches, cfg)
    return matches


def _ungapped_stage_translated(contexts, tblock, block_id, seed_hits, cfg):
    """Frame-aware x-drop + chaining for one target (reference
    align/ungapped.cpp:62-118, incl. the translated single-hit shortcut at
    :76-80).  contexts: {frame: (qseq, bias)}.  Returns ({frame: hsps},
    ungapped_score)."""
    from types import SimpleNamespace

    t_start = int(tblock.starts[block_id])
    m = cfg.matrix.matrix32
    use_hauser = cbs_mod.hauser(cfg.comp_based_stats)
    ungapped_score = max(h.score for h in seed_hits)
    if len(seed_hits) == 1:
        h = seed_hits[0]
        hsp = SimpleNamespace(d_min=h.diag, d_max=h.diag, score=h.score)
        return {h.frame: [hsp]}, ungapped_score
    hits = sorted(seed_hits, key=lambda h: (h.diag, h.j))
    segs: dict[int, list] = {}
    for h in hits:
        qpad, bias = contexts[h.frame][2], contexts[h.frame][1]
        fsegs = segs.setdefault(h.frame, [])
        if fsegs and fsegs[-1].diag == h.diag and fsegs[-1].subject_end >= h.j:
            continue
        d = xdrop_ungapped(qpad, bias if use_hauser else None,
                           tblock.letters[t_start:], h.i, h.j, m,
                           cfg.xdrop_raw)
        if d.score > 0:
            fsegs.append(d)
    out = {}
    tlen_true = int(tblock.lengths[block_id])
    for frame, fsegs in segs.items():
        hsps = chain_graph(fsegs, contexts[frame][2],
                           tblock.letters[t_start:], m,
                           cfg.matrix.gap_open, cfg.matrix.gap_extend,
                           query_len=len(contexts[frame][0]),
                           subject_len=tlen_true)
        if hsps:
            out[frame] = hsps
    return out, ungapped_score


def extend_query_translated(source_idx, query_hits, queries, tblock, cfg):
    """Per-source-query extension over 6 translated contexts (reference
    extend.cpp with align_mode.query_contexts = 6).

    query_hits: list of (subject_gpos, seed_offset, stage2_score, frame).
    queries: TranslatedQueries."""
    from diamond_tpu_torch.stats.cbs import hauser_bias_i8

    mat = cfg.matrix
    contexts = {}  # frame -> (qseq, bias, qseq_padded_view)
    for f, q in queries.contexts(source_idx):
        if len(q) == 0:
            continue
        i8 = hauser_bias_i8(q, mat.matrix32, mat.background_scores)
        cid = source_idx * 6 + f
        start = int(queries.block.starts[cid])
        contexts[f] = (q, i8, queries.block.letters[start:])

    tids, groups, tscores = load_hits(query_hits, tblock)
    n = len(tids)
    if n == 0:
        return []

    chunk_size = ranking_chunk_size(n, tblock.n_letters, cfg.max_target_seqs,
                                    toppercent=cfg.toppercent)
    order = list(range(n))
    if chunk_size < n:
        order.sort(key=lambda t: (-tscores[t], t))

    matches: list[Match] = []
    i0 = 0
    i1 = min(chunk_size, n)
    new_hits_ev = False
    tail_score = 0
    prev_tail = 0

    while True:
        aligned: list[tuple] = []  # (block_id, frame, first-round Hsp)
        while True:
            chunk = order[i0:i1]
            jobs = []
            job_meta = []  # (tid, tlen, frame)
            for t in chunk:
                hsps_by_frame, _ = _ungapped_stage_translated(
                    contexts, tblock, tids[t], groups[t], cfg)
                if not hsps_by_frame:
                    continue
                tlen = int(tblock.lengths[tids[t]])
                t_start = int(tblock.starts[tids[t]])
                tgt = tblock.letters[t_start : t_start + tlen]
                for frame, hsps in hsps_by_frame.items():
                    qlen_f = len(contexts[frame][0])
                    base_band = band(qlen_f, cfg.ext_mode)
                    work = WorkTarget(block_id=tids[t], hsps=hsps,
                                      ungapped_score=0)
                    for d0, d1 in merged_bands(work, qlen_f, tlen, base_band):
                        jobs.append((tgt, d0, d1))
                        job_meta.append((tids[t], tlen, frame))
            v = []
            if jobs:
                use_h = cbs_mod.hauser(cfg.comp_based_stats)
                best_by_tid: dict[int, Hsp] = {}
                # batch DP per frame
                by_frame: dict[int, list] = {}
                for k, (tid, tlen, frame) in enumerate(job_meta):
                    by_frame.setdefault(frame, []).append(k)
                res = [None] * len(jobs)
                for frame, ks in by_frame.items():
                    q, bias, _ = contexts[frame]
                    r = banded_swipe_batch_np(
                        q, bias if use_h else None, [jobs[k] for k in ks],
                        mat.matrix32, mat.gap_open, mat.gap_extend,
                        traceback=False)
                    for k, rr in zip(ks, r):
                        res[k] = rr
                for k, ((tid, tlen, frame), (score, max_col, max_row)) in \
                        enumerate(zip(job_meta, res)):
                    qlen_f = len(contexts[frame][0])
                    ev = (float(mat.evalue(score, qlen_f, tlen))
                          if score > 0 else float("inf"))
                    if score > 0 and mat.report_cutoff(
                            score, ev, cfg.max_evalue, cfg.min_bit_score):
                        h = Hsp(score=score, evalue=ev,
                                bit_score=float(mat.bitscore(score)),
                                d_begin=jobs[k][1], d_end=jobs[k][2],
                                query_range=(0, max_row + 1),
                                subject_range=(0, max_col + 1))
                        h.frame = frame
                        prev = best_by_tid.get(tid)
                        if prev is None or h.sort_key() < prev.sort_key():
                            best_by_tid[tid] = h
                seen = set()
                for tid, _, _ in job_meta:
                    if tid in best_by_tid and tid not in seen:
                        v.append((tid, best_by_tid[tid]))
                        seen.add(tid)
            new_hits = len(v) > 0
            new_hits_ev = new_hits_ev or new_hits
            multi_chunk = (i1 - i0) < n
            if multi_chunk:
                new_hits = _append_hits(aligned, v, cfg, mat)
            else:
                aligned = v
            i0 = i1
            i1 += min(chunk_size, n - i1)
            prev_tail = tail_score
            if new_hits and i1 > 0:
                tail_score = tscores[order[i1 - 1]]
            if not (i0 < n and not _ranking_terminate(
                    new_hits, prev_tail, tscores[order[i1 - 1]] if i1 > 0 else 0,
                    cfg, mat)):
                break

        aligned.sort(key=_target_sort_key(cfg))
        aligned = aligned[: _output_range(aligned, cfg)]

        # second round: traceback per frame
        round_matches = []
        use_h = cbs_mod.hauser(cfg.comp_based_stats)
        for block_id, first_hsp in aligned:
            frame = first_hsp.frame
            q, bias, _ = contexts[frame]
            qlen_f = len(q)
            tlen = int(tblock.lengths[block_id])
            t_start = int(tblock.starts[block_id])
            tgt = tblock.letters[t_start : t_start + tlen]
            r = banded_swipe_np(q, tgt, first_hsp.d_begin, first_hsp.d_end,
                                mat.matrix32, bias if use_h else None,
                                mat.gap_open, mat.gap_extend, traceback=True)
            ev = float(mat.evalue(r.score, qlen_f, tlen))
            if not (r.score > 0 and mat.report_cutoff(
                    r.score, ev, cfg.max_evalue, cfg.min_bit_score)):
                continue
            h = Hsp(score=r.score, evalue=ev,
                    bit_score=float(mat.bitscore(r.score)),
                    d_begin=first_hsp.d_begin, d_end=first_hsp.d_end,
                    query_range=r.query_range, subject_range=r.subject_range,
                    identities=r.identities, mismatches=r.mismatches,
                    positives=r.positives, gap_openings=r.gap_openings,
                    gaps=r.gaps, length=r.length, transcript=r.transcript,
                    backtraced=True)
            h.frame = frame
            if _filters_active(cfg):
                from diamond_tpu_torch.data.translate import absolute_interval

                dna_len = queries.dna_lens[source_idx]
                src = absolute_interval(r.query_range[0], r.query_range[1],
                                        frame, dna_len)
                if not hsp_passes_filters(h, dna_len, tlen, cfg,
                                          query_range_source=src):
                    continue
            m = Match(target_block_id=block_id, hsp=[h])
            m.set_filter()
            round_matches.append(m)
        _cull_matches(round_matches, cfg)
        matches.extend(round_matches)

        if not (cfg.toppercent is None and len(matches) < cfg.max_target_seqs
                and i0 < n and new_hits_ev):
            break

    _cull_matches(matches, cfg)
    return matches


def _seed_only_matches(tids, groups, tscores, cfg):
    """--ext none: report raw seed positions (reference extend.cpp:137-166
    seed_only_hsp/seed_only_matches: unit query/subject ranges, evalue 0,
    stat fields blank in tabular output)."""
    order = sorted(range(len(tids)), key=lambda t: (-tscores[t], t))
    matches = []
    for t in order:
        hsps = []
        for hit in groups[t]:
            h = Hsp(score=hit.score, evalue=0.0,
                    d_begin=hit.diag, d_end=hit.diag,
                    query_range=(hit.i, hit.i + 1),
                    subject_range=(hit.j, hit.j + 1))
            h.seed_only = True
            h.frame = hit.frame
            hsps.append(h)
        hsps.sort(key=lambda h: h.sort_key())
        if cfg.max_hsps > 0:
            hsps = hsps[: cfg.max_hsps]
        m = Match(target_block_id=tids[t], hsp=hsps)
        m.filter_evalue = 0.0
        m.filter_score = tscores[t]
        matches.append(m)
    _cull_matches(matches, cfg)
    return matches


def _ranking_terminate(new_hits, last_tail, tail, cfg, mat) -> bool:
    if new_hits:
        return False
    return (last_tail == 0
            or (tail / last_tail) <= cfg.ranking_score_drop_factor
            or float(mat.bitscore(tail)) < cfg.ranking_cutoff_bitscore)


def _top_cutoff_score(top_score, toppercent):
    """reference basic/config.h:453-455."""
    return (1.0 - toppercent / 100.0) * top_score


def _output_range(sorted_targets, cfg) -> int:
    """reference culling.cpp:95-114."""
    nt = len(sorted_targets)
    if nt == 0:
        return 0
    if sorted_targets[0][1].evalue == float("inf"):
        return 0
    if cfg.toppercent is not None:
        mat = cfg.matrix
        cutoff = max(_top_cutoff_score(
            float(mat.bitscore(sorted_targets[0][1].score)), cfg.toppercent), 1.0)
        i = 0
        while i < nt and float(mat.bitscore(sorted_targets[i][1].score)) >= cutoff:
            i += 1
        return i
    i = min(cfg.max_target_seqs, nt)
    while i > 1 and sorted_targets[i - 1][1].evalue == float("inf"):
        i -= 1
    return i


def _target_sort_key(cfg):
    if cfg.toppercent is not None:
        return lambda th: (-th[1].score, th[0])
    return lambda th: (th[1].evalue, -th[1].score, th[0])


def _append_hits(targets: list, new: list, cfg, mat) -> bool:
    """reference culling.cpp:116-139."""
    if not new:
        return False
    new_hits = cfg.toppercent is None and len(targets) < cfg.max_target_seqs
    append = new_hits
    targets.sort(key=_target_sort_key(cfg))
    if not append:
        del targets[_output_range(targets, cfg):]
    rng = _output_range(targets, cfg)
    if not targets:
        append = new_hits = True
    elif cfg.toppercent is None:
        min_evalue = min(h.evalue for _, h in new)
        if rng > 0 and min_evalue <= targets[rng - 1][1].evalue:
            append = new_hits = True
    else:
        max_score = max(h.score for _, h in new)
        if rng > 0 and max_score >= _top_cutoff_score(
                targets[rng - 1][1].score, cfg.toppercent):
            append = new_hits = True
    if append:
        targets.extend(new)
    return new_hits


def _reverse_pass_stats(q, use_bias, tgt, d_begin, d_end, fwd, tm,
                        gap_open, gap_extend):
    """Reversed-DP mismatch/gap-open counts (reference
    swipe_wrapper.cpp:364-430 recompute_reversed + stat_cell.h BackwardCell):
    the reference reports mismatches/gap openings from a stats pass over the
    reversed query and reversed target prefix, whose stat blending keeps
    already-held values on ties — a different cooptimal path than the
    trace-mask walk.  The reversed pass's end cell is the forward
    alignment's start cell.  Returns (score, mismatch, gapopen) or None."""
    from diamond_tpu_torch.ops.banded_swipe import backward_stats_np

    qlen = len(q)
    send = fwd.subject_range[1]
    q_rev = np.ascontiguousarray(q[::-1])
    t_rev = np.ascontiguousarray(tgt[:send][::-1])
    b_rev = None if use_bias is None else np.ascontiguousarray(use_bias[::-1])
    d0 = qlen - send - (d_end - 1)
    d1 = qlen - send - d_begin + 1
    i_end = qlen - 1 - fwd.query_range[0]
    j_end = send - 1 - fwd.subject_range[0]
    return backward_stats_np(q_rev, t_rev, d0, d1, tm, b_rev, gap_open,
                             gap_extend, i_end, j_end)


def hsp_passes_filters(h, query_source_len: int, tlen: int, cfg,
                       q_title=None, t_title=None, q_seq=None, t_seq=None,
                       query_range_source=None) -> bool:
    """Per-HSP output filters (reference align/culling.cpp:155-169
    filter_hsp): --id, --query-cover, --subject-cover, --no-self-hits."""
    if cfg.min_id > 0 and h.identities * 100.0 / h.length < cfg.min_id:
        return False
    if cfg.approx_min_id > 0:
        from diamond_tpu_torch.cluster.realign import approx_id

        qr = h.query_range
        sr = h.subject_range
        ident = (q_seq is not None and t_seq is not None
                 and qr[1] - qr[0] == sr[1] - sr[0]
                 and np.array_equal(np.asarray(q_seq)[qr[0]:qr[1]] & 31,
                                    np.asarray(t_seq)[sr[0]:sr[1]] & 31))
        aid = 100.0 if ident else approx_id(h.score, qr[1] - qr[0],
                                            sr[1] - sr[0])
        if aid < cfg.approx_min_id:
            return False
    if cfg.query_cover > 0:
        qr = query_range_source or h.query_range
        if (qr[1] - qr[0]) * 100.0 / query_source_len < cfg.query_cover:
            return False
    if cfg.subject_cover > 0:
        if (h.subject_range[1] - h.subject_range[0]) * 100.0 / tlen \
                < cfg.subject_cover:
            return False
    if getattr(cfg, "no_self_hits", False) and q_title is not None \
            and q_title == t_title and len(q_seq) == len(t_seq) \
            and (np.asarray(q_seq) == np.asarray(t_seq)).all():
        return False
    return True


def _filters_active(cfg) -> bool:
    return (cfg.min_id > 0 or cfg.approx_min_id > 0 or cfg.query_cover > 0
            or cfg.subject_cover > 0 or getattr(cfg, "no_self_hits", False))


MAX_SWIPE_DP = 1_000_000  # reference --max-swipe-dp default (config.cpp:595)


def _banded_cols(qlen: int, tlen: int, d_begin: int, d_end: int) -> int:
    """reference dp/dp.h:47-52 DpTarget::banded_cols."""
    pos = max(d_end - 1, 0) - (d_end - 1)
    j1 = min(qlen - 1 - d_begin, tlen - 1) + 1
    return j1 - pos


def apply_reversed_stats(survivors, q, use_bias, mat, matrices=None,
                         always=False):
    """Set mismatches_stats/gap_openings_stats on each surviving Hsp from
    the reference's reversed BackwardCell pass (reference
    swipe_wrapper.cpp:364-430 recompute_reversed): stats-only formats on
    LARGE matrices (dp_size > --max-swipe-dp, reference
    swipe_wrapper.cpp:77-97 bin()) report these counts, whose
    cooptimal-path tie resolution differs from the forward trace-mask
    walk; small matrices run the trace-mask walk even for stats-only
    formats, so the walk's counts stand.  survivors: [(hsp,
    target_letters, block_id)].  Native batch with Python-oracle
    fallback; a reversed best that misses the forward score keeps the
    walk's counts (defensive — should not happen)."""
    if not survivors:
        return
    qlen = len(q)
    if not always:
        survivors = [
            (h, t, bid) for h, t, bid in survivors
            if (_banded_cols(qlen, len(t), h.d_begin, h.d_end)
                * (h.d_end - h.d_begin)) > MAX_SWIPE_DP]
    if not survivors:
        return
    from diamond_tpu_torch import native
    from diamond_tpu_torch.ops.banded_swipe import backward_stats_pass_np

    matrices = matrices or {}
    std = [(h, t) for h, t, bid in survivors if bid not in matrices]
    adj = [(h, t, bid) for h, t, bid in survivors if bid in matrices]
    go, ge = mat.gap_open, mat.gap_extend
    if std and native.lib() is not None:
        n = len(std)
        q8 = np.ascontiguousarray(q, dtype=np.int8)
        bias32 = (np.ascontiguousarray(use_bias, dtype=np.int32)
                  if use_bias is not None else None)
        q_off = np.zeros(n, dtype=np.int64)
        q_len = np.full(n, len(q), dtype=np.int64)
        ub = np.full(n, 1 if use_bias is not None else 0, dtype=np.uint8)
        send = np.fromiter((h.subject_range[1] for h, _ in std),
                           dtype=np.int64, count=n)
        t_len = send
        t_off = np.zeros(n, dtype=np.int64)
        np.cumsum(t_len[:-1], out=t_off[1:])
        t_cat = np.empty(int(t_len.sum()), dtype=np.int8)
        for k, (h, t) in enumerate(std):
            t_cat[t_off[k] : t_off[k] + t_len[k]] = \
                np.asarray(t[: t_len[k]], dtype=np.int8)
        d0 = np.fromiter((h.d_begin for h, _ in std), dtype=np.int64,
                         count=n)
        d1 = np.fromiter((h.d_end for h, _ in std), dtype=np.int64, count=n)
        res = native.backward_stats_native(q8, bias32, q_off, q_len, ub,
                                           t_cat, t_off, send, d0, d1,
                                           mat.matrix32, go + ge, ge)
        if res is not None:
            for k, (h, _) in enumerate(std):
                if int(res[k, 0]) == h.score:
                    h.mismatches_stats = int(res[k, 1])
                    h.gap_openings_stats = int(res[k, 2])
            std = []
    for h, t in std:
        r = backward_stats_pass_np(q, use_bias, t, h.subject_range[1],
                                   h.d_begin, h.d_end, mat.matrix32, go, ge)
        if r[0] == h.score:
            h.mismatches_stats = r[1]
            h.gap_openings_stats = r[2]
    for h, t, bid in adj:
        r = backward_stats_pass_np(q, None, t, h.subject_range[1],
                                   h.d_begin, h.d_end, matrices[bid], go, ge)
        if r[0] == h.score:
            h.mismatches_stats = r[1]
            h.gap_openings_stats = r[2]


def _traceback_round(aligned, query_letters, q_start, qlen, bias, tblock, ctx,
                     matrices=None, query_id=None, first_round_culling=True,
                     previous_matches=0):
    """Second-round traceback DP (reference gapped_final.cpp align()).

    Each target arrives with its single round-1 best band (round-1
    inner_culling already selected it); the traceback aligns that band and
    the per-HSP output filters run on the result — a failing alignment
    drops the whole target, it does NOT fall back to another band.  When
    HSP filters deferred the first-round cut, targets are traced in steps
    of >=16 and culled between steps until max_target_seqs matches
    survive (reference gapped_final.cpp:104-154)."""
    cfg = ctx.cfg
    mat = cfg.matrix
    filt = _filters_active(cfg)
    q_title = ctx.query_block.ids[query_id] if query_id is not None else None
    out = []
    matrices = matrices or {}
    use_bias = bias if cbs_mod.hauser(cfg.comp_based_stats) else None
    q = query_letters[q_start : q_start + qlen]
    from diamond_tpu_torch.utils.log import ptimer

    MIN_STEP = 16
    stepped = not first_round_culling and cfg.toppercent is None
    pos = 0
    while pos < len(aligned):
        if stepped:
            want = max(cfg.max_target_seqs - len(out), MIN_STEP)
            step = min(-(-want // MIN_STEP) * MIN_STEP, len(aligned) - pos)
        else:
            step = len(aligned)
        batch = aligned[pos : pos + step]
        pos += step
        jobs = []
        job_meta = []
        with ptimer("ext.tbjobs"):
            for block_id, first_hsp in batch:
                tlen = int(tblock.lengths[block_id])
                t_start = int(tblock.starts[block_id])
                # the round-1 best cell pins the alignment end: columns
                # past it cannot change the walk (first-column-strictly-
                # greater keeps the earlier cooptimal end), so the
                # traceback DP stops there
                t_cut = min(tlen, int(first_hsp.subject_range[1])) or tlen
                jobs.append((tblock.letters[t_start : t_start + t_cut],
                             first_hsp.d_begin, first_hsp.d_end))
                job_meta.append((block_id, tlen))
        batch_res = yield DpRequest(q, use_bias, jobs, job_meta, matrices,
                                    True)
        with ptimer("ext.tbparse"):
            if batch_res is not None:
                res_list = batch_res
            else:
                res_list = [banded_swipe_np(
                    q, jobs[k][0], fh.d_begin, fh.d_end,
                    matrices.get(bid, mat.matrix32),
                    None if bid in matrices else use_bias,
                    mat.gap_open, mat.gap_extend, traceback=True)
                    for k, (bid, fh) in enumerate(batch)]
            for k, (block_id, first_hsp) in enumerate(batch):
                tlen = int(job_meta[k][1])
                r = res_list[k]
                # round-1 already evaluated this (score, qlen, tlen):
                # the traceback score equals the round-1 band score, so
                # its e-value/bitscore carry over (guarded exactly)
                if r.score == first_hsp.score:
                    ev = first_hsp.evalue
                    bits = first_hsp.bit_score
                else:
                    ev = float(mat.evalue(r.score, qlen, tlen))
                    bits = float(mat.bitscore(r.score))
                if not (r.score > 0 and mat.report_cutoff(
                        r.score, ev, cfg.max_evalue, cfg.min_bit_score)):
                    continue
                h = Hsp(score=r.score, evalue=ev,
                        bit_score=bits,
                        d_begin=first_hsp.d_begin, d_end=first_hsp.d_end,
                        query_range=r.query_range,
                        subject_range=r.subject_range,
                        identities=r.identities, mismatches=r.mismatches,
                        positives=r.positives, gap_openings=r.gap_openings,
                        gaps=r.gaps, length=r.length, transcript=r.transcript,
                        backtraced=True)
                t_start = int(tblock.starts[block_id])
                t_full = tblock.letters[t_start : t_start + tlen]
                if filt and not hsp_passes_filters(
                        h, qlen, tlen, cfg, q_title=q_title,
                        t_title=tblock.ids[block_id], q_seq=q,
                        t_seq=t_full):
                    continue
                m = Match(target_block_id=block_id, hsp=[h])
                m.set_filter()
                out.append(m)
        _cull_matches(out, cfg)
        if stepped and len(out) + previous_matches >= cfg.max_target_seqs:
            break
    # reversed-DP stats fixup only for the matches that survived culling
    survivors = []
    for m in out:
        bid = m.target_block_id
        t_start = int(tblock.starts[bid])
        tlen = int(tblock.lengths[bid])
        survivors.append((m.hsp[0], tblock.letters[t_start : t_start + tlen],
                          bid))
    apply_reversed_stats(survivors, q, use_bias, mat, matrices)
    return out


def _cull_matches(matches: list, cfg):
    if cfg.toppercent is not None:
        matches.sort(key=lambda m: (-m.filter_score, m.target_block_id))
    else:
        matches.sort(key=lambda m: (m.filter_evalue, -m.filter_score,
                                    m.target_block_id))
    nt = len(matches)
    if nt == 0:
        return
    if matches[0].filter_evalue == float("inf"):
        del matches[:]
        return
    if cfg.toppercent is not None:
        mat = cfg.matrix
        cutoff = max(_top_cutoff_score(
            float(mat.bitscore(matches[0].filter_score)), cfg.toppercent), 1.0)
        i = 0
        while i < nt and float(mat.bitscore(matches[i].filter_score)) >= cutoff:
            i += 1
        del matches[i:]
        return
    i = min(cfg.max_target_seqs, nt)
    while i > 1 and matches[i - 1].filter_evalue == float("inf"):
        i -= 1
    del matches[i:]
