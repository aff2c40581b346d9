"""Frameshift (-F) extension pipeline: the reference's legacy QueryMapper
path with 3-frame banded SWIPE per strand, plus query-range culling
(--range-culling / --long-reads).

Reference: src/align/legacy/query_mapper.cpp (seed-hit x-drop, target
grouping, rank_targets, score_only_culling, generate_output ordering),
src/align/legacy/banded_swipe_pipeline.cpp (band construction per strand,
range_ranking, score-only + traceback swipes), src/output/target_culling.h
(GlobalCulling/RangeCulling), src/util/geo/interval_partition.h.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.align.chain import xdrop_ungapped
from diamond_tpu_torch.align.extend import Hsp, Match
from types import SimpleNamespace

from diamond_tpu_torch.ops.swipe3 import banded_3frame_swipe_np

PADDING = 32            # config.padding default for this pipeline
WINDOW_LETTERS = 1 << 24  # target letters of one window's score-only jobs
RANK_RATIO = 0.4        # config.rank_ratio default (-1 -> 0.4)
RANK_FACTOR = 1e3       # config.rank_factor default (-1 -> 1e3)
COV_INCLUDE_CUTOFF = 0.1


# ---------------------------------------------------------------------------
# IntervalPartition (reference util/geo/interval_partition.h)
# ---------------------------------------------------------------------------

INF = float("inf")


class IntervalPartition:
    """Breakpoint map of (count, min_score, max_score) interval nodes."""

    def __init__(self, cap: int):
        self.cap = cap
        self.keys = [0]
        self.nodes = [(0, 1 << 62, 0)]  # (count, min_score, max_score)

    def _split(self, x: int):
        i = bisect.bisect_right(self.keys, x) - 1
        if self.keys[i] != x:
            self.keys.insert(i + 1, x)
            self.nodes.insert(i + 1, self.nodes[i])

    def insert(self, begin: int, end: int, score: int):
        if end <= begin:
            return
        self._split(begin)
        self._split(end)
        i = bisect.bisect_left(self.keys, begin)
        while i < len(self.keys) and self.keys[i] < end:
            c, mn, mx = self.nodes[i]
            self.nodes[i] = (c + 1, min(mn, score) if c < self.cap else mn,
                             max(mx, score))
            i += 1

    def _iter_over(self, begin: int, end: int):
        i = bisect.bisect_right(self.keys, begin) - 1
        while i < len(self.keys) and self.keys[i] < end:
            seg_b = self.keys[i]
            seg_e = self.keys[i + 1] if i + 1 < len(self.keys) else 1 << 62
            yield max(seg_b, begin), min(seg_e, end), self.nodes[i]
            i += 1

    def covered(self, begin: int, end: int) -> int:
        c = 0
        for b, e, (count, mn, mx) in self._iter_over(begin, end):
            if count >= self.cap and e > b:
                c += e - b
        return c

    def covered_min_score(self, begin: int, end: int, min_score: int) -> int:
        c = 0
        for b, e, (count, mn, mx) in self._iter_over(begin, end):
            if count >= self.cap and mn >= min_score and e > b:
                c += e - b
        return c

    def covered_max_score(self, begin: int, end: int, max_score: int) -> int:
        c = 0
        for b, e, (count, mn, mx) in self._iter_over(begin, end):
            if mx >= max_score and e > b:
                c += e - b
        return c


# ---------------------------------------------------------------------------
# target model
# ---------------------------------------------------------------------------

@dataclass
class FsSeedHit:
    frame: int      # 0..5
    i: int          # query pos, frame coords
    j: int          # subject pos
    score: int      # ungapped x-drop score

    @property
    def diag(self):
        return self.i - self.j

    @property
    def strand(self):
        return 0 if self.frame < 3 else 1


@dataclass
class FsTarget:
    block_id: int
    hits: list
    top_hit: FsSeedHit = None
    filter_score: int = 0
    filter_evalue: float = INF
    hsps: list = field(default_factory=list)

    def ungapped_query_range(self, tlen: int, frame_lens, dna_len: int):
        """reference banded_swipe_pipeline.cpp:49-56."""
        h = self.top_hit
        f = h.frame
        i0 = max(h.i - h.j, 0)
        i1 = min(h.i + tlen - h.j, frame_lens[f])
        return _absolute_interval(i0, i1, f, dna_len)


def _absolute_interval(i0, i1, frame, dna_len):
    """Proper source-coordinate interval for frame positions [i0, i1)."""
    strand, off = frame // 3, frame % 3
    a, b = i0 * 3 + off, i1 * 3 + off
    if strand == 0:
        return (a, b)
    return (dna_len - b, dna_len - a)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def extend_block_frameshift(reads, queries, tblock, cfg):
    """reads: [(source_idx, query_hits)] in output order, query_hits
    [(subject_gpos, seed_offset, stage2_score, frame 0-5)].  Returns
    {source_idx: culled [Match] in output order} of the reads with matches.

    Reads go through in windows (``_windows``): every read of a window runs
    steps 1-2 and builds its score-only work, the window's jobs on the card
    go to one swipe3_scores call (one launch per band class), then each
    read finishes (steps 3-6) in order."""
    prepared = ((sidx, _prepare_frameshift(sidx, hits, queries, tblock, cfg))
                for sidx, hits in reads)
    out = {}
    for window in _windows(prepared, lambda x: _work_letters(x[1])):
        live = [(sidx, fq) for sidx, fq in window if fq is not None]
        scores = _device_swipe3_scores(
            [(fq.work, fq.frames) for _, fq in live], cfg)
        for (sidx, fq), dev_scores in zip(live, scores):
            m = _finish_frameshift(fq, tblock, cfg, dev_scores)
            if m:
                out[sidx] = m
    return out


def _work_letters(fq):
    """Target letters of a prepared read's score-only jobs."""
    return sum(len(w[1]) for w in fq.work or ()) if fq is not None else 0


def _windows(items, size):
    """Consecutive runs of ``items`` whose ``size`` sums to at most
    WINDOW_LETTERS (an item above it on its own), drawn one run at a time,
    so host memory holds one window's reads and packed jobs."""
    window, n = [], 0
    for x in items:
        k = size(x)
        if window and n + k > WINDOW_LETTERS:
            yield window
            window, n = [], 0
        window.append(x)
        n += k
    if window:
        yield window


def _prepare_frameshift(source_idx: int, query_hits, queries, tblock, cfg):
    """Steps 1-2 of one read and the work of its score-only round (None
    when the round does not run); None when no target is left."""
    mat = cfg.matrix
    m32 = mat.matrix32
    dna_len = queries.dna_lens[source_idx]
    frames = {}       # frame -> (seq, padded view)
    for f in range(6):
        cid = source_idx * 6 + f
        start = int(queries.block.starts[cid])
        frames[f] = (queries.block.seq(cid), queries.block.letters[start:])
    frame_lens = [len(frames[f][0]) for f in range(6)]
    qlen0 = [frame_lens[0], frame_lens[3]]  # per-strand frame-0 lengths

    # 1. seed hits sorted by subject position, per-hit x-drop (reference
    # query_mapper.cpp:114-141; no Hauser bias)
    hits_sorted = sorted(query_hits, key=lambda h: h[0])
    seed_hits = []
    tids_order = []
    by_tid = {}
    for sgpos, soff, s2score, frame in hits_sorted:
        tid_arr, j_arr = tblock.global_to_local(np.array([sgpos]))
        tid, j = int(tid_arr[0]), int(j_arr[0])
        t_start = int(tblock.starts[tid])
        d = xdrop_ungapped(frames[frame][1], None, tblock.letters[t_start:],
                           soff, j, m32, cfg.xdrop_raw)
        if d.score > 0:
            h = FsSeedHit(frame=frame, i=soff, j=j, score=d.score)
            if tid not in by_tid:
                by_tid[tid] = []
                tids_order.append(tid)
            by_tid[tid].append(h)

    targets = []
    for tid in tids_order:
        t = FsTarget(block_id=tid, hits=by_tid[tid])
        top = t.hits[0]
        for h in t.hits[1:]:
            if h.score > top.score:
                top = h
        t.top_hit = top
        t.filter_score = top.score
        targets.append(t)
    if not targets:
        return None

    # 2. ranking (reference banded_swipe_pipeline.cpp:192-200)
    if cfg.query_range_culling:
        targets = _range_ranking(targets, tblock, frame_lens, dna_len, cfg)
    else:
        targets = _rank_targets(targets, cfg)
    if not targets:
        return None
    score_only = len(targets) > cfg.max_target_seqs or \
        cfg.toppercent is not None
    return SimpleNamespace(
        frames=frames, qlen0=qlen0, dna_len=dna_len, targets=targets,
        work=_swipe_work(targets, frames, tblock) if score_only else None)


def _finish_frameshift(fq, tblock, cfg, dev_scores):
    """Steps 3-6 of one prepared read; dev_scores: the card's {job_index:
    (score, max_col)} of its score-only work, or None (host oracle)."""
    frames, qlen0, dna_len = fq.frames, fq.qlen0, fq.dna_len
    targets = fq.targets

    # 3. score-only pass + culling when over the report cap
    if fq.work is not None:
        _run_swipe(targets, frames, qlen0, dna_len, tblock, cfg,
                   traceback=False, work=fq.work, dev_scores=dev_scores)
        for t in targets:
            t.filter_score = max((h.score for h in t.hsps), default=0)
            t.filter_evalue = min((h.evalue for h in t.hsps), default=INF)
        targets = _score_only_culling(targets, tblock, cfg)

    # 4. traceback pass
    for t in targets:
        t.hsps = []
    _run_swipe(targets, frames, qlen0, dna_len, tblock, cfg, traceback=True)

    # 5. inner culling (reference query_mapper.cpp:319-336)
    for t in targets:
        t.hsps.sort(key=_hsp_key)
        if t.hsps:
            t.filter_score = t.hsps[0].score
            t.filter_evalue = t.hsps[0].evalue
        else:
            t.filter_score, t.filter_evalue = 0, INF
        kept = []
        for h in t.hsps:
            if any(_overlap_factor(h.query_source_range,
                                   k.query_source_range) >= 0.5
                   for k in kept):
                continue
            kept.append(h)
        t.hsps = kept

    # 6. output ordering + final culling (reference
    # query_mapper.cpp:217-266)
    if cfg.toppercent is None:
        targets.sort(key=lambda t: (t.filter_evalue, -t.filter_score,
                                    t.block_id))
    else:
        targets.sort(key=lambda t: (-t.filter_score, t.block_id))
    culling = _make_culling(cfg)
    out = []
    for t in targets:
        _apply_filters(t, dna_len, int(tblock.lengths[t.block_id]), cfg)
        if not t.hsps:
            continue
        code, cov = culling.cull(t)
        if code == "NEXT":
            continue
        if code == "FINISHED":
            break
        culling.add(t)
        hsps = t.hsps[: cfg.max_hsps] if cfg.max_hsps > 0 else t.hsps
        m = Match(target_block_id=t.block_id, hsp=list(hsps))
        m.set_filter()
        out.append(m)
    return out


def _hsp_key(h):
    # Hsp::operator< (reference match.h:199-202); d_begin not tracked for
    # 3-frame alignments -> source-range begin breaks score ties
    return (-h.score, h.query_source_range[0])


def _overlap_factor(a, b):
    o = max(0, min(a[1], b[1]) - max(a[0], b[0]))
    la = a[1] - a[0]
    return o / la if la > 0 else 1.0


def _rank_targets(targets, cfg):
    """reference query_mapper.cpp:166-188."""
    targets = sorted(targets, key=lambda t: (-t.filter_score, t.block_id))
    if cfg.toppercent is not None:
        score = int(targets[0].filter_score * (1.0 - cfg.toppercent / 100.0)
                    * RANK_RATIO)
        cap = 1 << 62
    else:
        min_idx = min(len(targets), cfg.max_target_seqs)
        score = int(targets[min_idx - 1].filter_score * RANK_RATIO)
        cap = (1 << 62) if cfg.max_target_seqs >= (1 << 62) else \
            int(cfg.max_target_seqs * RANK_FACTOR)
    out = []
    for i, t in enumerate(targets):
        if t.filter_score < score or i >= cap:
            break
        out.append(t)
    return out


def _range_ranking(targets, tblock, frame_lens, dna_len, cfg):
    """reference banded_swipe_pipeline.cpp:139-156 (--range-culling)."""
    targets = sorted(targets, key=lambda t: (-t.filter_score, t.block_id))
    ip = IntervalPartition(cfg.max_target_seqs)
    out = []
    for t in targets:
        tlen = int(tblock.lengths[t.block_id])
        r = t.ungapped_query_range(tlen, frame_lens, dna_len)
        rl = r[1] - r[0]
        if cfg.toppercent is None:
            ms = int(t.filter_score / RANK_RATIO)
            cov = ip.covered_min_score(r[0], r[1], ms)
        else:
            ms = int(t.filter_score / RANK_RATIO
                     / (1.0 - cfg.toppercent / 100.0))
            cov = ip.covered_max_score(r[0], r[1], ms)
        if rl > 0 and cov / rl * 100.0 >= cfg.query_range_cover:
            continue  # outranked
        ip.insert(r[0], r[1], t.filter_score)
        out.append(t)
    return out


def _score_only_culling(targets, tblock, cfg):
    """reference query_mapper.cpp:190-215."""
    if cfg.toppercent is None:
        targets = sorted(targets, key=lambda t: (t.filter_evalue,
                                                 -t.filter_score, t.block_id))
    else:
        targets = sorted(targets, key=lambda t: (-t.filter_score, t.block_id))
    culling = _make_culling(cfg)
    out = []
    for t in targets:
        if not cfg.matrix.report_cutoff(t.filter_score, t.filter_evalue,
                                        cfg.max_evalue, cfg.min_bit_score):
            break
        code, cov = culling.cull(t)
        if code == "FINISHED":
            break
        if code == "NEXT":
            continue
        if cov < COV_INCLUDE_CUTOFF:
            culling.add(t)
        out.append(t)
    return out


class _GlobalCulling:
    """reference target_culling.h:39-110."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.n = 0
        self.top_score = 0.0

    def cull(self, t):
        if self.top_score == 0:
            return "INCLUDE", 0.0
        if self.cfg.toppercent is not None:
            bs = float(self.cfg.matrix.bitscore(t.filter_score))
            ok = (1.0 - bs / self.top_score) * 100.0 <= self.cfg.toppercent
            return ("INCLUDE" if ok else "FINISHED"), 0.0
        return ("INCLUDE" if self.n < self.cfg.max_target_seqs
                else "FINISHED"), 0.0

    def add(self, t):
        if self.top_score == 0:
            self.top_score = float(self.cfg.matrix.bitscore(t.filter_score))
        self.n += 1


class _RangeCulling:
    """reference target_culling.h:112-159."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.p = IntervalPartition(cfg.max_target_seqs)

    def cull(self, t):
        c = 0
        l = 0
        for h in t.hsps:
            b, e = h.query_source_range
            if self.cfg.toppercent is None:
                c += self.p.covered(b, e)
            else:
                cutoff = int(h.score / (1.0 - self.cfg.toppercent / 100.0))
                c += self.p.covered_max_score(b, e, cutoff)
            l += e - b
        cov = c / l if l > 0 else 1.0
        code = "INCLUDE" if cov * 100.0 < self.cfg.query_range_cover else "NEXT"
        return code, cov

    def add(self, t):
        for h in t.hsps:
            b, e = h.query_source_range
            self.p.insert(b, e, h.score)


def _make_culling(cfg):
    return _RangeCulling(cfg) if cfg.query_range_culling else _GlobalCulling(cfg)


def _apply_filters(t, dna_len, tlen, cfg):
    """reference query_mapper.cpp:338-349."""
    if cfg.min_id <= 0 and cfg.query_cover <= 0 and cfg.subject_cover <= 0:
        return
    kept = []
    for h in t.hsps:
        idp = h.identities * 100.0 / h.length
        qc = ((h.query_source_range[1] - h.query_source_range[0]) * 100.0
              / dna_len)
        sc = (h.subject_range[1] - h.subject_range[0]) * 100.0 / tlen
        if idp >= cfg.min_id and qc >= cfg.query_cover \
                and sc >= cfg.subject_cover:
            kept.append(h)
    t.hsps = kept


def _device_swipe3_scores(reads, cfg):
    """Score-only 3-frame DP on the card (ops/swipe3_device, kernel
    csrc/swipe3.cu; its plain version on a CPU) for a window of reads
    [(work or None, frames)]: one batch over every routed read's strands
    and (target, band) jobs, one launch per band class.  Returns per read
    {job_index: (score, max_col)}, or None where the read has no score-only
    work or takes the host oracle (device path off, a band above the
    kernel's cap)."""
    from diamond_tpu_torch.utils.device import device_dp_enabled

    out = [None] * len(reads)
    if not device_dp_enabled():
        return out
    from diamond_tpu_torch.ops.swipe3_device import MAX_BAND, swipe3_scores
    from diamond_tpu_torch.utils.device import resolve_device

    mat = cfg.matrix
    go, ge = mat.gap_open + mat.gap_extend, mat.gap_extend
    fs = mat.frame_shift
    strands, jobs, routed = [], [], []
    for r, (work, frames) in enumerate(reads):
        if not work:
            continue
        # a band above the kernel's register budget sends the read to the
        # host
        if max(d1 - d0 for *_, d0, d1 in work) > MAX_BAND:
            continue
        base = len(strands)
        strands += [[frames[s * 3 + f][0] for f in range(3)] for s in (0, 1)]
        routed.append((r, len(jobs), len(work)))
        jobs += [(base + strand, tgt, d0, d1)
                 for _t, tgt, _tl, strand, d0, d1 in work]
    if not jobs:
        return out
    best, mc = swipe3_scores(strands, jobs, mat.matrix32, go, ge, fs,
                             resolve_device())
    for r, lo, n in routed:
        out[r] = {idx: (int(best[lo + idx]), int(mc[lo + idx]))
                  for idx in range(n)}
    return out


def _swipe_work(targets, frames, tblock):
    """Band construction (reference banded_swipe_pipeline.cpp:57-99
    add_strand/add): every (target, strand, band) job of a read, as
    (t, tgt, tlen, strand, d0, d1)."""
    d_max = frames[0][0].shape[0] - 1  # query_seq(0) length - 1
    work = []
    for t in targets:
        tlen = int(tblock.lengths[t.block_id])
        t_start = int(tblock.starts[t.block_id])
        tgt = tblock.letters[t_start : t_start + tlen]
        d_min = -(tlen - 1)
        hits = sorted(t.hits, key=lambda h: (h.strand, h.diag, h.j))
        bands = {0: [], 1: []}  # strand -> [(d0, d1)]
        for strand in (0, 1):
            sh = [h for h in hits if h.strand == strand]
            if not sh:
                continue
            d0 = max(sh[0].diag - PADDING, d_min)
            d1 = min(sh[0].diag + PADDING, d_max)
            for h in sh[1:]:
                if h.diag - d1 <= PADDING:
                    d1 = min(h.diag + PADDING, d_max)
                else:
                    bands[strand].append((d0, d1))
                    d0 = max(h.diag - PADDING, d_min)
                    d1 = min(h.diag + PADDING, d_max)
            bands[strand].append((d0, d1))
        for strand in (0, 1):
            for d0, d1 in bands[strand]:
                work.append((t, tgt, tlen, strand, d0, d1))
    return work


def _run_swipe(targets, frames, qlen0, dna_len, tblock, cfg, traceback,
               work=None, dev_scores=None):
    """Per-band 3-frame DP (reference banded_swipe_pipeline.cpp:157-170
    run_swipe) over ``work`` (``_swipe_work`` of the targets unless given);
    dev_scores: the card's score-only results of that work, or None."""
    mat = cfg.matrix
    go, ge = mat.gap_open + mat.gap_extend, mat.gap_extend
    fs = mat.frame_shift
    if work is None:
        work = _swipe_work(targets, frames, tblock)

    for idx, (t, tgt, tlen, strand, d0, d1) in enumerate(work):
        q_frames = [frames[strand * 3 + f][0] for f in range(3)]
        qlen = qlen0[strand]
        if dev_scores is not None:
            score, max_col = dev_scores[idx]
            if score <= 0:
                continue
            r = SimpleNamespace(score=score, max_col=max_col)
        else:
            r = banded_3frame_swipe_np(
                q_frames, strand, dna_len, tgt, d0, d1,
                mat.matrix32, go, ge, fs, traceback=traceback)
        if r is None:
            continue
        ev = float(mat.evalue(r.score, qlen, tlen))
        if not mat.report_cutoff(r.score, ev, cfg.max_evalue,
                                 cfg.min_bit_score):
            continue
        if not traceback:
            h = Hsp(score=r.score, evalue=ev,
                    bit_score=float(mat.bitscore(r.score)))
            # approximated query extent for range culling (reference
            # banded_3frame_swipe.cpp:392-406 score-only traceback)
            band = d1 - d0
            i1_init = max(d1 - 1, 0)
            i0_init = i1_init + 1 - band
            j0 = i1_init - (d1 - 1)
            qe = min(i0_init + r.max_col + band // 2, qlen)
            qb = max(qe - (j0 + r.max_col), 0)
            h.frame = strand * 3
            h.query_source_range = _absolute_interval(
                qb, qe, h.frame, dna_len)
        else:
            h = Hsp(score=r.score, evalue=ev,
                    bit_score=float(mat.bitscore(r.score)),
                    query_range=r.query_range,
                    subject_range=r.subject_range,
                    identities=r.identities, mismatches=r.mismatches,
                    positives=r.positives,
                    gap_openings=r.gap_openings, gaps=r.gaps,
                    length=r.length, transcript=r.transcript,
                    backtraced=True)
            h.frame = r.frame
            h.query_source_range = r.query_source_range
        t.hsps.append(h)
