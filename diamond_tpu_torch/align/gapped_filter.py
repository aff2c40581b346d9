"""Two-stage gapped diagonal filter (sensitive+ modes).

Reference: src/align/gapped_filter.cpp:33-100, src/dp/scan_diags.cpp,
util/scores/cutoff_table.h:49-77.  Per seed hit: Kadane over 64 diagonals of
a +/-100-column window, combined across diagonals with affine gap penalties
(diag_alignment); survivors rerun at 128 diagonals over +/-200 columns.
A target survives when ANY of its seed hits passes both stages.

Vectorized over diagonals (numpy); columns loop like the reference.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_COUNT


class CutoffTable2D:
    """(qlen, slen)-bucketed minimum scores (reference cutoff_table.h:49-77)."""

    def __init__(self, score_matrix, evalue: float):
        self.data = np.zeros((32, 32), dtype=np.int32)
        for b1 in range(1, 32):
            for b2 in range(1, 32):
                self.data[b1, b2] = self._calc(score_matrix, 1 << (b1 - 1),
                                               1 << (b2 - 1), evalue)

    @staticmethod
    def _calc(m, qlen, slen, evalue):
        # evalue_norm is monotone decreasing in score: bisect then verify
        lo, hi = 10, 1000
        if m.evalue_norm(hi - 1, qlen, slen) > evalue:
            return 1000
        while lo < hi:
            mid = (lo + hi) // 2
            if m.evalue_norm(mid, qlen, slen) <= evalue:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def __call__(self, qlen: int, slen: int) -> int:
        return int(self.data[int(qlen).bit_length(), int(slen).bit_length()])


def make_profile8(query, bias, matrix8, padding: int = 128):
    """int8 query profile with -1 padding (reference score_profile.cpp:33-66).

    Returns [26, padding + qlen + padding] int32 (int8-saturated values)."""
    qlen = len(query)
    q = np.asarray(query).astype(np.int64) & 31
    prof = np.full((AMINO_ACID_COUNT, qlen + 2 * padding), -1, dtype=np.int32)
    core = matrix8[:AMINO_ACID_COUNT, :][:, q].astype(np.int32)  # [26, qlen]
    if bias is not None:
        core = core + np.asarray(bias, dtype=np.int32)[None, :]
        core = np.clip(core, -128, 127)  # int8 saturation of profile entries
    prof[:, padding : padding + qlen] = core
    return prof


def scan_diags(profile, qlen, target, d_begin, j_begin, j_end, band, padding=128):
    """Per-diagonal Kadane over `band` diagonals
    (reference dp/scan_diags.cpp:29-100).  Returns [band] int scores."""
    j0 = max(j_begin, -(d_begin + band - 1))
    j1 = min(qlen - d_begin, j_end)
    v = np.zeros(band, dtype=np.int64)
    best = np.zeros(band, dtype=np.int64)
    if j1 <= j0:
        return best
    t = np.asarray(target).astype(np.int64) & 31
    lanes = np.arange(band, dtype=np.int64)
    # profile row gather per column: profile[letter, padding + i + lane]
    i0 = d_begin + j0
    for idx, j in enumerate(range(j0, j1)):
        i = i0 + idx
        row = profile[t[j], padding + i : padding + i + band]
        v = np.minimum(np.maximum(v + row, 0), 255)
        best = np.maximum(best, v)
    return best


def diag_alignment(s, count, gap_open, gap_extend, diag_score_cutoff) -> int:
    """Combine diagonal scores with affine gaps
    (reference scan_diags.cpp:277-297)."""
    best = 0
    best_gap = -gap_open
    d = -1
    for i in range(count):
        si = int(s[i])
        if si < diag_score_cutoff:
            continue
        gap_score = -gap_extend * (i - d) + best_gap
        n = si
        if gap_score + si > best:
            best = n = gap_score + si
        if si > best:
            best = n = si
        open_score = -gap_open + n
        if open_score > gap_score:
            best_gap = open_score
            d = i
    return best


class GappedFilter:
    """Per-query filter state (profile + cutoff tables)."""

    WINDOW1 = 100
    MIN_STAGE2_QLEN = 100

    def __init__(self, cfg, query, bias):
        m = cfg.matrix
        self.cfg = cfg
        self.qlen = len(query)
        self.profile = make_profile8(query, bias, m.matrix8.astype(np.int32))
        self.cut1 = _table(cfg, "gf1", m, 2000.0)  # gapped_filter_evalue1
        self.cut2 = _table(cfg, "gf2", m, cfg.gapped_filter_evalue)
        self.go = m.gap_open
        self.ge = m.gap_extend
        self.diag_cut = m.rawscore(12.0)  # gapped_filter_diag_bit_score
        self.window2 = 200

    def target_passes(self, seed_hits, target) -> bool:
        slen = len(target)
        for h in seed_hits:
            f1 = self._filter(h, target, 64, self.WINDOW1)
            if f1 > self.cut1(self.qlen, slen):
                if self.qlen < self.MIN_STAGE2_QLEN and self.cfg.translated:
                    return True
                f2 = self._filter(h, target, 128, self.window2)
                if f2 > self.cut2(self.qlen, slen):
                    return True
        return False

    def _filter(self, hit, target, band, window):
        slen = len(target)
        d = max(hit.diag - band // 2, -(slen - 1))
        j0 = max(hit.j - window, 0)
        j1 = min(hit.j + window, slen)
        scores = scan_diags(self.profile, self.qlen, target, d, j0, j1, band)
        return diag_alignment(scores, band, self.go, self.ge, self.diag_cut)


_TABLE_CACHE: dict = {}


def _table(cfg, kind, m, evalue):
    key = (kind, m.name, m.gap_open, m.gap_extend, evalue)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = CutoffTable2D(m, evalue)
    return _TABLE_CACHE[key]
