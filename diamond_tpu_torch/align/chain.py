"""Ungapped x-drop extension and diagonal-segment chaining.

xdrop_ungapped is an exact port of the reference semantics (reference
src/dp/ungapped_align.cpp:151-213).  Chaining approximates the reference
greedy DiagGraph aligner (reference src/chaining/greedy_align.cpp:482,
merge_score at :427-438): diagonal segments are merged greedily with the
same gap/space penalties, producing ApproxHsps that carry the diagonal band
for the gapped stage.  The full graph aligner differs only in rare
multi-segment tie cases; its band output feeds the same DP.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.constants.alphabet import DELIMITER_LETTER

SPACE_PENALTY = 0.1
GAP_PENALTY = 0.5
CHAIN_CUTOFF = 19


@dataclass
class DiagSegment:
    i: int
    j: int
    len: int
    score: int

    @property
    def diag(self) -> int:
        return self.i - self.j

    @property
    def query_end(self) -> int:
        return self.i + self.len

    @property
    def subject_end(self) -> int:
        return self.j + self.len


@dataclass
class ApproxHsp:
    d_min: int
    d_max: int
    score: int
    query_begin: int
    query_end: int
    subject_begin: int
    subject_end: int


def xdrop_ungapped(query: np.ndarray, bias: np.ndarray | None, target: np.ndarray,
                   qa: int, sa: int, matrix32, xdrop: int) -> DiagSegment:
    """Two-sided x-drop ungapped extension from seed position (qa, sa).

    query/target are views into the padded concatenated block arrays so
    out-of-sequence reads hit delimiter letters, terminating the loops
    exactly like the reference.

    Runs through the native C++ twin when available (bit-identical
    integer semantics; diamond_tpu/native/src/xdrop.cc); this Python body
    is the fallback and test oracle."""
    if (query.dtype == np.int8 and target.dtype == np.int8
            and getattr(matrix32, "dtype", None) == np.int32):
        from diamond_tpu_torch import native

        r = native.xdrop_ungapped_native(query, bias, target, qa, sa,
                                         matrix32, xdrop)
        if r is not None:
            return DiagSegment(i=r[0], j=r[1], len=r[2], score=r[3])
    score = 0
    st = 0
    n = 1
    delta = 0
    ln = 0

    qi, si = qa - 1, sa - 1
    while score - st < xdrop:
        ql = int(query[qi])
        sl = int(target[si])
        if ql == DELIMITER_LETTER or sl == DELIMITER_LETTER:
            break
        st += int(matrix32[ql & 31, sl & 31])
        if bias is not None:
            st += int(bias[qi])
        if st > score:
            score = st
            delta = n
        qi -= 1
        si -= 1
        n += 1

    qi, si = qa, sa
    st = score
    n = 1
    while score - st < xdrop:
        ql = int(query[qi])
        sl = int(target[si])
        if ql == DELIMITER_LETTER or sl == DELIMITER_LETTER:
            break
        st += int(matrix32[ql & 31, sl & 31])
        if bias is not None:
            st += int(bias[qi])
        if st > score:
            score = st
            ln = n
        qi += 1
        si += 1
        n += 1

    return DiagSegment(i=qa - delta, j=sa - delta, len=ln + delta, score=score)


def merge_score(h1: ApproxHsp, h2: ApproxHsp) -> int:
    """Score of chaining h1 before h2 (reference greedy_align.cpp:427-438)."""
    gq = h2.query_begin - h1.query_end
    gt = h2.subject_begin - h1.subject_end
    if gq < 0 or gt < 0:
        return 0
    s = h1.score + h2.score
    if gq > gt:
        return int(s - gq * GAP_PENALTY - gt * SPACE_PENALTY)
    return int(s - gt * GAP_PENALTY - gq * SPACE_PENALTY)


def _merge(h1: ApproxHsp, h2: ApproxHsp) -> ApproxHsp:
    return ApproxHsp(
        d_min=min(h1.d_min, h2.d_min),
        d_max=max(h1.d_max, h2.d_max),
        score=merge_score(h1, h2),
        query_begin=h1.query_begin,
        query_end=h2.query_end,
        subject_begin=h1.subject_begin,
        subject_end=h2.subject_end,
    )


def merge_hsps(hsps: list) -> list:
    """Pairwise merging pass (reference greedy_align.cpp:461-482)."""
    out = list(hsps)
    i = 0
    while i < len(out):
        k = i + 1
        while k < len(out):
            if merge_score(out[i], out[k]) > max(out[i].score, out[k].score):
                out[i] = _merge(out[i], out[k])
                del out[k]
            elif merge_score(out[k], out[i]) > max(out[i].score, out[k].score):
                out[i] = _merge(out[k], out[i])
                del out[k]
            else:
                k += 1
        i += 1
    return out


def chain(segments: list, cutoff: int = CHAIN_CUTOFF) -> list:
    """Greedy chaining of diagonal segments into ApproxHsps.

    Approximation of Chaining::run (reference greedy_align.cpp:482-504):
    single segments pass through; multiple segments are chained greedily in
    subject order when the merge improves the score, then merge_hsps runs.
    Chains below the cutoff are dropped."""
    if not segments:
        return []
    hsps = [
        ApproxHsp(d_min=s.diag, d_max=s.diag, score=s.score,
                  query_begin=s.i, query_end=s.query_end,
                  subject_begin=s.j, subject_end=s.subject_end)
        for s in segments
    ]
    if len(hsps) > 1:
        hsps.sort(key=lambda h: (h.subject_begin, h.query_begin))
        hsps = merge_hsps(hsps)
    return [h for h in hsps if h.score > cutoff]
