"""Banded 3-frame (frameshift-aware) Smith-Waterman for blastx -F.

Numpy oracle of the reference's Banded3FrameSwipe (reference
src/dp/swipe/banded_3frame_swipe.cpp:408-531 forward recurrence,
:161-331 traceback matrix/iterator, src/dp/swipe/swipe.h:56-82
cell_update): the DP runs over the three frame translations of one strand
simultaneously; a cell (i, f) extends from

  - the same-frame diagonal (i-1, f)        + score
  - the forward frame shift  (i-1, f-1) or (i-2, 2)  + score - F
  - the reverse frame shift  (i-1, f+1) or (i,   0)  + score - F
  - affine gaps within the frame (vertical = query, horizontal = target).

The matrix band interleaves the frames: physical row r = 3*(i - i0_j) + f,
band shifts one query position (3 rows) per target column.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

NEG = -0x40000000


def _forward_np(q, qlens, t, qlen, tlen, m, go, ge, fs,
                i0_init, i1_init, j0, R, ncols):
    """Pure-Python forward recurrence (oracle twin of
    native/src/swipe3.cc banded_3frame_forward)."""
    # S[j+1, r] = score of column j (target position j0+j) at physical row r
    S = np.zeros((ncols + 1, R + 2), dtype=np.int64)
    Hprev = np.zeros(R + 4, dtype=np.int64)
    best = 0
    max_col = -1

    i0 = i0_init
    i1 = i1_init
    cols_done = 0
    for j in range(ncols):
        i0_ = max(i0, 0)
        i1_ = min(i1, qlen - 1)
        if i0_ > i1_:
            break
        tl = int(t[j0 + j])
        Hcur = np.zeros(R + 4, dtype=np.int64)
        Scur = S[j + 1]
        Sprev = S[j]
        vgap = [NEG, NEG, NEG]
        col_best = 0
        r = (i0_ - i0) * 3
        sm4 = 0
        sm3 = int(Sprev[r]) if r < R else 0
        sm2 = int(Sprev[r + 1]) if r + 1 <= R + 1 else 0
        stop = False
        for i in range(i0_, i1_ + 1):
            for f in range(3):
                if f > 0 and i >= qlens[f]:
                    stop = True
                    break
                score = int(m[int(q[f][i]), tl])
                hg = int(Hprev[r + 3])
                cur = sm3 + score
                fsc = score - fs
                cur = max(cur, sm4 + fsc, sm2 + fsc, vgap[f], hg, 0)
                col_best = max(col_best, cur)
                vgap[f] = max(vgap[f] - ge, cur - go)
                Hcur[r] = max(hg - ge, cur - go)
                Scur[r] = cur
                r += 1
                sm4 = sm3
                sm3 = sm2
                sm2 = int(Sprev[r + 1]) if r + 1 <= R + 1 else 0
            if stop:
                break
        Hprev = Hcur
        if col_best > best:
            best = col_best
            max_col = j
        i0 += 1
        i1 += 1
        cols_done = j + 1
    return S, best, max_col, cols_done


def banded_3frame_swipe_np(q_frames, strand, dna_len, target, d_begin, d_end,
                           matrix32, gap_open_total, gap_extend, frame_shift,
                           traceback=True):
    """One target, int32.  q_frames: 3 frame-translated arrays (this
    strand).  d_begin/d_end: diagonal band (frame query coords - target
    coords).  Returns SimpleNamespace(score, ...) like banded_swipe_np, or
    None when nothing scored > 0."""
    q = [np.asarray(f, dtype=np.int64) & 31 for f in q_frames]
    t = np.asarray(target, dtype=np.int64) & 31
    qlen = len(q[0])
    qlens = [len(f) for f in q]
    tlen = len(t)
    m = matrix32
    go, ge, fs = gap_open_total, gap_extend, frame_shift

    band = d_end - d_begin
    i1_init = max(d_end - 1, 0)
    i0_init = i1_init + 1 - band
    j0 = i1_init - (d_end - 1)
    R = band * 3

    ncols = tlen - j0
    if ncols <= 0:
        return None

    from diamond_tpu_torch import native
    fwd = native.banded_3frame_forward_native(
        q_frames, target, d_begin, d_end,
        np.ascontiguousarray(m, dtype=np.int32), go, ge, fs)
    if fwd is not None:
        S, best, max_col, cols_done = fwd
    else:
        S, best, max_col, cols_done = _forward_np(
            q, qlens, t, qlen, tlen, m, go, ge, fs,
            i0_init, i1_init, j0, R, ncols)

    if best <= 0:
        return None

    res = SimpleNamespace(score=int(best))
    if not traceback:
        res.max_col = max_col
        return res

    # --- traceback (reference banded_3frame_swipe.cpp:180-331,346-390) ---
    def cell(i, f, j):
        """Score at (query i, frame f, target column j); 0 outside the
        band/matrix (the reference zero-pads the band edges: first column,
        set_zero rows below, zeroed top row)."""
        if j < 0 or i < 0 or f < 0 or j >= cols_done or i >= qlens[f]:
            return 0
        r = 3 * (i - (i0_init + j)) + f
        if r < 0 or r >= R:
            return 0
        return int(S[j + 1][r])

    # start cell: first row from the bottom of the band in column max_col
    # with the winning score (reference :278-288 traceback())
    i0_mc = i0_init + max_col
    start = None
    r_lo = max(-i0_mc, 0) * 3
    r_hi = min(R, dna_len - 2 - i0_mc * 3)
    for r in range(r_lo, r_hi):
        if int(S[max_col + 1][r]) == best:
            start = (i0_mc + r // 3, r % 3)
            break
    if start is None:
        raise RuntimeError("3-frame traceback error.")
    i, f = start
    j = max_col  # column index; target position = j0 + j

    ops_rev = []  # ops in reverse order
    identities = mismatches = positives = length = 0
    gaps = gap_openings = 0
    end_i, end_f, end_j = i + 1, f, j + 1

    def push_match(qi, fi, ji):
        nonlocal identities, mismatches, positives, length
        ql = int(q[fi][qi])
        sl = int(t[j0 + ji])
        sc = int(m[ql, sl])
        if ql == sl:
            ops_rev.append(("M", 1))
            identities += 1
            positives += 1
        else:
            ops_rev.append(("S", sl))
            mismatches += 1
            if sc > 0:
                positives += 1
        length += 1

    score_here = best
    while score_here > 0:
        ql = int(q[f][i])
        sl = int(t[j0 + j])
        sc = int(m[ql, sl])
        sm3 = cell(i - 1, f, j - 1)
        if f > 0:
            sm4 = cell(i - 1, f - 1, j - 1)
            sm2 = cell(i - 1, f + 1, j - 1) if f < 2 else cell(i, 0, j - 1)
        else:
            sm4 = cell(i - 2, 2, j - 1)
            sm2 = cell(i - 1, 1, j - 1)
        if score_here == sm3 + sc:
            push_match(i, f, j)
            i -= 1
            j -= 1
        elif score_here == sm4 + sc - fs:
            push_match(i, f, j)
            ops_rev.append(("FF", 1))
            i -= 1
            j -= 1
            f -= 1
            if f == -1:
                f = 2
                i -= 1
        elif score_here == sm2 + sc - fs:
            push_match(i, f, j)
            ops_rev.append(("FR", 1))
            i -= 1
            j -= 1
            f += 1
            if f == 3:
                f = 0
                i += 1
        else:
            # gap walk (reference :221-260)
            i0g = max(d_begin + (j0 + j), 0)
            j0g = max(i - d_end, -1)
            found = False
            g = go
            l = 1
            max_h = (j0 + j) - j0g - 1
            max_v = i - i0g
            while l <= min(max_h, max_v):
                if score_here + g == cell(i, f, j - l):
                    ops_rev.extend(("D", int(t[j0 + j - k]))
                                   for k in range(1, l + 1))
                    j -= l
                    found = True
                    break
                if score_here + g == cell(i - l, f, j):
                    ops_rev.append(("I", l))
                    i -= l
                    found = True
                    break
                l += 1
                g += ge
            if not found:
                while l <= max_v:
                    if score_here + g == cell(i - l, f, j):
                        ops_rev.append(("I", l))
                        i -= l
                        found = True
                        break
                    l += 1
                    g += ge
            if not found:
                while l <= max_h:
                    if score_here + g == cell(i, f, j - l):
                        ops_rev.extend(("D", int(t[j0 + j - k]))
                                       for k in range(1, l + 1))
                        j -= l
                        found = True
                        break
                    l += 1
                    g += ge
            if not found:
                raise RuntimeError("3-frame traceback error (gap).")
            gap_openings += 1
            gaps += l
            length += l
        score_here = cell(i, f, j)

    begin_i, begin_f, begin_j = i + 1, f, j + 1

    # transcript order: ops were appended walking backwards; frameshift ops
    # were appended after their match, so reversal puts them before it —
    # same as the reference (banded_3frame_swipe.cpp:366-377)
    ops = list(reversed(ops_rev))

    def absolute(pos, frame):
        in_strand = pos * 3 + frame
        return in_strand if strand == 0 else dna_len - 1 - in_strand

    if strand == 0:
        qsrc = (absolute(begin_i, begin_f), absolute(end_i, end_f))
    else:
        qsrc = (absolute(end_i, end_f) + 1, absolute(begin_i, begin_f) + 1)

    res.identities = identities
    res.mismatches = mismatches
    res.positives = positives
    res.length = length
    res.gaps = gaps
    res.gap_openings = gap_openings
    res.transcript = ops
    res.query_range = (begin_i, end_i)
    res.subject_range = (j0 + begin_j, j0 + end_j)
    res.frame = strand * 3 + begin_f
    res.query_source_range = qsrc
    return res
