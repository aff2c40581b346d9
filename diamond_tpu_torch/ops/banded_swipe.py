"""Banded Smith-Waterman ("SWIPE") — numpy oracle and JAX batched kernel.

Semantics mirror the reference banded SWIPE (reference
src/dp/swipe/banded_swipe.h:200-360, cell_update.h:102-141):

  - local affine-gap DP restricted to diagonals d = i - j in [d_begin, d_end)
  - gap open charge = gap_open + gap_extend at opening
  - H, E (horizontal gap), F (vertical gap) all floored at 0 (the int8/16
    kernels saturate at the zero score, flooring every quantity)
  - per-query-position composition bias added to the match score
  - best cell = first column reaching the maximum; within a column, the last
    band row equal to the column max (reference VectorRowCounter,
    cell_update.h:36-53)
  - traceback priority at equal scores: vertical gap (insertion), then
    horizontal gap (deletion), then diagonal (reference trace-mask walk,
    banded_swipe.h:126-188, banded_matrix.h:382-402)
  - a gap run walks until the first cell whose open bit is set; the open bit
    wins ties (set_max(gap, open) keeps open on equality -> shortest run)

Band geometry: at column j (subject position), band row r holds query index
i = j + d_begin + r.  Diagonal predecessor (i-1, j-1) lives at the same band
row of the previous column; the horizontal predecessor (i, j-1) lives at band
row r+1 of the previous column.

The numpy version computes one (query, target) pair at a time and serves as
the traceback oracle.  The JAX twin (ops/swipe_jax.py) computes score-only
over batches of targets (channels = VPU lanes).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BandedResult:
    score: int
    max_col: int        # subject position of best cell
    max_row: int        # query position of best cell
    # traceback products (None if score-only)
    transcript: list | None = None
    query_range: tuple | None = None
    subject_range: tuple | None = None
    identities: int = 0
    mismatches: int = 0
    positives: int = 0
    gap_openings: int = 0
    gaps: int = 0
    length: int = 0


def banded_swipe_np(query: np.ndarray, target: np.ndarray, d_begin: int, d_end: int,
                    matrix32: np.ndarray, bias: np.ndarray | None,
                    gap_open: int, gap_extend: int,
                    traceback: bool = False,
                    tb_cell: tuple | None = None) -> BandedResult:
    """Reference-exact banded SW for one (query, target) pair.

    tb_cell=(i, j, score): force the traceback to start from the given
    (query pos, subject pos) cell with the given end score — used by the
    reversed stats pass, whose end cell is pinned to the forward pass's
    alignment start (reference swipe_wrapper.cpp:364-430)."""
    qlen, tlen = len(query), len(target)
    band = d_end - d_begin
    go = gap_open + gap_extend
    ge = gap_extend

    q = np.asarray(query).astype(np.int64) & 31
    t = np.asarray(target).astype(np.int64) & 31
    b = np.zeros(qlen, dtype=np.int64) if bias is None else np.asarray(bias).astype(np.int64)
    sub = matrix32[q]  # (qlen, 32) substitution row per query position
    biased = sub + b[:, None]

    H = np.zeros(band, dtype=np.int64)   # previous column, indexed by band row
    E = np.zeros(band + 1, dtype=np.int64)  # E[r] = horizontal gap into row r (prev col row r+1)
    best = 0
    max_col = 0
    max_row_band = 0

    if traceback:
        gapv = np.zeros((tlen, band), dtype=bool)
        gaph = np.zeros((tlen, band), dtype=bool)
        openv = np.zeros((tlen, band), dtype=bool)
        openh = np.zeros((tlen, band), dtype=bool)
    Hnew = np.zeros(band, dtype=np.int64)
    Enew = np.zeros(band, dtype=np.int64)

    r_ar = np.arange(band, dtype=np.int64)
    r_ge = r_ar * ge
    NEGB = -(10 ** 9)

    for j in range(tlen):
        i_lo = j + d_begin
        r_lo = max(0, -i_lo)
        r_hi = min(band, qlen - i_lo)
        if r_lo >= r_hi:
            H[:] = 0
            E[:band] = 0
            continue
        tl = t[j]
        scores = np.full(band, NEGB, dtype=np.int64)
        scores[r_lo:r_hi] = biased[i_lo + r_lo : i_lo + r_hi, tl]

        Ecur = E[:band]
        cur0 = np.maximum(np.maximum(H + scores, Ecur), 0)
        cur0[:r_lo] = 0
        cur0[r_hi:] = 0
        # lazy vertical gap: F_used(r) = max(0, cummax_{k<r}(cur0(k)-go+k*ge) - (r-1)*ge)
        g = cur0 - go + r_ge
        gm = np.maximum.accumulate(g)
        F_used = np.empty(band, dtype=np.int64)
        F_used[0] = 0
        np.maximum(gm[:-1] - r_ge[:-1], 0, out=F_used[1:])
        F_used[:r_lo + 1] = 0  # F enters first valid row as 0
        cur = np.maximum(cur0, F_used)
        cur[:r_lo] = 0
        cur[r_hi:] = 0

        # column best: last row attaining the max (VectorRowCounter)
        col_best = int(cur[r_lo:r_hi].max(initial=0))
        if col_best > best:
            best = col_best
            max_col = j
            max_row_band = r_hi - 1 - int(cur[r_lo:r_hi][::-1].argmax())

        opn = np.maximum(cur - go, 0)
        F_ext = np.maximum(F_used - ge, 0)
        e_next = np.maximum(Ecur - ge, 0)
        if traceback:
            gapv[j] = cur == F_used
            gaph[j] = cur == Ecur
            # openv(r) compares opn(r) with the extended vertical gap leaving r
            openv[j] = opn >= F_ext
            openh[j] = opn >= e_next
        Enew = np.maximum(e_next, opn)
        Enew[:r_lo] = 0
        Enew[r_hi:] = 0
        H[:] = cur
        # re-index for next column: diag pred keeps its row; horizontal pred
        # moves down one row
        E[:band - 1] = Enew[1:]
        E[band - 1 :] = 0

    res = BandedResult(score=int(best), max_col=int(max_col),
                       max_row=int(max_col + d_begin + max_row_band))
    if tb_cell is not None:
        res.max_row, res.max_col, res.score = tb_cell
    if not traceback or res.score == 0:
        return res
    _traceback(res, query, target, d_begin, d_end, matrix32, b, go, ge,
               gapv, gaph, openv, openh)
    return res


def backward_stats_np(query, target, d_begin, d_end, matrix32, bias,
                      gap_open: int, gap_extend: int, cell_i: int,
                      cell_j: int):
    """DEPRECATED prior attempt kept for reference; see
    backward_stats_pass_np for the verified semantics."""
    qlen, tlen = len(query), len(target)
    band = d_end - d_begin
    go = gap_open + gap_extend
    ge = gap_extend
    q = np.asarray(query).astype(np.int64) & 31
    t = np.asarray(target).astype(np.int64) & 31
    b = (np.zeros(qlen, dtype=np.int64) if bias is None
         else np.asarray(bias).astype(np.int64))
    sub = matrix32[q] + b[:, None]

    NEGB = -(10 ** 9)
    Hv = np.zeros(band, np.int64)
    Hm = np.zeros(band, np.int64)
    Hg = np.zeros(band, np.int64)
    Ev = np.zeros(band + 1, np.int64)
    Em = np.zeros(band + 1, np.int64)
    Eg = np.zeros(band + 1, np.int64)
    r_ar = np.arange(band, dtype=np.int64)
    r_ge = r_ar * ge
    out = None

    for j in range(tlen):
        i_lo = j + d_begin
        r_lo = max(0, -i_lo)
        r_hi = min(band, qlen - i_lo)
        if r_lo >= r_hi:
            Hv[:] = 0; Hm[:] = 0; Hg[:] = 0
            Ev[:band] = 0; Em[:band] = 0; Eg[:band] = 0
            continue
        tl = t[j]
        scores = np.full(band, NEGB, dtype=np.int64)
        scores[r_lo:r_hi] = sub[i_lo + r_lo : i_lo + r_hi, tl]
        mism = np.zeros(band, np.int64)
        mism[r_lo:r_hi] = (q[i_lo + r_lo : i_lo + r_hi] != tl)

        # diagonal candidate
        dv = Hv + scores
        dm = Hm + mism
        dg = Hg.copy()
        # horizontal gap (strict: E replaces only when strictly greater)
        ev, em, eg = Ev[:band], Em[:band], Eg[:band]
        take_e = ev > dv
        cv0 = np.where(take_e, ev, dv)
        cm0 = np.where(take_e, em, dm)
        cg0 = np.where(take_e, eg, dg)
        # zero floor for the pre-F cell (used for the F open chain)
        neg = cv0 < 0
        cv0 = np.where(neg, 0, cv0)
        cm0 = np.where(cv0 == 0, 0, cm0)
        cg0 = np.where(cv0 == 0, 0, cg0)
        cv0[:r_lo] = 0; cm0[:r_lo] = 0; cg0[:r_lo] = 0
        cv0[r_hi:] = 0; cm0[r_hi:] = 0; cg0[r_hi:] = 0
        # vertical gap: lazy chain over rows above; strict ties keep the
        # extension, so the winner is the FIRST row attaining the chain max
        g = cv0 - go + r_ge
        g[:r_lo] = NEGB
        gm = np.maximum.accumulate(g)
        # winner[r] = first row attaining the running max = the last row
        # where the running max strictly increased (strict ties keep the
        # already-held gap, i.e. the earlier open)
        inc = np.empty(band, dtype=bool)
        inc[0] = True
        inc[1:] = g[1:] > gm[:-1]
        winner = np.maximum.accumulate(np.where(inc, r_ar, -1))
        Fv = np.zeros(band, np.int64)
        Fm = np.zeros(band, np.int64)
        Fg = np.zeros(band, np.int64)
        Fv[1:] = np.maximum(gm[:-1] - r_ge[:-1], 0)
        w = winner[:-1]
        valid = w >= 0
        wc = np.where(valid, w, 0)
        Fm[1:] = np.where(valid, cm0[wc], 0)
        Fg[1:] = np.where(valid, cg0[wc] + 1, 0)
        Fv[: r_lo + 1] = 0; Fm[: r_lo + 1] = 0; Fg[: r_lo + 1] = 0
        take_f = Fv > cv0
        cv = np.where(take_f, Fv, cv0)
        cm = np.where(take_f, Fm, cm0)
        cg = np.where(take_f, Fg, cg0)
        cv[:r_lo] = 0; cv[r_hi:] = 0
        cm = np.where(cv == 0, 0, cm)
        cg = np.where(cv == 0, 0, cg)

        if j == cell_j:
            r = cell_i - i_lo
            if 0 <= r < band:
                out = (int(cv[r]), int(cm[r]), int(cg[r]))

        # next column's horizontal gaps (strict: open replaces only when
        # strictly greater); opens come from the final (F-included) cell
        ov = cv - go
        e2 = ev - ge
        take_o = ov > e2
        nEv = np.where(take_o, ov, e2)
        nEm = np.where(take_o, cm, em)
        nEg = np.where(take_o, cg + 1, eg)
        nEv = np.maximum(nEv, 0)
        nEv[:r_lo] = 0
        nEv[r_hi:] = 0
        Hv, Hm, Hg = cv, cm, cg
        Ev[: band - 1] = nEv[1:]; Em[: band - 1] = nEm[1:]; Eg[: band - 1] = nEg[1:]
        Ev[band - 1 :] = 0; Em[band - 1 :] = 0; Eg[band - 1 :] = 0
    return out


def backward_stats_pass_np(query, bias, target, send, d_begin, d_end,
                           matrix32, gap_open: int, gap_extend: int):
    """Mismatch/gap-open counts from the reference's reversed stats pass
    (reference dp/swipe/swipe_wrapper.cpp:364-430 recompute_reversed,
    stat_cell.h BackwardCell, cell_update.h:102-141 swipe_cell_update).

    The reversed DP runs the normal banded local SWIPE over the REVERSED
    query (full length) and the REVERSED target prefix [0, send), with
    band [qlen - send - (d_end-1), qlen - send - d_begin + 1) (rev_diag of
    the forward band).  Stats ride the cells; at every set_max a TIE takes
    the CANDIDATE's stats (blend mask v==x — stat_cell.h:266-272), so the
    effective priority is vertical gap > horizontal gap > diagonal, and
    gap-open beats gap-extension on equality (update_open then set_max).
    A cell clamped to 0 has its stats zeroed (update_open zero_mask).
    Best cell = first column strictly improving, last row attaining the
    column max.  Returns (best, mismatch, gapopen) at the best cell.

    query/bias/target are FORWARD arrays; reversal happens via indexing.
    Python oracle of native/src/backward_stats.cc."""
    qlen = len(query)
    go = gap_open + gap_extend
    ge = gap_extend
    band = d_end - d_begin
    d0 = qlen - send - (d_end - 1)
    tlen = send
    NEGB = -(10 ** 9)

    # cell = [value, mismatch, gapopen]
    H = [[0, 0, 0] for _ in range(band)]
    E = [[0, 0, 0] for _ in range(band + 1)]
    best = 0
    best_mm = 0
    best_go = 0

    for j in range(tlen):
        i_lo = j + d0
        r_lo = max(0, -i_lo)
        r_hi = min(band, qlen - i_lo)
        Hn = [[0, 0, 0] for _ in range(band)]
        En = [[0, 0, 0] for _ in range(band)]
        if r_lo >= r_hi:
            H = Hn
            E = En + [[0, 0, 0]]
            continue
        tL = int(target[send - 1 - j])
        V = [0, 0, 0]  # vertical gap, reset per column
        cb = 0
        cbr = r_lo
        for r in range(r_lo, r_hi):
            i = i_lo + r
            qL = int(query[qlen - 1 - i])
            sc = int(matrix32[qL & 31, tL & 31])
            if bias is not None:
                sc += int(bias[qlen - 1 - i])
            ident = 1 if qL == tL else 0
            cv = H[r][0] + sc
            cmm = H[r][1] + (1 - ident)
            cgo = H[r][2]
            e = E[r]
            if e[0] >= cv:          # tie -> horizontal gap wins
                cv, cmm, cgo = e[0], e[1], e[2]
            if V[0] >= cv:          # tie -> vertical gap wins
                cv, cmm, cgo = V[0], V[1], V[2]
            if cv < 0:
                cv = 0
            if cv >= cb:            # last row attaining the column max
                cb = cv
                cbr = r
            # gap updates (open beats extension on equality)
            ev = e[0] - ge
            vv = V[0] - ge
            ov = cv - go
            omm, ogo = cmm, cgo + 1
            if cv == 0:             # zero cell resets its stats
                cmm = 0
                cgo = 0
            if ov >= ev:            # tie -> open wins
                En[r] = [ov, omm, ogo]
            else:
                En[r] = [ev, e[1], e[2]]
            if ov >= vv:            # tie -> open wins
                V = [ov, omm, ogo]
            else:
                V = [vv, V[1], V[2]]
            Hn[r] = [cv, cmm, cgo]
        if cb > best:
            best = cb
            best_mm = Hn[cbr][1]
            best_go = Hn[cbr][2]
        H = Hn
        # horizontal predecessor moves down one row next column
        E = En[1:] + [[0, 0, 0], [0, 0, 0]]
        E = E[: band + 1]
    return best, best_mm, best_go


def _traceback(res, query, target, d_begin, d_end, matrix32, bias, go, ge,
               gapv, gaph, openv, openh):
    """Walk from the best cell following trace-mask priorities."""
    q = np.asarray(query).astype(np.int64) & 31
    t = np.asarray(target).astype(np.int64) & 31
    i, j = res.max_row, res.max_col
    end_score = res.score
    score = 0
    ops = []  # built reversed; (op, payload)
    identities = mismatches = positives = gap_openings = gaps = length = 0
    q_end, s_end = i + 1, j + 1
    band = d_end - d_begin

    def row(i, j):
        return i - j - d_begin

    while i >= 0 and j >= 0 and score < end_score:
        r = row(i, j)
        assert 0 <= r < band
        if gapv[j, r]:
            l = 0
            while True:
                l += 1
                i -= 1
                rr = row(i, j)
                if rr < 0 or (rr < band and openv[j, rr]) or i <= 0:
                    break
            ops.append(("I", l))
            gap_openings += 1
            gaps += l
            length += l
            score -= go + (l - 1) * ge
        elif gaph[j, r]:
            l = 0
            while True:
                l += 1
                j -= 1
                rr = row(i, j)
                if rr >= band or (rr >= 0 and openh[j, rr]) or j <= 0:
                    break
            # deletion letters pushed reversed: j+l down to j+1
            for k in range(l):
                ops.append(("D", int(t[j + l - k])))
            gap_openings += 1
            gaps += l
            length += l
            score -= go + (l - 1) * ge
        else:
            m = int(matrix32[q[i], t[j]])
            score += m + int(bias[i])
            if int(query[i]) == int(target[j]):
                ops.append(("M", 1))
                identities += 1
                positives += 1
            else:
                ops.append(("S", int(t[j])))
                mismatches += 1
                if m > 0:
                    positives += 1
            length += 1
            i -= 1
            j -= 1

    if score != end_score:
        raise RuntimeError("Traceback error.")
    ops.reverse()
    res.transcript = ops
    res.query_range = (i + 1, q_end)
    res.subject_range = (j + 1, s_end)
    res.identities = identities
    res.mismatches = mismatches
    res.positives = positives
    res.gap_openings = gap_openings
    res.gaps = gaps
    res.length = length


def _batch_native(query, bias, jobs, matrix32, gap_open, gap_extend,
                  traceback):
    """Run the job batch through the native C++ DP (bit-identical to the
    numpy path below; native/src/banded_swipe.cc).  Emits per-job trace
    masks so _traceback above stays the traceback oracle.  Returns None
    when the native library is unavailable."""
    from diamond_tpu_torch import native

    if native.lib() is None:
        return None
    q8 = np.ascontiguousarray(np.asarray(query), dtype=np.int8)
    bias32 = (None if bias is None
              else np.ascontiguousarray(bias, dtype=np.int32))
    B = len(jobs)
    t_len = np.fromiter((len(t) for t, _, _ in jobs), dtype=np.int64,
                        count=B)
    t_off = np.zeros(B, dtype=np.int64)
    np.cumsum(t_len[:-1], out=t_off[1:])
    t_cat = np.empty(int(t_len.sum()), dtype=np.int8)
    for k, (t, _, _) in enumerate(jobs):
        t_cat[t_off[k] : t_off[k] + t_len[k]] = np.asarray(t, dtype=np.int8)
    d_begins = np.fromiter((d0 for _, d0, _ in jobs), dtype=np.int64,
                           count=B)
    bands = np.fromiter((d1 - d0 for _, d0, d1 in jobs), dtype=np.int64,
                        count=B)
    go = gap_open + gap_extend
    ge = gap_extend
    if traceback:
        r = _tb_native(q8, bias, bias32, jobs, t_cat, t_off, t_len,
                       d_begins, bands, matrix32, go, ge)
        if r is not None:
            return r
    if not traceback:
        # striped (AVX-512) score engine — same outputs as the scalar
        # swipe_one, ~5x faster; q_off 0 for every job (single query)
        q_off = np.zeros(B, dtype=np.int64)
        q_len = np.full(B, len(q8), dtype=np.int64)
        use_b = np.full(B, 0 if bias32 is None else 1, dtype=np.uint8)
        out = native.banded_swipe_score_multi_native(
            q8, bias32, q_off, q_len, use_b, t_cat, t_off, t_len,
            d_begins, bands, matrix32, go, ge)
        if out is not None:
            return [(int(out[k, 0]), int(out[k, 1]), int(out[k, 2]))
                    for k in range(B)]
    masks = mask_off = None
    if traceback:
        sizes = t_len * bands
        mask_off = np.zeros(B, dtype=np.int64)
        np.cumsum(sizes[:-1], out=mask_off[1:])
        total = int(sizes.sum())
        masks = tuple(np.zeros(total, dtype=np.uint8) for _ in range(4))
    out = native.banded_swipe_many_native(
        q8, bias32, t_cat, t_off, t_len, d_begins, bands, matrix32, go, ge,
        mask_off, masks)
    if out is None:
        return None
    if not traceback:
        return [(int(out[k, 0]), int(out[k, 1]),
                 int(out[k, 1]) + int(d_begins[k]) + int(out[k, 2]))
                for k in range(B)]
    b64 = (np.zeros(len(q8), dtype=np.int64) if bias is None
           else np.asarray(bias).astype(np.int64))
    results = []
    for k, (t_let, d0, d1) in enumerate(jobs):
        tlen = int(t_len[k])
        band = int(bands[k])
        res = BandedResult(score=int(out[k, 0]), max_col=int(out[k, 1]),
                           max_row=int(out[k, 1]) + d0 + int(out[k, 2]))
        if res.score > 0:
            shape = (tlen, band)
            off = int(mask_off[k])
            end = off + tlen * band
            mv = [m[off:end].view(bool).reshape(shape) for m in masks]
            _traceback(res, query, t_let, d0, d1, matrix32, b64, go, ge,
                       mv[0], mv[1], mv[2], mv[3])
        results.append(res)
    return results


_OP_CHARS = ("M", "S", "D", "I")


class Transcript:
    """Lazy edit transcript backed by the native walk's op arrays (stored
    in walk order = reversed alignment).  Expands to ("M",1)/("S",letter)/
    ("D",letter)/("I",run) tuples only when a consumer iterates — the
    default -f6 output needs just the counts, so most transcripts are
    never expanded."""

    __slots__ = ("codes", "payloads")

    def __init__(self, codes, payloads):
        self.codes = codes
        self.payloads = payloads

    def _expand(self):
        return [(_OP_CHARS[c], p)
                for c, p in zip(self.codes[::-1].tolist(),
                                self.payloads[::-1].tolist())]

    def __iter__(self):
        return iter(self._expand())

    def __len__(self):
        return len(self.codes)

    def __bool__(self):
        return len(self.codes) > 0

    def __eq__(self, other):
        if other is None:
            return False
        return self._expand() == list(other)

    def __repr__(self):
        return f"Transcript({self._expand()!r})"


def _tb_native(q8, bias, bias32, jobs, t_cat, t_off, t_len, d_begins, bands,
               matrix32, go, ge):
    """DP + traceback walk entirely in C++ (native/src/banded_swipe.cc
    banded_swipe_tb_many); only the op streams cross the boundary.  A walk
    failure (stats[:,11]==0, the rare shared-band spill tie) raises
    RuntimeError exactly like the Python walk, so callers' fallback paths
    are unchanged.  Returns a BandedResult list or None."""
    from diamond_tpu_torch import native

    r = native.banded_swipe_tb_native(q8, bias32, t_cat, t_off, t_len,
                                      d_begins, bands, matrix32, go, ge)
    if r is None:
        return None
    if not r[1][:, 11].all():
        raise RuntimeError("Traceback error.")
    return results_from_tb(r)


def tb_multi_results(q_base, bias_base, q_off, q_len, use_bias, t_cat,
                     t_off, t_len, d_begins, bands, matrix32, go, ge,
                     max_ops: int = 8 << 20):
    """banded_swipe_tb_multi in job slices bounded by op-buffer size:
    each slice's op streams are consumed into BandedResults (copied
    transcripts) and freed before the next slice allocates, so the peak
    op-buffer footprint is ~max_ops * 5 bytes instead of the whole
    wave's (hundreds of MB on 1000-query out-of-core rounds).  Returns
    (out [njobs,3], stats [njobs,12], results list) or None when the
    native library is unavailable."""
    import numpy as np

    from diamond_tpu_torch import native

    if native.lib() is None:
        return None
    njobs = len(t_off)
    caps = (np.asarray(t_len, dtype=np.int64)
            + np.asarray(q_len, dtype=np.int64) + 2)
    cum = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(caps, out=cum[1:])
    outs = []
    stats = []
    results = []
    k0 = 0
    while k0 < njobs:
        k1 = int(np.searchsorted(cum, cum[k0] + max_ops, side="right")) - 1
        k1 = min(max(k1, k0 + 1), njobs)
        r = native.banded_swipe_tb_multi_native(
            q_base, bias_base, q_off[k0:k1], q_len[k0:k1],
            use_bias[k0:k1], t_cat, t_off[k0:k1], t_len[k0:k1],
            d_begins[k0:k1], bands[k0:k1], matrix32, go, ge)
        if r is None:
            return None
        outs.append(r[0])
        stats.append(r[1])
        results.extend(results_from_tb(r))
        k0 = k1
    return np.concatenate(outs), np.concatenate(stats), results


def results_from_tb(r, idx=None):
    """BandedResult list from a native tb-batch output tuple
    (out, stats, op_off, op_codes, op_payload); idx selects a subset of
    jobs (None = all)."""
    out, stats, op_off, op_codes, op_payload = r
    if idx is None:
        idx = range(len(out))
    results = []
    for k in idx:
        res = BandedResult(score=int(out[k, 0]), max_col=int(out[k, 1]),
                           max_row=int(out[k, 2]))
        if res.score > 0:
            st = stats[k]
            n_ops = int(st[10])
            lo = int(op_off[k])
            # copies, not views: a view would pin the whole wave's op
            # buffers (tens of MB) for as long as any single surviving
            # Hsp lives — across an out-of-core run that multiplies
            # into GBs of retained garbage
            res.transcript = Transcript(op_codes[lo : lo + n_ops].copy(),
                                        op_payload[lo : lo + n_ops].copy())
            res.query_range = (int(st[0]), int(st[1]))
            res.subject_range = (int(st[2]), int(st[3]))
            res.identities = int(st[4])
            res.mismatches = int(st[5])
            res.positives = int(st[6])
            res.gap_openings = int(st[7])
            res.gaps = int(st[8])
            res.length = int(st[9])
        results.append(res)
    return results


def banded_swipe_batch_np(query, bias, jobs, matrix32, gap_open, gap_extend,
                          traceback=False):
    """Banded SW over a batch of (target, d_begin, d_end) jobs, vectorized
    over the batch via the uniform-band shift (numpy twin of
    ops/swipe_jax.banded_swipe_uniform; same exact semantics as
    banded_swipe_np).  Score-only returns a list of (score, max_col,
    max_row); with traceback=True returns a list of BandedResult with
    transcripts."""
    if not jobs:
        return []
    r = _batch_native(query, bias, jobs, matrix32, gap_open, gap_extend,
                      traceback)
    if r is not None:
        return r
    qlen = len(query)
    q = np.asarray(query).astype(np.int64) & 31
    b = np.zeros(qlen, dtype=np.int64) if bias is None else np.asarray(bias).astype(np.int64)
    prof = matrix32[q].astype(np.int64) + b[:, None]  # [qlen, 32]

    go = gap_open + gap_extend
    ge = gap_extend
    NEGB = -(10 ** 9)
    band = max(d1 - d0 for _, d0, d1 in jobs)
    C = max(0, -min(d0 for _, d0, _ in jobs))
    shifts = [d0 + C for _, d0, _ in jobs]
    T = max(len(t) + s for (t, _, _), s in zip(jobs, shifts))
    B = len(jobs)
    tgt = np.full((B, T), 31, dtype=np.int64)
    band_len = np.zeros(B, dtype=np.int64)
    for k, ((t, d0, d1), s) in enumerate(zip(jobs, shifts)):
        tgt[k, s : s + len(t)] = np.asarray(t, dtype=np.int64) & 31
        band_len[k] = d1 - d0

    # profile rows per (column, band row): i = j - C + r
    prof_pad = np.full((T + band, 32), NEGB, dtype=np.int64)
    lo = -C
    i0 = max(0, lo)
    i1 = min(qlen, lo + T + band)
    if i1 > i0:
        prof_pad[i0 - lo : i1 - lo] = prof[i0:i1]

    r_ar = np.arange(band, dtype=np.int64)
    r_ge = r_ar * ge
    row_valid = r_ar[None, :] < band_len[:, None]  # STRICT_BAND mask

    H = np.zeros((B, band), dtype=np.int64)
    E = np.zeros((B, band), dtype=np.int64)
    best = np.zeros(B, dtype=np.int64)
    max_col = np.zeros(B, dtype=np.int64)
    max_row = np.zeros(B, dtype=np.int64)

    if traceback:
        gapv = np.zeros((T, B, band), dtype=bool)
        gaph = np.zeros((T, B, band), dtype=bool)
        openv = np.zeros((T, B, band), dtype=bool)
        openh = np.zeros((T, B, band), dtype=bool)

    for j in range(T):
        scores = prof_pad[j + r_ar[None, :], tgt[:, j][:, None]]
        scores = np.where(row_valid, scores, NEGB)
        valid = scores > NEGB // 2  # in-band, in-query, in-target cells
        cur0 = np.maximum(np.maximum(H + scores, E), 0)
        g = cur0 - go + r_ge[None, :]
        gm = np.maximum.accumulate(g, axis=1)
        F = np.zeros((B, band), dtype=np.int64)
        np.maximum(gm[:, :-1] - r_ge[None, :-1], 0, out=F[:, 1:])
        # zero invalid cells so gap scores can't tunnel through out-of-band /
        # out-of-query rows and re-enter the valid region (the reference
        # never computes those cells)
        Hn = np.where(valid, np.maximum(cur0, F), 0)
        col_best = Hn.max(axis=1)
        upd = col_best > best
        if upd.any():
            col_row = band - 1 - Hn[:, ::-1].argmax(axis=1)
            best = np.where(upd, col_best, best)
            max_col = np.where(upd, j, max_col)
            max_row = np.where(upd, col_row, max_row)
        E_out = np.maximum(np.maximum(E - ge, Hn - go), 0)
        if traceback:
            gapv[j] = Hn == F
            gaph[j] = Hn == E
            opn = np.maximum(Hn - go, 0)
            openv[j] = opn >= np.maximum(F - ge, 0)
            openh[j] = opn >= np.maximum(E - ge, 0)
        H = Hn
        E[:, : band - 1] = E_out[:, 1:]
        E[:, band - 1] = 0

    if not traceback:
        out = []
        for k in range(B):
            j_true = int(max_col[k]) - shifts[k]
            i_true = int(max_col[k]) - C + int(max_row[k])
            out.append((int(best[k]), j_true, i_true))
        return out

    results = []
    bias_arr = b
    for k, ((t_let, d0, d1), s) in enumerate(zip(jobs, shifts)):
        tlen = len(t_let)
        res = BandedResult(score=int(best[k]),
                           max_col=int(max_col[k]) - s,
                           max_row=int(max_col[k]) - C + int(max_row[k]))
        if res.score > 0:
            # per-job mask views in true coordinates: row index r = i - j - d0
            # equals the shared-band row index (see swipe_jax docstring)
            view = slice(s, s + tlen)
            _traceback(res, query, t_let, d0, d0 + band, matrix32, bias_arr,
                       go, ge,
                       gapv[view, k], gaph[view, k],
                       openv[view, k], openh[view, k])
        results.append(res)
    return results
