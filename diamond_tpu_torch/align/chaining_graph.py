"""Band-selection chaining over an anchor relay graph.

Chooses the diagonal band(s) the banded-DP extension stage explores.
Ungapped anchor segments become graph vertices; a greedy sweep links each
anchor to the best-scoring predecessor chain through "relays" (scored
gap crossings), and a harvest walk turns the top chains into ApproxHsps
whose d_min/d_max set the DP band geometry.

Decision-compatible with the reference chainer (reference
src/chaining/greedy_align.cpp:56-497, diag_graph.h, backtrace.cpp — the
same scores and tie-breaks, because the band choice feeds goldens that
are byte-pinned) but expressed in this repo's own form: the crossover
placement between two anchors is an argmax over vectorized prefix sums
instead of a scalar sweep, relays live in per-anchor lists instead of a
shifted global arena, and the harvest is an explicit two-phase loop
rather than recursion.  Tunables mirror the reference defaults: space
penalty 0.1, chain cutoff 19, band shift cap (--chaining-maxgap) 2000,
range cover 8, stacked-HSP ratio 0.5.
"""
from __future__ import annotations

from bisect import bisect_left, insort

import numpy as np

from diamond_tpu_torch.align.chain import ApproxHsp

DRIFT_COST = 0.1          # per-letter penalty for unaligned span
CROSS_PAD = 10            # columns scanned around the crossover point
MIN_BACKLINK_HANG = 10    # subject overhang required for a reverse relay
COVER_CAP = 8             # max dominating anchors before one is dropped
STACK_RATIO = 0.5         # stacked-HSP admission ratio in the harvest
CHAIN_CUTOFF = 19
BAND_SHIFT_CAP = 2000
NEG_INF = -(2 ** 62)
POS_INF = 2 ** 62


class _Anchor:
    """One maximal ungapped run: query/subject start, length, score, plus
    the chain state accumulated by the sweep (best carry into this anchor
    and the peak/floor of that chain's running score)."""

    __slots__ = ("qa", "sa", "n", "score", "carry", "crest", "trough",
                 "relays")

    def __init__(self, qa, sa, n, score):
        self.qa = qa
        self.sa = sa
        self.n = n
        self.score = score
        self.carry = score
        self.crest = score
        self.trough = score
        self.relays = []

    @property
    def dg(self):
        return self.qa - self.sa

    @property
    def qe(self):
        return self.qa + self.n

    @property
    def se(self):
        return self.sa + self.n

    def peak_gain(self):
        """Chain value used to rank harvest starts: the full carry when
        the chain never dipped, otherwise carry above its floor."""
        return (self.carry if self.carry == self.crest
                else self.carry - self.trough)


class _Relay:
    """A scored crossing from an anchor back to a predecessor chain."""

    __slots__ = ("carry", "crest", "trough", "carry0", "cut", "prev")

    def __init__(self, carry, crest, trough, carry0, cut, prev):
        self.carry = carry          # chain score through this relay
        self.crest = crest          # running-score peak along the chain
        self.trough = trough        # running-score floor
        self.carry0 = carry0        # chain score just before this anchor
        self.cut = cut              # subject column where the chain enters
        self.prev = prev            # predecessor anchor index


class _Handoff:
    """Crossover placement between two anchors on different diagonals:
    where the chain leaves the predecessor (uq/us) and enters the current
    anchor (dq/ds), and how much of each anchor's score survives."""

    __slots__ = ("total", "uq", "us", "dq", "ds", "keep_up", "keep_dn")


def _pair_score(m, q, s, i, j, n):
    """Substitution score of n aligned letter pairs starting at (i, j);
    0 when n <= 0."""
    if n <= 0:
        return 0
    return int(m[q[i : i + n] & 31, s[j : j + n] & 31].sum())


def _crossover(m, q, s, ui, uj, un, uscore, di, dj, dn, dscore):
    """Best switch column between predecessor anchor u (higher diagonal)
    and current anchor d.  The chain follows u's diagonal to some column,
    jumps, and continues on d's diagonal; every admissible split inside
    the scan window is scored at once (prefix sums + argmax; ties go to
    the earliest split, matching the reference's strict-improvement
    sweep).  Returns a _Handoff or None when no split exists."""
    gap = (ui - uj) - (di - dj)
    u_last = uj + un - 1
    d_last = dj + dn - 1
    scan_last = min(max(dj, u_last + gap + 1 + CROSS_PAD), d_last)
    if u_last < dj - gap - 1:
        ja, spaced = u_last, True
    else:
        ja, spaced = max(dj - gap - 1 - CROSS_PAD, uj), False
    jb = ja + gap + 1
    if jb > d_last:
        return None
    ia = ui + (ja - uj)

    # score of d's run kept when entering at column jb (head extends the
    # run leftward to jb when jb < dj; tail clips it when jb > dj)
    keep_dn0 = (_pair_score(m, q, s, ia + 1, jb, dj - jb) + dscore
                - _pair_score(m, q, s, di, dj, jb - dj))

    steps = max(0, scan_last - jb)
    if steps:
        # both running sums consume the same query letters (the exit row
        # advances in lockstep with the entry row, one diagonal apart)
        qrow = q[ia + 1 : ia + 1 + steps] & 31
        gain_up = np.cumsum(m[qrow, s[ja + 1 : ja + 1 + steps] & 31])
        lose_dn = np.cumsum(m[qrow, s[jb : jb + steps] & 31])
        split = np.empty(steps + 1, dtype=np.int64)
        split[0] = keep_dn0
        split[1:] = keep_dn0 + gain_up - lose_dn
        k = int(np.argmax(split))
        total = int(split[k])
        up_at_k = int(gain_up[k - 1]) if k else 0
        dn_at_k = keep_dn0 - (int(lose_dn[k - 1]) if k else 0)
        up_final = int(gain_up[-1])
    else:
        k = 0
        total = keep_dn0
        up_at_k = 0
        dn_at_k = keep_dn0
        up_final = 0

    h = _Handoff()
    h.total = total
    h.uq, h.us = ia + k, ja + k
    h.dq, h.ds = ia + 1 + k, jb + k
    h.keep_dn = dn_at_k

    # score of u's run kept up to the exit: when the anchors are disjoint
    # in subject the whole run survives; otherwise clip/extend u's run at
    # the scan end and subtract the swept gains (they were already counted
    # into the split)
    keep_up = up_at_k
    if spaced:
        keep_up += uscore
    else:
        j_exit = scan_last - gap
        use = uj + un
        keep_up += (uscore
                    - _pair_score(m, q, s, (ui - uj) + j_exit, j_exit,
                                  use - j_exit)
                    + _pair_score(m, q, s, ui + un, use, j_exit - use)
                    - up_final)
    h.keep_up = keep_up
    return h


def _place_handoff(m, q, s, prev, cur):
    """Crossover between predecessor and current anchors; when the chain
    moves to a HIGHER diagonal the roles of query and subject swap (the
    jump is then horizontal in the transposed matrix)."""
    if prev.dg < cur.dg:
        h = _crossover(m, s, q, prev.sa, prev.qa, prev.n, prev.score,
                       cur.sa, cur.qa, cur.n, cur.score)
        if h is not None:
            h.uq, h.us = h.us, h.uq
            h.dq, h.ds = h.ds, h.dq
        return h
    return _crossover(m, q, s, prev.qa, prev.sa, prev.n, prev.score,
                      cur.qa, cur.sa, cur.n, cur.score)


class _Chainer:
    def __init__(self, query, subject, matrix32, gap_open, gap_extend,
                 query_len, subject_len):
        self.q = query
        self.s = subject
        self.m = matrix32
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.query_len = query_len
        self.subject_len = subject_len
        self.anchors: list[_Anchor] = []

    # -- relay bookkeeping ------------------------------------------------

    def _best_relay(self, a: _Anchor, s_cap: int):
        """Highest-carry relay of `a` whose cut lies before subject column
        s_cap; None when the anchor's own score wins.  Newest relay wins
        carry ties (reverse scan with strict improvement).  A zero-score
        anchor degenerately yields its newest relay (decision parity with
        the reference's unguarded lookup)."""
        if a.score == 0:
            return a.relays[-1] if a.relays else None
        best = None
        bar = a.score
        for r in reversed(a.relays):
            if r.cut < s_cap and r.carry > bar:
                best, bar = r, r.carry
        return best

    def _carry_at(self, a: _Anchor, s_cap: int):
        """(carry, crest, trough) of the best chain into `a` restricted to
        relays cut before s_cap."""
        r = self._best_relay(a, s_cap)
        if r is None:
            return a.score, a.score, a.score
        return (max(a.score, r.carry), max(a.score, r.crest), r.trough)

    def _add_relay(self, cur_idx: int, relay: _Relay):
        a = self.anchors[cur_idx]
        if relay.carry > a.carry:
            a.carry = relay.carry
            a.crest = relay.crest
            a.trough = relay.trough
        a.relays.append(relay)

    # -- sweep ------------------------------------------------------------

    def _try_relay(self, cur_idx: int, prev_idx: int, drift_cost: float):
        """Score a relay from chain-so-far at `prev` into `cur`; record it
        when it beats every existing relay of `cur` and the anchor's own
        score.  Returns the candidate carry (0 = rejected early)."""
        cur = self.anchors[cur_idx]
        prev = self.anchors[prev_idx]
        slide = cur.dg - prev.dg
        bend = (-self.gap_open - abs(slide) * self.gap_extend
                if slide != 0 else 0)
        span = cur.sa - prev.se if slide > 0 else cur.qa - prev.qe
        carry_new = 0
        crest = trough = carry0 = 0
        cut = 0
        if span <= 0 or drift_cost == 0.0:
            held = self._best_relay(cur, cur.sa)
            if (held is not None
                    and held.carry > prev.carry + bend + cur.score):
                return 0
            h = _place_handoff(self.m, self.q, self.s, prev, cur)
            if h is not None and h.total > 0:
                lost_up = prev.score - h.keep_up
                carry_prev, crest, trough = self._carry_at(prev, h.us)
                carry_new = carry_prev - lost_up + bend + h.keep_dn
                held = self._best_relay(cur, h.ds)
                if held is not None and held.carry > carry_new:
                    return 0
                carry0 = carry_new - h.keep_dn
                trough = min(trough, carry0)
                if carry_prev == crest:
                    crest -= lost_up
                cut = h.ds
        else:
            carry_new = (prev.carry + bend
                         - int(drift_cost * max(span - 1, 0)) + cur.score)
            held = self._best_relay(cur, cur.sa)
            if held is not None and held.carry > carry_new:
                return 0
            carry0 = carry_new - cur.score
            crest = prev.crest
            trough = min(prev.trough, carry0)
            cut = cur.sa

        if carry_new > cur.score:
            crest = max(crest, carry_new)
            self._add_relay(cur_idx, _Relay(
                carry_new, crest,
                carry_new if carry_new == crest else trough,
                carry0, cut, prev_idx))
        return carry_new

    def _stale(self, e: _Anchor, cur: _Anchor, drift_cost: float) -> bool:
        """Frontier eviction: the chain at `e` cannot reach `cur` with
        positive score once the drift cost of the subject span is paid."""
        return (e.carry
                - int(drift_cost * max(cur.sa - e.se, 0))) <= 0

    def sweep(self, drift_cost: float):
        """One pass over anchors in (subject, query) order; the frontier
        maps each diagonal to its latest anchor.  For every anchor, walk
        the frontier outward on both sides — evicting stale chains,
        skipping anchors shadowed by a nearer one — and try relays in both
        directions."""
        frontier: list[int] = []       # sorted diagonals
        latest: dict[int, int] = {}    # diagonal -> newest anchor index
        for cur_idx, cur in enumerate(self.anchors):
            dg = cur.dg
            if dg not in latest:
                insort(frontier, dg)
                latest[dg] = cur_idx
            at = bisect_left(frontier, dg)

            # lower diagonals: nearest first, shadowed by subject extent
            k = at
            shadow_s = 0
            while k > 0:
                k -= 1
                e_dg = frontier[k]
                e_idx = latest[e_dg]
                e = self.anchors[e_idx]
                if self._stale(e, cur, drift_cost):
                    del frontier[k]
                    del latest[e_dg]
                    at -= 1
                    continue
                if e.se < shadow_s:
                    continue
                self._try_relay(cur_idx, e_idx, drift_cost)
                shadow_s = max(shadow_s, min(cur.sa, e.se))
                if (e.se - (cur.se - min(e.dg - cur.dg, 0))
                        >= MIN_BACKLINK_HANG):
                    self._try_relay(e_idx, cur_idx, drift_cost)

            # higher diagonals: nearest first, shadowed by query extent
            k = at
            if k < len(frontier) and latest[frontier[k]] == cur_idx:
                k += 1
            shadow_q = 0
            while k < len(frontier):
                e_dg = frontier[k]
                e_idx = latest[e_dg]
                e = self.anchors[e_idx]
                if self._stale(e, cur, drift_cost) and e_dg != dg:
                    del frontier[k]
                    del latest[e_dg]
                    continue
                if e.qe < shadow_q:
                    k += 1
                    continue
                self._try_relay(cur_idx, e_idx, drift_cost)
                if e.qa < cur.qa:
                    shadow_q = max(shadow_q, min(e.qe, cur.qa))
                if (e.se - (cur.se - min(e.dg - cur.dg, 0))
                        >= MIN_BACKLINK_HANG):
                    self._try_relay(e_idx, cur_idx, drift_cost)
                k += 1
            latest[dg] = cur_idx

    # -- harvest ----------------------------------------------------------

    def _walk_chain(self, head: int, s_limit: int, shift_cap: int):
        """Follow the best-relay chain from `head` downward and emit one
        ApproxHsp.  Two phases: descend while each relay improves on the
        running ceiling, then settle on the terminal anchor (natural chain
        start, a relay whose band shift exceeds the cap — which yields the
        next head — or the deepest frame whose pre-anchor carry stays at
        the chain floor).  Returns (hsp, next_head or None)."""
        anchors = self.anchors
        top = anchors[head]
        t = ApproxHsp(d_min=POS_INF, d_max=NEG_INF, score=0, query_begin=0,
                      query_end=top.qe, subject_begin=0, subject_end=top.se)
        ceiling = top.carry
        floor = ceiling
        next_head = None

        trail: list[tuple[int, _Relay, int]] = []   # (anchor, relay, floor)
        node = head
        s_cap = min(top.se, s_limit)
        terminal = None
        term_floor = 0
        while True:
            a = anchors[node]
            r = self._best_relay(a, s_cap)
            if r is None:
                if a.score > ceiling:
                    break                      # dead walk: unwind below
                floor = min(floor, 0)
                terminal, term_floor = node, floor
                break
            if r.carry > ceiling:
                break                          # dead walk: unwind below
            floor = min(floor, r.carry0)
            slide = a.dg - anchors[r.prev].dg
            if abs(slide) > shift_cap:
                next_head = r.prev
                terminal, term_floor = node, floor
                break
            trail.append((node, r, floor))
            s_cap = r.cut if slide > 0 else r.cut + slide
            node = r.prev

        if terminal is None:
            # the descent died: settle on the deepest trail frame whose
            # pre-anchor carry did not undercut its floor
            while trail:
                node_k, r_k, floor_k = trail.pop()
                if r_k.carry0 > floor_k:
                    continue
                terminal, term_floor = node_k, floor_k
                trail.append((node_k, r_k, floor_k))
                break
            if terminal is None:
                return t, next_head            # nothing emitted

        term = anchors[terminal]
        t.query_begin = term.qa
        t.subject_begin = term.sa
        t.score = ceiling - term_floor
        for node_k, _r, _f in trail:
            dgk = anchors[node_k].dg
            t.d_max = max(t.d_max, dgk)
            t.d_min = min(t.d_min, dgk)
        t.d_max = max(t.d_max, term.dg)
        t.d_min = min(t.d_min, term.dg)
        return t, next_head

    def _admissible(self, ts, first, qr, sr, score, cutoff):
        """Stacked-HSP test against the HSPs already harvested this round:
        reject when the candidate is mostly covered by a stronger one and
        the uncovered remainder falls under the cutoff."""
        for h in ts[first:]:
            ls = sr[1] - sr[0]
            lq = qr[1] - qr[0]
            os_ = (_overlap(sr, (h.subject_begin, h.subject_end)) / ls
                   if ls else 0.0)
            oq = (_overlap(qr, (h.query_begin, h.query_end)) / lq
                  if lq else 0.0)
            if (1.0 - min(os_, oq)) * score / h.score >= STACK_RATIO:
                continue
            if (1.0 - max(os_, oq)) * score < cutoff:
                return False
        return True

    def harvest(self, ts: list, cutoff: int, shift_cap: int):
        """Emit chains best-first.  Each candidate head may yield several
        HSPs: when a relay's band shift exceeds the cap the walk restarts
        from the far side, constrained to earlier subject columns."""
        anchors = self.anchors
        heads = [k for k in range(len(anchors))
                 if anchors[k].peak_gain() >= cutoff]
        heads.sort(key=lambda k: (-anchors[k].peak_gain(), k))
        first = len(ts)
        for k in heads:
            a = anchors[k]
            if not self._admissible(ts, first, (a.qa, a.qe), (a.sa, a.se),
                                    a.score, cutoff):
                continue
            s_limit = self.subject_len
            head = k
            while head is not None:
                t, head = self._walk_chain(head, s_limit, shift_cap)
                if t.score > 0:
                    s_limit = t.subject_begin
                if t.score >= cutoff and self._admissible(
                        ts, first, (t.query_begin, t.query_end),
                        (t.subject_begin, t.subject_end), t.score, cutoff):
                    ts.append(t)

    # -- setup ------------------------------------------------------------

    def load(self, segments):
        """One anchor per diagonal run start: segments arrive sorted by
        (diagonal, subject); consecutive same-diagonal segments collapse
        unless they start beyond the running subject extent."""
        dg = NEG_INF
        reach = NEG_INF
        for seg in segments:
            d2 = seg.diag
            if d2 != dg:
                dg = d2
                self.anchors.append(_Anchor(seg.i, seg.j, seg.len,
                                            seg.score))
                reach = self.anchors[-1].se
            elif reach < seg.j:
                self.anchors.append(_Anchor(seg.i, seg.j, seg.len,
                                            seg.score))
                reach = max(reach, self.anchors[-1].se)

    def prune(self):
        """Drop anchors dominated by more than COVER_CAP stronger anchors
        covering the same subject range; eviction order of the running
        window fixes the final anchor order."""
        settled: list[_Anchor] = []
        window: list[_Anchor] = []
        for a in self.anchors:
            dominated = 0
            live = []
            for e in window:
                if e.se > a.sa:
                    if e.score >= a.score and e.sa <= a.sa and e.se >= a.se:
                        dominated += 1
                    live.append(e)
                else:
                    settled.append(e)
            window = live
            if dominated <= COVER_CAP:
                window.append(a)
        settled.extend(window)
        self.anchors = settled

    def chain(self, segments, drift_cost=DRIFT_COST, cutoff=CHAIN_CUTOFF,
              shift_cap=BAND_SHIFT_CAP):
        """Full pipeline: load anchors, cap the anchor count by cumulative
        length (2x query length, floor 200), order by (subject, query),
        prune, sweep, harvest."""
        self.load(segments)
        anchors = self.anchors
        if len(anchors) > 200:
            order = sorted(range(len(anchors)),
                           key=lambda k: (-anchors[k].score, k))
            budget = self.query_len * 2.0
            used = 0.0
            take = 0
            while take < len(order) and used < budget:
                used += anchors[order[take]].n
                take += 1
            keep = sorted(order[: max(200, take)])
            self.anchors = anchors = [anchors[k] for k in keep]
        anchors.sort(key=lambda a: (a.sa, a.qa))
        self.prune()
        self.sweep(drift_cost)
        ts: list[ApproxHsp] = []
        self.harvest(ts, cutoff, shift_cap)
        return ts


def _overlap(a, b):
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def chain_graph(segments, query, subject, matrix32, gap_open, gap_extend,
                query_len=None, subject_len=None):
    """Chain one target's anchor segments into band-selecting ApproxHsps
    (reference greedy_align.cpp:482-497 Chaining::run): a single segment
    passes through uncut; multiple run the graph chainer, then adjacent
    compatible HSPs merge."""
    from diamond_tpu_torch.align.chain import merge_hsps

    if not segments:
        return []
    if len(segments) == 1:
        s = segments[0]
        return [ApproxHsp(d_min=s.diag, d_max=s.diag, score=s.score,
                          query_begin=s.i, query_end=s.query_end,
                          subject_begin=s.j, subject_end=s.subject_end)]
    segs = sorted(segments, key=lambda s: (s.diag, s.j))
    ch = _Chainer(query, subject, matrix32, gap_open, gap_extend,
                  len(query) if query_len is None else query_len,
                  len(subject) if subject_len is None else subject_len)
    ts = ch.chain(segs)
    return merge_hsps(ts)
