// Band-selection chaining over an anchor relay graph + the fused
// per-query first-round stage (native twin of
// diamond_tpu/align/chaining_graph.py and the per-target loop of
// align/extend.py ungapped_stage; decision-compatible with the
// reference chainer, src/chaining/greedy_align.cpp, diag_graph.h,
// backtrace.cpp — same scores and tie-breaks, own structure).
//
// ungapped_stage_many runs, for every target of one query's ranking
// chunk: the (diag, j) stable sort of its seed hits, the x-drop chain
// extension with the skip rule, the relay-graph sweep + harvest, and
// the pairwise HSP merge — emitting ApproxHsp rows
// [d_min, d_max, score, query_begin, query_end, subject_begin,
// subject_end] in a CSR layout.  The Python module remains the
// bit-identical oracle.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" void xdrop_ungapped_one(const int8_t*, const int8_t*,
                                   const int8_t*, int64_t, int64_t,
                                   const int32_t*, int32_t, int64_t*);

namespace {

constexpr double DRIFT_COST = 0.1;
constexpr double GAP_PENALTY = 0.5;
constexpr int64_t CROSS_PAD = 10;
constexpr int64_t MIN_BACKLINK_HANG = 10;
constexpr int64_t COVER_CAP = 8;
constexpr double STACK_RATIO = 0.5;
constexpr int64_t CHAIN_CUTOFF = 19;
constexpr int64_t BAND_SHIFT_CAP = 2000;
constexpr int64_t I64_MIN = -(int64_t(1) << 62);
constexpr int64_t I64_MAX = int64_t(1) << 62;

struct Seg {
    int64_t i, j, len, score;
    int64_t diag() const { return i - j; }
    int64_t query_end() const { return i + len; }
    int64_t subject_end() const { return j + len; }
};

struct Hsp {
    int64_t d_min, d_max, score;
    int64_t query_begin, query_end, subject_begin, subject_end;
};

// A scored crossing from an anchor back to a predecessor chain.
struct Relay {
    int64_t carry;   // chain score through this relay
    int64_t crest;   // running-score peak along the chain
    int64_t trough;  // running-score floor
    int64_t carry0;  // chain score just before this anchor
    int64_t cut;     // subject column where the chain enters
    int32_t prev;    // predecessor anchor index
};

// One maximal ungapped run plus the chain state the sweep accumulates.
struct Anchor {
    int64_t qa, sa, n, score;
    int64_t carry, crest, trough;
    std::vector<Relay> relays;
    int64_t dg() const { return qa - sa; }
    int64_t qe() const { return qa + n; }
    int64_t se() const { return sa + n; }
    // chain value ranking harvest starts: full carry when the chain
    // never dipped, otherwise carry above its floor
    int64_t peak_gain() const {
        return carry == crest ? carry : carry - trough;
    }
};

// Crossover placement between two anchors: where the chain leaves the
// predecessor (uq/us) and enters the current anchor (dq/ds), and how
// much of each anchor's score survives.
struct Handoff {
    int64_t total;
    int64_t uq, us, dq, ds;
    int64_t keep_up, keep_dn;
};

inline int64_t pair_score(const int32_t* m, const int8_t* q,
                          const int8_t* s, int64_t i, int64_t j, int64_t n) {
    int64_t acc = 0;
    for (int64_t k = 0; k < n; ++k)
        acc += m[(q[i + k] & 31) * 32 + (s[j + k] & 31)];
    return acc;
}

// Best switch column between predecessor anchor u (higher diagonal) and
// current anchor d: scan every admissible split once tracking only the
// best index (first max wins), then reconstruct the handoff from it.
// Returns false when no split exists.
bool crossover(const int32_t* m, const int8_t* q, const int8_t* s,
               int64_t ui, int64_t uj, int64_t un, int64_t uscore,
               int64_t di, int64_t dj, int64_t dn, int64_t dscore,
               Handoff& h) {
    const int64_t gap = (ui - uj) - (di - dj);
    const int64_t u_last = uj + un - 1;
    const int64_t d_last = dj + dn - 1;
    const int64_t scan_last =
        std::min(std::max(dj, u_last + gap + 1 + CROSS_PAD), d_last);
    int64_t ja;
    bool spaced;
    if (u_last < dj - gap - 1) {
        ja = u_last;
        spaced = true;
    } else {
        ja = std::max(dj - gap - 1 - CROSS_PAD, uj);
        spaced = false;
    }
    const int64_t jb = ja + gap + 1;
    if (jb > d_last)
        return false;
    const int64_t ia = ui + (ja - uj);

    // d's run entered at column jb: head extends it leftward when
    // jb < dj, tail clips it when jb > dj
    const int64_t keep_dn0 = pair_score(m, q, s, ia + 1, jb, dj - jb) +
                             dscore - pair_score(m, q, s, di, dj, jb - dj);

    const int64_t steps = std::max(int64_t(0), scan_last - jb);
    // both running sums consume the same query letters (the exit row
    // advances in lockstep with the entry row, one diagonal apart)
    int64_t up_run = 0, dn_run = 0;
    int64_t best = keep_dn0, best_k = 0;
    for (int64_t k = 1; k <= steps; ++k) {
        const int64_t letter = q[ia + k] & 31;
        up_run += m[letter * 32 + (s[ja + k] & 31)];
        dn_run += m[letter * 32 + (s[jb + k - 1] & 31)];
        const int64_t val = keep_dn0 + up_run - dn_run;
        if (val > best) {
            best = val;
            best_k = k;
        }
    }
    const int64_t up_final = up_run;
    const int64_t up_at_k =
        pair_score(m, q, s, ia + 1, ja + 1, best_k);
    const int64_t dn_at_k =
        keep_dn0 - pair_score(m, q, s, ia + 1, jb, best_k);

    h.total = best;
    h.uq = ia + best_k;
    h.us = ja + best_k;
    h.dq = ia + 1 + best_k;
    h.ds = jb + best_k;
    h.keep_dn = dn_at_k;

    // u's run kept up to the exit: disjoint anchors keep the whole run;
    // otherwise clip/extend u's run at the scan end and subtract the
    // swept gains (already counted into the split)
    int64_t keep_up = up_at_k;
    if (spaced) {
        keep_up += uscore;
    } else {
        const int64_t j_exit = scan_last - gap;
        const int64_t use = uj + un;
        keep_up += uscore -
                   pair_score(m, q, s, (ui - uj) + j_exit, j_exit,
                              use - j_exit) +
                   pair_score(m, q, s, ui + un, use, j_exit - use) -
                   up_final;
    }
    h.keep_up = keep_up;
    return true;
}

// When the chain moves to a HIGHER diagonal the roles of query and
// subject swap (the jump is then horizontal in the transposed matrix).
bool place_handoff(const int32_t* m, const int8_t* q, const int8_t* s,
                   const Anchor& prev, const Anchor& cur, Handoff& h) {
    if (prev.dg() < cur.dg()) {
        if (!crossover(m, s, q, prev.sa, prev.qa, prev.n, prev.score,
                       cur.sa, cur.qa, cur.n, cur.score, h))
            return false;
        std::swap(h.uq, h.us);
        std::swap(h.dq, h.ds);
        return true;
    }
    return crossover(m, q, s, prev.qa, prev.sa, prev.n, prev.score,
                     cur.qa, cur.sa, cur.n, cur.score, h);
}

struct Chainer {
    const int8_t* q;
    const int8_t* s;
    const int32_t* m;
    int64_t gap_open, gap_extend;
    int64_t query_len, subject_len;
    std::vector<Anchor> anchors;

    // Highest-carry relay of `a` cut before subject column s_cap;
    // null when the anchor's own score wins.  Newest relay wins carry
    // ties (reverse scan, strict improvement).  A zero-score anchor
    // degenerately yields its newest relay (decision parity with the
    // reference's unguarded lookup).
    const Relay* best_relay(const Anchor& a, int64_t s_cap) const {
        if (a.score == 0)
            return a.relays.empty() ? nullptr : &a.relays.back();
        const Relay* pick = nullptr;
        int64_t bar = a.score;
        for (auto it = a.relays.rbegin(); it != a.relays.rend(); ++it)
            if (it->cut < s_cap && it->carry > bar) {
                pick = &*it;
                bar = it->carry;
            }
        return pick;
    }

    // (carry, crest, trough) of the best chain into `a` restricted to
    // relays cut before s_cap.
    void carry_at(const Anchor& a, int64_t s_cap, int64_t& carry,
                  int64_t& crest, int64_t& trough) const {
        const Relay* r = best_relay(a, s_cap);
        if (!r) {
            carry = crest = trough = a.score;
            return;
        }
        carry = std::max(a.score, r->carry);
        crest = std::max(a.score, r->crest);
        trough = r->trough;
    }

    void add_relay(Anchor& a, const Relay& r) {
        if (r.carry > a.carry) {
            a.carry = r.carry;
            a.crest = r.crest;
            a.trough = r.trough;
        }
        a.relays.push_back(r);
    }

    // Score a relay from the chain-so-far at `prev` into `cur`; record
    // it when it beats every existing relay of `cur` and the anchor's
    // own score.
    void try_relay(int32_t cur_idx, int32_t prev_idx, double drift_cost) {
        Anchor& cur = anchors[cur_idx];
        Anchor& prev = anchors[prev_idx];
        const int64_t slide = cur.dg() - prev.dg();
        const int64_t bend =
            slide != 0 ? -gap_open - std::abs(slide) * gap_extend : 0;
        const int64_t span =
            slide > 0 ? cur.sa - prev.se() : cur.qa - prev.qe();
        int64_t carry_new = 0;
        int64_t crest = 0, trough = 0, carry0 = 0, cut = 0;
        if (span <= 0 || drift_cost == 0.0) {
            const Relay* held = best_relay(cur, cur.sa);
            if (held && held->carry > prev.carry + bend + cur.score)
                return;
            Handoff h;
            if (place_handoff(m, q, s, prev, cur, h) && h.total > 0) {
                const int64_t lost_up = prev.score - h.keep_up;
                int64_t carry_prev;
                carry_at(prev, h.us, carry_prev, crest, trough);
                carry_new = carry_prev - lost_up + bend + h.keep_dn;
                held = best_relay(cur, h.ds);
                if (held && held->carry > carry_new)
                    return;
                carry0 = carry_new - h.keep_dn;
                trough = std::min(trough, carry0);
                if (carry_prev == crest)
                    crest -= lost_up;
                cut = h.ds;
            }
        } else {
            carry_new =
                prev.carry + bend -
                (int64_t)(drift_cost *
                          (double)std::max(span - 1, int64_t(0))) +
                cur.score;
            const Relay* held = best_relay(cur, cur.sa);
            if (held && held->carry > carry_new)
                return;
            carry0 = carry_new - cur.score;
            crest = prev.crest;
            trough = std::min(prev.trough, carry0);
            cut = cur.sa;
        }
        if (carry_new > cur.score) {
            crest = std::max(crest, carry_new);
            add_relay(cur, Relay{carry_new, crest,
                                 carry_new == crest ? carry_new : trough,
                                 carry0, cut, prev_idx});
        }
    }

    // Frontier eviction: the chain at `e` cannot reach `cur` with a
    // positive score once the drift cost of the subject span is paid.
    bool stale(const Anchor& e, const Anchor& cur,
               double drift_cost) const {
        return e.carry -
                   (int64_t)(drift_cost *
                             (double)std::max(cur.sa - e.se(),
                                              int64_t(0))) <=
               0;
    }

    // One pass over anchors in (subject, query) order; the frontier
    // maps each diagonal to its latest anchor.  Walk the frontier
    // outward on both sides — evicting stale chains, skipping anchors
    // shadowed by a nearer one — and try relays in both directions.
    void sweep(double drift_cost) {
        std::vector<std::pair<int64_t, int32_t>> frontier;  // (diag, idx)
        frontier.reserve(anchors.size());
        for (int32_t cur_idx = 0; cur_idx < (int32_t)anchors.size();
             ++cur_idx) {
            const Anchor& cur = anchors[cur_idx];
            const int64_t dg = cur.dg();
            auto pos = std::lower_bound(frontier.begin(), frontier.end(),
                                        std::make_pair(dg, INT32_MIN));
            if (pos == frontier.end() || pos->first != dg)
                pos = frontier.insert(pos, {dg, cur_idx});
            int64_t at = pos - frontier.begin();

            // lower diagonals: nearest first, shadowed by subject extent
            int64_t k = at;
            int64_t shadow_s = 0;
            while (k > 0) {
                --k;
                const int32_t e_idx = frontier[k].second;
                const Anchor& e = anchors[e_idx];
                if (stale(e, cur, drift_cost)) {
                    frontier.erase(frontier.begin() + k);
                    --at;
                    continue;
                }
                if (e.se() < shadow_s)
                    continue;
                try_relay(cur_idx, e_idx, drift_cost);
                shadow_s = std::max(shadow_s, std::min(cur.sa, e.se()));
                if (e.se() - (cur.se() - std::min(e.dg() - cur.dg(),
                                                  int64_t(0))) >=
                    MIN_BACKLINK_HANG)
                    try_relay(e_idx, cur_idx, drift_cost);
            }

            // higher diagonals: nearest first, shadowed by query extent
            k = at;
            if (k < (int64_t)frontier.size() &&
                frontier[k].second == cur_idx)
                ++k;
            int64_t shadow_q = 0;
            while (k < (int64_t)frontier.size()) {
                const int64_t e_dg = frontier[k].first;
                const int32_t e_idx = frontier[k].second;
                const Anchor& e = anchors[e_idx];
                if (stale(e, cur, drift_cost) && e_dg != dg) {
                    frontier.erase(frontier.begin() + k);
                    continue;
                }
                if (e.qe() < shadow_q) {
                    ++k;
                    continue;
                }
                try_relay(cur_idx, e_idx, drift_cost);
                if (e.qa < cur.qa)
                    shadow_q = std::max(shadow_q,
                                        std::min(e.qe(), cur.qa));
                if (e.se() - (cur.se() - std::min(e.dg() - cur.dg(),
                                                  int64_t(0))) >=
                    MIN_BACKLINK_HANG)
                    try_relay(e_idx, cur_idx, drift_cost);
                ++k;
            }
            // (re)bind this diagonal to the current anchor
            auto pos2 = std::lower_bound(frontier.begin(), frontier.end(),
                                         std::make_pair(dg, INT32_MIN));
            if (pos2 != frontier.end() && pos2->first == dg)
                pos2->second = cur_idx;
            else
                frontier.insert(pos2, {dg, cur_idx});
        }
    }

    // Follow the best-relay chain from `head` downward and emit one
    // HSP.  Two phases: descend while each relay improves on the
    // running ceiling, then settle on the terminal anchor (natural
    // chain start, a relay whose band shift exceeds the cap — which
    // yields the next head — or the deepest frame whose pre-anchor
    // carry stays at the chain floor).
    void walk_chain(int32_t head, int64_t s_limit, Hsp& t,
                    int32_t& next_head) const {
        const Anchor& top = anchors[head];
        t = Hsp{I64_MAX, I64_MIN, 0, 0, top.qe(), 0, top.se()};
        const int64_t ceiling = top.carry;
        int64_t floor = ceiling;
        next_head = -1;

        struct Frame {
            int32_t node;
            const Relay* relay;
            int64_t floor;
        };
        std::vector<Frame> trail;
        int32_t node = head;
        int64_t s_cap = std::min(top.se(), s_limit);
        int32_t terminal = -1;
        int64_t term_floor = 0;
        for (;;) {
            const Anchor& a = anchors[node];
            const Relay* r = best_relay(a, s_cap);
            if (!r) {
                if (a.score > ceiling)
                    break;  // dead walk: unwind below
                floor = std::min(floor, int64_t(0));
                terminal = node;
                term_floor = floor;
                break;
            }
            if (r->carry > ceiling)
                break;  // dead walk: unwind below
            floor = std::min(floor, r->carry0);
            const int64_t slide = a.dg() - anchors[r->prev].dg();
            if (std::abs(slide) > BAND_SHIFT_CAP) {
                next_head = r->prev;
                terminal = node;
                term_floor = floor;
                break;
            }
            trail.push_back({node, r, floor});
            s_cap = slide > 0 ? r->cut : r->cut + slide;
            node = r->prev;
        }

        if (terminal < 0) {
            // the descent died: settle on the deepest trail frame whose
            // pre-anchor carry did not undercut its floor
            while (!trail.empty()) {
                const Frame f = trail.back();
                trail.pop_back();
                if (f.relay->carry0 > f.floor)
                    continue;
                terminal = f.node;
                term_floor = f.floor;
                trail.push_back(f);
                break;
            }
            if (terminal < 0)
                return;  // nothing emitted
        }

        const Anchor& term = anchors[terminal];
        t.query_begin = term.qa;
        t.subject_begin = term.sa;
        t.score = ceiling - term_floor;
        for (const Frame& f : trail) {
            const int64_t dgk = anchors[f.node].dg();
            t.d_max = std::max(t.d_max, dgk);
            t.d_min = std::min(t.d_min, dgk);
        }
        t.d_max = std::max(t.d_max, term.dg());
        t.d_min = std::min(t.d_min, term.dg());
    }

    // Stacked-HSP test against the HSPs already harvested this round:
    // reject when the candidate is mostly covered by a stronger one and
    // the uncovered remainder falls under the cutoff.
    static bool admissible(const std::vector<Hsp>& ts, int64_t first,
                           int64_t qb, int64_t qe, int64_t sb, int64_t se,
                           int64_t score, int64_t cutoff) {
        for (int64_t k = first; k < (int64_t)ts.size(); ++k) {
            const Hsp& h = ts[k];
            const int64_t ls = se - sb;
            const int64_t lq = qe - qb;
            const int64_t ovs = std::max(
                int64_t(0),
                std::min(se, h.subject_end) - std::max(sb, h.subject_begin));
            const int64_t ovq = std::max(
                int64_t(0),
                std::min(qe, h.query_end) - std::max(qb, h.query_begin));
            const double os = ls ? (double)ovs / (double)ls : 0.0;
            const double oq = lq ? (double)ovq / (double)lq : 0.0;
            if ((1.0 - std::min(os, oq)) * (double)score /
                    (double)h.score >=
                STACK_RATIO)
                continue;
            if ((1.0 - std::max(os, oq)) * (double)score < (double)cutoff)
                return false;
        }
        return true;
    }

    // Emit chains best-first.  Each candidate head may yield several
    // HSPs: when a relay's band shift exceeds the cap the walk restarts
    // from the far side, constrained to earlier subject columns.
    void harvest(std::vector<Hsp>& ts, int64_t cutoff) const {
        std::vector<int32_t> heads;
        for (int32_t k = 0; k < (int32_t)anchors.size(); ++k)
            if (anchors[k].peak_gain() >= cutoff)
                heads.push_back(k);
        std::stable_sort(heads.begin(), heads.end(),
                         [&](int32_t a, int32_t b) {
                             return anchors[a].peak_gain() >
                                    anchors[b].peak_gain();
                         });
        const int64_t first = ts.size();
        for (const int32_t k : heads) {
            const Anchor& a = anchors[k];
            if (!admissible(ts, first, a.qa, a.qe(), a.sa, a.se(), a.score,
                            cutoff))
                continue;
            int64_t s_limit = subject_len;
            int32_t head = k;
            while (head >= 0) {
                Hsp t;
                int32_t next_head;
                walk_chain(head, s_limit, t, next_head);
                if (t.score > 0)
                    s_limit = t.subject_begin;
                if (t.score >= cutoff &&
                    admissible(ts, first, t.query_begin, t.query_end,
                               t.subject_begin, t.subject_end, t.score,
                               cutoff))
                    ts.push_back(t);
                head = next_head;
            }
        }
    }

    // One anchor per diagonal run start: segments arrive sorted by
    // (diagonal, subject); consecutive same-diagonal segments collapse
    // unless they start beyond the running subject extent.
    void load(const Seg* segs, int64_t count) {
        int64_t dg = I64_MIN;
        int64_t reach = I64_MIN;
        for (int64_t k = 0; k < count; ++k) {
            const Seg& seg = segs[k];
            const int64_t d2 = seg.diag();
            if (d2 != dg) {
                dg = d2;
                anchors.push_back(Anchor{seg.i, seg.j, seg.len, seg.score,
                                         seg.score, seg.score, seg.score,
                                         {}});
                reach = anchors.back().se();
            } else if (reach < seg.j) {
                anchors.push_back(Anchor{seg.i, seg.j, seg.len, seg.score,
                                         seg.score, seg.score, seg.score,
                                         {}});
                reach = std::max(reach, anchors.back().se());
            }
        }
    }

    // Drop anchors dominated by more than COVER_CAP stronger anchors
    // covering the same subject range; the eviction order of the
    // running window fixes the final anchor order.
    void prune() {
        std::vector<Anchor> settled;
        std::vector<Anchor> window;
        for (Anchor& a : anchors) {
            int64_t dominated = 0;
            std::vector<Anchor> live;
            for (Anchor& e : window) {
                if (e.se() > a.sa) {
                    if (e.score >= a.score && e.sa <= a.sa &&
                        e.se() >= a.se())
                        ++dominated;
                    live.push_back(std::move(e));
                } else {
                    settled.push_back(std::move(e));
                }
            }
            window = std::move(live);
            if (dominated <= COVER_CAP)
                window.push_back(std::move(a));
        }
        for (Anchor& e : window)
            settled.push_back(std::move(e));
        anchors = std::move(settled);
    }

    // Full pipeline: load anchors, cap the anchor count by cumulative
    // length (2x query length, floor 200), order by (subject, query),
    // prune, sweep, harvest.
    void chain(const Seg* segs, int64_t count, std::vector<Hsp>& ts) {
        load(segs, count);
        if ((int64_t)anchors.size() > 200) {
            std::vector<int32_t> order(anchors.size());
            for (size_t k = 0; k < order.size(); ++k)
                order[k] = (int32_t)k;
            std::stable_sort(order.begin(), order.end(),
                             [&](int32_t a, int32_t b) {
                                 return anchors[a].score >
                                        anchors[b].score;
                             });
            const double budget = (double)query_len * 2.0;
            double used = 0.0;
            int64_t take = 0;
            while (take < (int64_t)order.size() && used < budget) {
                used += (double)anchors[order[take]].n;
                ++take;
            }
            order.resize(std::max(int64_t(200), take));
            std::sort(order.begin(), order.end());
            std::vector<Anchor> kept;
            kept.reserve(order.size());
            for (const int32_t k : order)
                kept.push_back(std::move(anchors[k]));
            anchors = std::move(kept);
        }
        std::stable_sort(anchors.begin(), anchors.end(),
                         [](const Anchor& a, const Anchor& b) {
                             return a.sa != b.sa ? a.sa < b.sa
                                                 : a.qa < b.qa;
                         });
        prune();
        sweep(DRIFT_COST);
        harvest(ts, CHAIN_CUTOFF);
    }
};

// reference greedy_align.cpp:427-438
inline int64_t merge_score(const Hsp& h1, const Hsp& h2) {
    const int64_t gq = h2.query_begin - h1.query_end;
    const int64_t gt = h2.subject_begin - h1.subject_end;
    if (gq < 0 || gt < 0)
        return 0;
    const int64_t s = h1.score + h2.score;
    if (gq > gt)
        return (int64_t)((double)s - (double)gq * GAP_PENALTY -
                         (double)gt * DRIFT_COST);
    return (int64_t)((double)s - (double)gt * GAP_PENALTY -
                     (double)gq * DRIFT_COST);
}

inline Hsp merge2(const Hsp& h1, const Hsp& h2) {
    return Hsp{std::min(h1.d_min, h2.d_min), std::max(h1.d_max, h2.d_max),
               merge_score(h1, h2), h1.query_begin, h2.query_end,
               h1.subject_begin, h2.subject_end};
}

// reference greedy_align.cpp:461-482
void merge_hsps(std::vector<Hsp>& out) {
    size_t i = 0;
    while (i < out.size()) {
        size_t k = i + 1;
        while (k < out.size()) {
            if (merge_score(out[i], out[k]) >
                std::max(out[i].score, out[k].score)) {
                out[i] = merge2(out[i], out[k]);
                out.erase(out.begin() + k);
            } else if (merge_score(out[k], out[i]) >
                       std::max(out[i].score, out[k].score)) {
                out[i] = merge2(out[k], out[i]);
                out.erase(out.begin() + k);
            } else {
                ++k;
            }
        }
        ++i;
    }
}

// Chaining for one target (reference greedy_align.cpp:482-497
// Chaining::run): a single segment passes through uncut; multiple run
// the graph chainer then merge_hsps.  Appends to ts.
void chain_one(const int8_t* query, const int8_t* subject,
               const int32_t* matrix32, int64_t gap_open, int64_t gap_extend,
               int64_t query_len, int64_t subject_len, Seg* segs, int64_t n,
               std::vector<Hsp>& ts) {
    if (n == 0)
        return;
    if (n == 1) {
        const Seg& s = segs[0];
        ts.push_back(Hsp{s.diag(), s.diag(), s.score, s.i, s.query_end(),
                         s.j, s.subject_end()});
        return;
    }
    std::stable_sort(segs, segs + n, [](const Seg& a, const Seg& b) {
        const int64_t da = a.diag(), db = b.diag();
        return da != db ? da < db : a.j < b.j;
    });
    Chainer ch{query, subject, matrix32, gap_open, gap_extend, query_len,
               subject_len, {}};
    ch.chain(segs, n, ts);
    merge_hsps(ts);
}

}  // namespace

// Fused first-round extension stage for one query over a chunk of
// targets (native twin of the per-target loop in align/extend.py
// extend_query_gen; reference ungapped.cpp:62-150 + greedy_align.cpp).
// Inputs are CSR seed-hit arrays per target; hits need not be pre-sorted
// (the (diag, j) stable sort runs here).  Outputs: per-target max hit
// score, and ApproxHsp rows [d_min, d_max, score, qb, qe, sb, se] in CSR
// (out_start[nt+1], out_hsp capacity = total hit count).  Returns total
// HSP rows written, or -1 if the output would exceed `cap` rows (the
// caller falls back to the Python oracle; the harvest can in rare
// cases emit more HSPs than seed hits).
extern "C" int64_t ungapped_stage_many(
    const int8_t* q,           // padded query view (letters + q_start)
    const int8_t* bias,        // Hauser bias over the query view, or null
    const int8_t* t_letters,   // target block letters base
    const int64_t* t_starts,   // absolute start per chunk target [nt]
    const int64_t* t_lens,     // true length per chunk target [nt]
    const int64_t* grp_start,  // CSR offsets into hit arrays [nt+1]
    const int64_t* hit_i, const int64_t* hit_j, const int64_t* hit_score,
    int64_t nt, const int32_t* matrix32, int32_t xdrop,
    int64_t gap_open, int64_t gap_extend, int64_t query_len,
    int64_t cap,              // out_hsp row capacity
    int64_t* ungapped_score,  // [nt]
    int64_t* out_start,       // [nt+1]
    int64_t* out_hsp) {       // [cap, 7]
    std::vector<int64_t> idx;
    std::vector<Seg> segs;
    std::vector<Hsp> ts;
    int64_t written = 0;
    out_start[0] = 0;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t h0 = grp_start[t], h1 = grp_start[t + 1];
        const int64_t nh = h1 - h0;
        const int8_t* subject = t_letters + t_starts[t];
        int64_t best = 0;
        for (int64_t k = h0; k < h1; ++k)
            best = std::max(best, hit_score[k]);
        ungapped_score[t] = best;
        // (diag, j) stable sort of the hit order (align/extend.py:207)
        idx.resize(nh);
        for (int64_t k = 0; k < nh; ++k)
            idx[k] = h0 + k;
        std::stable_sort(idx.begin(), idx.end(),
                         [&](int64_t a, int64_t b) {
                             const int64_t da = hit_i[a] - hit_j[a];
                             const int64_t db = hit_i[b] - hit_j[b];
                             return da != db ? da < db
                                             : hit_j[a] < hit_j[b];
                         });
        // x-drop chain extension with the skip rule (ungapped.cpp:62-150)
        segs.clear();
        int64_t one[4];
        for (int64_t k = 0; k < nh; ++k) {
            const int64_t i = hit_i[idx[k]], j = hit_j[idx[k]];
            if (!segs.empty() && segs.back().diag() == i - j &&
                segs.back().subject_end() >= j)
                continue;
            xdrop_ungapped_one(q, bias, subject, i, j, matrix32, xdrop, one);
            if (one[3] > 0)
                segs.push_back(Seg{one[0], one[1], one[2], one[3]});
        }
        ts.clear();
        chain_one(q, subject, matrix32, gap_open, gap_extend, query_len,
                  t_lens[t], segs.data(), (int64_t)segs.size(), ts);
        if (written + (int64_t)ts.size() > cap)
            return -1;
        for (const Hsp& h : ts) {
            int64_t* row = out_hsp + 7 * written;
            row[0] = h.d_min;
            row[1] = h.d_max;
            row[2] = h.score;
            row[3] = h.query_begin;
            row[4] = h.query_end;
            row[5] = h.subject_begin;
            row[6] = h.subject_end;
            ++written;
        }
        out_start[t + 1] = written;
    }
    return written;
}

// ungapped_stage_many with the chunk selection done natively: callers
// pass the per-query CSR (ha.gstart/hi/hj/hscore over ALL targets) plus
// the ranking-chunk target indices; the per-chunk gathers that the
// Python wrapper used to do with ~8 numpy calls per query become two
// small C loops.
extern "C" int64_t ungapped_stage_chunk_sel(
    const int8_t* q, const int8_t* bias, const int8_t* t_letters,
    const int64_t* chunk, int64_t nt, const int64_t* tids,
    const int64_t* block_starts, const int64_t* block_lens,
    const int64_t* gstart, const int64_t* hit_i, const int64_t* hit_j,
    const int64_t* hit_score, const int32_t* matrix32, int32_t xdrop,
    int64_t gap_open, int64_t gap_extend, int64_t query_len, int64_t cap,
    int64_t* ungapped_score, int64_t* out_start, int64_t* out_hsp) {
    static thread_local std::vector<int64_t> ts, tl, gs, hi, hj, hs;
    ts.resize(nt);
    tl.resize(nt);
    gs.resize(nt + 1);
    gs[0] = 0;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t g = chunk[t];
        ts[t] = block_starts[tids[g]];
        tl[t] = block_lens[tids[g]];
        gs[t + 1] = gs[t] + (gstart[g + 1] - gstart[g]);
    }
    hi.resize(gs[nt]);
    hj.resize(gs[nt]);
    hs.resize(gs[nt]);
    int64_t o = 0;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t g = chunk[t];
        for (int64_t k = gstart[g]; k < gstart[g + 1]; ++k, ++o) {
            hi[o] = hit_i[k];
            hj[o] = hit_j[k];
            hs[o] = hit_score[k];
        }
    }
    return ungapped_stage_many(q, bias, t_letters, ts.data(), tl.data(),
                               gs.data(), hi.data(), hj.data(), hs.data(),
                               nt, matrix32, xdrop, gap_open, gap_extend,
                               query_len, cap, ungapped_score, out_start,
                               out_hsp);
}

// Whole-wave first-round stage: ungapped_stage_many over MANY queries in
// one call (the reference's per-thread align_queries partition over the
// extension work list, src/align/align.cpp:203-269, as a single flat
// pass; replaces one native call per query with one per wave).  Groups
// are (query, target) runs of the globally-sorted hit table; query q
// owns groups [q_grp_lo[q], q_grp_lo[q+1]).  Hit CSR offsets are
// absolute into hit_i/hit_j/hit_score.  Returns rows written or -1 when
// cap is exceeded (caller regrows).
extern "C" int64_t ungapped_stage_queries(
    const int8_t* q_letters, const int8_t* bias_all, const int8_t* t_letters,
    const int64_t* q_starts,   // block starts per query id
    const int64_t* qids,       // [nq] query ids
    const int64_t* q_grp_lo,   // [nq+1] group bounds per query
    const int64_t* q_lens,     // [nq] query lengths
    int64_t nq,
    const int64_t* g_tstart,   // [G] absolute target starts
    const int64_t* g_tlen,     // [G] target lengths
    const int64_t* g_hit_start,  // [G+1] absolute CSR into hit arrays
    const int64_t* hit_i, const int64_t* hit_j, const int64_t* hit_score,
    const int32_t* matrix32, int32_t xdrop, int64_t gap_open,
    int64_t gap_extend, int64_t cap,
    int64_t* ungapped_score,   // [G]
    int64_t* out_start,        // [G+1]
    int64_t* out_hsp) {        // [cap, 7]
    std::vector<int64_t> idx;
    std::vector<Seg> segs;
    std::vector<Hsp> ts;
    int64_t written = 0;
    out_start[0] = 0;
    for (int64_t nqi = 0; nqi < nq; ++nqi) {
        const int64_t lo = q_grp_lo[nqi], hi_g = q_grp_lo[nqi + 1];
        const int64_t qoff = q_starts[qids[nqi]];
        const int8_t* q = q_letters + qoff;
        const int8_t* bias = bias_all ? bias_all + qoff : nullptr;
        const int64_t qlen = q_lens[nqi];
        for (int64_t t = lo; t < hi_g; ++t) {
            const int64_t h0 = g_hit_start[t], h1 = g_hit_start[t + 1];
            const int64_t nh = h1 - h0;
            const int8_t* subject = t_letters + g_tstart[t];
            int64_t best = 0;
            for (int64_t k = h0; k < h1; ++k)
                best = std::max(best, hit_score[k]);
            ungapped_score[t] = best;
            idx.resize(nh);
            for (int64_t k = 0; k < nh; ++k)
                idx[k] = h0 + k;
            std::stable_sort(idx.begin(), idx.end(),
                             [&](int64_t a, int64_t b) {
                                 const int64_t da = hit_i[a] - hit_j[a];
                                 const int64_t db = hit_i[b] - hit_j[b];
                                 return da != db ? da < db
                                                 : hit_j[a] < hit_j[b];
                             });
            segs.clear();
            int64_t one[4];
            for (int64_t k = 0; k < nh; ++k) {
                const int64_t i = hit_i[idx[k]], j = hit_j[idx[k]];
                if (!segs.empty() && segs.back().diag() == i - j &&
                    segs.back().subject_end() >= j)
                    continue;
                xdrop_ungapped_one(q, bias, subject, i, j, matrix32, xdrop,
                                   one);
                if (one[3] > 0)
                    segs.push_back(Seg{one[0], one[1], one[2], one[3]});
            }
            ts.clear();
            chain_one(q, subject, matrix32, gap_open, gap_extend, qlen,
                      g_tlen[t], segs.data(), (int64_t)segs.size(), ts);
            if (written + (int64_t)ts.size() > cap)
                return -1;
            for (const Hsp& h : ts) {
                int64_t* row = out_hsp + 7 * written;
                row[0] = h.d_min;
                row[1] = h.d_max;
                row[2] = h.score;
                row[3] = h.query_begin;
                row[4] = h.query_end;
                row[5] = h.subject_begin;
                row[6] = h.subject_end;
                ++written;
            }
            out_start[t + 1] = written;
        }
    }
    return written;
}
