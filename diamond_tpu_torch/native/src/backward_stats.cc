// Reversed stats pass (native twin of
// diamond_tpu/ops/banded_swipe.py backward_stats_pass_np; reference
// semantics from src/dp/swipe/swipe_wrapper.cpp:364-430
// recompute_reversed, stat_cell.h BackwardCell,
// cell_update.h:102-141 swipe_cell_update).
//
// Runs the banded local SWIPE over the REVERSED query and REVERSED
// target prefix [0, send) with the rev_diag band; mismatch/gap-open
// counters ride the cells, ties take the candidate's stats
// (vgap > hgap > diagonal; open > extension), zero cells reset their
// stats, and the reported values are those at the first-column /
// last-row best cell.  Reversal happens via indexing — no copies.

#include <cstdint>
#include <vector>

namespace {

struct BCell {
    int32_t v, mm, go;
};

void backward_one(const int8_t* q, int64_t qlen, const int32_t* bias,
                  const int8_t* t, int64_t send, int64_t d_begin_f,
                  int64_t d_end_f, const int32_t* matrix32, int32_t go_pen,
                  int32_t ge, int64_t* out3) {
    const int64_t band = d_end_f - d_begin_f;
    const int64_t d0 = qlen - send - (d_end_f - 1);
    std::vector<BCell> H(band, {0, 0, 0}), E(band + 1, {0, 0, 0});
    std::vector<BCell> Hn(band), En(band);
    int32_t best = 0, best_mm = 0, best_go = 0;

    for (int64_t j = 0; j < send; ++j) {
        const int64_t i_lo = j + d0;
        const int64_t r_lo = i_lo < 0 ? -i_lo : 0;
        const int64_t r_hi = band < qlen - i_lo ? band : qlen - i_lo;
        for (int64_t r = 0; r < band; ++r) {
            Hn[r] = {0, 0, 0};
            En[r] = {0, 0, 0};
        }
        if (r_lo >= r_hi) {
            H = Hn;
            for (int64_t r = 0; r < band; ++r)
                E[r] = {0, 0, 0};
            E[band] = {0, 0, 0};
            continue;
        }
        const int8_t tL = t[send - 1 - j];
        BCell V = {0, 0, 0};
        int32_t cb = 0;
        int64_t cbr = r_lo;
        for (int64_t r = r_lo; r < r_hi; ++r) {
            const int64_t i = i_lo + r;
            const int8_t qL = q[qlen - 1 - i];
            int32_t sc = matrix32[(qL & 31) * 32 + (tL & 31)];
            if (bias)
                sc += bias[qlen - 1 - i];
            const int32_t ident = qL == tL ? 1 : 0;
            int32_t cv = H[r].v + sc;
            int32_t cmm = H[r].mm + (1 - ident);
            int32_t cgo = H[r].go;
            const BCell& e = E[r];
            if (e.v >= cv) {        // tie -> horizontal gap wins
                cv = e.v;
                cmm = e.mm;
                cgo = e.go;
            }
            if (V.v >= cv) {        // tie -> vertical gap wins
                cv = V.v;
                cmm = V.mm;
                cgo = V.go;
            }
            if (cv < 0)
                cv = 0;
            if (cv >= cb) {         // last row attaining the column max
                cb = cv;
                cbr = r;
            }
            const int32_t ev = e.v - ge;
            const int32_t vv = V.v - ge;
            const int32_t ov = cv - go_pen;
            const int32_t omm = cmm, ogo = cgo + 1;
            if (cv == 0) {          // zero cell resets its stats
                cmm = 0;
                cgo = 0;
            }
            En[r] = ov >= ev ? BCell{ov, omm, ogo} : BCell{ev, e.mm, e.go};
            V = ov >= vv ? BCell{ov, omm, ogo} : BCell{vv, V.mm, V.go};
            Hn[r] = {cv, cmm, cgo};
        }
        if (cb > best) {
            best = cb;
            best_mm = Hn[cbr].mm;
            best_go = Hn[cbr].go;
        }
        H = Hn;
        for (int64_t r = 0; r < band - 1; ++r)
            E[r] = En[r + 1];
        E[band - 1] = {0, 0, 0};
        E[band] = {0, 0, 0};
    }
    out3[0] = best;
    out3[1] = best_mm;
    out3[2] = best_go;
}

// Full-matrix fast path: when the band covers the whole reversed
// matrix (the --swipe FULL bin: d_begin <= -(send-1), d_end >= qlen),
// iterate the true qlen x send cells with flat row arrays instead of
// the (qlen+send-1)-wide diagonal band — ~2.7x fewer cells and no
// per-column band clears/copies.  Cell values, tie rules
// (vgap >= hgap >= diag), the last-row column max, the strict
// cross-column best, and the pre-reset gap-open stats all mirror
// backward_one exactly.
void backward_one_full(const int8_t* q, int64_t qlen, const int32_t* bias,
                       const int8_t* t, int64_t send,
                       const int32_t* matrix32, int32_t go_pen, int32_t ge,
                       int64_t* out3) {
    std::vector<int32_t> Hv(qlen, 0), Hmm(qlen, 0), Hgo(qlen, 0);
    std::vector<int32_t> Ev(qlen, 0), Emm(qlen, 0), Ego(qlen, 0);
    int32_t best = 0, best_mm = 0, best_go = 0;

    for (int64_t j = 0; j < send; ++j) {
        const int8_t tL = t[send - 1 - j];
        const int32_t* mcol = matrix32;  // indexed per row letter below
        int32_t dv = 0, dmm = 0, dgo = 0;          // H[i-1][j-1]
        int32_t Vv = 0, Vmm = 0, Vgo = 0;          // vertical gap carry
        int32_t cb = 0, cb_mm = 0, cb_go = 0;
        for (int64_t i = 0; i < qlen; ++i) {
            const int8_t qL = q[qlen - 1 - i];
            int32_t sc = mcol[(qL & 31) * 32 + (tL & 31)];
            if (bias)
                sc += bias[qlen - 1 - i];
            const int32_t ident = qL == tL ? 1 : 0;
            int32_t cv = dv + sc;
            int32_t cmm = dmm + (1 - ident);
            int32_t cgo = dgo;
            if (Ev[i] >= cv) {      // tie -> horizontal gap wins
                cv = Ev[i];
                cmm = Emm[i];
                cgo = Ego[i];
            }
            if (Vv >= cv) {         // tie -> vertical gap wins
                cv = Vv;
                cmm = Vmm;
                cgo = Vgo;
            }
            if (cv < 0)
                cv = 0;
            if (cv >= cb) {         // last row attaining the column max
                cb = cv;
                cb_mm = cmm;        // pre-reset (winning cell has cv>0
                cb_go = cgo;        // whenever cb>0, so reset never hits)
            }
            const int32_t ev = Ev[i] - ge;
            const int32_t vv = Vv - ge;
            const int32_t ov = cv - go_pen;
            const int32_t omm = cmm, ogo = cgo + 1;
            if (cv == 0) {          // zero cell resets its stats
                cmm = 0;
                cgo = 0;
            }
            if (ov >= ev) {
                Ev[i] = ov;
                Emm[i] = omm;
                Ego[i] = ogo;
            } else {
                Ev[i] = ev;         // stats ride along unchanged
            }
            if (ov >= vv) {
                Vv = ov;
                Vmm = omm;
                Vgo = ogo;
            } else {
                Vv = vv;
            }
            dv = Hv[i];             // previous column, next row's diag
            dmm = Hmm[i];
            dgo = Hgo[i];
            Hv[i] = cv;
            Hmm[i] = cmm;
            Hgo[i] = cgo;
        }
        if (cb > best) {
            best = cb;
            best_mm = cb_mm;
            best_go = cb_go;
        }
    }
    out3[0] = best;
    out3[1] = best_mm;
    out3[2] = best_go;
}

}  // namespace

// Batched over jobs, each with its own query (offsets into q_base) and
// forward target prefix in t_cat; out = [njobs, 3] (best, mismatch,
// gapopen).
extern "C" void backward_stats_many(
    const int8_t* q_base, const int32_t* bias_base,
    const int64_t* q_off, const int64_t* q_len, const uint8_t* use_bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* send,
    const int64_t* d_begin, const int64_t* d_end, int64_t njobs,
    const int32_t* matrix32, int64_t go_pen, int64_t ge, int64_t* out) {
    for (int64_t k = 0; k < njobs; ++k) {
        const int32_t* bias =
            (use_bias[k] && bias_base) ? bias_base + q_off[k] : nullptr;
        if (d_begin[k] <= -(send[k] - 1) && d_end[k] >= q_len[k]) {
            backward_one_full(q_base + q_off[k], q_len[k], bias,
                              t_cat + t_off[k], send[k], matrix32,
                              (int32_t)go_pen, (int32_t)ge, out + 3 * k);
        } else {
            backward_one(q_base + q_off[k], q_len[k], bias,
                         t_cat + t_off[k], send[k], d_begin[k], d_end[k],
                         matrix32, (int32_t)go_pen, (int32_t)ge,
                         out + 3 * k);
        }
    }
}
