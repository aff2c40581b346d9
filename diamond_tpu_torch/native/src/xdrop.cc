// Two-sided x-drop ungapped extension (native twin of
// diamond_tpu/align/chain.py xdrop_ungapped; reference semantics from
// src/dp/ungapped_align.cpp:151-213).
//
// Pointers are padded views into the concatenated block arrays: reads
// beyond either sequence hit delimiter letters (31) and terminate the
// loops exactly like the Python oracle.

#include <cstdint>

namespace {
constexpr int8_t DELIMITER = 31;
}

extern "C" void xdrop_ungapped_one(const int8_t* query, const int8_t* bias,
                                   const int8_t* target, int64_t qa,
                                   int64_t sa, const int32_t* matrix32,
                                   int32_t xdrop, int64_t* out /* i,j,len,score */) {
    int64_t score = 0, st = 0, n = 1, delta = 0, ln = 0;

    int64_t qi = qa - 1, si = sa - 1;
    while (score - st < xdrop) {
        const int8_t ql = query[qi];
        const int8_t sl = target[si];
        if (ql == DELIMITER || sl == DELIMITER)
            break;
        st += matrix32[(ql & 31) * 32 + (sl & 31)];
        if (bias)
            st += bias[qi];
        if (st > score) {
            score = st;
            delta = n;
        }
        --qi;
        --si;
        ++n;
    }

    qi = qa;
    si = sa;
    st = score;
    n = 1;
    while (score - st < xdrop) {
        const int8_t ql = query[qi];
        const int8_t sl = target[si];
        if (ql == DELIMITER || sl == DELIMITER)
            break;
        st += matrix32[(ql & 31) * 32 + (sl & 31)];
        if (bias)
            st += bias[qi];
        if (st > score) {
            score = st;
            ln = n;
        }
        ++qi;
        ++si;
        ++n;
    }

    out[0] = qa - delta;
    out[1] = sa - delta;
    out[2] = ln + delta;
    out[3] = score;
}

// Batched per-target extension loop with the chaining skip rule
// (native twin of the hot loop in diamond_tpu/align/extend.py
// ungapped_stage; reference align/ungapped.cpp:62-150): hits must arrive
// sorted by (diag, j); a hit on the same diagonal as the LAST KEPT segment
// whose j falls inside that segment is skipped; segments with score <= 0
// are dropped.  Returns the number of kept segments written to the out
// arrays (each sized n).
extern "C" int64_t xdrop_ungapped_chain(
    const int8_t* query, const int8_t* bias, const int8_t* target,
    const int64_t* hi, const int64_t* hj, int64_t n,
    const int32_t* matrix32, int32_t xdrop,
    int64_t* out_i, int64_t* out_j, int64_t* out_len, int64_t* out_score) {
    int64_t kept = 0;
    int64_t last_diag = 0, last_subj_end = 0;
    int64_t one[4];
    for (int64_t k = 0; k < n; ++k) {
        const int64_t i = hi[k], j = hj[k];
        if (kept && last_diag == i - j && last_subj_end >= j)
            continue;
        xdrop_ungapped_one(query, bias, target, i, j, matrix32, xdrop, one);
        if (one[3] > 0) {
            out_i[kept] = one[0];
            out_j[kept] = one[1];
            out_len[kept] = one[2];
            out_score[kept] = one[3];
            last_diag = one[0] - one[1];
            last_subj_end = one[1] + one[2];
            ++kept;
        }
    }
    return kept;
}
