// Banded 3-frame (frameshift-aware) Smith-Waterman forward pass.
//
// Bit-identical twin of the numpy oracle in ops/swipe3.py (itself modeled
// on the reference's Banded3FrameSwipe forward recurrence, reference
// src/dp/swipe/banded_3frame_swipe.cpp:408-531): the DP runs over the
// three frame translations of one strand simultaneously; physical band
// row r = 3*(i - i0_j) + f, and the band shifts one query position
// (3 rows) per target column.  The kernel fills the full score matrix S
// ((ncols+1) x (R+2), int32, caller-zeroed) so the caller's traceback
// walk (ops/swipe3.py, O(alignment length)) reads the same values the
// numpy oracle produces.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
inline int32_t max2(int32_t a, int32_t b) { return a > b ? a : b; }
}

extern "C" void banded_3frame_forward(
    const int8_t* q0, const int8_t* q1, const int8_t* q2,
    int64_t qlen0, int64_t qlen1, int64_t qlen2,
    const int8_t* target, int64_t tlen,
    int64_t d_begin, int64_t d_end,
    const int32_t* matrix32,  // 32x32 row-major
    int32_t go, int32_t ge, int32_t fs,
    int32_t* S,    // (ncols+1) x (R+2) row-major, zero-initialised
    int64_t* out)  // {best, max_col, cols_done}
{
    const int8_t* q[3] = {q0, q1, q2};
    const int64_t qlens[3] = {qlen0, qlen1, qlen2};
    const int64_t qlen = qlen0;
    const int64_t band = d_end - d_begin;
    const int64_t i1_init = d_end - 1 > 0 ? d_end - 1 : 0;
    const int64_t i0_init = i1_init + 1 - band;
    const int64_t j0 = i1_init - (d_end - 1);
    const int64_t R = band * 3;
    const int64_t ncols = tlen - j0;
    const int64_t stride = R + 2;
    const int32_t NEG = -0x40000000;

    int32_t best = 0;
    int64_t max_col = -1, cols_done = 0;

    std::vector<int32_t> Ha(R + 4, 0), Hb(R + 4, 0);
    int32_t* Hprev = Ha.data();
    int32_t* Hcur = Hb.data();

    int64_t i0 = i0_init, i1 = i1_init;
    for (int64_t jc = 0; jc < ncols; ++jc) {
        const int64_t lo = i0 > 0 ? i0 : 0;
        const int64_t hi = i1 < qlen - 1 ? i1 : qlen - 1;
        if (lo > hi) break;
        const int32_t* mrow = matrix32;  // indexed by query letter row
        const int64_t tl = target[j0 + jc] & 31;
        std::memset(Hcur, 0, (R + 4) * sizeof(int32_t));
        int32_t* Scur = S + (jc + 1) * stride;
        const int32_t* Sprev = S + jc * stride;
        int32_t vgap[3] = {NEG, NEG, NEG};
        int32_t col_best = 0;
        int64_t r = (lo - i0) * 3;
        // rolling previous-column reads: sm3 = Sprev[r] (same frame
        // diagonal), sm2 = Sprev[r+1] (reverse shift), sm4 (forward shift)
        int32_t sm4 = 0;
        int32_t sm3 = r < R ? Sprev[r] : 0;
        int32_t sm2 = r + 1 <= R + 1 ? Sprev[r + 1] : 0;
        bool stop = false;
        for (int64_t i = lo; i <= hi && !stop; ++i) {
            for (int f = 0; f < 3; ++f) {
                if (f > 0 && i >= qlens[f]) { stop = true; break; }
                const int32_t score =
                    mrow[((int64_t)(q[f][i] & 31)) * 32 + tl];
                const int32_t hg = Hprev[r + 3];
                const int32_t fsc = score - fs;
                int32_t cur = sm3 + score;
                cur = max2(cur, sm4 + fsc);
                cur = max2(cur, sm2 + fsc);
                cur = max2(cur, vgap[f]);
                cur = max2(cur, hg);
                cur = max2(cur, 0);
                col_best = max2(col_best, cur);
                vgap[f] = max2(vgap[f] - ge, cur - go);
                Hcur[r] = max2(hg - ge, cur - go);
                Scur[r] = cur;
                ++r;
                sm4 = sm3;
                sm3 = sm2;
                sm2 = r + 1 <= R + 1 ? Sprev[r + 1] : 0;
            }
        }
        int32_t* t32 = Hprev; Hprev = Hcur; Hcur = t32;
        if (col_best > best) { best = col_best; max_col = jc; }
        ++i0; ++i1;
        cols_done = jc + 1;
    }
    out[0] = best;
    out[1] = max_col;
    out[2] = cols_done;
}
