// Banded SWIPE score-only host kernels (native transplants of the
// framework's own batched formulation, ops/banded_swipe.py
// banded_swipe_batch_np — NOT the reference's striped SWIPE code; the
// lazy-F prefix-max banded recurrence is this repo's own design, see
// reference src/dp/swipe/banded_swipe.h only for the role it plays).
//
// Two engines behind one entry point:
//
// 1. striped16 (AVX-512BW): intra-job parallelism — the band COLUMN is
//    the vector (32 int16 lanes/register).  All cells of a column share
//    one target letter, so substitution scores are CONTIGUOUS masked
//    loads from a transposed profile profT[letter][query_pos] — no
//    gathers.  The serial vertical lazy-F chain becomes a log-depth
//    in-register prefix max over A[r] = cur[r] + r*ge (5 permute+max
//    steps per 32 lanes) with a scalar carry between 32-lane chunks.
//    Saturating int16 arithmetic is exact while scores stay under
//    OVF16; jobs that reach it (or band > MAX_BAND16) fall back to:
//
// 2. lanes_i32: inter-job parallelism — 16 consecutive same-query jobs
//    as int32 lanes, one fused pass per column (the v1 engine; exact
//    for any int32 score).
//
// Both produce bit-identical (score, max_col, max_row) to the numpy
// oracle, including its tie rules: per-row `>=` keeps the highest row
// of a column max, per-column `>` keeps the first column.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512BW__)
#include <immintrin.h>
#define DTPU_STRIPED16 1
#endif

namespace {

constexpr int LANES = 16;
constexpr int32_t NEGB = -1000000000;

// ---------- shared profile caches ----------

struct ProfT32 {
    std::vector<int32_t> flat;  // [32][qlen] letter-major
    int64_t q_off = -1;
    int64_t qlen = 0;
    int use_bias = -1;
};

void build_profT32(ProfT32& p, const int8_t* q, int64_t qlen,
                   const int32_t* bias, const int32_t* matrix32) {
    p.flat.resize((size_t)32 * qlen);
    for (int64_t i = 0; i < qlen; ++i) {
        const int32_t* mrow = matrix32 + (q[i] & 31) * 32;
        const int32_t b = bias ? bias[i] : 0;
        for (int c = 0; c < 32; ++c)
            p.flat[(size_t)c * qlen + i] = mrow[c] + b;
    }
}

// ---------- engine 2: int32 16-job lanes (exact fallback) ----------

void score_lanes_i32(const int8_t* q_base, const int32_t* bias_base,
                     const int64_t* q_off, const int64_t* q_len,
                     const uint8_t* use_bias, const int8_t* t_cat,
                     const int64_t* t_off, const int64_t* t_len,
                     const int64_t* d_begin, const int64_t* band_arr,
                     int64_t njobs, const int32_t* matrix32, int32_t go,
                     int32_t ge, int64_t* out) {
    ProfT32 prof;
    std::vector<int32_t> H, E;
    int64_t k0 = 0;
    while (k0 < njobs) {
        int64_t k1 = k0 + 1;
        while (k1 < njobs && k1 - k0 < LANES && q_off[k1] == q_off[k0]
               && use_bias[k1] == use_bias[k0])
            ++k1;
        const int L = (int)(k1 - k0);
        const int64_t qoff = q_off[k0];
        const int64_t qlen64 = q_len[k0];
        const int32_t qlen = (int32_t)qlen64;
        if (prof.q_off != qoff || prof.qlen != qlen64
            || prof.use_bias != (int)use_bias[k0]) {
            build_profT32(prof, q_base + qoff, qlen64,
                          use_bias[k0] && bias_base ? bias_base + qoff
                                                    : nullptr,
                          matrix32);
            prof.q_off = qoff;
            prof.qlen = qlen64;
            prof.use_bias = use_bias[k0];
        }
        const int32_t* profT = prof.flat.data();
        int64_t band = 0, T = 0;
        alignas(64) int32_t base[LANES] = {0};
        alignas(64) int32_t blen[LANES] = {0};
        alignas(64) int32_t tlen_l[LANES] = {0};
        alignas(64) int32_t prow[LANES];
        const int8_t* tp[LANES] = {nullptr};
        for (int l = 0; l < L; ++l) {
            const int64_t k = k0 + l;
            if (band_arr[k] > band)
                band = band_arr[k];
            if (t_len[k] > T)
                T = t_len[k];
            base[l] = (int32_t)d_begin[k];
            blen[l] = (int32_t)band_arr[k];
            tlen_l[l] = (int32_t)t_len[k];
            tp[l] = t_cat + t_off[k];
        }
        const size_t cells = (size_t)band * LANES;
        H.assign(cells, 0);
        E.assign(cells, 0);
        alignas(64) int32_t best[LANES] = {0};
        alignas(64) int32_t max_col[LANES] = {0};
        alignas(64) int32_t max_row[LANES] = {0};
        int32_t* __restrict__ Hd = H.data();
        int32_t* __restrict__ Ed = E.data();

        for (int64_t j = 0; j < T; ++j) {
            for (int l = 0; l < LANES; ++l)
                prow[l] = (tp[l] && j < tlen_l[l])
                              ? (int32_t)(tp[l][j] & 31) * qlen
                              : -1;
            alignas(64) int32_t run[LANES];
            alignas(64) int32_t prev_cur[LANES];
            alignas(64) int32_t cb[LANES];
            alignas(64) int32_t cbr[LANES];
            for (int l = 0; l < LANES; ++l) {
                run[l] = NEGB;
                prev_cur[l] = 0;
                cb[l] = 0;
                cbr[l] = 0;
            }
            int32_t rg = 0;
            for (int64_t r = 0; r < band; ++r) {
                int32_t* __restrict__ h = Hd + r * LANES;
                int32_t* __restrict__ e = Ed + r * LANES;
                alignas(64) int32_t s[LANES];
                alignas(64) int32_t cur[LANES];
                alignas(64) int32_t fv[LANES];
                const int32_t r32 = (int32_t)r;
                for (int l = 0; l < LANES; ++l) {
                    const int32_t qi = base[l] + r32;
                    const bool valid = prow[l] >= 0 && r32 < blen[l]
                                       && (uint32_t)qi < (uint32_t)qlen;
                    s[l] = valid ? profT[prow[l] + qi] : NEGB;
                }
                for (int l = 0; l < LANES; ++l) {
                    int32_t v = h[l] + s[l];
                    if (e[l] > v)
                        v = e[l];
                    cur[l] = v > 0 ? v : 0;
                }
                if (r == 0) {
                    for (int l = 0; l < LANES; ++l)
                        fv[l] = 0;
                } else {
                    for (int l = 0; l < LANES; ++l) {
                        const int32_t g = prev_cur[l] - go + rg;
                        if (g > run[l])
                            run[l] = g;
                        const int32_t f = run[l] - rg;
                        fv[l] = f > 0 ? f : 0;
                    }
                    rg += ge;
                }
                alignas(64) int32_t hn[LANES];
                for (int l = 0; l < LANES; ++l) {
                    int32_t v = cur[l];
                    if (fv[l] > v)
                        v = fv[l];
                    if (s[l] <= NEGB / 2)
                        v = 0;
                    hn[l] = v;
                    if (v >= cb[l]) {
                        cb[l] = v;
                        cbr[l] = r32;
                    }
                }
                alignas(64) int32_t en[LANES];
                for (int l = 0; l < LANES; ++l) {
                    int32_t v = e[l] - ge;
                    const int32_t o = hn[l] - go;
                    if (o > v)
                        v = o;
                    en[l] = v > 0 ? v : 0;
                }
                if (r > 0)
                    std::memcpy(Ed + (r - 1) * LANES, en,
                                LANES * sizeof(int32_t));
                for (int l = 0; l < LANES; ++l) {
                    prev_cur[l] = cur[l];
                    h[l] = hn[l];
                }
            }
            std::memset(Ed + (band - 1) * LANES, 0, LANES * sizeof(int32_t));
            for (int l = 0; l < L; ++l)
                if (cb[l] > best[l]) {
                    best[l] = cb[l];
                    max_col[l] = (int32_t)j;
                    max_row[l] = cbr[l];
                }
            for (int l = 0; l < LANES; ++l)
                ++base[l];
        }
        for (int l = 0; l < L; ++l) {
            const int64_t k = k0 + l;
            out[3 * k] = best[l];
            out[3 * k + 1] = max_col[l];
            out[3 * k + 2] = max_col[l] + (int32_t)d_begin[k] + max_row[l];
        }
        k0 = k1;
    }
}

#ifdef DTPU_STRIPED16

// ---------- engine 1: int16 striped-band single-job kernel ----------

// dead-cell score marker: with saturating adds, H + (-32768) <= -1 for
// any int16 H, so dead lanes can never read positive regardless of the
// live values — the marker is sound unconditionally
constexpr int16_t NEG16 = -32768;
// exactness threshold: while every H stays under OVF16, no saturating
// op clips a live value (A = cur + r*ge <= OVF16 + band*ge <= 32048 and
// H+s <= OVF16 + 1000); best is the running max of all H, so a final
// best < OVF16 certifies the whole run exact
constexpr int32_t OVF16 = 30000;
constexpr int64_t MAX_BANDGE16 = 2048;      // band * ge cap (A headroom)

struct ProfT16 {
    std::vector<int16_t> flat;  // [32][qlen]
    int64_t q_off = -1;
    int64_t qlen = 0;
    int use_bias = -1;
    bool ok = true;  // false if any |entry| too large for int16
};

void build_profT16(ProfT16& p, const int8_t* q, int64_t qlen,
                   const int32_t* bias, const int32_t* matrix32) {
    p.flat.resize((size_t)32 * qlen);
    p.ok = true;
#if defined(__AVX512BW__)
    // conservative precheck so the int16 arithmetic below cannot wrap:
    // huge custom-matrix entries or biases route to the int32 engine
    int32_t raw_max = 0;
    for (int i = 0; i < 1024; ++i) {
        const int32_t a = matrix32[i] < 0 ? -matrix32[i] : matrix32[i];
        if (a > raw_max)
            raw_max = a;
    }
    if (bias)
        for (int64_t i = 0; i < qlen; ++i) {
            const int32_t a = bias[i] < 0 ? -bias[i] : bias[i];
            if (a > raw_max)
                raw_max = a;
        }
    if (raw_max > 15000) {
        p.ok = false;
        return;
    }
    // letter-major build via vpermw: per target letter c the 32 matrix
    // column entries form one int16 lookup register; 32 query positions
    // resolve in one permute (8x fewer ops than the scalar loop)
    alignas(64) int16_t col[32];
    const __m512i m31 = _mm512_set1_epi16(31);
    __m512i vmax = _mm512_set1_epi16(-32768);
    __m512i vmin = _mm512_set1_epi16(32767);
    for (int c = 0; c < 32; ++c) {
        for (int r = 0; r < 32; ++r)
            col[r] = (int16_t)matrix32[r * 32 + c];
        const __m512i tbl = _mm512_load_si512(col);
        int16_t* dst = p.flat.data() + (size_t)c * qlen;
        for (int64_t i = 0; i < qlen; i += 32) {
            const __mmask32 m =
                qlen - i >= 32 ? (__mmask32)~0u
                               : (__mmask32)(~0u >> (32 - (qlen - i)));
            const __m512i ql = _mm512_and_si512(
                _mm512_cvtepi8_epi16(_mm256_maskz_loadu_epi8(m, q + i)),
                m31);
            __m512i v = _mm512_permutexvar_epi16(ql, tbl);
            if (bias) {
                const __m512i b0 = _mm512_maskz_loadu_epi32(
                    (__mmask16)m, bias + i);
                const __m512i b1 = _mm512_maskz_loadu_epi32(
                    (__mmask16)(m >> 16), bias + i + 16);
                const __m512i bb = _mm512_inserti64x4(
                    _mm512_castsi256_si512(_mm512_cvtepi32_epi16(b0)),
                    _mm512_cvtepi32_epi16(b1), 1);
                v = _mm512_add_epi16(v, bb);
            }
            _mm512_mask_storeu_epi16(dst + i, m, v);
            vmax = _mm512_mask_max_epi16(vmax, m, vmax, v);
            vmin = _mm512_mask_min_epi16(vmin, m, vmin, v);
        }
    }
    const int32_t mx0 = _mm512_reduce_max_epi32(
        _mm512_cvtepi16_epi32(_mm512_castsi512_si256(vmax)));
    const int32_t mx1 = _mm512_reduce_max_epi32(
        _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(vmax, 1)));
    const int32_t mn0 = _mm512_reduce_min_epi32(
        _mm512_cvtepi16_epi32(_mm512_castsi512_si256(vmin)));
    const int32_t mn1 = _mm512_reduce_min_epi32(
        _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(vmin, 1)));
    if ((mx0 > mx1 ? mx0 : mx1) > 1000 || (mn0 < mn1 ? mn0 : mn1) < -1000)
        p.ok = false;
#else
    for (int64_t i = 0; i < qlen; ++i) {
        const int32_t* mrow = matrix32 + (q[i] & 31) * 32;
        const int32_t b = bias ? bias[i] : 0;
        for (int c = 0; c < 32; ++c) {
            const int32_t v = mrow[c] + b;
            if (v > 1000 || v < -1000)
                p.ok = false;
            p.flat[(size_t)c * qlen + i] = (int16_t)v;
        }
    }
#endif
}

// in-register inclusive prefix max over 32 int16 lanes (lane i =
// max(v[0..i])), NEG16-filling shifts.  Only the shift-by-one-lane step
// needs vpermw (2 uops, port-5-only on Skylake-SP); the 2/4/8/16-lane
// steps are dword-aligned, so valignd (1 uop, 1c) does them — this
// halves the port-5 pressure that bounds the whole column loop.
struct Shifter {
    __m512i idx1;
    __mmask32 msk1;
    __m512i neg;
    Shifter() {
        alignas(64) int16_t buf[32];
        for (int i = 0; i < 32; ++i)
            buf[i] = (int16_t)(i >= 1 ? i - 1 : 0);
        idx1 = _mm512_load_si512(buf);
        msk1 = (__mmask32)(~0u << 1);
        neg = _mm512_set1_epi16(NEG16);
    }
    // shift left by one int16 lane, NEG16 fill (lane i = v[i-1])
    inline __m512i shift_fill(__m512i v, int /*step0 only*/) const {
        return _mm512_mask_permutexvar_epi16(neg, msk1, idx1, v);
    }
    inline __m512i prefix_max(__m512i v) const {
        v = _mm512_max_epi16(v, shift_fill(v, 0));
        v = _mm512_max_epi16(v, _mm512_alignr_epi32(v, neg, 16 - 1));
        v = _mm512_max_epi16(v, _mm512_alignr_epi32(v, neg, 16 - 2));
        v = _mm512_max_epi16(v, _mm512_alignr_epi32(v, neg, 16 - 4));
        v = _mm512_max_epi16(v, _mm512_alignr_epi32(v, neg, 16 - 8));
        return v;
    }
};

// one job; returns best<OVF16 ? 0 : 1 (1 = caller must rerun in int32)
int swipe_striped16(const int16_t* profT, int64_t qlen, const int8_t* t,
                    int64_t tlen, int64_t d0, int64_t band, int32_t go,
                    int32_t ge, int64_t* out3) {
    static thread_local Shifter SH;
    const int nch = (int)((band + 31) / 32);
    static thread_local std::vector<int16_t> state;
    // layout: [1 scratch][E band][H band][per-chunk R,G vectors]
    state.assign(1 + 2 * (size_t)nch * 32 + 2 * (size_t)nch * 32, 0);
    int16_t* Ed = state.data() + 1;
    int16_t* Hd = Ed + (size_t)nch * 32;
    int16_t* Rv = Hd + (size_t)nch * 32;   // (32c+i)*ge
    int16_t* Gv = Rv + (size_t)nch * 32;   // go + (32c+i-1)*ge
    for (int c = 0; c < nch; ++c)
        for (int i = 0; i < 32; ++i) {
            const int32_t r = 32 * c + i;
            Rv[32 * c + i] = (int16_t)(r * ge);
            Gv[32 * c + i] = (int16_t)(go + (r - 1) * ge);
        }
    const __m512i zero = _mm512_setzero_si512();
    const __m512i neg = _mm512_set1_epi16(NEG16);
    const __m512i ge_v = _mm512_set1_epi16((int16_t)ge);
    const __m512i go_v = _mm512_set1_epi16((int16_t)go);
    int32_t best = 0, bc = 0, br = 0;
    // valid column range: leading dead columns leave the zero state
    // untouched, trailing ones can never raise the max — skip both
    // (bands cover only a [qlen+band)-wide window of a long target)
    int64_t j0 = -d0 - band + 1;
    if (j0 < 0)
        j0 = 0;
    int64_t j1 = qlen - d0;
    if (j1 > tlen)
        j1 = tlen;
    for (int64_t j = j0; j < j1; ++j) {
        const int16_t* prow = profT + (size_t)(t[j] & 31) * qlen;
        const int64_t off = j + d0;  // qi = off + r
        // valid rows: r in [rlo, rhi)
        const int64_t rlo64 = off < 0 ? -off : 0;
        int64_t rhi64 = qlen - off;
        if (rhi64 > band)
            rhi64 = band;
        const int32_t rlo = (int32_t)(rlo64 < 0 ? 0 : rlo64);
        const int32_t rhi = (int32_t)(rhi64 < 0 ? 0 : rhi64);
        int16_t carry = NEG16;  // running max of A over previous chunks
        __m512i colmax = zero;
        for (int c = 0; c < nch; ++c) {
            const int32_t rb = 32 * c;
            // validity mask for this chunk
            __mmask32 m;
            if (rb >= rhi || rb + 32 <= rlo) {
                m = 0;
            } else {
                uint32_t bits = ~0u;
                if (rlo > rb)
                    bits &= ~0u << (rlo - rb);
                if (rhi < rb + 32)
                    bits &= ~0u >> (rb + 32 - rhi);
                m = (__mmask32)bits;
            }
            // s: contiguous masked load from the profile row
            __m512i s = _mm512_mask_loadu_epi16(neg, m, prow + off + rb);
            __m512i H = _mm512_loadu_si512(Hd + rb);
            __m512i E = _mm512_loadu_si512(Ed + rb);
            __m512i cur = _mm512_adds_epi16(H, s);
            cur = _mm512_max_epi16(cur, E);
            cur = _mm512_max_epi16(cur, zero);
            // lazy-F via prefix max of A = cur + r*ge
            __m512i A = _mm512_adds_epi16(cur,
                                          _mm512_loadu_si512(Rv + rb));
            __m512i incl = SH.prefix_max(A);
            __m512i excl = SH.shift_fill(incl, 0);
            if (c > 0)
                excl = _mm512_max_epi16(excl, _mm512_set1_epi16(carry));
            {   // accumulate the cross-chunk A carry
                __m128i hi = _mm512_extracti32x4_epi32(incl, 3);
                const int16_t top = (int16_t)_mm_extract_epi16(hi, 7);
                if (top > carry)
                    carry = top;
            }
            __m512i F = _mm512_subs_epi16(excl,
                                          _mm512_loadu_si512(Gv + rb));
            F = _mm512_max_epi16(F, zero);
            __m512i hn = _mm512_max_epi16(cur, F);
            hn = _mm512_maskz_mov_epi16(m, hn);  // dead cells -> 0
            _mm512_storeu_si512(Hd + rb, hn);
            colmax = _mm512_max_epi16(colmax, hn);
            // E' (row r-1) = max(E-ge, hn-go, 0), fused shift via the
            // -1 offset store (scratch slot in front absorbs r=0)
            __m512i en = _mm512_max_epi16(_mm512_subs_epi16(E, ge_v),
                                          _mm512_subs_epi16(hn, go_v));
            en = _mm512_max_epi16(en, zero);
            _mm512_storeu_si512((void*)(Ed + rb - 1), en);
        }
        Ed[band - 1] = 0;
        // column max (hn >= 0 always, so unsigned minpos trick works)
        __m256i m256 = _mm256_max_epi16(
            _mm512_castsi512_si256(colmax),
            _mm512_extracti64x4_epi64(colmax, 1));
        __m128i m128 = _mm_max_epi16(_mm256_castsi256_si128(m256),
                                     _mm256_extracti128_si256(m256, 1));
        __m128i inv = _mm_sub_epi16(_mm_set1_epi16(0x7fff), m128);
        const int32_t cm = 0x7fff - (_mm_extract_epi16(
                               _mm_minpos_epu16(inv), 0));
        if (cm > best) {
            best = cm;
            bc = (int32_t)j;
            if (best >= OVF16) {  // result will be discarded: abort now
                out3[0] = out3[1] = out3[2] = 0;
                return 1;
            }
            // last row attaining the column max (the oracle's per-row
            // `>=` tie rule)
            const __m512i cmv = _mm512_set1_epi16((int16_t)cm);
            br = 0;
            for (int c = 0; c < nch; ++c) {
                const __mmask32 eq = _mm512_cmpeq_epi16_mask(
                    _mm512_loadu_si512(Hd + 32 * c), cmv);
                if (eq)
                    br = 32 * c + (31 - __builtin_clz((uint32_t)eq));
            }
        }
    }
    out3[0] = best;
    out3[1] = bc;
    out3[2] = bc + d0 + br;
    return 0;
}

// ---------- full-matrix score engines ----------
// True full Smith-Waterman for "full-band" jobs (d0 <= -(tlen-1),
// band >= qlen+tlen-1): the banded formulation computes
// (qlen+tlen)*tlen cells for these, up to ~16x the true qlen*tlen when
// tlen >> qlen.  Vector axis = query rows (the band axis collapses to
// the query), diagonal input = previous column H shifted one lane with
// a cross-chunk carry.  Bit-identical cell values and tie rules
// (last-row column max, first-column strict improvement).

int swipe_full16(const int16_t* profT, int64_t qlen, const int8_t* t,
                 int64_t tlen, int32_t go, int32_t ge, int64_t* out3) {
    static thread_local Shifter SH;
    const int nch = (int)((qlen + 31) / 32);
    static thread_local std::vector<int16_t> state;
    state.assign(4 * (size_t)nch * 32, 0);
    int16_t* Hd = state.data();
    int16_t* Ed = Hd + (size_t)nch * 32;
    int16_t* Rv = Ed + (size_t)nch * 32;
    int16_t* Gv = Rv + (size_t)nch * 32;
    for (int c = 0; c < nch; ++c)
        for (int i = 0; i < 32; ++i) {
            const int32_t r = 32 * c + i;
            Rv[32 * c + i] = (int16_t)(r * ge);
            Gv[32 * c + i] = (int16_t)(go + (r - 1) * ge);
        }
    const __m512i zero = _mm512_setzero_si512();
    const __m512i neg = _mm512_set1_epi16(NEG16);
    const __m512i ge_v = _mm512_set1_epi16((int16_t)ge);
    const __m512i go_v = _mm512_set1_epi16((int16_t)go);
    // tail mask for the last chunk (query rows >= qlen are dead)
    const int tail = (int)(qlen - (int64_t)(nch - 1) * 32);
    const __mmask32 mtail = tail >= 32 ? (__mmask32)~0u
                                       : (__mmask32)(~0u >> (32 - tail));
    int32_t best = 0, bc = 0, br = 0;
    for (int64_t j = 0; j < tlen; ++j) {
        const int16_t* prow = profT + (size_t)(t[j] & 31) * qlen;
        int16_t carryA = NEG16;   // prefix-max A carry
        int16_t carryH = 0;       // diag shift carry (H[i-1] row boundary)
        __m512i colmax = zero;
        for (int c = 0; c < nch; ++c) {
            const int32_t rb = 32 * c;
            const __mmask32 m = c + 1 < nch ? (__mmask32)~0u : mtail;
            __m512i s = c + 1 < nch
                            ? _mm512_loadu_si512(prow + rb)
                            : _mm512_mask_loadu_epi16(neg, m, prow + rb);
            __m512i Hp = _mm512_loadu_si512(Hd + rb);
            __m512i E = _mm512_loadu_si512(Ed + rb);
            // diag = Hp shifted down one query row, carry across chunks
            __m512i diag = SH.shift_fill(Hp, 0);
            diag = _mm512_mask_set1_epi16(diag, (__mmask32)1, carryH);
            {
                __m128i hi = _mm512_extracti32x4_epi32(Hp, 3);
                carryH = (int16_t)_mm_extract_epi16(hi, 7);
            }
            __m512i cur = _mm512_adds_epi16(diag, s);
            cur = _mm512_max_epi16(cur, E);
            cur = _mm512_max_epi16(cur, zero);
            __m512i A = _mm512_adds_epi16(cur,
                                          _mm512_loadu_si512(Rv + rb));
            __m512i incl = SH.prefix_max(A);
            __m512i excl = SH.shift_fill(incl, 0);
            if (c > 0)
                excl = _mm512_max_epi16(excl, _mm512_set1_epi16(carryA));
            {
                __m128i hi = _mm512_extracti32x4_epi32(incl, 3);
                const int16_t top = (int16_t)_mm_extract_epi16(hi, 7);
                if (top > carryA)
                    carryA = top;
            }
            __m512i F = _mm512_subs_epi16(excl,
                                          _mm512_loadu_si512(Gv + rb));
            F = _mm512_max_epi16(F, zero);
            __m512i hn = _mm512_max_epi16(cur, F);
            hn = _mm512_maskz_mov_epi16(m, hn);
            _mm512_storeu_si512(Hd + rb, hn);
            colmax = _mm512_max_epi16(colmax, hn);
            __m512i en = _mm512_max_epi16(_mm512_subs_epi16(E, ge_v),
                                          _mm512_subs_epi16(hn, go_v));
            en = _mm512_max_epi16(en, zero);
            en = _mm512_maskz_mov_epi16(m, en);
            _mm512_storeu_si512(Ed + rb, en);
        }
        __m256i m256 = _mm256_max_epi16(
            _mm512_castsi512_si256(colmax),
            _mm512_extracti64x4_epi64(colmax, 1));
        __m128i m128 = _mm_max_epi16(_mm256_castsi256_si128(m256),
                                     _mm256_extracti128_si256(m256, 1));
        __m128i inv = _mm_sub_epi16(_mm_set1_epi16(0x7fff), m128);
        const int32_t cm = 0x7fff - (_mm_extract_epi16(
                               _mm_minpos_epu16(inv), 0));
        if (cm > best) {
            best = cm;
            bc = (int32_t)j;
            if (best >= OVF16) {
                out3[0] = out3[1] = out3[2] = 0;
                return 1;  // caller reruns in int32
            }
            const __m512i cmv = _mm512_set1_epi16((int16_t)cm);
            br = 0;
            for (int c = 0; c < nch; ++c) {
                const __mmask32 eq = _mm512_cmpeq_epi16_mask(
                    _mm512_loadu_si512(Hd + 32 * c), cmv);
                if (eq)
                    br = 32 * c + (31 - __builtin_clz((uint32_t)eq));
            }
        }
    }
    out3[0] = best;
    out3[1] = bc;   // target column
    out3[2] = br;   // query row
    return 0;
}

// exact int32 twin (16 lanes) for jobs the int16 engine cannot certify
void swipe_full32(const int32_t* profT, int64_t qlen, const int8_t* t,
                  int64_t tlen, int32_t go, int32_t ge, int64_t* out3);

// ---------- interleaved score engine ----------
// The per-column work is one long dependency chain (5-step prefix max
// per 32-lane chunk, serial across chunks via the carry, serial across
// columns via H/E) — the core sits latency-bound.  Independent jobs
// have independent chains, so advancing four jobs one column each per
// round-robin step fills the pipeline (~2-3x on the real job mix).

struct JobState16 {
    const int16_t* profT;
    const int8_t* t;
    int64_t qlen, d0, band;
    int64_t j, j1;
    int nch;
    int16_t* Ed;   // [-1] slot valid (scratch in front)
    int16_t* Hd;
    int16_t* Rv;
    int16_t* Gv;
    int32_t best, bc, br;
};

// one DP column of one job; returns 1 when the job overflowed int16
static inline int step_col16(JobState16& J, const Shifter& SH,
                             const __m512i zero, const __m512i neg,
                             const __m512i ge_v, const __m512i go_v) {
    const int64_t j = J.j;
    const int16_t* prow = J.profT + (size_t)(J.t[j] & 31) * J.qlen;
    const int64_t off = j + J.d0;
    const int64_t rlo64 = off < 0 ? -off : 0;
    int64_t rhi64 = J.qlen - off;
    if (rhi64 > J.band)
        rhi64 = J.band;
    const int32_t rlo = (int32_t)rlo64;
    const int32_t rhi = (int32_t)rhi64;
    int16_t carry = NEG16;
    __m512i colmax = zero;
    const int nch = J.nch;
    int16_t* Hd = J.Hd;
    int16_t* Ed = J.Ed;
    for (int c = 0; c < nch; ++c) {
        const int32_t rb = 32 * c;
        const bool interior = rlo <= rb && rb + 32 <= rhi;
        __m512i s, H, E;
        __mmask32 m = (__mmask32)~0u;
        if (interior) {  // full chunk: unmasked load, no lane zeroing
            s = _mm512_loadu_si512(prow + off + rb);
        } else {
            if (rb >= rhi || rb + 32 <= rlo) {
                m = 0;
            } else {
                uint32_t bits = ~0u;
                if (rlo > rb)
                    bits &= ~0u << (rlo - rb);
                if (rhi < rb + 32)
                    bits &= ~0u >> (rb + 32 - rhi);
                m = (__mmask32)bits;
            }
            s = _mm512_mask_loadu_epi16(neg, m, prow + off + rb);
        }
        H = _mm512_loadu_si512(Hd + rb);
        E = _mm512_loadu_si512(Ed + rb);
        __m512i cur = _mm512_adds_epi16(H, s);
        cur = _mm512_max_epi16(cur, E);
        cur = _mm512_max_epi16(cur, zero);
        __m512i A = _mm512_adds_epi16(cur,
                                      _mm512_loadu_si512(J.Rv + rb));
        __m512i incl = SH.prefix_max(A);
        __m512i excl = SH.shift_fill(incl, 0);
        if (c > 0)
            excl = _mm512_max_epi16(excl, _mm512_set1_epi16(carry));
        if (c + 1 < nch) {  // cross-chunk A carry (skip on the last)
            __m128i hi = _mm512_extracti32x4_epi32(incl, 3);
            const int16_t top = (int16_t)_mm_extract_epi16(hi, 7);
            if (top > carry)
                carry = top;
        }
        __m512i F = _mm512_subs_epi16(excl,
                                      _mm512_loadu_si512(J.Gv + rb));
        F = _mm512_max_epi16(F, zero);
        __m512i hn = _mm512_max_epi16(cur, F);
        if (!interior)
            hn = _mm512_maskz_mov_epi16(m, hn);
        _mm512_storeu_si512(Hd + rb, hn);
        colmax = _mm512_max_epi16(colmax, hn);
        __m512i en = _mm512_max_epi16(_mm512_subs_epi16(E, ge_v),
                                      _mm512_subs_epi16(hn, go_v));
        en = _mm512_max_epi16(en, zero);
        _mm512_storeu_si512((void*)(Ed + rb - 1), en);
    }
    Ed[J.band - 1] = 0;
    __m256i m256 = _mm256_max_epi16(
        _mm512_castsi512_si256(colmax),
        _mm512_extracti64x4_epi64(colmax, 1));
    __m128i m128 = _mm_max_epi16(_mm256_castsi256_si128(m256),
                                 _mm256_extracti128_si256(m256, 1));
    __m128i inv = _mm_sub_epi16(_mm_set1_epi16(0x7fff), m128);
    const int32_t cm = 0x7fff - (_mm_extract_epi16(
                           _mm_minpos_epu16(inv), 0));
    if (cm > J.best) {
        J.best = cm;
        J.bc = (int32_t)j;
        if (cm >= OVF16)
            return 1;
        const __m512i cmv = _mm512_set1_epi16((int16_t)cm);
        int32_t br = 0;
        for (int c = 0; c < nch; ++c) {
            const __mmask32 eq = _mm512_cmpeq_epi16_mask(
                _mm512_loadu_si512(Hd + 32 * c), cmv);
            if (eq)
                br = 32 * c + (31 - __builtin_clz((uint32_t)eq));
        }
        J.br = br;
    }
    return 0;
}

// rolling 4-slot profile cache; entries fetched for the current group
// are pinned via used_mask so a group never evicts its own profiles
struct ProfCache16 {
    ProfT16 e[4];
    const ProfT16* get(const int8_t* q_base, const int32_t* bias_base,
                       int64_t qoff, int64_t qlen, int ub,
                       const int32_t* matrix32, uint32_t& used_mask) {
        for (int i = 0; i < 4; ++i)
            if (e[i].q_off == qoff && e[i].qlen == qlen
                && e[i].use_bias == ub) {
                used_mask |= 1u << i;
                return &e[i];
            }
        int s = 0;
        while (s < 4 && (used_mask & (1u << s)))
            ++s;
        if (s == 4)
            s = 0;  // unreachable: groups hold at most 4 queries
        ProfT16& p = e[s];
        build_profT16(p, q_base + qoff, qlen,
                      ub && bias_base ? bias_base + qoff : nullptr,
                      matrix32);
        p.q_off = qoff;
        p.qlen = qlen;
        p.use_bias = ub;
        used_mask |= 1u << s;
        return &p;
    }
};

// traceback variant: same DP, additionally emitting the four trace-mask
// byte planes ([tlen, band] row-major 0/1, bit-exact with the scalar
// swipe_one in banded_swipe.cc, whose walk consumes them).  The masks
// compare against the SCALAR engine's state trajectory, so this engine
// adds its zeroing rules: En zeroed outside [rlo, rhi), F zeroed for
// rows <= rlo (the scalar's F[0]=0 + 1..r_lo loop), and fully-dead
// columns memset H/E and skip mask emission entirely.
int swipe_striped16_tb(const int16_t* profT, int64_t qlen, const int8_t* t,
                       int64_t tlen, int64_t d0, int64_t band, int32_t go,
                       int32_t ge, int64_t* out3, uint32_t* gvp,
                       uint32_t* ghp, uint32_t* ovp, uint32_t* ohp) {
    static thread_local Shifter SH;
    const int nch = (int)((band + 31) / 32);
    static thread_local std::vector<int16_t> state;
    state.assign(1 + 4 * (size_t)nch * 32, 0);
    int16_t* Ed = state.data() + 1;
    int16_t* Hd = Ed + (size_t)nch * 32;
    int16_t* Rv = Hd + (size_t)nch * 32;
    int16_t* Gv = Rv + (size_t)nch * 32;
    for (int c = 0; c < nch; ++c)
        for (int i = 0; i < 32; ++i) {
            const int32_t r = 32 * c + i;
            Rv[32 * c + i] = (int16_t)(r * ge);
            Gv[32 * c + i] = (int16_t)(go + (r - 1) * ge);
        }
    const __m512i zero = _mm512_setzero_si512();
    const __m512i neg = _mm512_set1_epi16(NEG16);
    const __m512i ge_v = _mm512_set1_epi16((int16_t)ge);
    const __m512i go_v = _mm512_set1_epi16((int16_t)go);
    int32_t best = 0, bc = 0, br = 0;
    // valid column range (dead columns carry no state and no mask
    // emission — the walk can never reach them)
    int64_t j0 = -d0 - band + 1;
    if (j0 < 0)
        j0 = 0;
    int64_t j1 = qlen - d0;
    if (j1 > tlen)
        j1 = tlen;
    for (int64_t j = j0; j < j1; ++j) {
        const int16_t* prow = profT + (size_t)(t[j] & 31) * qlen;
        const int64_t off = j + d0;
        const int64_t rlo64 = off < 0 ? -off : 0;
        int64_t rhi64 = qlen - off;
        if (rhi64 > band)
            rhi64 = band;
        const int32_t rlo = (int32_t)(rlo64 < 0 ? 0 : rlo64);
        const int32_t rhi = (int32_t)(rhi64 < 0 ? 0 : rhi64);
        if (rlo >= rhi) {  // unreachable inside [j0, j1); kept for safety
            std::memset(Hd, 0, (size_t)nch * 32 * sizeof(int16_t));
            std::memset(Ed - 1, 0, (1 + (size_t)nch * 32) * sizeof(int16_t));
            continue;
        }
        int16_t carry = NEG16;
        __m512i colmax = zero;
        const int64_t pbase = j * nch;  // bit-plane words per column
        for (int c = 0; c < nch; ++c) {
            const int32_t rb = 32 * c;
            const bool interior = rlo <= rb && rb + 32 <= rhi && rlo < rb;
            __mmask32 m = (__mmask32)~0u;
            __mmask32 m_gt_lo = (__mmask32)~0u;
            __m512i s;
            if (interior) {  // full chunk, F not lo-zeroed: plain load
                s = _mm512_loadu_si512(prow + off + rb);
            } else {
                if (rb >= rhi || rb + 32 <= rlo) {
                    m = 0;
                } else {
                    uint32_t bits = ~0u;
                    if (rlo > rb)
                        bits &= ~0u << (rlo - rb);
                    if (rhi < rb + 32)
                        bits &= ~0u >> (rb + 32 - rhi);
                    m = (__mmask32)bits;
                }
                // rows r <= rlo have F zeroed in the scalar engine
                if (rlo < rb)
                    m_gt_lo = (__mmask32)~0u;
                else if (rlo - rb >= 31)
                    m_gt_lo = 0;
                else
                    m_gt_lo = (__mmask32)(~0u << (rlo - rb + 1));
                s = _mm512_mask_loadu_epi16(neg, m, prow + off + rb);
            }
            __m512i H = _mm512_loadu_si512(Hd + rb);
            __m512i E = _mm512_loadu_si512(Ed + rb);
            __m512i cur = _mm512_adds_epi16(H, s);
            cur = _mm512_max_epi16(cur, E);
            cur = _mm512_max_epi16(cur, zero);
            __m512i A = _mm512_adds_epi16(cur,
                                          _mm512_loadu_si512(Rv + rb));
            __m512i incl = SH.prefix_max(A);
            __m512i excl = SH.shift_fill(incl, 0);
            if (c > 0)
                excl = _mm512_max_epi16(excl, _mm512_set1_epi16(carry));
            {
                __m128i hi = _mm512_extracti32x4_epi32(incl, 3);
                const int16_t top = (int16_t)_mm_extract_epi16(hi, 7);
                if (top > carry)
                    carry = top;
            }
            __m512i F = _mm512_subs_epi16(excl,
                                          _mm512_loadu_si512(Gv + rb));
            F = _mm512_max_epi16(F, zero);
            __m512i Fm = interior ? F : _mm512_maskz_mov_epi16(m_gt_lo, F);
            __m512i hn = _mm512_max_epi16(cur, Fm);
            if (!interior)
                hn = _mm512_maskz_mov_epi16(m, hn);
            _mm512_storeu_si512(Hd + rb, hn);
            colmax = _mm512_max_epi16(colmax, hn);
            // trace masks (scalar formulas, all rows of the band)
            __m512i opn = _mm512_max_epi16(_mm512_subs_epi16(hn, go_v),
                                           zero);
            __m512i e_next = _mm512_max_epi16(_mm512_subs_epi16(E, ge_v),
                                              zero);
            const __mmask32 gv_b = _mm512_cmpeq_epi16_mask(hn, Fm);
            const __mmask32 gh_b = _mm512_cmpeq_epi16_mask(hn, E);
            const __mmask32 ov_b = _mm512_cmp_epi16_mask(
                opn,
                _mm512_max_epi16(_mm512_subs_epi16(Fm, ge_v), zero),
                _MM_CMPINT_NLT);
            const __mmask32 oh_b = _mm512_cmp_epi16_mask(opn, e_next,
                                                         _MM_CMPINT_NLT);
            // compare masks ARE the planes: one 32-bit store per plane
            // per chunk (8x less traffic than byte expansion); garbage
            // bits >= band are never read by the walk
            gvp[pbase + c] = (uint32_t)gv_b;
            ghp[pbase + c] = (uint32_t)gh_b;
            ovp[pbase + c] = (uint32_t)ov_b;
            ohp[pbase + c] = (uint32_t)oh_b;
            // En = max(e_next, opn) on valid rows, 0 outside (scalar)
            __m512i en = _mm512_max_epi16(e_next, opn);
            if (!interior)
                en = _mm512_maskz_mov_epi16(m, en);
            _mm512_storeu_si512((void*)(Ed + rb - 1), en);
        }
        Ed[band - 1] = 0;
        __m256i m256 = _mm256_max_epi16(
            _mm512_castsi512_si256(colmax),
            _mm512_extracti64x4_epi64(colmax, 1));
        __m128i m128 = _mm_max_epi16(_mm256_castsi256_si128(m256),
                                     _mm256_extracti128_si256(m256, 1));
        __m128i inv = _mm_sub_epi16(_mm_set1_epi16(0x7fff), m128);
        const int32_t cm = 0x7fff - (_mm_extract_epi16(
                               _mm_minpos_epu16(inv), 0));
        if (cm > best) {
            best = cm;
            bc = (int32_t)j;
            if (best >= OVF16) {  // masks will be refilled exactly by the
                out3[0] = out3[1] = out3[2] = 0;  // int32 engine: abort
                return 0;
            }
            const __m512i cmv = _mm512_set1_epi16((int16_t)cm);
            br = 0;
            for (int c = 0; c < nch; ++c) {
                const __mmask32 eq = _mm512_cmpeq_epi16_mask(
                    _mm512_loadu_si512(Hd + 32 * c), cmv);
                if (eq)
                    br = 32 * c + (31 - __builtin_clz((uint32_t)eq));
            }
        }
    }
    out3[0] = best;
    out3[1] = bc;
    out3[2] = br;  // band row (swipe_one's contract)
    return 1;
}

// ---------- striped int32 engines (exact for any score/band) ----------
// same structure as striped16 with 16 int32 lanes; used for the rare
// jobs the int16 engine cannot certify (overflow, band*ge too large,
// out-of-range profile values)

struct Shifter32 {
    __m512i idx[4];
    __mmask16 msk[4];
    __m512i neg;
    Shifter32() {
        alignas(64) int32_t buf[16];
        for (int step = 0, k = 1; k < 16; k <<= 1, ++step) {
            for (int i = 0; i < 16; ++i)
                buf[i] = i >= k ? i - k : 0;
            idx[step] = _mm512_load_si512(buf);
            msk[step] = (__mmask16)(~0u << k);
        }
        neg = _mm512_set1_epi32(NEGB);
    }
    inline __m512i shift_fill(__m512i v, int step) const {
        return _mm512_mask_permutexvar_epi32(neg, msk[step], idx[step], v);
    }
    inline __m512i prefix_max(__m512i v) const {
        for (int s = 0; s < 4; ++s)
            v = _mm512_max_epi32(v, shift_fill(v, s));
        return v;
    }
};

// emit_masks=false: score-only.  bit planes ([tlen, ceil(band/32)]
// uint32 words, bit r&31 of word r>>5) may be null then.
void swipe_striped32(const int32_t* profT, int64_t qlen, const int8_t* t,
                     int64_t tlen, int64_t d0, int64_t band, int32_t go,
                     int32_t ge, int64_t* out3, bool emit_masks,
                     uint32_t* gvp, uint32_t* ghp, uint32_t* ovp,
                     uint32_t* ohp) {
    static thread_local Shifter32 SH;
    const int nch = (int)((band + 15) / 16);
    static thread_local std::vector<int32_t> state;
    state.assign(1 + 4 * (size_t)nch * 16, 0);
    int32_t* Ed = state.data() + 1;
    int32_t* Hd = Ed + (size_t)nch * 16;
    int32_t* Rv = Hd + (size_t)nch * 16;
    int32_t* Gv = Rv + (size_t)nch * 16;
    for (int c = 0; c < nch; ++c)
        for (int i = 0; i < 16; ++i) {
            const int32_t r = 16 * c + i;
            Rv[16 * c + i] = r * ge;
            Gv[16 * c + i] = go + (r - 1) * ge;
        }
    const __m512i zero = _mm512_setzero_si512();
    const __m512i neg = _mm512_set1_epi32(NEGB);
    const __m512i ge_v = _mm512_set1_epi32(ge);
    const __m512i go_v = _mm512_set1_epi32(go);
    int32_t best = 0, bc = 0, br = 0;
    int64_t j0 = -d0 - band + 1;
    if (j0 < 0)
        j0 = 0;
    int64_t j1 = qlen - d0;
    if (j1 > tlen)
        j1 = tlen;
    for (int64_t j = j0; j < j1; ++j) {
        const int32_t* prow = profT + (size_t)(t[j] & 31) * qlen;
        const int64_t off = j + d0;
        const int64_t rlo64 = off < 0 ? -off : 0;
        int64_t rhi64 = qlen - off;
        if (rhi64 > band)
            rhi64 = band;
        const int32_t rlo = (int32_t)(rlo64 < 0 ? 0 : rlo64);
        const int32_t rhi = (int32_t)(rhi64 < 0 ? 0 : rhi64);
        if (emit_masks && rlo >= rhi) {
            std::memset(Hd, 0, (size_t)nch * 16 * sizeof(int32_t));
            std::memset(Ed - 1, 0, (1 + (size_t)nch * 16) * sizeof(int32_t));
            continue;
        }
        int32_t carry = NEGB;
        __m512i colmax = zero;
        // bit-plane halfword index: 16-lane chunk c lands in halfword c
        // of the column's word run (words = ceil(band/32))
        const int64_t pbase_hw = j * (((band + 31) / 32) * 2);
        for (int c = 0; c < nch; ++c) {
            const int32_t rb = 16 * c;
            __mmask16 m;
            if (rb >= rhi || rb + 16 <= rlo) {
                m = 0;
            } else {
                uint32_t bits = 0xffffu;
                if (rlo > rb)
                    bits &= 0xffffu << (rlo - rb);
                if (rhi < rb + 16)
                    bits &= 0xffffu >> (rb + 16 - rhi);
                m = (__mmask16)bits;
            }
            __mmask16 m_gt_lo;
            if (rlo < rb)
                m_gt_lo = (__mmask16)0xffffu;
            else if (rlo - rb >= 15)
                m_gt_lo = 0;
            else
                m_gt_lo = (__mmask16)(0xffffu << (rlo - rb + 1));
            __m512i s = _mm512_mask_loadu_epi32(neg, m, prow + off + rb);
            __m512i H = _mm512_loadu_si512(Hd + rb);
            __m512i E = _mm512_loadu_si512(Ed + rb);
            __m512i cur = _mm512_add_epi32(H, s);
            cur = _mm512_max_epi32(cur, E);
            cur = _mm512_max_epi32(cur, zero);
            __m512i A = _mm512_add_epi32(cur, _mm512_loadu_si512(Rv + rb));
            __m512i incl = SH.prefix_max(A);
            __m512i excl = SH.shift_fill(incl, 0);
            if (c > 0)
                excl = _mm512_max_epi32(excl, _mm512_set1_epi32(carry));
            {
                __m128i hi = _mm512_extracti32x4_epi32(incl, 3);
                const int32_t top = _mm_extract_epi32(hi, 3);
                if (top > carry)
                    carry = top;
            }
            __m512i F = _mm512_sub_epi32(excl, _mm512_loadu_si512(Gv + rb));
            F = _mm512_max_epi32(F, zero);
            __m512i Fm = _mm512_maskz_mov_epi32(m_gt_lo, F);
            __m512i hn = _mm512_max_epi32(cur, Fm);
            hn = _mm512_maskz_mov_epi32(m, hn);
            _mm512_storeu_si512(Hd + rb, hn);
            colmax = _mm512_max_epi32(colmax, hn);
            __m512i e_next = _mm512_max_epi32(_mm512_sub_epi32(E, ge_v),
                                              zero);
            __m512i opn = _mm512_max_epi32(_mm512_sub_epi32(hn, go_v),
                                           zero);
            if (emit_masks) {
                const __mmask16 gv_b = _mm512_cmpeq_epi32_mask(hn, Fm);
                const __mmask16 gh_b = _mm512_cmpeq_epi32_mask(hn, E);
                const __mmask16 ov_b = _mm512_cmp_epi32_mask(
                    opn,
                    _mm512_max_epi32(_mm512_sub_epi32(Fm, ge_v), zero),
                    _MM_CMPINT_NLT);
                const __mmask16 oh_b = _mm512_cmp_epi32_mask(
                    opn, e_next, _MM_CMPINT_NLT);
                ((uint16_t*)gvp)[pbase_hw + c] = (uint16_t)gv_b;
                ((uint16_t*)ghp)[pbase_hw + c] = (uint16_t)gh_b;
                ((uint16_t*)ovp)[pbase_hw + c] = (uint16_t)ov_b;
                ((uint16_t*)ohp)[pbase_hw + c] = (uint16_t)oh_b;
            }
            __m512i en = _mm512_max_epi32(e_next, opn);
            en = _mm512_maskz_mov_epi32(m, en);
            _mm512_storeu_si512((void*)(Ed + rb - 1), en);
        }
        Ed[band - 1] = 0;
        const int32_t cm = _mm512_reduce_max_epi32(colmax);
        if (cm > best) {
            best = cm;
            bc = (int32_t)j;
            const __m512i cmv = _mm512_set1_epi32(cm);
            br = 0;
            for (int c = 0; c < nch; ++c) {
                const __mmask16 eq = _mm512_cmpeq_epi32_mask(
                    _mm512_loadu_si512(Hd + 16 * c), cmv);
                if (eq)
                    br = 16 * c + (31 - __builtin_clz((uint32_t)eq));
            }
        }
    }
    out3[0] = best;
    out3[1] = bc;
    out3[2] = br;  // band row; score callers convert
}

void swipe_full32(const int32_t* profT, int64_t qlen, const int8_t* t,
                  int64_t tlen, int32_t go, int32_t ge, int64_t* out3) {
    static thread_local Shifter32 SH;
    const int nch = (int)((qlen + 15) / 16);
    static thread_local std::vector<int32_t> state;
    state.assign(4 * (size_t)nch * 16, 0);
    int32_t* Hd = state.data();
    int32_t* Ed = Hd + (size_t)nch * 16;
    int32_t* Rv = Ed + (size_t)nch * 16;
    int32_t* Gv = Rv + (size_t)nch * 16;
    for (int c = 0; c < nch; ++c)
        for (int i = 0; i < 16; ++i) {
            const int32_t r = 16 * c + i;
            Rv[16 * c + i] = r * ge;
            Gv[16 * c + i] = go + (r - 1) * ge;
        }
    const __m512i zero = _mm512_setzero_si512();
    const __m512i neg = _mm512_set1_epi32(NEGB);
    const __m512i ge_v = _mm512_set1_epi32(ge);
    const __m512i go_v = _mm512_set1_epi32(go);
    const int tail = (int)(qlen - (int64_t)(nch - 1) * 16);
    const __mmask16 mtail = tail >= 16
                                ? (__mmask16)0xffffu
                                : (__mmask16)(0xffffu >> (16 - tail));
    int32_t best = 0, bc = 0, br = 0;
    for (int64_t j = 0; j < tlen; ++j) {
        const int32_t* prow = profT + (size_t)(t[j] & 31) * qlen;
        int32_t carryA = NEGB;
        int32_t carryH = 0;
        __m512i colmax = zero;
        for (int c = 0; c < nch; ++c) {
            const int32_t rb = 16 * c;
            const __mmask16 m = c + 1 < nch ? (__mmask16)0xffffu : mtail;
            __m512i s = _mm512_mask_loadu_epi32(neg, m, prow + rb);
            __m512i Hp = _mm512_loadu_si512(Hd + rb);
            __m512i E = _mm512_loadu_si512(Ed + rb);
            __m512i diag = SH.shift_fill(Hp, 0);
            diag = _mm512_mask_set1_epi32(diag, (__mmask16)1, carryH);
            {
                __m128i hi = _mm512_extracti32x4_epi32(Hp, 3);
                carryH = _mm_extract_epi32(hi, 3);
            }
            __m512i cur = _mm512_add_epi32(diag, s);
            cur = _mm512_max_epi32(cur, E);
            cur = _mm512_max_epi32(cur, zero);
            __m512i A = _mm512_add_epi32(cur, _mm512_loadu_si512(Rv + rb));
            __m512i incl = SH.prefix_max(A);
            __m512i excl = SH.shift_fill(incl, 0);
            if (c > 0)
                excl = _mm512_max_epi32(excl, _mm512_set1_epi32(carryA));
            {
                __m128i hi = _mm512_extracti32x4_epi32(incl, 3);
                const int32_t top = _mm_extract_epi32(hi, 3);
                if (top > carryA)
                    carryA = top;
            }
            __m512i F = _mm512_sub_epi32(excl, _mm512_loadu_si512(Gv + rb));
            F = _mm512_max_epi32(F, zero);
            __m512i hn = _mm512_max_epi32(cur, F);
            hn = _mm512_maskz_mov_epi32(m, hn);
            _mm512_storeu_si512(Hd + rb, hn);
            colmax = _mm512_max_epi32(colmax, hn);
            __m512i en = _mm512_max_epi32(_mm512_sub_epi32(E, ge_v),
                                          _mm512_sub_epi32(hn, go_v));
            en = _mm512_max_epi32(en, zero);
            en = _mm512_maskz_mov_epi32(m, en);
            _mm512_storeu_si512(Ed + rb, en);
        }
        const int32_t cm = _mm512_reduce_max_epi32(colmax);
        if (cm > best) {
            best = cm;
            bc = (int32_t)j;
            const __m512i cmv = _mm512_set1_epi32(cm);
            br = 0;
            for (int c = 0; c < nch; ++c) {
                const __mmask16 eq = _mm512_cmpeq_epi32_mask(
                    _mm512_loadu_si512(Hd + 16 * c), cmv);
                if (eq)
                    br = 16 * c + (31 - __builtin_clz((uint32_t)eq));
            }
        }
    }
    out3[0] = best;
    out3[1] = bc;
    out3[2] = br;
}

struct TbProfCache {
    const int8_t* q = nullptr;
    const int32_t* bias = nullptr;
    int64_t qlen = 0;
    bool valid = false;
    ProfT16 prof;
    ProfT32 prof32;
    bool p32_valid = false;
};
thread_local TbProfCache g_tbcache;

#endif  // DTPU_STRIPED16

}  // namespace

// cross-TU hooks for banded_swipe.cc's traceback batchers: striped DP
// fill with byte-plane mask emission; returns 1 on success, 0 when the
// caller must run the scalar engine (overflow / wide band / big bias).
extern "C" void dtpu_striped16_cache_reset() {
#ifdef DTPU_STRIPED16
    g_tbcache.valid = false;
#endif
}

extern "C" int dtpu_striped16_tb_fill(
    const int8_t* q, int64_t qlen, const int32_t* bias, const int8_t* t,
    int64_t tlen, int64_t d0, int64_t band, const int32_t* matrix32,
    int64_t go64, int64_t ge64, int64_t* out3, uint32_t* gv, uint32_t* gh,
    uint32_t* ov, uint32_t* oh) {
#ifdef DTPU_STRIPED16
    TbProfCache& c = g_tbcache;
    if (!c.valid || c.q != q || c.bias != bias || c.qlen != qlen) {
        build_profT16(c.prof, q, qlen, bias, matrix32);
        c.q = q;
        c.bias = bias;
        c.qlen = qlen;
        c.valid = true;
        c.p32_valid = false;
    }
    if (band * (ge64 > 0 ? ge64 : 1) <= MAX_BANDGE16 && c.prof.ok
        && swipe_striped16_tb(c.prof.flat.data(), qlen, t, tlen, d0, band,
                              (int32_t)go64, (int32_t)ge64, out3, gv, gh,
                              ov, oh))
        return 1;
    // int16 could not certify (overflow / big bias): exact int32 striped
    if (!c.p32_valid) {
        build_profT32(c.prof32, q, qlen, bias, matrix32);
        c.p32_valid = true;
    }
    swipe_striped32(c.prof32.flat.data(), qlen, t, tlen, d0, band,
                    (int32_t)go64, (int32_t)ge64, out3, true, gv, gh, ov,
                    oh);
    return 1;
#else
    (void)q; (void)qlen; (void)bias; (void)t; (void)tlen; (void)d0;
    (void)band; (void)matrix32; (void)go64; (void)ge64; (void)out3;
    (void)gv; (void)gh; (void)ov; (void)oh;
    return 0;
#endif
}

extern "C" void banded_swipe_score_lanes(
    const int8_t* q_base, const int32_t* bias_base,
    const int64_t* q_off, const int64_t* q_len, const uint8_t* use_bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* d_begin, const int64_t* band_arr, int64_t njobs,
    const int32_t* matrix32, int64_t go64, int64_t ge64, int64_t* out) {
    const int32_t go = (int32_t)go64, ge = (int32_t)ge64;
#ifdef DTPU_STRIPED16
    static thread_local ProfCache16 cache;
    for (auto& p : cache.e)
        p.q_off = -1;  // q_base may differ between calls
    std::vector<int64_t> redo;
    std::vector<int64_t> fulls;
    static thread_local Shifter SH;
    static thread_local std::vector<int16_t> state;
    const __m512i zero = _mm512_setzero_si512();
    const __m512i neg = _mm512_set1_epi16(NEG16);
    const __m512i ge_v = _mm512_set1_epi16((int16_t)ge);
    const __m512i go_v = _mm512_set1_epi16((int16_t)go);
    int64_t k = 0;
    while (k < njobs) {
        // assemble a group of up to 4 int16-eligible jobs
        JobState16 js[4];
        int64_t ks[4];
        int G = 0;
        uint32_t used = 0;
        while (k < njobs && G < 4) {
            if (d_begin[k] <= -(t_len[k] - 1)
                && band_arr[k] >= q_len[k] + t_len[k] - 1) {
                // full-band job: the true full-matrix engine computes
                // qlen*tlen cells instead of (qlen+tlen)*tlen
                fulls.push_back(k);
                ++k;
                continue;
            }
            if (band_arr[k] * (ge > 0 ? ge : 1) > MAX_BANDGE16) {
                redo.push_back(k);
                ++k;
                continue;
            }
            const ProfT16* p = cache.get(q_base, bias_base, q_off[k],
                                         q_len[k], (int)use_bias[k],
                                         matrix32, used);
            if (!p->ok) {
                redo.push_back(k);
                ++k;
                continue;
            }
            JobState16& J = js[G];
            J.profT = p->flat.data();
            J.t = t_cat + t_off[k];
            J.qlen = q_len[k];
            J.d0 = d_begin[k];
            J.band = band_arr[k];
            J.nch = (int)((J.band + 31) / 32);
            int64_t j0 = -J.d0 - J.band + 1;
            if (j0 < 0)
                j0 = 0;
            int64_t j1 = J.qlen - J.d0;
            if (j1 > t_len[k])
                j1 = t_len[k];
            J.j = j0;
            J.j1 = j1 > j0 ? j1 : j0;
            J.best = 0;
            J.bc = 0;
            J.br = 0;
            ks[G] = k;
            ++G;
            ++k;
        }
        if (!G)
            continue;
        // carve per-job state blocks: [1 scratch][E][H][Rv][Gv]
        size_t total = 0;
        size_t off_i[4];
        for (int i = 0; i < G; ++i) {
            off_i[i] = total;
            total += 1 + 4 * (size_t)js[i].nch * 32;
        }
        state.assign(total, 0);
        for (int i = 0; i < G; ++i) {
            JobState16& J = js[i];
            int16_t* base = state.data() + off_i[i];
            J.Ed = base + 1;
            J.Hd = J.Ed + (size_t)J.nch * 32;
            J.Rv = J.Hd + (size_t)J.nch * 32;
            J.Gv = J.Rv + (size_t)J.nch * 32;
            for (int c = 0; c < J.nch; ++c)
                for (int l = 0; l < 32; ++l) {
                    const int32_t r = 32 * c + l;
                    J.Rv[32 * c + l] = (int16_t)(r * ge);
                    J.Gv[32 * c + l] = (int16_t)(go + (r - 1) * ge);
                }
        }
        // round-robin: each job's column body is one long dependency
        // chain (prefix max + H/E serialization); alternating the
        // group's independent jobs fills the pipeline
        bool ovf[4] = {false, false, false, false};
        for (bool alive = true; alive;) {
            alive = false;
            for (int i = 0; i < G; ++i) {
                JobState16& J = js[i];
                if (ovf[i] || J.j >= J.j1)
                    continue;
                if (step_col16(J, SH, zero, neg, ge_v, go_v))
                    ovf[i] = true;
                else
                    ++J.j;
                alive = true;
            }
        }
        for (int i = 0; i < G; ++i) {
            if (ovf[i]) {
                redo.push_back(ks[i]);
                continue;
            }
            const JobState16& J = js[i];
            int64_t* o = out + 3 * ks[i];
            o[0] = J.best;
            o[1] = J.bc;
            o[2] = J.bc + J.d0 + J.br;
        }
    }
    // full-band jobs: true full-matrix engines (int16, certify, else
    // int32), profile caches keyed on the query
    {
        ProfT16 pf16;
        ProfT32 pf32;
        int64_t c16 = -1, c32 = -1;
        for (int64_t k : fulls) {
            const int64_t qoff = q_off[k];
            const int64_t qlen = q_len[k];
            int64_t o3[3];
            int need32 = 1;
            if (qlen * (ge > 0 ? ge : 1) <= MAX_BANDGE16) {
                if (c16 != qoff || pf16.qlen != qlen
                    || pf16.use_bias != (int)use_bias[k]) {
                    build_profT16(pf16, q_base + qoff, qlen,
                                  use_bias[k] && bias_base
                                      ? bias_base + qoff : nullptr,
                                  matrix32);
                    pf16.qlen = qlen;
                    pf16.use_bias = use_bias[k];
                    c16 = qoff;
                }
                if (pf16.ok)
                    need32 = swipe_full16(pf16.flat.data(), qlen,
                                          t_cat + t_off[k], t_len[k], go,
                                          ge, o3);
            }
            if (need32) {
                if (c32 != qoff || pf32.qlen != qlen
                    || pf32.use_bias != (int)use_bias[k]) {
                    build_profT32(pf32, q_base + qoff, qlen,
                                  use_bias[k] && bias_base
                                      ? bias_base + qoff : nullptr,
                                  matrix32);
                    pf32.qlen = qlen;
                    pf32.use_bias = use_bias[k];
                    c32 = qoff;
                }
                swipe_full32(pf32.flat.data(), qlen, t_cat + t_off[k],
                             t_len[k], go, ge, o3);
            }
            out[3 * k] = o3[0];
            out[3 * k + 1] = o3[1];
            out[3 * k + 2] = o3[2];  // already the true query row
        }
    }
    // jobs the int16 engine could not certify: exact striped int32
    // (no lane padding — each redo job usually has its own query)
    ProfT32 prof32;
    for (int64_t k : redo) {
        const int64_t qoff = q_off[k];
        if (prof32.q_off != qoff || prof32.qlen != q_len[k]
            || prof32.use_bias != (int)use_bias[k]) {
            build_profT32(prof32, q_base + qoff, q_len[k],
                          use_bias[k] && bias_base ? bias_base + qoff
                                                   : nullptr,
                          matrix32);
            prof32.q_off = qoff;
            prof32.qlen = q_len[k];
            prof32.use_bias = use_bias[k];
        }
        int64_t o3[3];
        swipe_striped32(prof32.flat.data(), q_len[k], t_cat + t_off[k],
                        t_len[k], d_begin[k], band_arr[k], go, ge, o3,
                        false, nullptr, nullptr, nullptr, nullptr);
        out[3 * k] = o3[0];
        out[3 * k + 1] = o3[1];
        out[3 * k + 2] = o3[1] + d_begin[k] + o3[2];
    }
#else
    score_lanes_i32(q_base, bias_base, q_off, q_len, use_bias, t_cat,
                    t_off, t_len, d_begin, band_arr, njobs, matrix32, go,
                    ge, out);
#endif
}

#ifdef DTPU_STRIPED16

namespace {

// Traceback-fill job state for the round-robin driver: the single-job
// swipe_striped16_tb's locals lifted into a struct so independent jobs'
// column chains can interleave (the column body is latency-bound on the
// prefix-max + H/E serialization; alternating 4 jobs ~doubles
// throughput, same as the score engine).
struct JobStateTB {
    const int16_t* profT;
    const int8_t* t;
    int64_t qlen, d0, band;
    int64_t j, j1;
    int nch;
    int16_t* Ed;
    int16_t* Hd;
    int16_t* Rv;
    int16_t* Gv;
    uint32_t *gvp, *ghp, *ovp, *ohp;
    int32_t best, bc, br;
};

// one mask-emitting DP column; returns 1 when int16 overflowed
static inline int step_col16_tb(JobStateTB& J, const Shifter& SH,
                                const __m512i zero, const __m512i neg,
                                const __m512i ge_v, const __m512i go_v) {
    const int64_t j = J.j;
    const int16_t* prow = J.profT + (size_t)(J.t[j] & 31) * J.qlen;
    const int64_t off = j + J.d0;
    const int64_t rlo64 = off < 0 ? -off : 0;
    int64_t rhi64 = J.qlen - off;
    if (rhi64 > J.band)
        rhi64 = J.band;
    const int32_t rlo = (int32_t)(rlo64 < 0 ? 0 : rlo64);
    const int32_t rhi = (int32_t)(rhi64 < 0 ? 0 : rhi64);
    int16_t* Hd = J.Hd;
    int16_t* Ed = J.Ed;
    if (rlo >= rhi) {  // unreachable inside [j0, j1); kept for safety
        std::memset(Hd, 0, (size_t)J.nch * 32 * sizeof(int16_t));
        std::memset(Ed - 1, 0, (1 + (size_t)J.nch * 32) * sizeof(int16_t));
        return 0;
    }
    int16_t carry = NEG16;
    __m512i colmax = zero;
    const int64_t pbase = j * J.nch;
    for (int c = 0; c < J.nch; ++c) {
        const int32_t rb = 32 * c;
        const bool interior = rlo <= rb && rb + 32 <= rhi && rlo < rb;
        __mmask32 m = (__mmask32)~0u;
        __mmask32 m_gt_lo = (__mmask32)~0u;
        __m512i s;
        if (interior) {
            s = _mm512_loadu_si512(prow + off + rb);
        } else {
            if (rb >= rhi || rb + 32 <= rlo) {
                m = 0;
            } else {
                uint32_t bits = ~0u;
                if (rlo > rb)
                    bits &= ~0u << (rlo - rb);
                if (rhi < rb + 32)
                    bits &= ~0u >> (rb + 32 - rhi);
                m = (__mmask32)bits;
            }
            if (rlo < rb)
                m_gt_lo = (__mmask32)~0u;
            else if (rlo - rb >= 31)
                m_gt_lo = 0;
            else
                m_gt_lo = (__mmask32)(~0u << (rlo - rb + 1));
            s = _mm512_mask_loadu_epi16(neg, m, prow + off + rb);
        }
        __m512i H = _mm512_loadu_si512(Hd + rb);
        __m512i E = _mm512_loadu_si512(Ed + rb);
        __m512i cur = _mm512_adds_epi16(H, s);
        cur = _mm512_max_epi16(cur, E);
        cur = _mm512_max_epi16(cur, zero);
        __m512i A = _mm512_adds_epi16(cur, _mm512_loadu_si512(J.Rv + rb));
        __m512i incl = SH.prefix_max(A);
        __m512i excl = SH.shift_fill(incl, 0);
        if (c > 0)
            excl = _mm512_max_epi16(excl, _mm512_set1_epi16(carry));
        {
            __m128i hi = _mm512_extracti32x4_epi32(incl, 3);
            const int16_t top = (int16_t)_mm_extract_epi16(hi, 7);
            if (top > carry)
                carry = top;
        }
        __m512i F = _mm512_subs_epi16(excl, _mm512_loadu_si512(J.Gv + rb));
        F = _mm512_max_epi16(F, zero);
        __m512i Fm = interior ? F : _mm512_maskz_mov_epi16(m_gt_lo, F);
        __m512i hn = _mm512_max_epi16(cur, Fm);
        if (!interior)
            hn = _mm512_maskz_mov_epi16(m, hn);
        _mm512_storeu_si512(Hd + rb, hn);
        colmax = _mm512_max_epi16(colmax, hn);
        __m512i opn = _mm512_max_epi16(_mm512_subs_epi16(hn, go_v), zero);
        __m512i e_next = _mm512_max_epi16(_mm512_subs_epi16(E, ge_v), zero);
        const __mmask32 gv_b = _mm512_cmpeq_epi16_mask(hn, Fm);
        const __mmask32 gh_b = _mm512_cmpeq_epi16_mask(hn, E);
        const __mmask32 ov_b = _mm512_cmp_epi16_mask(
            opn, _mm512_max_epi16(_mm512_subs_epi16(Fm, ge_v), zero),
            _MM_CMPINT_NLT);
        const __mmask32 oh_b = _mm512_cmp_epi16_mask(opn, e_next,
                                                     _MM_CMPINT_NLT);
        J.gvp[pbase + c] = (uint32_t)gv_b;
        J.ghp[pbase + c] = (uint32_t)gh_b;
        J.ovp[pbase + c] = (uint32_t)ov_b;
        J.ohp[pbase + c] = (uint32_t)oh_b;
        __m512i en = _mm512_max_epi16(e_next, opn);
        if (!interior)
            en = _mm512_maskz_mov_epi16(m, en);
        _mm512_storeu_si512((void*)(Ed + rb - 1), en);
    }
    Ed[J.band - 1] = 0;
    __m256i m256 = _mm256_max_epi16(
        _mm512_castsi512_si256(colmax),
        _mm512_extracti64x4_epi64(colmax, 1));
    __m128i m128 = _mm_max_epi16(_mm256_castsi256_si128(m256),
                                 _mm256_extracti128_si256(m256, 1));
    __m128i inv = _mm_sub_epi16(_mm_set1_epi16(0x7fff), m128);
    const int32_t cm = 0x7fff - (_mm_extract_epi16(_mm_minpos_epu16(inv),
                                                   0));
    if (cm > J.best) {
        J.best = cm;
        J.bc = (int32_t)j;
        if (cm >= OVF16)
            return 1;
        const __m512i cmv = _mm512_set1_epi16((int16_t)cm);
        int32_t br = 0;
        for (int c = 0; c < J.nch; ++c) {
            const __mmask32 eq = _mm512_cmpeq_epi16_mask(
                _mm512_loadu_si512(J.Hd + 32 * c), cmv);
            if (eq)
                br = 32 * c + (31 - __builtin_clz((uint32_t)eq));
        }
        J.br = br;
    }
    return 0;
}

// 4-entry cross-query int16 profile cache for the quad driver
struct TbProfCache4 {
    ProfT16 e[4];
    int64_t q_off[4] = {-1, -1, -1, -1};
    const ProfT16* get(const int8_t* q_base, const int32_t* bias_base,
                       int64_t qoff, int64_t qlen, int ub,
                       const int32_t* matrix32, uint32_t& used) {
        for (int i = 0; i < 4; ++i)
            if (q_off[i] == qoff && e[i].qlen == qlen
                && e[i].use_bias == ub) {
                used |= 1u << i;
                return &e[i];
            }
        int s = 0;
        while (s < 4 && (used & (1u << s)))
            ++s;
        if (s == 4)
            s = 0;
        build_profT16(e[s], q_base + qoff, qlen,
                      ub && bias_base ? bias_base + qoff : nullptr,
                      matrix32);
        e[s].qlen = qlen;
        e[s].use_bias = ub;
        q_off[s] = qoff;
        used |= 1u << s;
        return &e[s];
    }
};

}  // namespace

// Round-robin mask-emitting fill for up to 4 jobs of a cross-query
// batch.  Per job: out3[3] (best, best col, band row) and four
// caller-provided bit-plane buffers.  ok[i] semantics: 1 = int16 result
// certified; 0 = caller must refill job i exactly (striped32).
extern "C" void dtpu_striped16_tb_fill_quad(
    const int8_t* q_base, const int32_t* bias_base,
    const int64_t* q_off, const int64_t* q_len, const uint8_t* use_bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* d_begin, const int64_t* band, int64_t n,
    const int32_t* matrix32, int64_t go64, int64_t ge64,
    int64_t* out3,           // [n,3]
    uint32_t* const* gv, uint32_t* const* gh,
    uint32_t* const* ov, uint32_t* const* oh,
    uint8_t* ok) {
    static thread_local Shifter SH;
    static thread_local TbProfCache4 cache;
    static thread_local std::vector<int16_t> state;
    for (auto& off : cache.q_off)
        off = -1;  // q_base may differ between calls
    const int32_t go = (int32_t)go64, ge = (int32_t)ge64;
    const __m512i zero = _mm512_setzero_si512();
    const __m512i neg = _mm512_set1_epi16(NEG16);
    const __m512i ge_v = _mm512_set1_epi16((int16_t)ge);
    const __m512i go_v = _mm512_set1_epi16((int16_t)go);
    JobStateTB js[4];
    uint32_t used = 0;
    size_t total = 0;
    size_t off_i[4];
    int live[4];
    int G = 0;
    for (int64_t k = 0; k < n; ++k)
        ok[k] = 0;
    for (int64_t k = 0; k < n && G < 4; ++k) {
        if (band[k] * (ge > 0 ? ge : 1) > MAX_BANDGE16)
            continue;  // int16 cannot certify: caller refills
        const ProfT16* p = cache.get(q_base, bias_base, q_off[k], q_len[k],
                                     (int)use_bias[k], matrix32, used);
        if (!p->ok)
            continue;
        JobStateTB& J = js[G];
        J.profT = p->flat.data();
        J.t = t_cat + t_off[k];
        J.qlen = q_len[k];
        J.d0 = d_begin[k];
        J.band = band[k];
        J.nch = (int)((J.band + 31) / 32);
        int64_t j0 = -J.d0 - J.band + 1;
        if (j0 < 0)
            j0 = 0;
        int64_t j1 = J.qlen - J.d0;
        if (j1 > t_len[k])
            j1 = t_len[k];
        J.j = j0;
        J.j1 = j1 > j0 ? j1 : j0;
        J.gvp = gv[k];
        J.ghp = gh[k];
        J.ovp = ov[k];
        J.ohp = oh[k];
        J.best = 0;
        J.bc = 0;
        J.br = 0;
        live[G] = (int)k;
        ++G;
    }
    if (!G)
        return;
    for (int i = 0; i < G; ++i) {
        off_i[i] = total;
        total += 1 + 4 * (size_t)js[i].nch * 32;
    }
    state.assign(total, 0);
    for (int i = 0; i < G; ++i) {
        JobStateTB& J = js[i];
        int16_t* base = state.data() + off_i[i];
        J.Ed = base + 1;
        J.Hd = J.Ed + (size_t)J.nch * 32;
        J.Rv = J.Hd + (size_t)J.nch * 32;
        J.Gv = J.Rv + (size_t)J.nch * 32;
        for (int c = 0; c < J.nch; ++c)
            for (int l = 0; l < 32; ++l) {
                const int32_t r = 32 * c + l;
                J.Rv[32 * c + l] = (int16_t)(r * ge);
                J.Gv[32 * c + l] = (int16_t)(go + (r - 1) * ge);
            }
    }
    bool ovf[4] = {false, false, false, false};
    for (bool alive = true; alive;) {
        alive = false;
        for (int i = 0; i < G; ++i) {
            JobStateTB& J = js[i];
            if (ovf[i] || J.j >= J.j1)
                continue;
            if (step_col16_tb(J, SH, zero, neg, ge_v, go_v))
                ovf[i] = true;
            else
                ++J.j;
            alive = true;
        }
    }
    for (int i = 0; i < G; ++i) {
        if (ovf[i])
            continue;  // ok stays 0: caller refills exactly (striped32)
        const JobStateTB& J = js[i];
        int64_t* o = out3 + 3 * live[i];
        o[0] = J.best;
        o[1] = J.bc;
        o[2] = J.br;
        ok[live[i]] = 1;
    }
}

#else  // !DTPU_STRIPED16

extern "C" void dtpu_striped16_tb_fill_quad(
    const int8_t*, const int32_t*, const int64_t*, const int64_t*,
    const uint8_t*, const int8_t*, const int64_t*, const int64_t*,
    const int64_t*, const int64_t*, int64_t n, const int32_t*, int64_t,
    int64_t, int64_t*, uint32_t* const*, uint32_t* const*,
    uint32_t* const*, uint32_t* const*, uint8_t* ok) {
    for (int64_t k = 0; k < n; ++k)
        ok[k] = 0;
}

#endif  // DTPU_STRIPED16
