// Left-most dedup filter (native twin of
// diamond_tpu/search/left_most_batch.py; reference semantics from
// src/search/left_most.h:31-110).
//
// left_most_filter_many runs the COMPLETE per-hit filter — stage-2 window
// geometry, subject-side delimiter clip, reduced match-mask packing,
// pattern-matcher table lookups, and candidate verification — in one pass
// per hit with no temporaries.  leftmost_verify remains exported for the
// numpy batch fallback, which is the bit-identical oracle.

#include <cstdint>

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

constexpr int8_t DELIMITER = 31;
constexpr int8_t MASK_LETTER = 23;
constexpr int8_t STOP_LETTER = 24;

inline uint8_t verify_one(
    const int8_t* q_letters, const int8_t* s_letters,
    int64_t qs, int64_t ss, uint64_t hit_bits, uint64_t match_mask,
    int32_t left,
    uint64_t shape_mask, const int64_t* shape_positions,
    int32_t shape_weight,
    const int8_t* reduction_map, int64_t reduction_size,
    int32_t chunked, int64_t part_lo, int64_t part_hi, uint64_t seedp_mask,
    int32_t hamming_filter_id, const int16_t* part_tbl = nullptr) {
    uint64_t m = hit_bits;
    while (m) {
        const int bit = __builtin_ctzll(m);
        m &= m - 1;
        const int64_t qpos = qs + bit;
        const int64_t spos = ss + bit;
        if (chunked) {
            const uint64_t mm = match_mask >> bit;
            if ((mm & shape_mask) == shape_mask) {
                if (part_tbl) {
                    // precomputed subject-position partition (sentinel
                    // INT32_MAX = no valid seed here) replaces the
                    // per-candidate key recompute
                    const int64_t part = part_tbl[spos];
                    if (left ? !(part < part_hi) : !(part < part_lo))
                        continue;
                } else {
                    bool good = true;
                    int64_t key = 0;
                    for (int32_t c = 0; c < shape_weight; ++c) {
                        const int l =
                            s_letters[spos + shape_positions[c]] & 31;
                        if (l >= 20) {
                            good = false;
                            break;
                        }
                        key = key * reduction_size + reduction_map[l];
                    }
                    if (!good)
                        continue;
                    const int64_t part = key & (int64_t)seedp_mask;
                    if (left ? !(part < part_hi) : !(part < part_lo))
                        continue;
                }
            }
        }
#if defined(__AVX512BW__)
        const __mmask64 w48 = 0xFFFFFFFFFFFFull;
        const __m512i m31 = _mm512_set1_epi8(31);
        const __m512i qv = _mm512_and_si512(
            _mm512_maskz_loadu_epi8(w48, q_letters + qpos - 16), m31);
        const __m512i sv = _mm512_and_si512(
            _mm512_maskz_loadu_epi8(w48, s_letters + spos - 16), m31);
        const int32_t ident = __builtin_popcountll(
            _mm512_cmpeq_epi8_mask(qv, sv) & w48);
#else
        int32_t ident = 0;
        for (int o = -16; o < 32; ++o)
            ident += (q_letters[qpos + o] & 31) == (s_letters[spos + o] & 31);
#endif
        if (ident >= hamming_filter_id)
            return 1;
    }
    return 0;
}

// PatternMatcher.hit for one packed match mask (left_most_batch.py:47-60),
// bit-parallel: pattern p matches at offset i iff every set bit b of p has
// h bit (i+b) set, i.e. bit i of AND_{b in p} (h >> b).  One shift+and per
// pattern bit replaces the per-offset table-lookup loop; the length bound
// is automatic because h is zero above the window.
inline uint64_t matcher_hit(uint64_t h, const uint64_t* masks,
                            int32_t n_masks) {
    uint64_t out = 0;
    for (int32_t k = 0; k < n_masks; ++k) {
        uint64_t bits = masks[k];
        uint64_t m = ~0ull;
        while (bits) {
            m &= h >> __builtin_ctzll(bits);
            bits &= bits - 1;
        }
        out |= m;
    }
    return out;
}

}  // namespace

extern "C" void leftmost_verify(
    const int8_t* q_letters, const int8_t* s_letters,
    const int64_t* qs, const int64_t* ss,
    const uint64_t* hit_bits, const uint64_t* match_masks,
    int64_t n, int32_t left,
    uint64_t shape_mask, const int64_t* shape_positions,
    int32_t shape_weight,
    const int8_t* reduction_map, int64_t reduction_size,
    int32_t chunked, int64_t part_lo, int64_t part_hi, uint64_t seedp_mask,
    int32_t hamming_filter_id, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = verify_one(q_letters, s_letters, qs[i], ss[i], hit_bits[i],
                            match_masks[i], left, shape_mask, shape_positions,
                            shape_weight, reduction_map, reduction_size,
                            chunked, part_lo, part_hi, seedp_mask,
                            hamming_filter_id);
}

// Per-position seed partition table for verify_one: out[pos] = (reduced
// seed key at pos) & seedp_mask when every sampled letter is a true AA,
// else INT32_MAX.  Semantics match verify_one's inline recompute exactly
// (letter validity = (l & 31) < 20; no explicit sequence-bound check —
// delimiters are invalid letters).
extern "C" void build_seed_part_table(
    const int8_t* letters, int64_t n,
    const int64_t* shape_positions, int32_t shape_weight,
    int64_t shape_length,
    const int8_t* reduction_map, int64_t reduction_size,
    uint64_t seedp_mask, int16_t* out) {
    const int64_t end = n - shape_length + 1;
    for (int64_t pos = 0; pos < n; ++pos)
        out[pos] = INT16_MAX;  // sentinel: no valid seed (>= any bound)
    for (int64_t pos = 0; pos < end; ++pos) {
        int64_t key = 0;
        bool good = true;
        for (int32_t c = 0; c < shape_weight; ++c) {
            const int l = letters[pos + shape_positions[c]] & 31;
            if (l >= 20) {
                good = false;
                break;
            }
            key = key * reduction_size + reduction_map[l];
        }
        if (good)
            out[pos] = (int16_t)(key & (int64_t)seedp_mask);
    }
}

namespace {

// Single-hit left-most filter core (body of left_most_filter_many below).
inline uint8_t left_most_one(
    const int8_t* q_letters, const int8_t* s_letters,
    const uint8_t* q_seed_mask,
    const int8_t* reduction_map, int64_t reduction_size,
    int64_t qp, int64_t sp, int64_t seed_offset,
    int64_t wl0, int64_t wr0,
    uint64_t shape_mask, const int64_t* shape_positions,
    int32_t shape_weight, int64_t shape_length,
    int32_t first_shape, int32_t chunked,
    const uint64_t* cur_masks, int32_t cur_n,
    const uint64_t* prev_masks, int32_t prev_n,
    int64_t part_lo, int64_t part_hi, uint64_t seedp_mask,
    int32_t hamming_filter_id, const int16_t* part_tbl = nullptr) {
    const int64_t interval_mod = seed_offset % 32;
    int64_t overhang = wl0 - interval_mod;
    if (overhang < 0)
        overhang = 0;
    const int64_t seed_off = wl0 - overhang;
    const int64_t win_len0 = wl0 + wr0 - overhang;
    int64_t d = seed_off - 16;
    if (d < 0)
        d = 0;
    int64_t wl = seed_off < 16 ? seed_off : 16;
    int64_t qs = qp - seed_off + d;
    int64_t ss = sp - seed_off + d;
    int64_t window = win_len0 - d;
    if (window > wl + 1 + 32)
        window = wl + 1 + 32;
    int64_t first_after = window;
    int64_t last_before = -1;
#if defined(__AVX512BW__)
    {   // delimiter scan as one masked compare (window <= 49 always)
        const __mmask64 wm = window >= 64 ? ~0ull
                                          : ((1ull << window) - 1);
        const uint64_t dels = _mm512_cmpeq_epi8_mask(
            _mm512_maskz_loadu_epi8(wm, s_letters + ss),
            _mm512_set1_epi8(DELIMITER)) & wm;
        const uint64_t d_ge = wl < 64 ? dels >> wl : 0;
        if (d_ge)
            first_after = wl + __builtin_ctzll(d_ge);
        const uint64_t d_lt =
            dels & (wl >= 64 ? ~0ull : ((1ull << wl) - 1));
        if (d_lt)
            last_before = 63 - __builtin_clzll(d_lt);
    }
#else
    for (int64_t o = 0; o < window; ++o) {
        if (s_letters[ss + o] == DELIMITER) {
            if (o >= wl) {
                first_after = o;
                break;
            }
            last_before = o;
        }
    }
#endif
    const int64_t dd = last_before >= 0 ? last_before + 1 : 0;
    qs += dd;
    ss += dd;
    wl -= dd;
    window = first_after - dd;
    uint64_t match_mask = 0, smask = 0;
#if defined(__AVX512BW__)
    {   // reduced-alphabet match mask: two 16-entry shuffles + bit-4
        // select implement the 32-entry reduction_map byte lookup
        const __mmask64 wm = window >= 64 ? ~0ull
                                          : window <= 0
                                                ? 0
                                                : ((1ull << window) - 1);
        const __m512i m31 = _mm512_set1_epi8(31);
        const __m512i qb = _mm512_and_si512(
            _mm512_maskz_loadu_epi8(wm, q_letters + qs), m31);
        const __m512i sb = _mm512_and_si512(
            _mm512_maskz_loadu_epi8(wm, s_letters + ss), m31);
        const __m512i vmask = _mm512_set1_epi8(MASK_LETTER);
        const __m512i vdel = _mm512_set1_epi8(DELIMITER);
        const __m512i vstop = _mm512_set1_epi8(STOP_LETTER);
        const __mmask64 aaq = _mm512_cmpneq_epi8_mask(qb, vmask)
                              & _mm512_cmpneq_epi8_mask(qb, vdel)
                              & _mm512_cmpneq_epi8_mask(qb, vstop);
        const __mmask64 aas = _mm512_cmpneq_epi8_mask(sb, vmask)
                              & _mm512_cmpneq_epi8_mask(sb, vdel)
                              & _mm512_cmpneq_epi8_mask(sb, vstop);
        const __m512i tlo = _mm512_broadcast_i32x4(
            _mm_loadu_si128((const __m128i*)reduction_map));
        const __m512i thi = _mm512_broadcast_i32x4(
            _mm_loadu_si128((const __m128i*)(reduction_map + 16)));
        const __m512i b16 = _mm512_set1_epi8(16);
        const __mmask64 q4 = _mm512_test_epi8_mask(qb, b16);
        const __mmask64 s4 = _mm512_test_epi8_mask(sb, b16);
        const __m512i rq = _mm512_mask_blend_epi8(
            q4, _mm512_shuffle_epi8(tlo, qb), _mm512_shuffle_epi8(thi, qb));
        const __m512i rs = _mm512_mask_blend_epi8(
            s4, _mm512_shuffle_epi8(tlo, sb), _mm512_shuffle_epi8(thi, sb));
        match_mask = _mm512_cmpeq_epi8_mask(rq, rs) & aaq & aas & wm;
        smask = _mm512_cmpneq_epi8_mask(
                    _mm512_maskz_loadu_epi8(wm, q_seed_mask + qs),
                    _mm512_setzero_si512()) & wm;
    }
#else
    for (int64_t o = 0; o < window; ++o) {
        const int ql = q_letters[qs + o] & 31;
        const int sl = s_letters[ss + o] & 31;
        const bool aaq =
            ql != MASK_LETTER && ql != DELIMITER && ql != STOP_LETTER;
        const bool aas =
            sl != MASK_LETTER && sl != DELIMITER && sl != STOP_LETTER;
        if (aaq && aas && reduction_map[ql] == reduction_map[sl])
            match_mask |= 1ull << o;
        if (q_seed_mask[qs + o])
            smask |= 1ull << o;
    }
#endif
    const uint64_t query_seed_mask = ~smask;
    const int64_t len_left = wl + shape_length - 1;
    const uint64_t bits_left = (1ull << len_left) - 1;
    const uint64_t mm_left = match_mask & bits_left;
    const uint64_t qm_left = query_seed_mask & bits_left;
    const uint64_t left_hit =
        matcher_hit(mm_left, cur_masks, cur_n) & qm_left;
    if (first_shape && !chunked) {
        return left_hit == 0
                   ? 1
                   : (uint8_t)!verify_one(
                         q_letters, s_letters, qs, ss, left_hit, mm_left, 1,
                         shape_mask, shape_positions, shape_weight,
                         reduction_map, reduction_size, chunked, part_lo,
                         part_hi, seedp_mask, hamming_filter_id, part_tbl);
    }
    const uint64_t shift = (uint64_t)(wl + 1);
    const uint64_t mm_right = (match_mask >> shift) & 0xFFFFFFFFull;
    const uint64_t qm_right = (query_seed_mask >> shift) & 0xFFFFFFFFull;
    const uint64_t right_hit =
        matcher_hit(mm_right, chunked ? cur_masks : prev_masks,
                    chunked ? cur_n : prev_n) &
        qm_right;
    uint8_t keep = 1;
    if (left_hit)
        keep &= (uint8_t)!verify_one(
            q_letters, s_letters, qs, ss, left_hit, mm_left, 1, shape_mask,
            shape_positions, shape_weight, reduction_map, reduction_size,
            chunked, part_lo, part_hi, seedp_mask, hamming_filter_id,
            part_tbl);
    if (keep && right_hit)
        keep &= (uint8_t)!verify_one(
            q_letters, s_letters, qs + (int64_t)shift, ss + (int64_t)shift,
            right_hit, mm_right, 0, shape_mask, shape_positions,
            shape_weight, reduction_map, reduction_size, chunked, part_lo,
            part_hi, seedp_mask, hamming_filter_id, part_tbl);
    return keep;
}

#if defined(__AVX512BW__)

// Loop-invariant vector constants of the left-most filter.
struct LmTables {
    __m512i m31, vmask, vdel, vstop, b16, tlo, thi;
};

inline LmTables lm_tables(const int8_t* reduction_map) {
    LmTables t;
    t.m31 = _mm512_set1_epi8(31);
    t.vmask = _mm512_set1_epi8(MASK_LETTER);
    t.vdel = _mm512_set1_epi8(DELIMITER);
    t.vstop = _mm512_set1_epi8(STOP_LETTER);
    t.b16 = _mm512_set1_epi8(16);
    t.tlo = _mm512_broadcast_i32x4(
        _mm_loadu_si128((const __m128i*)reduction_map));
    t.thi = _mm512_broadcast_i32x4(
        _mm_loadu_si128((const __m128i*)(reduction_map + 16)));
    return t;
}

// Query-side invariants of the left-most filter, hoisted out of the
// subject loop (left_most_one recomputes all of this per pair; within a
// seed group every pair shares the query seed).  The fast path assumes no
// subject delimiter before the anchor (dd == 0) and falls back to
// left_most_one otherwise.
struct LmQuery {
    int64_t seed_off, d, wl, qs, window, wl48, wr48;
    uint64_t smask;   // query seed-mask bits over the window
    __mmask64 wm;     // window mask
    __mmask64 aaq;    // query AA-validity bits
    __m512i rq;       // reduced query letters
};

inline void lm_query_init(LmQuery& L, const LmTables& T,
                          const int8_t* q_letters,
                          const uint8_t* q_seed_mask,
                          int64_t qp, int64_t seed_offset,
                          int64_t wl48, int64_t wr48) {
    L.wl48 = wl48;
    L.wr48 = wr48;
    const int64_t interval_mod = seed_offset % 32;
    int64_t overhang = wl48 - interval_mod;
    if (overhang < 0)
        overhang = 0;
    L.seed_off = wl48 - overhang;
    const int64_t win_len0 = wl48 + wr48 - overhang;
    int64_t d = L.seed_off - 16;
    if (d < 0)
        d = 0;
    L.d = d;
    L.wl = L.seed_off < 16 ? L.seed_off : 16;
    L.qs = qp - L.seed_off + d;
    int64_t window = win_len0 - d;
    if (window > L.wl + 1 + 32)
        window = L.wl + 1 + 32;
    L.window = window;
    L.wm = window >= 64 ? ~0ull : ((1ull << window) - 1);
    const __m512i qb = _mm512_and_si512(
        _mm512_maskz_loadu_epi8(L.wm, q_letters + L.qs), T.m31);
    L.aaq = _mm512_cmpneq_epi8_mask(qb, T.vmask)
          & _mm512_cmpneq_epi8_mask(qb, T.vdel)
          & _mm512_cmpneq_epi8_mask(qb, T.vstop);
    const __mmask64 q4 = _mm512_test_epi8_mask(qb, T.b16);
    L.rq = _mm512_mask_blend_epi8(q4, _mm512_shuffle_epi8(T.tlo, qb),
                                  _mm512_shuffle_epi8(T.thi, qb));
    L.smask = _mm512_cmpneq_epi8_mask(
                  _mm512_maskz_loadu_epi8(L.wm, q_seed_mask + L.qs),
                  _mm512_setzero_si512()) &
              L.wm;
}

// Per-subject left-most check against a prepared LmQuery.  Bit-identical
// to left_most_one: the only difference is that query-side loads, masks
// and reduction lookups are reused across the group's subjects, and the
// subject smask truncation is skipped (hits cannot exist past the clipped
// subject window because the match mask is zero there).
inline uint8_t left_most_fast(
    const LmQuery& L, const LmTables& T,
    const int8_t* q_letters, const int8_t* s_letters,
    const uint8_t* q_seed_mask,
    const int8_t* reduction_map, int64_t reduction_size,
    int64_t qp, int64_t sp, int64_t seed_offset,
    uint64_t shape_mask, const int64_t* shape_positions,
    int32_t shape_weight, int64_t shape_length,
    int32_t first_shape, int32_t chunked,
    const uint64_t* cur_masks, int32_t cur_n,
    const uint64_t* prev_masks, int32_t prev_n,
    int64_t part_lo, int64_t part_hi, uint64_t seedp_mask,
    int32_t hamming_id, const int16_t* part_tbl) {
    const int64_t ss = sp - L.seed_off + L.d;
    const __m512i sb0 = _mm512_maskz_loadu_epi8(L.wm, s_letters + ss);
    const uint64_t dels = _mm512_cmpeq_epi8_mask(sb0, T.vdel) & L.wm;
    uint64_t wms = L.wm;
    if (dels) {
        const uint64_t d_lt =
            dels & (L.wl >= 64 ? ~0ull : ((1ull << L.wl) - 1));
        if (d_lt)  // delimiter before the anchor: rare, take the full path
            return left_most_one(
                q_letters, s_letters, q_seed_mask, reduction_map,
                reduction_size, qp, sp, seed_offset, L.wl48, L.wr48,
                shape_mask, shape_positions, shape_weight, shape_length,
                first_shape, chunked, cur_masks, cur_n, prev_masks, prev_n,
                part_lo, part_hi, seedp_mask, hamming_id, part_tbl);
        const int64_t window = L.wl + __builtin_ctzll(dels >> L.wl);
        wms = window >= 64 ? ~0ull : ((1ull << window) - 1);
    }
    const __m512i sb = _mm512_and_si512(sb0, T.m31);
    const __mmask64 aas = _mm512_cmpneq_epi8_mask(sb, T.vmask)
                        & _mm512_cmpneq_epi8_mask(sb, T.vdel)
                        & _mm512_cmpneq_epi8_mask(sb, T.vstop);
    const __mmask64 s4 = _mm512_test_epi8_mask(sb, T.b16);
    const __m512i rs = _mm512_mask_blend_epi8(
        s4, _mm512_shuffle_epi8(T.tlo, sb), _mm512_shuffle_epi8(T.thi, sb));
    const uint64_t match_mask =
        _mm512_cmpeq_epi8_mask(L.rq, rs) & L.aaq & aas & wms;
    const uint64_t query_seed_mask = ~L.smask;
    const int64_t len_left = L.wl + shape_length - 1;
    const uint64_t bits_left = (1ull << len_left) - 1;
    const uint64_t mm_left = match_mask & bits_left;
    const uint64_t qm_left = query_seed_mask & bits_left;
    const uint64_t left_hit =
        matcher_hit(mm_left, cur_masks, cur_n) & qm_left;
    if (first_shape && !chunked) {
        return left_hit == 0
                   ? 1
                   : (uint8_t)!verify_one(
                         q_letters, s_letters, L.qs, ss, left_hit, mm_left,
                         1, shape_mask, shape_positions, shape_weight,
                         reduction_map, reduction_size, chunked, part_lo,
                         part_hi, seedp_mask, hamming_id, part_tbl);
    }
    const uint64_t shift = (uint64_t)(L.wl + 1);
    const uint64_t mm_right = (match_mask >> shift) & 0xFFFFFFFFull;
    const uint64_t qm_right = (query_seed_mask >> shift) & 0xFFFFFFFFull;
    const uint64_t right_hit =
        matcher_hit(mm_right, chunked ? cur_masks : prev_masks,
                    chunked ? cur_n : prev_n) &
        qm_right;
    uint8_t keep = 1;
    if (left_hit)
        keep &= (uint8_t)!verify_one(
            q_letters, s_letters, L.qs, ss, left_hit, mm_left, 1, shape_mask,
            shape_positions, shape_weight, reduction_map, reduction_size,
            chunked, part_lo, part_hi, seedp_mask, hamming_id, part_tbl);
    if (keep && right_hit)
        keep &= (uint8_t)!verify_one(
            q_letters, s_letters, L.qs + (int64_t)shift, ss + (int64_t)shift,
            right_hit, mm_right, 0, shape_mask, shape_positions,
            shape_weight, reduction_map, reduction_size, chunked, part_lo,
            part_hi, seedp_mask, hamming_id, part_tbl);
    return keep;
}

#endif  // __AVX512BW__

}  // namespace

// Fused stage-1 fingerprint filter -> stage-2 ungapped window score ->
// left-most dedup over a seed-join CSR slice (native form of
// diamond_tpu/search/pipeline.py _stage12; reference hot loops 1+2,
// src/search/hamming/kernel.h:29-75 and stage2.h:74-154).  One pass per
// candidate pair with early exits — no intermediate pair arrays exist.
// Emits kept hits as [qidx, spos_global, qoff_local, min(score,255)]
// rows; returns the row count.

#if defined(__AVX512BW__)
// longest run of non-DELIMITER letters immediately left of q, capped at w
// (vector twin of the scalar backward scan; w > 64 falls back)
static inline int64_t scan_left_delim(const int8_t* q, int64_t w) {
    if (w <= 0)
        return 0;
    if (w > 64) {
        int64_t n = 0;
        while (n < w && q[-n - 1] != DELIMITER)
            ++n;
        return n;
    }
    const __mmask64 wm = w >= 64 ? ~0ull : ((1ull << w) - 1);
    const __m512i v = _mm512_maskz_loadu_epi8(wm, q - w);
    const uint64_t m = _mm512_mask_cmpeq_epi8_mask(
        wm, v, _mm512_set1_epi8(DELIMITER));
    if (!m)
        return w;
    return (w - 1) - (63 - (int64_t)__builtin_clzll(m));
}

// longest run of non-DELIMITER letters at q forward, capped at w
static inline int64_t scan_right_delim(const int8_t* q, int64_t w) {
    if (w <= 0)
        return 0;
    if (w > 64) {
        int64_t n = 0;
        while (n < w && q[n] != DELIMITER)
            ++n;
        return n;
    }
    const __mmask64 wm = w >= 64 ? ~0ull : ((1ull << w) - 1);
    const __m512i v = _mm512_maskz_loadu_epi8(wm, q);
    const uint64_t m = _mm512_mask_cmpeq_epi8_mask(
        wm, v, _mm512_set1_epi8(DELIMITER));
    if (!m)
        return w;
    return (int64_t)__builtin_ctzll(m);
}
#endif

extern "C" int64_t stage12_pipeline(
    const int8_t* q_letters, const int8_t* s_letters,
    const uint8_t* q_seed_mask,
    const int64_t* q_start, const int64_t* q_pos,
    const int64_t* s_start, const int64_t* s_pos,
    const uint8_t* group_keep,  // optional per-group skip mask
    int64_t group_lo, int64_t group_hi,
    const int64_t* q_block_starts, int64_t n_queries,
    const int32_t* cutoff_per_query, const int64_t* window_per_query,
    int32_t clamp255,
    int32_t hamming_id, const int32_t* matrix32,
    int32_t self_search,
    const int64_t* s_block_starts, int64_t n_targets,
    int32_t do_leftmost,
    const int8_t* reduction_map, int64_t reduction_size,
    uint64_t shape_mask, const int64_t* shape_positions,
    int32_t shape_weight, int64_t shape_length,
    int32_t first_shape, int32_t chunked,
    const uint64_t* cur_masks, int32_t cur_n,
    const uint64_t* prev_masks, int32_t prev_n,
    int64_t part_lo, int64_t part_hi, uint64_t seedp_mask,
    const int16_t* part_tbl,  // optional per-subject-position seed
                              // partition table (build_seed_part_table)
    const int32_t* q_idx_tbl,  // optional pos -> query index table
    const int32_t* s_idx_tbl,  // optional pos -> subject index table
    int64_t* out_rows,
    int64_t* stats_out) {  // optional [2]: stage1 passes, lm passes
    int64_t m = 0;
    int64_t n_s1 = 0, n_lm = 0;
#if defined(__AVX512BW__)
    const LmTables lmt = lm_tables(reduction_map);
#endif
    for (int64_t g = group_lo; g < group_hi; ++g) {
        if (group_keep && !group_keep[g])
            continue;
        for (int64_t qi = q_start[g]; qi < q_start[g + 1]; ++qi) {
            const int64_t qp = q_pos[qi];
#if defined(__AVX512BW__)
            if (qi + 1 < q_start[g + 1]) {  // next query window + masks
                const int64_t qpn = q_pos[qi + 1];
                _mm_prefetch((const char*)(q_letters + qpn - 16),
                             _MM_HINT_T0);
                _mm_prefetch((const char*)(q_letters + qpn + 32),
                             _MM_HINT_T0);
                _mm_prefetch((const char*)(q_seed_mask + qpn), _MM_HINT_T0);
            }
#endif
            // query id: O(1) table or binary search over block starts
            int64_t qidx;
            if (q_idx_tbl) {
                qidx = q_idx_tbl[qp];
            } else {
                int64_t lo = 0, hi = n_queries;
                while (lo + 1 < hi) {
                    const int64_t mid = (lo + hi) / 2;
                    if (q_block_starts[mid] <= qp)
                        lo = mid;
                    else
                        hi = mid;
                }
                qidx = lo;
            }
            const int64_t qoff = qp - q_block_starts[qidx];
            const int32_t cutoff = cutoff_per_query[qidx];
            const int64_t window = window_per_query[qidx];
            const int8_t* q = q_letters + qp;
            // query-side delimiter clip (shared by stage 2 and left-most)
#if defined(__AVX512BW__)
            const int64_t wleft = scan_left_delim(q, window);
            const int64_t wright = scan_right_delim(q, window);
#else
            int64_t wleft = 0;
            while (wleft < window && q[-wleft - 1] != DELIMITER)
                ++wleft;
            int64_t wright = 0;
            while (wright < window && q[wright] != DELIMITER)
                ++wright;
#endif
#if defined(__AVX512BW__)
            // stage 1 as one 48-byte masked compare (the reference's
            // SIMD fingerprint, hamming/kernel.h:29-75, as AVX-512)
            const __mmask64 w48 = 0xFFFFFFFFFFFFull;
            const __m512i m31 = _mm512_set1_epi8(31);
            const __m512i qv = _mm512_and_si512(
                _mm512_maskz_loadu_epi8(w48, q - 16), m31);
            // stage 2 hoist: query-side matrix row offsets over the
            // clipped window, (q[o]&31)*32 as int32 — filled lazily on the
            // first pair that survives the left-most filter (most don't)
            const int64_t W = wleft + wright;
            alignas(64) int32_t qrow[192];
            const int use_vec2 = W <= 192;
            int qrow_filled = 0;
#endif
            // left-most query-side hoist: the 48-window clip and all
            // query-side loads/reductions are invariant across the
            // group's subjects
            int64_t wl48 = wleft, wr48 = wright;
            if (do_leftmost && window != 48) {
#if defined(__AVX512BW__)
                wl48 = scan_left_delim(q, 48);
                wr48 = scan_right_delim(q, 48);
#else
                wl48 = 0;
                while (wl48 < 48 && q[-wl48 - 1] != DELIMITER)
                    ++wl48;
                wr48 = 0;
                while (wr48 < 48 && q[wr48] != DELIMITER)
                    ++wr48;
#endif
            }
#if defined(__AVX512BW__)
            LmQuery lq;
            if (do_leftmost)
                lm_query_init(lq, lmt, q_letters, q_seed_mask, qp, qoff,
                              wl48, wr48);
#endif
            for (int64_t si = s_start[g]; si < s_start[g + 1]; ++si) {
                const int64_t sp = s_pos[si];
                const int8_t* s = s_letters + sp;
                // the pair loop is memory-latency-bound: subject windows
                // and the partition table are random reads over tens of
                // MB — prefetch the next subject's lines one iteration
                // ahead (covers stage 1, left-most and verify loads)
#if defined(__AVX512BW__)
                if (si + 1 < s_start[g + 1]) {
                    const int64_t spn = s_pos[si + 1];
                    _mm_prefetch((const char*)(s_letters + spn - 16),
                                 _MM_HINT_T0);
                    _mm_prefetch((const char*)(s_letters + spn + 32),
                                 _MM_HINT_T0);
                    if (part_tbl)
                        _mm_prefetch((const char*)(part_tbl + spn),
                                     _MM_HINT_T0);
                }
#endif
                // stage 1: fingerprint identity
#if defined(__AVX512BW__)
                const __m512i sv = _mm512_and_si512(
                    _mm512_maskz_loadu_epi8(w48, s - 16), m31);
                const int32_t ident = __builtin_popcountll(
                    _mm512_cmpeq_epi8_mask(qv, sv) & w48);
#else
                int32_t ident = 0;
                for (int o = -16; o < 32; ++o)
                    ident += (q[o] & 31) == (s[o] & 31);
#endif
                if (ident < hamming_id)
                    continue;
                ++n_s1;
                // self-pair and left-most dedup checks run BEFORE the
                // stage-2 score: all three predicates are independent
                // per-pair, left-most rejects the bulk, and the score is
                // only emitted for kept hits — so the (expensive) exact
                // Kadane runs on survivors only.  Same final rows, same
                // order.
                if (self_search) {
                    int64_t sidx;
                    if (s_idx_tbl) {
                        sidx = s_idx_tbl[sp];
                    } else {
                        int64_t lo2 = 0, hi2 = n_targets;
                        while (lo2 + 1 < hi2) {
                            const int64_t mid = (lo2 + hi2) / 2;
                            if (s_block_starts[mid] <= sp)
                                lo2 = mid;
                            else
                                hi2 = mid;
                        }
                        sidx = lo2;
                    }
                    if (sidx == qidx)
                        continue;
                }
                if (do_leftmost) {
#if defined(__AVX512BW__)
                    if (!left_most_fast(
                            lq, lmt, q_letters, s_letters, q_seed_mask,
                            reduction_map, reduction_size, qp, sp, qoff,
                            shape_mask, shape_positions, shape_weight,
                            shape_length, first_shape, chunked, cur_masks,
                            cur_n, prev_masks, prev_n, part_lo, part_hi,
                            seedp_mask, hamming_id, part_tbl))
                        continue;
#else
                    if (!left_most_one(
                            q_letters, s_letters, q_seed_mask, reduction_map,
                            reduction_size, qp, sp, qoff, wl48, wr48,
                            shape_mask, shape_positions, shape_weight,
                            shape_length, first_shape, chunked, cur_masks,
                            cur_n, prev_masks, prev_n, part_lo, part_hi,
                            seedp_mask, hamming_id, part_tbl))
                        continue;
#endif
                }
                ++n_lm;
                // stage 2: best ungapped segment on the seed diagonal
                int64_t bestsc = 0;
#if defined(__AVX512BW__)
                if (use_vec2) {
                    if (!qrow_filled) {
                        qrow_filled = 1;
                        for (int64_t o = 0; o < W; ++o)
                            qrow[o] = (int32_t)(q[o - wleft] & 31) * 32;
                    }
                    // Kadane == max_k(P[k] - min(0, min_{j<k} P[j])) on
                    // the unclamped prefix sums; identical to the
                    // clamped scan whenever the result stays under 255
                    // (values never reach the clamp), else rerun scalar
                    const __m512i z = _mm512_setzero_si512();
                    const __m512i m31_32 = _mm512_set1_epi32(31);
                    __m512i bestv = z;
                    int32_t pc = 0;    // running total of scores
                    int32_t mc = 0;    // min(0, all previous P)
                    for (int64_t o = 0; o < W; o += 16) {
                        const __mmask16 m =
                            W - o >= 16
                                ? (__mmask16)0xffff
                                : (__mmask16)(0xffffu >> (16 - (W - o)));
                        // masked 16-byte load: an unmasked one reads up
                        // to 15 bytes past the clipped window, which can
                        // run off the end of the letters buffer
                        const __m512i s32 = _mm512_and_si512(
                            _mm512_cvtepi8_epi32(_mm_maskz_loadu_epi8(
                                m, s - wleft + o)),
                            m31_32);
                        const __m512i idx = _mm512_add_epi32(
                            _mm512_load_si512(qrow + o), s32);
                        // masked lanes score 0 (neutral for the scan)
                        const __m512i sc = _mm512_mask_i32gather_epi32(
                            z, m, idx, matrix32, 4);
                        // inclusive prefix sum / prefix min (4 steps)
                        __m512i P = sc;
                        P = _mm512_add_epi32(P, _mm512_alignr_epi32(
                                P, z, 16 - 1));
                        P = _mm512_add_epi32(P, _mm512_alignr_epi32(
                                P, z, 16 - 2));
                        P = _mm512_add_epi32(P, _mm512_alignr_epi32(
                                P, z, 16 - 4));
                        P = _mm512_add_epi32(P, _mm512_alignr_epi32(
                                P, z, 16 - 8));
                        const __m512i Pg =
                            _mm512_add_epi32(P, _mm512_set1_epi32(pc));
                        __m512i M = Pg;
                        const __m512i big = _mm512_set1_epi32(1 << 30);
                        M = _mm512_min_epi32(M, _mm512_alignr_epi32(
                                M, big, 16 - 1));
                        M = _mm512_min_epi32(M, _mm512_alignr_epi32(
                                M, big, 16 - 2));
                        M = _mm512_min_epi32(M, _mm512_alignr_epi32(
                                M, big, 16 - 4));
                        M = _mm512_min_epi32(M, _mm512_alignr_epi32(
                                M, big, 16 - 8));
                        // exclusive min with the carry (includes empty=0
                        // via mc's min(0, ...) invariant)
                        const __m512i Mex = _mm512_min_epi32(
                            _mm512_alignr_epi32(M, big, 16 - 1),
                            _mm512_set1_epi32(mc));
                        bestv = _mm512_max_epi32(
                            bestv, _mm512_sub_epi32(Pg, Mex));
                        alignas(64) int32_t ptail[16], mtail[16];
                        _mm512_store_si512(ptail, Pg);
                        _mm512_store_si512(mtail, M);
                        const int lastl = W - o >= 16 ? 15
                                                      : (int)(W - o - 1);
                        if (mtail[lastl] < mc)
                            mc = mtail[lastl];
                        pc = ptail[15];  // masked lanes add 0: safe
                    }
                    bestsc = _mm512_reduce_max_epi32(bestv);
                    if (bestsc < 0)
                        bestsc = 0;
                    if (clamp255 && bestsc > 255) {
                        int64_t st = 0;
                        bestsc = 0;
                        for (int64_t o = -wleft; o < wright; ++o) {
                            st += matrix32[(q[o] & 31) * 32 + (s[o] & 31)];
                            if (st < 0)
                                st = 0;
                            else if (st > 255)
                                st = 255;
                            if (st > bestsc)
                                bestsc = st;
                        }
                    }
                } else
#endif
                {
                    int64_t st = 0;
                    for (int64_t o = -wleft; o < wright; ++o) {
                        st += matrix32[(q[o] & 31) * 32 + (s[o] & 31)];
                        if (st < 0)
                            st = 0;
                        else if (clamp255 && st > 255)
                            st = 255;
                        if (st > bestsc)
                            bestsc = st;
                    }
                }
                if (bestsc <= cutoff)
                    continue;
                int64_t* row = out_rows + 4 * m;
                row[0] = qidx;
                row[1] = sp;
                row[2] = qoff;
                row[3] = bestsc > 255 ? 255 : bestsc;
                ++m;
            }
        }
    }
    if (stats_out) {
        stats_out[0] = n_s1;
        stats_out[1] = n_lm;
    }
    return m;
}

extern "C" void left_most_filter_many(
    const int8_t* q_letters, const int8_t* s_letters,
    const uint8_t* q_seed_mask,
    const int8_t* reduction_map, int64_t reduction_size,
    const int64_t* qp, const int64_t* sp, const int64_t* seed_offsets,
    const int64_t* window_lefts, const int64_t* window_rights, int64_t n,
    uint64_t shape_mask, const int64_t* shape_positions,
    int32_t shape_weight, int64_t shape_length,
    int32_t first_shape, int32_t chunked,
    const uint64_t* cur_masks, int32_t cur_n,
    const uint64_t* prev_masks, int32_t prev_n,
    int64_t part_lo, int64_t part_hi, uint64_t seedp_mask,
    int32_t hamming_filter_id, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        // stage2 window geometry (reference stage2.h:95-105)
        const int64_t wl0 = window_lefts[i];
        const int64_t wr0 = window_rights[i];
        const int64_t interval_mod = seed_offsets[i] % 32;
        int64_t overhang = wl0 - interval_mod;
        if (overhang < 0)
            overhang = 0;
        const int64_t seed_off = wl0 - overhang;
        const int64_t win_len0 = wl0 + wr0 - overhang;

        // left_most entry geometry (reference left_most.h:74-88)
        int64_t d = seed_off - 16;
        if (d < 0)
            d = 0;
        int64_t wl = seed_off < 16 ? seed_off : 16;
        int64_t qs = qp[i] - seed_off + d;
        int64_t ss = sp[i] - seed_off + d;
        int64_t window = win_len0 - d;
        if (window > wl + 1 + 32)
            window = wl + 1 + 32;

        // subject-side delimiter clip around the anchor at wl
        int64_t first_after = window;
        int64_t last_before = -1;
        for (int64_t o = 0; o < window; ++o) {
            if (s_letters[ss + o] == DELIMITER) {
                if (o >= wl) {
                    first_after = o;
                    break;
                }
                last_before = o;
            }
        }
        const int64_t dd = last_before >= 0 ? last_before + 1 : 0;
        qs += dd;
        ss += dd;
        wl -= dd;
        window = first_after - dd;

        // reduced match mask + seed-mask bits over the clipped window
        uint64_t match_mask = 0, smask = 0;
        for (int64_t o = 0; o < window; ++o) {
            const int ql = q_letters[qs + o] & 31;
            const int sl = s_letters[ss + o] & 31;
            const bool aaq =
                ql != MASK_LETTER && ql != DELIMITER && ql != STOP_LETTER;
            const bool aas =
                sl != MASK_LETTER && sl != DELIMITER && sl != STOP_LETTER;
            if (aaq && aas && reduction_map[ql] == reduction_map[sl])
                match_mask |= 1ull << o;
            if (q_seed_mask[qs + o])
                smask |= 1ull << o;
        }
        const uint64_t query_seed_mask = ~smask;

        const int64_t len_left = wl + shape_length - 1;
        const uint64_t bits_left = (1ull << len_left) - 1;
        const uint64_t mm_left = match_mask & bits_left;
        const uint64_t qm_left = query_seed_mask & bits_left;
        const uint64_t left_hit =
            matcher_hit(mm_left, cur_masks, cur_n) & qm_left;

        if (first_shape && !chunked) {
            out[i] = left_hit == 0
                         ? 1
                         : (uint8_t)!verify_one(
                               q_letters, s_letters, qs, ss, left_hit,
                               mm_left, 1, shape_mask, shape_positions,
                               shape_weight, reduction_map, reduction_size,
                               chunked, part_lo, part_hi, seedp_mask,
                               hamming_filter_id);
            continue;
        }

        const uint64_t shift = (uint64_t)(wl + 1);
        const uint64_t mm_right = (match_mask >> shift) & 0xFFFFFFFFull;
        const uint64_t qm_right = (query_seed_mask >> shift) & 0xFFFFFFFFull;
        const uint64_t right_hit =
            matcher_hit(mm_right, chunked ? cur_masks : prev_masks,
                        chunked ? cur_n : prev_n) &
            qm_right;

        uint8_t keep = 1;
        if (left_hit)
            keep &= (uint8_t)!verify_one(
                q_letters, s_letters, qs, ss, left_hit, mm_left, 1,
                shape_mask, shape_positions, shape_weight, reduction_map,
                reduction_size, chunked, part_lo, part_hi, seedp_mask,
                hamming_filter_id);
        if (keep && right_hit)
            keep &= (uint8_t)!verify_one(
                q_letters, s_letters, qs + (int64_t)shift,
                ss + (int64_t)shift, right_hit, mm_right, 0, shape_mask,
                shape_positions, shape_weight, reduction_map, reduction_size,
                chunked, part_lo, part_hi, seedp_mask, hamming_filter_id);
        out[i] = keep;
    }
}
