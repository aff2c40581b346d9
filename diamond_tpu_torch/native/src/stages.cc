// Stage-1/2 candidate filters (native twins of
// diamond_tpu/search/stages.py stage1_filter / stage2_scores; reference
// semantics from src/search/stage2.h:95-100, dp/ungapped_simd.cpp:32-67,
// hamming/finger_print.h:41-49).
//
// Window reads rely on the Block perimeter padding (256 delimiter bytes
// at both ends, data/block.py) so [pos-48, pos+48) is always in bounds.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512DQ__)
#include <immintrin.h>
#endif

namespace {
constexpr int8_t DELIMITER = 31;
}

// Fingerprint identity filter: out[i] = 1 iff the 48-letter windows
// around qp/sp agree at >= hamming_id positions.
extern "C" void stage1_filter_many(
    const int8_t* q_letters, const int8_t* s_letters,
    const int64_t* qp, const int64_t* sp, int64_t n,
    int32_t hamming_id, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* q = q_letters + qp[i];
        const int8_t* s = s_letters + sp[i];
        int32_t ident = 0;
        for (int o = -16; o < 32; ++o)
            ident += (q[o] & 31) == (s[o] & 31);
        out[i] = ident >= hamming_id;
    }
}

// Best ungapped segment score on the seed diagonal within the
// delimiter-clipped query window (Kadane, floor 0, optional ceiling 255
// mirroring the saturated int8 SIMD path).
extern "C" void stage2_scores_many(
    const int8_t* q_letters, const int8_t* s_letters,
    const int64_t* qp, const int64_t* sp, int64_t n,
    const int32_t* matrix32, int64_t window, int32_t clamp,
    int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* q = q_letters + qp[i];
        const int8_t* s = s_letters + sp[i];
        // query-side delimiter clip (reference Util::Seq::clip)
        int64_t left = 0;
        while (left < window && q[-left - 1] != DELIMITER)
            ++left;
        int64_t right = 0;
        while (right < window && q[right] != DELIMITER)
            ++right;
        int64_t st = 0, best = 0;
        for (int64_t o = -left; o < right; ++o) {
            st += matrix32[(q[o] & 31) * 32 + (s[o] & 31)];
            if (st < 0)
                st = 0;
            else if (clamp && st > 255)
                st = 255;
            if (st > best)
                best = st;
        }
        out[i] = (int32_t)best;
    }
}

// Per-position delimiter window clip (native twin of
// diamond_tpu/search/stages.py clip_window; reference Util::Seq::clip,
// sequence.h:30-40): window [pos-left, pos+right) contains no delimiter.
extern "C" void clip_window_many(
    const int8_t* letters, const int64_t* pos, int64_t n, int64_t window,
    int64_t* out_left, int64_t* out_right) {
    for (int64_t i = 0; i < n; ++i) {
        const int8_t* p = letters + pos[i];
        int64_t left = 0;
        while (left < window && p[-left - 1] != DELIMITER)
            ++left;
        int64_t right = 0;
        while (right < window && p[right] != DELIMITER)
            ++right;
        out_left[i] = left;
        out_right[i] = right;
    }
}

// Compacted per-block seed enumeration (native twin of
// diamond_tpu/search/stages.py enumerate_seeds; reference
// enum_seeds.h:131-188): loops sequences directly so no per-window
// temporaries exist.  Returns the number of valid seeds written.
// When out_keys is null, only counts (the caller then allocates exactly).
extern "C" int64_t enumerate_seeds_block(
    const int8_t* reduced, const int64_t* starts, const int64_t* lengths,
    int64_t nseqs, const int64_t* positions, int32_t weight,
    int64_t shape_length, int64_t base, int64_t min_len,
    uint64_t* out_keys, int64_t* out_pos) {
    int64_t m = 0;
#if defined(__AVX512F__) && defined(__AVX512DQ__)
    // 8 positions per step: the spaced key accumulates in 8 int64 lanes
    // (key = key*base + letter per shape position, validity as a lane
    // mask), survivors compress-store straight into the output
    const __m512i basev = _mm512_set1_epi64(base);
    const __m512i zerov = _mm512_setzero_si512();
    const __m512i iota = _mm512_setr_epi64(0, 1, 2, 3, 4, 5, 6, 7);
    for (int64_t s = 0; s < nseqs; ++s) {
        const int64_t L = lengths[s];
        if (L < shape_length || (min_len && L < min_len))
            continue;
        const int64_t st = starts[s];
        const int64_t end = st + L - shape_length;
        int64_t p = st;
        for (; p + 7 <= end; p += 8) {
            __m512i key = zerov;
            __mmask8 valid = 0xff;
            for (int32_t c = 0; c < weight; ++c) {
                // 8-byte load: exactly the lanes consumed by
                // cvtepi8_epi64 — a 16-byte load could run past the
                // end of the reduced buffer on the final sequence
                const __m128i raw = _mm_loadl_epi64(
                    (const __m128i*)(reduced + p + positions[c]));
                const __m512i w = _mm512_cvtepi8_epi64(raw);
                valid &= _mm512_cmpge_epi64_mask(w, zerov)
                         & _mm512_cmplt_epi64_mask(w, basev);
                key = _mm512_add_epi64(_mm512_mullo_epi64(key, basev), w);
            }
            if (out_keys) {
                _mm512_mask_compressstoreu_epi64(out_keys + m, valid, key);
                _mm512_mask_compressstoreu_epi64(
                    out_pos + m, valid,
                    _mm512_add_epi64(_mm512_set1_epi64(p), iota));
            }
            m += __builtin_popcount((unsigned)valid);
        }
        for (; p <= end; ++p) {
            uint64_t key = 0;
            bool v = true;
            for (int32_t c = 0; c < weight; ++c) {
                const int64_t w = reduced[p + positions[c]];
                v &= (w >= 0 && w < base);
                key = key * (uint64_t)base + (uint64_t)(w >= 0 && w < base
                                                            ? w : 0);
            }
            if (v) {
                if (out_keys) {
                    out_keys[m] = key;
                    out_pos[m] = p;
                }
                ++m;
            }
        }
    }
    return m;
#else
    for (int64_t s = 0; s < nseqs; ++s) {
        const int64_t L = lengths[s];
        if (L < shape_length || (min_len && L < min_len))
            continue;
        const int64_t st = starts[s];
        const int64_t end = st + L - shape_length;
        for (int64_t p = st; p <= end; ++p) {
            uint64_t key = 0;
            bool v = true;
            for (int32_t c = 0; c < weight; ++c) {
                const int64_t w = reduced[p + positions[c]];
                v &= (w >= 0 && w < base);
                key = key * (uint64_t)base + (uint64_t)(w < base ? w : 0);
            }
            if (v) {
                if (out_keys) {
                    out_keys[m] = key;
                    out_pos[m] = p;
                }
                ++m;
            }
        }
    }
    return m;
#endif
}

// 8-mer motif scan: for each window of 8 true-AA letters, binary-search
// the sorted motif key table; writes global start positions of hits
// (native twin of masking/motifs.find_motif_starts_block).
extern "C" int64_t motif_scan_block(
    const int8_t* letters, const int64_t* starts, const int64_t* lengths,
    int64_t nseqs, const int64_t* table, int64_t table_n, int64_t true_aa,
    int64_t* out_pos) {
    // Rolling 8-mer key (exact int64, keys < 20^8) + a 64K-bit filter
    // and an open-addressing set replace the per-position 8-letter key
    // recompute + binary search (~10x on the block scan; same output
    // positions in the same order).
    int64_t ta7 = 1;
    for (int c = 0; c < 7; ++c)
        ta7 *= true_aa;
    constexpr uint64_t MULT = 0x9E3779B97F4A7C15ull;
    constexpr int HBITS = 13;            // 8192 slots for ~1-8K motifs
    static thread_local std::vector<uint64_t> bloom;
    static thread_local std::vector<int64_t> hset;
    static thread_local const int64_t* built_for = nullptr;
    static thread_local int64_t built_n = -1;
    if (built_for != table || built_n != table_n) {
        bloom.assign(65536 / 64, 0);
        hset.assign((size_t)1 << HBITS, -1);
        for (int64_t i = 0; i < table_n; ++i) {
            const uint64_t k = (uint64_t)table[i];
            const uint64_t hb = (k * MULT) >> 48;  // 16 bits
            bloom[hb >> 6] |= 1ull << (hb & 63);
            uint64_t h = (k * MULT) >> (64 - HBITS);
            while (hset[h] != -1)
                h = (h + 1) & (((uint64_t)1 << HBITS) - 1);
            hset[h] = table[i];
        }
        built_for = table;
        built_n = table_n;
    }
    int64_t m = 0;
    for (int64_t s = 0; s < nseqs; ++s) {
        const int64_t L = lengths[s];
        if (L < 8)
            continue;
        const int64_t st = starts[s];
        const int64_t end = st + L - 8;
        int64_t key = 0;
        int bad = 0;
        for (int c = 0; c < 8; ++c) {
            const int64_t w = letters[st + c];
            const bool v = (w >= 0 && w < true_aa);
            bad += !v;
            key = key * true_aa + (v ? w : 0);
        }
        for (int64_t p = st;; ++p) {
            if (!bad) {
                const uint64_t k = (uint64_t)key;
                const uint64_t hb = (k * MULT) >> 48;
                if (bloom[hb >> 6] >> (hb & 63) & 1ull) {
                    uint64_t h = (k * MULT) >> (64 - HBITS);
                    while (hset[h] != -1 && hset[h] != key)
                        h = (h + 1) & (((uint64_t)1 << HBITS) - 1);
                    if (hset[h] == key)
                        out_pos[m++] = p;
                }
            }
            if (p == end)
                break;
            const int64_t wo = letters[p];
            const bool vo = (wo >= 0 && wo < true_aa);
            bad -= !vo;
            key -= (vo ? wo : 0) * ta7;
            key *= true_aa;
            const int64_t wi = letters[p + 8];
            const bool vi = (wi >= 0 && wi < true_aa);
            bad += !vi;
            key += vi ? wi : 0;
        }
    }
    return m;
}

// Reduced-alphabet seed-complexity filter (native twin of
// diamond_tpu/search/stages.py complexity_mask; reference
// seed_complexity.cpp:37-51): keep[g] = 1 iff the multinomial entropy of
// the seed key's bucket counts is >= cut.
extern "C" void seed_complexity_keep(
    const uint64_t* keys, int64_t n, int32_t weight, int64_t base,
    const double* lnfact, double cut, uint8_t* keep) {
    for (int64_t g = 0; g < n; ++g) {
        uint64_t k = keys[g];
        int32_t counts[64] = {0};
        for (int32_t i = 0; i < weight; ++i) {
            ++counts[k % (uint64_t)base];
            k /= (uint64_t)base;
        }
        double e = lnfact[weight];
        for (int64_t b = 0; b < base; ++b)
            e -= lnfact[counts[b]];
        keep[g] = e >= cut;
    }
}

// Stable LSD radix sort of (key, value) pairs by key, 8 bits per pass,
// high zero-bytes skipped (native replacement of the seed-join argsort).
extern "C" void sort_kv_u64(
    uint64_t* keys, int64_t* vals, int64_t n,
    uint64_t* tmp_k, int64_t* tmp_v, int32_t key_bytes) {
    uint64_t* ka = keys;
    int64_t* va = vals;
    uint64_t* kb = tmp_k;
    int64_t* vb = tmp_v;
    int64_t count[256];
    for (int32_t b = 0; b < key_bytes; ++b) {
        const int shift = b * 8;
        for (int i = 0; i < 256; ++i)
            count[i] = 0;
        for (int64_t i = 0; i < n; ++i)
            ++count[(ka[i] >> shift) & 0xFF];
        int64_t sum = 0;
        for (int i = 0; i < 256; ++i) {
            const int64_t c = count[i];
            count[i] = sum;
            sum += c;
        }
        for (int64_t i = 0; i < n; ++i) {
            const int64_t d = count[(ka[i] >> shift) & 0xFF]++;
            kb[d] = ka[i];
            vb[d] = va[i];
        }
        uint64_t* tk = ka; ka = kb; kb = tk;
        int64_t* tv = va; va = vb; vb = tv;
    }
    if (ka != keys) {
        for (int64_t i = 0; i < n; ++i) {
            keys[i] = ka[i];
            vals[i] = va[i];
        }
    }
}

// Whole-block spaced-seed extraction (native twin of
// diamond_tpu/seed/shapes.py Shape.extract_seeds): one pass, no
// temporaries.  keys/valid have n = L - shape_length + 1 entries; digit
// semantics replicate the numpy np.where(w < base, w, 0) exactly
// (signed digit, wrap on uint64 cast).
extern "C" void extract_seeds_many(
    const int8_t* reduced, int64_t n, const int64_t* positions,
    int32_t weight, int64_t base, uint64_t* keys, uint8_t* valid) {
    for (int64_t i = 0; i < n; ++i) {
        uint64_t key = 0;  // mod-2^64 arithmetic == numpy int64 wrap + cast
        uint8_t v = 1;
        for (int32_t c = 0; c < weight; ++c) {
            const int64_t w = reduced[i + positions[c]];
            v &= (uint8_t)(w >= 0 && w < base);
            key = key * (uint64_t)base + (uint64_t)(w < base ? w : 0);
        }
        keys[i] = key;
        valid[i] = v;
    }
}

// Hauser per-position composition bias, int8 (native twin of
// stats/cbs.py hauser_correction; reference hauser_correction.cpp:53-106).
// Sliding 32-letter count window + one 32-term dot per position — the
// Python path builds a (20, L) prefix matrix, 20x the work.  Integer
// window sums and a single double division keep it bit-exact.
extern "C" void hauser_bias_i8(
    const int8_t* letters, int64_t L, const int32_t* matrix32,
    const double* background_scores, int64_t window, int8_t* out) {
    if (L == 0)
        return;
    int64_t wh = window / 2;
    if (wh > L - 1)
        wh = L - 1;
    const int64_t a = wh < L - wh - 1 ? wh : L - wh - 1;
    const int64_t m0 = a + 1;
    const int64_t tmax = L - wh - 1;
    int64_t counts[32] = {0};
    int64_t h_cur = 0, t_cur = 0;
    for (int64_t m = 0; m < L; ++m) {
        int64_t h = m + wh + 1;
        if (h > L)
            h = L;
        while (h_cur < h)
            ++counts[letters[h_cur++] & 31];
        int64_t t = 0;
        if (m >= m0) {
            t = m - m0 + 1;
            if (t > tmax)
                t = tmax;
        }
        while (t_cur < t)
            --counts[letters[t_cur++] & 31];
        const int32_t r = letters[m] & 31;
        if (r >= 20) {
            out[m] = 0;
            continue;
        }
        const int32_t* mrow = matrix32 + r * 32;
        int64_t win_sum = 0;
        for (int c = 0; c < 32; ++c)
            win_sum += counts[c] * (int64_t)mrow[c];
        const int64_t n_eff = h - t;
        int64_t denom = n_eff - 1;
        if (denom < 1)
            denom = 1;
        const double v = background_scores[r]
                         - (double)(win_sum - mrow[r]) / (double)denom;
        out[m] = (int8_t)(v < 0.0 ? v - 0.5 : v + 0.5);
    }
}

// One-pass sort-merge join of two key-sorted (key, pos) arrays
// (native twin of search/stages.seed_join_sorted's numpy merge:
// run-boundary scan + searchsorted + boolean takes become a single
// two-pointer walk with memcpy'd runs).  Returns the group count;
// out_qstart[g]/out_sstart[g] carry the emitted position counts.
extern "C" int64_t sorted_join_merge(
    const uint64_t* qk, const int64_t* qp, int64_t nq,
    const uint64_t* sk, const int64_t* sp, int64_t ns,
    uint64_t* out_keys, int64_t* out_qstart, int64_t* out_sstart,
    int64_t* out_qpos, int64_t* out_spos) {
    int64_t i = 0, j = 0, g = 0, oq = 0, os = 0;
    out_qstart[0] = 0;
    out_sstart[0] = 0;
    while (i < nq && j < ns) {
        const uint64_t a = qk[i];
        const uint64_t b = sk[j];
        if (a < b) {
            do {
                ++i;
            } while (i < nq && qk[i] == a);
        } else if (b < a) {
            do {
                ++j;
            } while (j < ns && sk[j] == b);
        } else {
            int64_t i1 = i;
            do {
                ++i1;
            } while (i1 < nq && qk[i1] == a);
            int64_t j1 = j;
            do {
                ++j1;
            } while (j1 < ns && sk[j1] == a);
            out_keys[g] = a;
            std::memcpy(out_qpos + oq, qp + i,
                        (size_t)(i1 - i) * sizeof(int64_t));
            std::memcpy(out_spos + os, sp + j,
                        (size_t)(j1 - j) * sizeof(int64_t));
            oq += i1 - i;
            os += j1 - j;
            ++g;
            out_qstart[g] = oq;
            out_sstart[g] = os;
            i = i1;
            j = j1;
        }
    }
    return g;
}

// 16-bit-digit LSD radix (3 passes for 48-bit seed keys instead of 5
// 8-bit passes; the 64K count table is L2-resident)
extern "C" void sort_kv_u64_d16(
    uint64_t* keys, int64_t* vals, int64_t n,
    uint64_t* tmp_k, int64_t* tmp_v, int32_t key_bits) {
    static thread_local std::vector<int64_t> count;
    count.assign(65536, 0);
    const int ndig = (key_bits + 15) / 16;
    uint64_t* ka = keys;
    int64_t* va = vals;
    uint64_t* kb = tmp_k;
    int64_t* vb = tmp_v;
    for (int d = 0; d < ndig; ++d) {
        const int shift = d * 16;
        if (d)
            std::fill(count.begin(), count.end(), 0);
        for (int64_t i = 0; i < n; ++i)
            ++count[(ka[i] >> shift) & 0xFFFF];
        int64_t sum = 0;
        for (int i = 0; i < 65536; ++i) {
            const int64_t c = count[i];
            count[i] = sum;
            sum += c;
        }
        for (int64_t i = 0; i < n; ++i) {
            const int64_t dd = count[(ka[i] >> shift) & 0xFFFF]++;
            kb[dd] = ka[i];
            vb[dd] = va[i];
        }
        uint64_t* tk = ka;
        ka = kb;
        kb = tk;
        int64_t* tv = va;
        va = vb;
        vb = tv;
    }
    if (ka != keys) {
        std::memcpy(keys, ka, (size_t)n * sizeof(uint64_t));
        std::memcpy(vals, va, (size_t)n * sizeof(int64_t));
    }
}

// Query-indexed seed filter (reference double_indexed.cpp:267-294
// HashedSeedSet role): keep target seeds whose key occurs in the sorted
// query key set — one open-addressing probe per target seed instead of
// sorting the whole DB side.  Keys are < 2^63 (seedp-masked), so ~0 is a
// free EMPTY sentinel.  Returns the number of kept seeds.
extern "C" int64_t filter_keys(const uint64_t* t_keys, int64_t n,
                               const uint64_t* q_keys_sorted, int64_t nq,
                               uint8_t* keep) {
    uint64_t cap = 16;
    while (cap < (uint64_t)nq * 2) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<uint64_t> table(cap, ~0ull);
    auto hash = [](uint64_t k) {
        k *= 0x9e3779b97f4a7c15ull;
        k ^= k >> 29;
        k *= 0xbf58476d1ce4e5b9ull;
        k ^= k >> 32;
        return k;
    };
    for (int64_t i = 0; i < nq; ++i) {
        const uint64_t k = q_keys_sorted[i];
        if (i && k == q_keys_sorted[i - 1])
            continue;  // input sorted: duplicates adjacent
        uint64_t h = hash(k) & mask;
        while (table[h] != ~0ull)
            h = (h + 1) & mask;
        table[h] = k;
    }
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t k = t_keys[i];
        uint64_t h = hash(k) & mask;
        uint8_t kp = 0;
        for (; table[h] != ~0ull; h = (h + 1) & mask)
            if (table[h] == k) {
                kp = 1;
                break;
            }
        keep[i] = kp;
        cnt += kp;
    }
    return cnt;
}

// Bulk Block letters fill: memcpy every sequence's letter run from a
// shared base buffer into a Block letters layout (the read_dmnd
// strip_mask load; plays the role of the reference's block load loop,
// sequence_file.cpp:113-150).
extern "C" void block_fill(const int8_t* base, const int64_t* src,
                           const int64_t* dst, const int64_t* lens,
                           int64_t n, int8_t* letters) {
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(letters + dst[i], base + src[i], (size_t)lens[i]);
}

// Block-wide Hauser bias: hauser_bias_i8 for every sequence of a block
// in one call (the per-query calls of the extension driver collapse to
// one; reference hauser_correction.cpp:53-106 runs per target thread).
extern "C" void hauser_bias_block(
    const int8_t* letters, const int64_t* starts, const int64_t* lens,
    int64_t n_seqs, const int32_t* matrix32,
    const double* background_scores, int64_t window, int8_t* out) {
    for (int64_t s = 0; s < n_seqs; ++s)
        hauser_bias_i8(letters + starts[s], lens[s], matrix32,
                       background_scores, window, out + starts[s]);
}

// Fused query-indexed DB enumeration (role: the streaming probe of the
// reference's HashedSeedSet route, double_indexed.cpp:267-294 +
// search/stage0): compute each DB position's spaced seed key and probe
// the query key hash set immediately — only matches are written, so no
// full-block key/pos arrays ever exist and the count pass disappears.
// Survivor set and order are identical to enumerate_seeds_block
// followed by filter_keys (same key math, same probe, position order).
extern "C" int64_t enumerate_seeds_filtered(
    const int8_t* reduced, const int64_t* starts, const int64_t* lengths,
    int64_t nseqs, const int64_t* positions, int32_t weight,
    int64_t shape_length, int64_t base, int64_t min_len,
    const uint64_t* q_keys_sorted, int64_t nq,
    uint64_t* out_keys, int64_t* out_pos) {
    if (nq <= 0)
        return 0;
    uint64_t cap = 16;
    while (cap < (uint64_t)nq * 2) cap <<= 1;
    const uint64_t hmask = cap - 1;
    std::vector<uint64_t> table(cap, ~0ull);
    auto hash = [](uint64_t k) {
        k *= 0x9e3779b97f4a7c15ull;
        k ^= k >> 29;
        k *= 0xbf58476d1ce4e5b9ull;
        k ^= k >> 32;
        return k;
    };
    for (int64_t i = 0; i < nq; ++i) {
        const uint64_t k = q_keys_sorted[i];
        if (i && k == q_keys_sorted[i - 1])
            continue;
        uint64_t h = hash(k) & hmask;
        while (table[h] != ~0ull)
            h = (h + 1) & hmask;
        table[h] = k;
    }
    auto probe = [&](uint64_t k) -> bool {
        uint64_t h = hash(k) & hmask;
        for (; table[h] != ~0ull; h = (h + 1) & hmask)
            if (table[h] == k)
                return true;
        return false;
    };

    int64_t m = 0;
#if defined(__AVX512F__) && defined(__AVX512DQ__)
    const __m512i basev = _mm512_set1_epi64(base);
    const __m512i zerov = _mm512_setzero_si512();
    for (int64_t s = 0; s < nseqs; ++s) {
        const int64_t L = lengths[s];
        if (L < shape_length || (min_len && L < min_len))
            continue;
        const int64_t st = starts[s];
        const int64_t end = st + L - shape_length;
        int64_t p = st;
        alignas(64) uint64_t lane_keys[8];
        for (; p + 7 <= end; p += 8) {
            __m512i key = zerov;
            __mmask8 valid = 0xff;
            for (int32_t c = 0; c < weight; ++c) {
                const __m128i raw = _mm_loadl_epi64(
                    (const __m128i*)(reduced + p + positions[c]));
                const __m512i w = _mm512_cvtepi8_epi64(raw);
                valid &= _mm512_cmpge_epi64_mask(w, zerov)
                         & _mm512_cmplt_epi64_mask(w, basev);
                key = _mm512_add_epi64(_mm512_mullo_epi64(key, basev), w);
            }
            if (!valid)
                continue;
            _mm512_store_si512((__m512i*)lane_keys, key);
            for (int32_t j = 0; j < 8; ++j) {
                if ((valid >> j) & 1) {
                    const uint64_t k = lane_keys[j];
                    if (probe(k)) {
                        out_keys[m] = k;
                        out_pos[m] = p + j;
                        ++m;
                    }
                }
            }
        }
        for (; p <= end; ++p) {
            uint64_t key = 0;
            bool v = true;
            for (int32_t c = 0; c < weight; ++c) {
                const int64_t w = reduced[p + positions[c]];
                v &= (w >= 0 && w < base);
                key = key * (uint64_t)base + (uint64_t)(w >= 0 && w < base
                                                            ? w : 0);
            }
            if (v && probe(key)) {
                out_keys[m] = key;
                out_pos[m] = p;
                ++m;
            }
        }
    }
#else
    for (int64_t s = 0; s < nseqs; ++s) {
        const int64_t L = lengths[s];
        if (L < shape_length || (min_len && L < min_len))
            continue;
        const int64_t st = starts[s];
        const int64_t end = st + L - shape_length;
        for (int64_t p = st; p <= end; ++p) {
            uint64_t key = 0;
            bool v = true;
            for (int32_t c = 0; c < weight; ++c) {
                const int64_t w = reduced[p + positions[c]];
                v &= (w >= 0 && w < base);
                key = key * (uint64_t)base + (uint64_t)(w < base ? w : 0);
            }
            if (v && probe(key)) {
                out_keys[m] = key;
                out_pos[m] = p;
                ++m;
            }
        }
    }
#endif
    return m;
}
