// Banded Smith-Waterman score DP (native twin of
// diamond_tpu/ops/banded_swipe.py banded_swipe_np / banded_swipe_batch_np;
// reference semantics from src/dp/swipe/banded_swipe.h:200-360,
// cell_update.h:102-141).
//
// Computes the column DP exactly like the numpy oracle (int32 cells —
// every quantity is bounded well inside int32: scores are matrix+bias
// sums, the NEG sentinel is -10^9, and the gap chain subtracts at most
// band*ge — so int32 results equal the oracle's int64), with the lazy
// vertical-gap chain, last-row-attaining column max, and first column
// strictly improving.  Optionally emits the four trace-mask planes as
// BIT planes ([tlen, ceil(band/32)] uint32 words, bit r&31 of word
// r>>5): the striped engines' compare masks store directly (8x less
// traffic than byte planes) and walk_one reads bits.  The Python
// oracle's byte planes are expanded from these in banded_swipe_many.
// Row loops are segmented on [r_lo, r_hi) so the hot loops are
// branch-free and auto-vectorize.  On TPU the same DP runs as the
// Pallas kernel (ops/swipe_pallas.py); this is the host path.

#include <cstdint>
#include <cstring>
#include <vector>

// striped int16 DP fill (swipe_lanes.cc): emits the same bit planes
// ~10x faster; returns 0 when the scalar engine must run instead
extern "C" int dtpu_striped16_tb_fill(
    const int8_t* q, int64_t qlen, const int32_t* bias, const int8_t* t,
    int64_t tlen, int64_t d0, int64_t band, const int32_t* matrix32,
    int64_t go, int64_t ge, int64_t* out3, uint32_t* gv, uint32_t* gh,
    uint32_t* ov, uint32_t* oh);
extern "C" void dtpu_striped16_cache_reset();

namespace {
constexpr int32_t NEGB = -1000000000;  // matches the oracle's -(10**9)

inline int32_t max32(int32_t a, int32_t b) { return a > b ? a : b; }

void swipe_one(const int8_t* q_letters, int64_t qlen, const int32_t* bias,
               const int8_t* t_letters, int64_t tlen, int64_t d_begin,
               int64_t band, const int32_t* matrix32, int32_t go, int32_t ge,
               int64_t* out3, uint32_t* gapv, uint32_t* gaph, uint32_t* openv,
               uint32_t* openh, std::vector<int32_t>& Hbuf,
               std::vector<int32_t>& Ebuf, std::vector<int32_t>& c0buf,
               std::vector<int32_t>& Fbuf) {
    Hbuf.assign(band, 0);
    Ebuf.assign(band + 1, 0);
    c0buf.resize(band);
    Fbuf.resize(band);
    int32_t* H = Hbuf.data();
    int32_t* E = Ebuf.data();
    int32_t* cur = c0buf.data();
    int32_t* F = Fbuf.data();

    int64_t best = 0, max_col = 0, max_row_band = 0;

    // skip dead leading/trailing columns (state is zero there and they
    // can never raise the max); same clamp as the striped engines
    int64_t j_begin = -d_begin - band + 1;
    if (j_begin < 0)
        j_begin = 0;
    int64_t j_end = qlen - d_begin;
    if (j_end > tlen)
        j_end = tlen;
    for (int64_t j = j_begin; j < j_end; ++j) {
        const int64_t i_lo = j + d_begin;
        const int64_t r_lo = i_lo < 0 ? -i_lo : 0;
        const int64_t r_hi = band < qlen - i_lo ? band : qlen - i_lo;
        if (r_lo >= r_hi) {
            std::memset(H, 0, band * sizeof(int32_t));
            std::memset(E, 0, band * sizeof(int32_t));
            continue;
        }
        const int64_t tl = t_letters[j] & 31;
        const int32_t* mcol = matrix32;  // row (q letter) * 32 + tl

        // cur0 = max(H + score, E, 0) on [r_lo, r_hi), 0 outside
        for (int64_t r = 0; r < r_lo; ++r)
            cur[r] = 0;
        const int8_t* qrow = q_letters + i_lo;
        if (bias) {
            const int32_t* brow = bias + i_lo;
            for (int64_t r = r_lo; r < r_hi; ++r) {
                const int32_t sc = mcol[(qrow[r] & 31) * 32 + tl] + brow[r];
                int32_t v = H[r] + sc;
                v = max32(v, E[r]);
                cur[r] = max32(v, 0);
            }
        } else {
            for (int64_t r = r_lo; r < r_hi; ++r) {
                const int32_t sc = mcol[(qrow[r] & 31) * 32 + tl];
                int32_t v = H[r] + sc;
                v = max32(v, E[r]);
                cur[r] = max32(v, 0);
            }
        }
        for (int64_t r = r_hi; r < band; ++r)
            cur[r] = 0;

        // lazy vertical-gap chain: g[r] = cur0[r] - go + r*ge, running max;
        // F[r] = max(gm[r-1] - (r-1)*ge, 0), zeroed through row r_lo
        {
            int32_t run = NEGB;
            F[0] = 0;
            for (int64_t r = 1; r < band; ++r) {
                const int32_t g = cur[r - 1] - go + (int32_t)(r - 1) * ge;
                run = max32(run, g);
                F[r] = max32(run - (int32_t)(r - 1) * ge, 0);
            }
            for (int64_t r = 1; r <= r_lo && r < band; ++r)
                F[r] = 0;
        }
        // cur = max(cur0, F) on valid rows; column best = LAST row
        // attaining the max (VectorRowCounter); F keeps its value on
        // out-of-range rows (the numpy twin does not zero it there, and
        // the gapv mask compares against it)
        int32_t cb = 0;
        int64_t cbr = r_lo;
        for (int64_t r = r_lo; r < r_hi; ++r) {
            const int32_t v = max32(cur[r], F[r]);
            cur[r] = v;
            if (v > 0 && v >= cb) {
                cb = v;
                cbr = r;
            }
        }
        if (cb > best) {
            best = cb;
            max_col = j;
            max_row_band = cbr;
        }
        // E update + trace masks (gaph compares against the OLD E)
        if (gapv) {
            const int64_t nchw = (band + 31) / 32;
            const int64_t base = j * nchw;
            uint32_t wv = 0, wh = 0, wov = 0, woh = 0;
            for (int64_t r = 0; r < band; ++r) {
                const int32_t cu = cur[r];
                const int32_t opn = max32(cu - go, 0);
                const int32_t e_next = max32(E[r] - ge, 0);
                const uint32_t bit = (uint32_t)(r & 31);
                wv |= (uint32_t)(cu == F[r]) << bit;
                wh |= (uint32_t)(cu == E[r]) << bit;
                wov |= (uint32_t)(opn >= max32(F[r] - ge, 0)) << bit;
                woh |= (uint32_t)(opn >= e_next) << bit;
                int32_t en = max32(e_next, opn);
                if (r < r_lo || r >= r_hi)
                    en = 0;
                F[r] = en;  // F reused as Enew scratch
                if (bit == 31 || r + 1 == band) {
                    const int64_t w = base + (r >> 5);
                    gapv[w] = wv;
                    gaph[w] = wh;
                    openv[w] = wov;
                    openh[w] = woh;
                    wv = wh = wov = woh = 0;
                }
            }
        } else {
            for (int64_t r = 0; r < r_lo; ++r)
                F[r] = 0;
            for (int64_t r = r_lo; r < r_hi; ++r) {
                const int32_t opn = max32(cur[r] - go, 0);
                const int32_t e_next = max32(E[r] - ge, 0);
                F[r] = max32(e_next, opn);
            }
            for (int64_t r = r_hi; r < band; ++r)
                F[r] = 0;
        }
        std::memcpy(H, cur, band * sizeof(int32_t));
        std::memcpy(E, F + 1, (band - 1) * sizeof(int32_t));
        E[band - 1] = 0;
    }
    out3[0] = best;
    out3[1] = max_col;
    out3[2] = max_row_band;
}
// Trace-mask walk (native twin of ops/banded_swipe.py _traceback): from
// the best cell, follow vertical gap > horizontal gap > diagonal at
// equal scores; a gap run ends at the first set open bit.  Ops are
// emitted in walk order (reversed alignment); op codes 0=M, 1=S(letter),
// 2=D(letter), 3=I(run length).  Returns 1 on success, 0 when the summed
// score misses the end score (rare shared-band spill ties; caller falls
// back to the per-job oracle).
inline int plane_bit(const uint32_t* plane, int64_t nchw, int64_t j,
                     int64_t r) {
    return (plane[j * nchw + (r >> 5)] >> (r & 31)) & 1u;
}

int walk_one(const int8_t* query, const int32_t* bias, const int8_t* target,
             int64_t d_begin, int64_t band, const int32_t* matrix32,
             int32_t go, int32_t ge, int64_t best, int64_t max_col,
             int64_t max_row, const uint32_t* gapv, const uint32_t* gaph,
             const uint32_t* openv, const uint32_t* openh,
             int8_t* op_codes, int32_t* op_payload, int64_t* stats) {
    const int64_t nchw = (band + 31) / 32;
    int64_t i = max_row, j = max_col;
    int64_t score = 0;
    int64_t n_ops = 0;
    int64_t identities = 0, mismatches = 0, positives = 0;
    int64_t gap_openings = 0, gaps = 0, length = 0;
    const int64_t q_end = i + 1, s_end = j + 1;
    while (i >= 0 && j >= 0 && score < best) {
        const int64_t r = i - j - d_begin;
        if (r < 0 || r >= band)
            return 0;
        if (plane_bit(gapv, nchw, j, r)) {
            int64_t l = 0;
            for (;;) {
                ++l;
                --i;
                const int64_t rr = i - j - d_begin;
                if (rr < 0 || (rr < band && plane_bit(openv, nchw, j, rr))
                    || i <= 0)
                    break;
            }
            op_codes[n_ops] = 3;
            op_payload[n_ops++] = (int32_t)l;
            ++gap_openings;
            gaps += l;
            length += l;
            score -= go + (l - 1) * ge;
        } else if (plane_bit(gaph, nchw, j, r)) {
            int64_t l = 0;
            for (;;) {
                ++l;
                --j;
                const int64_t rr = i - j - d_begin;
                if (rr >= band || (rr >= 0 && plane_bit(openh, nchw, j, rr))
                    || j <= 0)
                    break;
            }
            for (int64_t k = 0; k < l; ++k) {
                op_codes[n_ops] = 2;
                op_payload[n_ops++] = (int32_t)(target[j + l - k] & 31);
            }
            ++gap_openings;
            gaps += l;
            length += l;
            score -= go + (l - 1) * ge;
        } else {
            const int ql = query[i] & 31;
            const int tl = target[j] & 31;
            const int32_t m = matrix32[ql * 32 + tl];
            score += m + (bias ? bias[i] : 0);
            if (query[i] == target[j]) {
                op_codes[n_ops] = 0;
                op_payload[n_ops++] = 1;
                ++identities;
                ++positives;
            } else {
                op_codes[n_ops] = 1;
                op_payload[n_ops++] = tl;
                ++mismatches;
                if (m > 0)
                    ++positives;
            }
            ++length;
            --i;
            --j;
        }
    }
    if (score != best)
        return 0;
    stats[0] = i + 1;       // q_begin
    stats[1] = q_end;
    stats[2] = j + 1;       // s_begin
    stats[3] = s_end;
    stats[4] = identities;
    stats[5] = mismatches;
    stats[6] = positives;
    stats[7] = gap_openings;
    stats[8] = gaps;
    stats[9] = length;
    stats[10] = n_ops;
    return 1;
}
}  // namespace

// Batched DP + in-place traceback walk: per job emits
// out[k*3..] = (score, max_col_true, max_row_true), stats[k*12..] (see
// walk_one; stats[11] = ok flag), and ops at op_off[k] (walk order,
// caller reverses).  Mask planes live only in scratch — nothing large
// crosses the boundary.
extern "C" void banded_swipe_tb_many(
    const int8_t* q_letters, int64_t qlen, const int32_t* bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* d_begin, const int64_t* band, int64_t njobs,
    const int32_t* matrix32, int64_t go, int64_t ge, int64_t* out,
    const int64_t* op_off, int8_t* op_codes, int32_t* op_payload,
    int64_t* stats) {
    std::vector<int32_t> Hbuf, Ebuf, c0buf, Fbuf;
    std::vector<uint32_t> gv, gh, ov, oh;
    dtpu_striped16_cache_reset();
    for (int64_t k = 0; k < njobs; ++k) {
        const int64_t tlen = t_len[k];
        const int64_t b = band[k];
        const size_t words = (size_t)(tlen * ((b + 31) / 32));
        if (gv.size() < words) {
            gv.resize(words);
            gh.resize(words);
            ov.resize(words);
            oh.resize(words);
        }
        int64_t o3[3];
        if (!dtpu_striped16_tb_fill(q_letters, qlen, bias, t_cat + t_off[k],
                                    tlen, d_begin[k], b, matrix32, go, ge,
                                    o3, gv.data(), gh.data(), ov.data(),
                                    oh.data()))
            swipe_one(q_letters, qlen, bias, t_cat + t_off[k], tlen,
                      d_begin[k], b, matrix32, (int32_t)go, (int32_t)ge, o3,
                      gv.data(), gh.data(), ov.data(), oh.data(), Hbuf,
                      Ebuf, c0buf, Fbuf);
        out[3 * k] = o3[0];
        out[3 * k + 1] = o3[1];
        out[3 * k + 2] = o3[1] + d_begin[k] + o3[2];
        int64_t* st = stats + 12 * k;
        if (o3[0] <= 0) {
            st[11] = 1;
            st[10] = 0;
            for (int z = 0; z < 10; ++z)
                st[z] = 0;
            continue;
        }
        st[11] = walk_one(q_letters, bias, t_cat + t_off[k], d_begin[k], b,
                          matrix32, (int32_t)go, (int32_t)ge, o3[0], o3[1],
                          out[3 * k + 2], gv.data(), gh.data(), ov.data(),
                          oh.data(), op_codes + op_off[k],
                          op_payload + op_off[k], st);
    }
}

// Multi-query batched score-only DP (the wave driver's cross-query host
// batch; one call per wave round).
extern "C" void banded_swipe_score_multi(
    const int8_t* q_base, const int32_t* bias_base,
    const int64_t* q_off, const int64_t* q_len, const uint8_t* use_bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* d_begin, const int64_t* band, int64_t njobs,
    const int32_t* matrix32, int64_t go, int64_t ge, int64_t* out) {
    std::vector<int32_t> Hbuf, Ebuf, c0buf, Fbuf;
    for (int64_t k = 0; k < njobs; ++k) {
        const int8_t* q = q_base + q_off[k];
        const int32_t* bias =
            (use_bias[k] && bias_base) ? bias_base + q_off[k] : nullptr;
        int64_t o3[3];
        swipe_one(q, q_len[k], bias, t_cat + t_off[k], t_len[k], d_begin[k],
                  band[k], matrix32, (int32_t)go, (int32_t)ge, o3, nullptr,
                  nullptr, nullptr, nullptr, Hbuf, Ebuf, c0buf, Fbuf);
        out[3 * k] = o3[0];
        out[3 * k + 1] = o3[1];
        out[3 * k + 2] = o3[1] + d_begin[k] + o3[2];
    }
}

// Multi-query batched DP + traceback walk: like banded_swipe_tb_many but
// each job k addresses its own query at q_base + q_off[k] (the wave
// driver's cross-query host batch; one call per wave round instead of
// one per query).  bias_base is aligned with q_base; use_bias[k] selects
// per job.
extern "C" void dtpu_striped16_tb_fill_quad(
    const int8_t* q_base, const int32_t* bias_base,
    const int64_t* q_off, const int64_t* q_len, const uint8_t* use_bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* d_begin, const int64_t* band, int64_t n,
    const int32_t* matrix32, int64_t go, int64_t ge, int64_t* out3,
    uint32_t* const* gv, uint32_t* const* gh, uint32_t* const* ov,
    uint32_t* const* oh, uint8_t* ok);

extern "C" void banded_swipe_tb_multi(
    const int8_t* q_base, const int32_t* bias_base,
    const int64_t* q_off, const int64_t* q_len, const uint8_t* use_bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* d_begin, const int64_t* band, int64_t njobs,
    const int32_t* matrix32, int64_t go, int64_t ge, int64_t* out,
    const int64_t* op_off, int8_t* op_codes, int32_t* op_payload,
    int64_t* stats) {
    std::vector<int32_t> Hbuf, Ebuf, c0buf, Fbuf;
    std::vector<uint32_t> planes[4][4];  // [slot][gv,gh,ov,oh]
    dtpu_striped16_cache_reset();
    for (int64_t k0 = 0; k0 < njobs; k0 += 2) {
        const int64_t n4 = njobs - k0 < 2 ? njobs - k0 : 2;
        uint32_t* pgv[4];
        uint32_t* pgh[4];
        uint32_t* pov[4];
        uint32_t* poh[4];
        for (int64_t i = 0; i < n4; ++i) {
            const int64_t k = k0 + i;
            const size_t words =
                (size_t)(t_len[k] * ((band[k] + 31) / 32));
            for (int p = 0; p < 4; ++p)
                if (planes[i][p].size() < words)
                    planes[i][p].resize(words);
            pgv[i] = planes[i][0].data();
            pgh[i] = planes[i][1].data();
            pov[i] = planes[i][2].data();
            poh[i] = planes[i][3].data();
        }
        uint8_t ok4[4] = {0, 0, 0, 0};
        int64_t o12[12];
        dtpu_striped16_tb_fill_quad(
            q_base, bias_base, q_off + k0, q_len + k0, use_bias + k0,
            t_cat, t_off + k0, t_len + k0, d_begin + k0, band + k0, n4,
            matrix32, go, ge, o12, pgv, pgh, pov, poh, ok4);
        for (int64_t i = 0; i < n4; ++i) {
            const int64_t k = k0 + i;
            const int8_t* q = q_base + q_off[k];
            const int32_t* bias =
                (use_bias[k] && bias_base) ? bias_base + q_off[k] : nullptr;
            int64_t o3[3];
            if (ok4[i]) {
                o3[0] = o12[3 * i];
                o3[1] = o12[3 * i + 1];
                o3[2] = o12[3 * i + 2];
            } else if (!dtpu_striped16_tb_fill(
                           q, q_len[k], bias, t_cat + t_off[k], t_len[k],
                           d_begin[k], band[k], matrix32, go, ge, o3,
                           pgv[i], pgh[i], pov[i], poh[i])) {
                swipe_one(q, q_len[k], bias, t_cat + t_off[k], t_len[k],
                          d_begin[k], band[k], matrix32, (int32_t)go,
                          (int32_t)ge, o3, pgv[i], pgh[i], pov[i], poh[i],
                          Hbuf, Ebuf, c0buf, Fbuf);
            }
            out[3 * k] = o3[0];
            out[3 * k + 1] = o3[1];
            out[3 * k + 2] = o3[1] + d_begin[k] + o3[2];
            int64_t* st = stats + 12 * k;
            if (o3[0] <= 0) {
                st[11] = 1;
                st[10] = 0;
                for (int z = 0; z < 10; ++z)
                    st[z] = 0;
                continue;
            }
            st[11] = walk_one(q, bias, t_cat + t_off[k], d_begin[k],
                              band[k], matrix32, (int32_t)go, (int32_t)ge,
                              o3[0], o3[1], out[3 * k + 2], pgv[i], pgh[i],
                              pov[i], poh[i], op_codes + op_off[k],
                              op_payload + op_off[k], st);
        }
    }
}

// Batched entry: njobs jobs over one query.  targets are concatenated in
// t_cat with per-job offsets/lengths; per-job band geometry in d_begin/band.
// out: [njobs, 3] (score, max_col, max_row_band).  When mask_off is
// non-null, the four mask planes for job k are written at mask_off[k]
// within the gapv/gaph/openv/openh buffers ([tlen_k, band_k] each).
extern "C" void banded_swipe_many(
    const int8_t* q_letters, int64_t qlen, const int32_t* bias,
    const int8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* d_begin, const int64_t* band, int64_t njobs,
    const int32_t* matrix32, int64_t go, int64_t ge, int64_t* out,
    const int64_t* mask_off, uint8_t* gapv, uint8_t* gaph, uint8_t* openv,
    uint8_t* openh) {
    std::vector<int32_t> Hbuf, Ebuf, c0buf, Fbuf;
    // swipe_one emits bit planes; this entry serves the Python oracle,
    // which consumes [tlen, band] byte planes — expand per job (the
    // oracle path only runs adjusted-matrix and fallback jobs)
    std::vector<uint32_t> wv, wh, wo, wp;
    for (int64_t k = 0; k < njobs; ++k) {
        const int64_t tlen = t_len[k], b = band[k];
        uint32_t *gv = nullptr, *gh = nullptr, *ov = nullptr, *oh = nullptr;
        const int64_t nchw = (b + 31) / 32;
        if (mask_off) {
            const size_t words = (size_t)(tlen * nchw);
            wv.assign(words, 0);
            wh.assign(words, 0);
            wo.assign(words, 0);
            wp.assign(words, 0);
            gv = wv.data();
            gh = wh.data();
            ov = wo.data();
            oh = wp.data();
        }
        swipe_one(q_letters, qlen, bias, t_cat + t_off[k], tlen,
                  d_begin[k], b, matrix32, (int32_t)go, (int32_t)ge,
                  out + 3 * k, gv, gh, ov, oh, Hbuf, Ebuf, c0buf, Fbuf);
        if (mask_off) {
            const int64_t off = mask_off[k];
            for (int64_t j = 0; j < tlen; ++j)
                for (int64_t r = 0; r < b; ++r) {
                    const int64_t w = j * nchw + (r >> 5);
                    const uint32_t bit = (uint32_t)(r & 31);
                    gapv[off + j * b + r] = (wv[w] >> bit) & 1u;
                    gaph[off + j * b + r] = (wh[w] >> bit) & 1u;
                    openv[off + j * b + r] = (wo[w] >> bit) & 1u;
                    openh[off + j * b + r] = (wp[w] >> bit) & 1u;
                }
        }
    }
}
