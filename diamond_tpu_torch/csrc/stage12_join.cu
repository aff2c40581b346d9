// The whole fused stage-1/2 seeding pass over a seed join on the card: the
// Hopper kernels behind ops/stage12_device.stage12_join.
//
// Replaces diamond_tpu/ops/stage12_jax.py:35-78 (_stage12_kernel, jit/XLA
// code on the TPU, no Pallas) together with the host steps around it in
// diamond_tpu/search/pipeline.py:699-738 (the pair expansion, the self-hit
// test, the clip and the left-most filter).  Same function as the fused host
// pass, native/src/leftmost.cc stage12_pipeline: for every pair of a seed
// group (query occurrence qp, target occurrence sp), in the order group,
// query occurrence, target occurrence,
//   stage 1   ident = #{o in [-16, 32) : (q[qp+o] & 31) == (s[sp+o] & 31)}
//             >= hamming_id;
//   self-hit  with self_search, the target's sequence (s_idx[sp]) is not
//             the query's (q_idx[qp]);
//   left-most left_most_one of leftmost.cc (the seed is the left-most hit of
//             its diagonal among the shapes already searched), with the
//             query window clipped at 48;
//   stage 2   best = the uint8-saturating Kadane over [-wl, wr), the query's
//             delimiter clip at its window win[qidx], > cut[qidx];
// a pair that passes all four is a row (qidx, sp, qp - q_starts[qidx],
// min(best, 255)).
//
// What bounds it on the card: integer operations, and on this data the
// latency of the loads behind them.  Every pair runs stage 1; nearly every
// pair of a self-search passes it (its own copy) and reaches the left-most
// filter, so that filter is most of the work; stage 2 runs for the few
// pairs left.  What the design does:
//   - the host hands over the join's entries (one per query occurrence of a
//     kept group: qp, the group's first target index, the prefix of pair
//     counts), built on the card from the join's CSR by the wrapper; a CTA
//     takes 256 consecutive pairs, one a thread, so groups of one pair and
//     groups of thousands fill the lanes alike;
//   - a CTA finds its entries once (one binary search, then the prefix of
//     its <= 256 entries in shared memory) and computes each entry's query
//     side once, not once a pair, into shared memory: its sequence,
//     offset, cutoff and window, both delimiter clips (at the window and at
//     48), its 48 fingerprint letters as 12 masked words, and the left-most
//     filter's query side (leftmost.cc lm_query_init: the window geometry,
//     the seed-mask bits, the reduced letters);
//   - letters come in with 16-byte loads, realigned into words by funnel
//     shifts, and are compared four at a time (__vcmpeq4): stage 1 is 12
//     packed compares and __popc; a clip or a window's delimiters are one
//     52-bit mask (a multiply gathers each word's four byte flags); the
//     left-most match mask is the target's reduced words against the
//     entry's, all without a loop that waits on a load;
//   - the left-most filter (64-bit masks, __ffsll, the part table) takes
//     leftmost.cc left_most_fast's path, and left_most_one's where a target
//     delimiter lies before the anchor; the Kadane runs only for the pairs
//     past it, the 32 x 32 matrix in shared memory, rows rotated as in
//     csrc/stage2.cu;
//   - the rows leave in the host pass's order without a sort: the first
//     kernel writes each pair's score byte (0: no row) and each CTA's count
//     (__syncthreads_count), the wrapper scans the counts, and the second
//     kernel writes each CTA's rows at its offset, ranked by a scan in
//     shared memory.
// The caller guarantees that every read lies inside the blocks: each seed
// position at least MARGIN (192) letters from either end of its block,
// windows of at most 128 letters, shapes of at most 32 positions, and both
// blocks 16-byte aligned (stage12_device checks it).  The kernels allocate
// nothing, do not synchronise, and launch on the caller's stream; the C
// entry points return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // pairs of a CTA, one a thread
constexpr int DELIM = 31;
constexpr int MASK_LETTER = 23;
constexpr int STOP_LETTER = 24;
constexpr uint32_t DELIM4 = 0x1F1F1F1Fu;
constexpr int MAX_MASKS = 64;   // patterns of a matcher
constexpr int MAX_WEIGHT = 32;  // shape positions
constexpr int LM_SPAN = 52;     // the left-most window (<= 49), 13 words
constexpr uint8_t NOT_AA = 0xFF;  // a reduced query letter that matches none

struct Params {
  const int8_t* q;         // query letters
  const int8_t* s;         // target letters
  const uint8_t* q_mask;   // query_seed_mask (nonzero: a masked seed)
  const int32_t* e_qp;     // entry -> query position
  const int32_t* e_sbeg;   // entry -> its group's first index into s_pos
  const int32_t* e_pstart; // [n_e + 1] first pair of each entry
  const int32_t* s_pos;
  const int32_t* q_idx;    // query position -> query index
  const int32_t* q_starts; // query index -> first position
  const int32_t* cut;      // query index -> stage-2 cutoff
  const int32_t* win;      // query index -> stage-2 window
  const int32_t* s_idx;    // target position -> target index (self_search)
  const int32_t* matrix;   // [32][32]
  const int8_t* red_map;   // [32] letter -> reduced letter
  const int32_t* shape_pos;
  const uint64_t* cur;     // current matcher's pattern masks
  const uint64_t* prev;    // previous matcher's pattern masks
  const int16_t* part_tbl; // target position -> seed partition, or null
  uint64_t shape_mask, seedp_mask;
  int n_e, n_pairs, red_size, weight, shape_len, cur_n, prev_n;
  int part_lo, part_hi, hamming_id;
  int first_shape, chunked, do_leftmost, self_search;
};

// the 4 * NW bytes [a, a + 4 * NW) as NW words, from NV aligned 16-byte
// loads of [a & ~15, (a & ~15) + 16 * NV), realigned by funnel shifts
template <int NW, int J, int NV>
__device__ __forceinline__ void pick(const uint32_t (&w)[4 * NV], int sh,
                                     uint32_t (&out)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    out[k] = __funnelshift_r(w[J + k], w[J + k + 1], sh);
}

template <int NW>
__device__ __forceinline__ void load_words(const void* a,
                                           uint32_t (&out)[NW]) {
  constexpr int NV = (NW + 7) / 4;  // J + NW + 1 <= 4 NV for every J
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a);
  const uint4* base = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  uint32_t w[4 * NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const uint4 v = __ldg(base + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  const int sh = 8 * int(addr & 3);
  switch ((addr >> 2) & 3) {
    case 0: pick<NW, 0, NV>(w, sh, out); break;
    case 1: pick<NW, 1, NV>(w, sh, out); break;
    case 2: pick<NW, 2, NV>(w, sh, out); break;
    default: pick<NW, 3, NV>(w, sh, out); break;
  }
}

// the 48 letters [a, a + 48) & 31 as 12 words (four 16-byte loads)
__device__ __forceinline__ void fingerprint(const int8_t* a,
                                            uint32_t (&out)[12]) {
  load_words<12>(a, out);
#pragma unroll
  for (int k = 0; k < 12; ++k) out[k] &= DELIM4;
}

// bit b of the result: byte b of m (0xFF or 0, from __vcmpeq4) is set
__device__ __forceinline__ uint32_t byte_bits(uint32_t m) {
  return ((((m >> 7) & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
}

// bit i of the result: byte i of the 13 words equals the packed byte v4
__device__ __forceinline__ uint64_t eq_bits(const uint32_t (&w)[13],
                                            uint32_t v4) {
  uint64_t r = 0;
#pragma unroll
  for (int k = 0; k < 13; ++k)
    r |= uint64_t(byte_bits(__vcmpeq4(w[k], v4))) << (4 * k);
  return r;
}

__device__ __forceinline__ int ident48(const uint32_t (&a)[12],
                                       const uint32_t (&b)[12]) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < 12; ++k) n += __popc(__vcmpeq4(a[k], b[k]));
  return n >> 3;
}

__device__ __forceinline__ uint32_t word_at(const int8_t* base, intptr_t i) {
  return __ldg(reinterpret_cast<const uint32_t*>(base) + i);
}

// the k in [0, w) of the first raw delimiter at p + k, else w (aligned
// 4-byte words, one after another; p's block is 4-byte aligned)
__device__ int clip_right_walk(const int8_t* p, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int8_t* base = reinterpret_cast<const int8_t*>(a & ~uintptr_t(3));
  const int lead = int(a & 3);
  for (int j = 0; 4 * j - lead < w; ++j) {
    uint32_t m = __vcmpeq4(word_at(base, j), DELIM4);
    if (j == 0) m &= 0xFFFFFFFFu << (8 * lead);
    if (m) {
      const int k = 4 * j + ((__ffs(m) - 1) >> 3) - lead;
      return k < w ? k : w;
    }
  }
  return w;
}

// the k in [0, w) of the first raw delimiter at p - 1 - k, else w
__device__ int clip_left_walk(const int8_t* p, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) - 1;  // the byte p - 1
  const int8_t* base = reinterpret_cast<const int8_t*>(a & ~uintptr_t(3));
  const int tail = int(a & 3);  // p - 1's byte in its word
  if (w <= 0) return 0;
  // word j holds k in [4j + tail - 3, 4j + tail]
  for (int j = 0; j == 0 || 4 * j + tail - 3 < w; ++j) {
    uint32_t m = __vcmpeq4(word_at(base, -j), DELIM4);
    if (j == 0 && tail < 3) m &= 0xFFFFFFFFu >> (8 * (3 - tail));
    if (m) {
      const int k = 4 * j + tail - ((31 - __clz(m)) >> 3);
      return k < w ? k : w;
    }
  }
  return w;
}

__device__ __forceinline__ int ctz64(uint64_t x) { return __ffsll(x) - 1; }

// clip_right_walk and clip_left_walk from 52 letters loaded at once, for
// windows of at most 52 (the search's 48); longer ones walk
__device__ int clip_right(const int8_t* p, int w) {
  if (w > 52) return clip_right_walk(p, w);
  uint32_t x[13];
  load_words<13>(p, x);
  const uint64_t d = eq_bits(x, DELIM4) & ((1ull << w) - 1);
  return d ? ctz64(d) : w;
}

__device__ int clip_left(const int8_t* p, int w) {
  if (w > 52) return clip_left_walk(p, w);
  uint32_t x[13];
  load_words<13>(p - 52, x);  // byte i is p - 52 + i, offset k = 51 - i
  const uint64_t d = eq_bits(x, DELIM4) & ~((1ull << (52 - w)) - 1);
  return d ? 51 - (63 - __clzll(d)) : w;
}

// PatternMatcher.hit, bit-parallel (leftmost.cc matcher_hit)
__device__ uint64_t matcher_hit(uint64_t h, const uint64_t* masks, int n) {
  uint64_t out = 0;
  for (int k = 0; k < n; ++k) {
    uint64_t bits = masks[k], m = ~0ull;
    while (bits) {
      m &= h >> ctz64(bits);
      bits &= bits - 1;
    }
    out |= m;
  }
  return out;
}

__device__ __forceinline__ bool is_aa(int l) {
  return l != MASK_LETTER && l != DELIM && l != STOP_LETTER;
}

// leftmost.cc verify_one: does any set bit of hit_bits verify?
__device__ bool verify_one(const Params& P, const int8_t* red_map,
                           const int32_t* shape_pos, int qs, int ss,
                           uint64_t hit_bits, uint64_t match_mask, bool left) {
  uint64_t m = hit_bits;
  while (m) {
    const int bit = ctz64(m);
    m &= m - 1;
    const int qpos = qs + bit, spos = ss + bit;
    if (P.chunked && ((match_mask >> bit) & P.shape_mask) == P.shape_mask) {
      long long part;
      if (P.part_tbl) {
        part = P.part_tbl[spos];
      } else {
        long long key = 0;
        bool good = true;
        for (int c = 0; c < P.weight; ++c) {
          const int l = P.s[spos + shape_pos[c]] & 31;
          if (l >= 20) {
            good = false;
            break;
          }
          key = key * P.red_size + red_map[l];
        }
        if (!good) continue;
        part = key & (long long)P.seedp_mask;
      }
      if (left ? !(part < P.part_hi) : !(part < P.part_lo)) continue;
    }
    uint32_t fq[12], fs[12];
    fingerprint(P.q + qpos - 16, fq);
    fingerprint(P.s + spos - 16, fs);
    if (ident48(fq, fs) >= P.hamming_id) return true;
  }
  return false;
}

// the matchers and the verifications of left_most_one over its clipped
// window (qs, ss, the anchor wl, the reduced match mask, the query's
// seed-mask bits): true keeps the pair
__device__ bool left_most_hits(const Params& P, const int8_t* red_map,
                               const int32_t* shape_pos, const uint64_t* cur,
                               const uint64_t* prev, int qs, int ss, int wl,
                               uint64_t match_mask, uint64_t smask) {
  const uint64_t qsm = ~smask;
  const int len_left = wl + P.shape_len - 1;
  const uint64_t bits_left = (1ull << len_left) - 1;
  const uint64_t mm_left = match_mask & bits_left;
  const uint64_t left_hit =
      matcher_hit(mm_left, cur, P.cur_n) & (qsm & bits_left);
  if (P.first_shape && !P.chunked)
    return left_hit == 0 || !verify_one(P, red_map, shape_pos, qs, ss,
                                        left_hit, mm_left, true);
  const int shift = wl + 1;
  const uint64_t mm_right = (match_mask >> shift) & 0xFFFFFFFFull;
  const uint64_t qm_right = (qsm >> shift) & 0xFFFFFFFFull;
  const uint64_t right_hit =
      matcher_hit(mm_right, P.chunked ? cur : prev,
                  P.chunked ? P.cur_n : P.prev_n) & qm_right;
  if (left_hit &&
      verify_one(P, red_map, shape_pos, qs, ss, left_hit, mm_left, true))
    return false;
  if (right_hit && verify_one(P, red_map, shape_pos, qs + shift, ss + shift,
                              right_hit, mm_right, false))
    return false;
  return true;
}

// leftmost.cc left_most_one: true keeps the pair
__device__ bool left_most_one(const Params& P, const int8_t* red_map,
                              const int32_t* shape_pos, const uint64_t* cur,
                              const uint64_t* prev, int qp, int sp,
                              int seed_offset, int wl0, int wr0) {
  const int interval_mod = seed_offset % 32;
  const int overhang = max(wl0 - interval_mod, 0);
  const int seed_off = wl0 - overhang;
  const int win_len0 = wl0 + wr0 - overhang;
  const int d = max(seed_off - 16, 0);
  int wl = min(seed_off, 16);
  int qs = qp - seed_off + d, ss = sp - seed_off + d;
  int window = min(win_len0 - d, wl + 1 + 32);
  int first_after = window, last_before = -1;
  for (int o = 0; o < window; ++o) {
    if (P.s[ss + o] == DELIM) {
      if (o >= wl) {
        first_after = o;
        break;
      }
      last_before = o;
    }
  }
  const int dd = last_before >= 0 ? last_before + 1 : 0;
  qs += dd;
  ss += dd;
  wl -= dd;
  window = first_after - dd;
  uint64_t match_mask = 0, smask = 0;
  for (int o = 0; o < window; ++o) {
    const int ql = P.q[qs + o] & 31, sl = P.s[ss + o] & 31;
    if (is_aa(ql) && is_aa(sl) && red_map[ql] == red_map[sl])
      match_mask |= 1ull << o;
    if (P.q_mask[qs + o]) smask |= 1ull << o;
  }
  return left_most_hits(P, red_map, shape_pos, cur, prev, qs, ss, wl,
                        match_mask, smask);
}

// the largest k in [lo, hi) with a[k] <= x (a ascending, a[lo] <= x)
__device__ __forceinline__ int upper_index(const int32_t* a, int lo, int hi,
                                           int x) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
join_eval_kernel(const Params P, uint8_t* __restrict__ score,
                 int32_t* __restrict__ tile_count) {
  // M[a * 32 + ((a + b) & 31)] = matrix[a][b]
  __shared__ int32_t M[32 * 32];
  __shared__ uint64_t cur[MAX_MASKS], prev[MAX_MASKS];
  __shared__ int32_t shape_pos[MAX_WEIGHT];
  __shared__ int8_t red_map[32];
  __shared__ int32_t pstart[THREADS + 1];
  // the CTA's entries: query side, computed once each
  __shared__ int32_t e_qp[THREADS], e_sbeg[THREADS], e_qidx[THREADS],
      e_qoff[THREADS], e_cut[THREADS], e_wl[THREADS], e_wr[THREADS],
      e_wl48[THREADS], e_wr48[THREADS];
  __shared__ uint32_t e_fp[12][THREADS];
  // the query side of the left-most filter (leftmost.cc lm_query_init):
  // window geometry (the seed's offset in it + 64, the anchor, the length,
  // a byte each), seed-mask bits and reduced letters (NOT_AA for a letter
  // that is no amino acid)
  __shared__ int32_t e_lm[THREADS];
  __shared__ uint64_t e_smask[THREADS];
  __shared__ uint32_t e_rq[THREADS][LM_SPAN / 4];
  __shared__ int k0_s;
  const int t = threadIdx.x;
  for (int k = t; k < 32 * 32; k += THREADS)
    M[(k & ~31) | ((k + (k >> 5)) & 31)] = P.matrix[k];
  for (int k = t; k < P.cur_n; k += THREADS) cur[k] = P.cur[k];
  for (int k = t; k < P.prev_n; k += THREADS) prev[k] = P.prev[k];
  for (int k = t; k < P.weight; k += THREADS) shape_pos[k] = P.shape_pos[k];
  if (t < 32) red_map[t] = P.red_map[t];
  const int p0 = blockIdx.x * THREADS;
  if (t == 0) k0_s = upper_index(P.e_pstart, 0, P.n_e, p0);
  __syncthreads();
  const int k0 = k0_s;
  const int n_local = min(THREADS, P.n_e - k0);  // entries that may start here
  pstart[t] = t < n_local ? P.e_pstart[k0 + t] : 0x7FFFFFFF;
  if (t == 0) pstart[THREADS] = 0x7FFFFFFF;
  __syncthreads();
  // the query side of each entry that has a pair in this CTA
  if (t < n_local && pstart[t] < p0 + THREADS) {
    const int qp = P.e_qp[k0 + t];
    const int qidx = P.q_idx[qp];
    const int w = P.win[qidx];
    const int8_t* q = P.q + qp;
    e_qp[t] = qp;
    e_sbeg[t] = P.e_sbeg[k0 + t];
    e_qidx[t] = qidx;
    e_qoff[t] = qp - P.q_starts[qidx];
    e_cut[t] = P.cut[qidx];
    const int wl = clip_left(q, w), wr = clip_right(q, w);
    e_wl[t] = wl;
    e_wr[t] = wr;
    const bool at48 = P.do_leftmost && w != 48;
    e_wl48[t] = at48 ? clip_left(q, 48) : wl;
    e_wr48[t] = at48 ? clip_right(q, 48) : wr;
    uint32_t fq[12];
    fingerprint(q - 16, fq);
#pragma unroll
    for (int k = 0; k < 12; ++k) e_fp[k][t] = fq[k];
    if (P.do_leftmost) {
      const int overhang = max(e_wl48[t] - e_qoff[t] % 32, 0);
      const int seed_off = e_wl48[t] - overhang;
      const int d = max(seed_off - 16, 0);
      const int lwl = min(seed_off, 16);
      const int window =
          min(e_wl48[t] + e_wr48[t] - overhang - d, lwl + 1 + 32);
      const int qs = qp - seed_off + d;
      uint32_t qw[13], mw[13];
      load_words<13>(P.q + qs, qw);
      load_words<13>(P.q_mask + qs, mw);
      const uint64_t in_win = (1ull << window) - 1;
      e_smask[t] = ~eq_bits(mw, 0u) & in_win;
#pragma unroll
      for (int k = 0; k < 13; ++k) {
        uint32_t r = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int ql = (qw[k] >> (8 * b)) & 31;
          const bool aa = 4 * k + b < window && is_aa(ql);
          r |= uint32_t(aa ? uint8_t(red_map[ql]) : NOT_AA) << (8 * b);
        }
        e_rq[t][k] = r;
      }
      e_lm[t] = (d - seed_off + 64) | (lwl << 8) | (window << 16);
    }
  }
  __syncthreads();
  const int p = p0 + t;
  int out = 0;
  if (p < P.n_pairs) {
    const int j = upper_index(pstart, 0, n_local, p);
    const int qp = e_qp[j];
    const int sp = P.s_pos[e_sbeg[j] + (p - pstart[j])];
    uint32_t fq[12], fs[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) fq[k] = e_fp[k][j];
    fingerprint(P.s + sp - 16, fs);
    bool keep = ident48(fq, fs) >= P.hamming_id;
    if (keep && P.self_search) keep = P.s_idx[sp] != e_qidx[j];
    if (keep && P.do_leftmost) {
      // leftmost.cc left_most_fast: the target's window against the
      // entry's query side, in one pass; a delimiter before the anchor
      // (rare) takes left_most_one
      const int lm = e_lm[j];
      const int delta = (lm & 0xFF) - 64, wl = (lm >> 8) & 0xFF;
      const int window = lm >> 16;
      uint32_t sw[13];
      load_words<13>(P.s + sp + delta, sw);
      // a delimiter at or past the window cuts nothing: no query letter
      // there matches (NOT_AA)
      const uint64_t dels = eq_bits(sw, DELIM4);
      const bool slow = (dels & ((1ull << wl) - 1)) != 0;
      uint64_t match_mask = 0;
      if (!slow) {
#pragma unroll
        for (int k = 0; k < 13; ++k) {
          const uint32_t x = sw[k] & DELIM4;
          const uint32_t not_aa = __vcmpeq4(x, MASK_LETTER * 0x01010101u) |
                                  __vcmpeq4(x, STOP_LETTER * 0x01010101u) |
                                  __vcmpeq4(x, DELIM4);
          const uint32_t rs = uint32_t(uint8_t(red_map[x & 31])) |
                              uint32_t(uint8_t(red_map[(x >> 8) & 31])) << 8 |
                              uint32_t(uint8_t(red_map[(x >> 16) & 31])) << 16 |
                              uint32_t(uint8_t(red_map[x >> 24])) << 24;
          match_mask |= uint64_t(byte_bits(__vcmpeq4(rs, e_rq[j][k]) &
                                           ~not_aa)) << (4 * k);
        }
        // up to the first delimiter at or after the anchor
        if (dels) match_mask &= (1ull << ctz64(dels)) - 1;
      }
      keep = slow ? left_most_one(P, red_map, shape_pos, cur, prev, qp, sp,
                                  e_qoff[j], e_wl48[j], e_wr48[j])
                  : left_most_hits(P, red_map, shape_pos, cur, prev,
                                   qp + delta, sp + delta, wl, match_mask,
                                   e_smask[j]);
    }
    if (keep) {
      const int8_t* qa = P.q + qp;
      const int8_t* sa = P.s + sp;
      int st = 0, best = 0;
      for (int o = -e_wl[j]; o < e_wr[j]; ++o) {
        const int a = qa[o] & 31, b = sa[o] & 31;
        st = min(max(st + M[a * 32 + ((a + b) & 31)], 0), 255);
        best = max(best, st);
      }
      // the wrapper refuses a negative cutoff, so a row scores >= 1
      if (best > e_cut[j]) out = best;
    }
    score[p] = uint8_t(out);
  }
  const int n = __syncthreads_count(out != 0);
  if (t == 0) tile_count[blockIdx.x] = n;
}

__global__ void __launch_bounds__(THREADS)
join_rows_kernel(const Params P, const uint8_t* __restrict__ score,
                 const int32_t* __restrict__ tile_end,
                 int32_t* __restrict__ rows) {
  __shared__ int32_t rank[THREADS];
  const int b = blockIdx.x, t = threadIdx.x;
  const int off = b ? tile_end[b - 1] : 0;
  if (tile_end[b] == off) return;  // no row here (uniform in the CTA)
  const int p = b * THREADS + t;
  const int sc = p < P.n_pairs ? score[p] : 0;
  // inclusive scan of the row flags in shared memory
  rank[t] = sc != 0;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {
    const int v = t >= d ? rank[t - d] : 0;
    __syncthreads();
    rank[t] += v;
    __syncthreads();
  }
  if (sc) {
    const int k = upper_index(P.e_pstart, 0, P.n_e, p);
    const int qp = P.e_qp[k];
    const int sp = P.s_pos[P.e_sbeg[k] + (p - P.e_pstart[k])];
    const int qidx = P.q_idx[qp];
    int32_t* row = rows + 4 * (off + rank[t] - 1);
    row[0] = qidx;
    row[1] = sp;
    row[2] = qp - P.q_starts[qidx];
    row[3] = sc;
  }
}

}  // namespace

// One call of the fused pass over n_pairs pairs (the entries of a range of
// seed groups): score uint8 [n_pairs] and tile_count int32
// [ceil(n_pairs / 256)] out.  The pointers are device pointers, matrix
// int32 [32][32], red_map int8 [32], shape_pos int32 [weight], cur / prev
// uint64 [cur_n] / [prev_n]; part_tbl and s_idx may be null.
extern "C" int stage12_join_eval(
    const void* q, const void* s, const void* q_mask, const void* e_qp,
    const void* e_sbeg, const void* e_pstart, int n_e, int n_pairs,
    const void* s_pos, const void* q_idx, const void* q_starts,
    const void* cut, const void* win, const void* s_idx, const void* matrix,
    const void* red_map, int red_size, const void* shape_pos, int weight,
    int shape_len, uint64_t shape_mask, const void* cur, int cur_n,
    const void* prev, int prev_n, int part_lo, int part_hi,
    uint64_t seedp_mask, const void* part_tbl, int hamming_id,
    int first_shape, int chunked, int do_leftmost, int self_search,
    void* score, void* tile_count, void* stream) {
  if (n_pairs <= 0) return 0;
  if (cur_n > MAX_MASKS || prev_n > MAX_MASKS || weight > MAX_WEIGHT)
    return int(cudaErrorInvalidValue);
  Params P;
  P.q = static_cast<const int8_t*>(q);
  P.s = static_cast<const int8_t*>(s);
  P.q_mask = static_cast<const uint8_t*>(q_mask);
  P.e_qp = static_cast<const int32_t*>(e_qp);
  P.e_sbeg = static_cast<const int32_t*>(e_sbeg);
  P.e_pstart = static_cast<const int32_t*>(e_pstart);
  P.s_pos = static_cast<const int32_t*>(s_pos);
  P.q_idx = static_cast<const int32_t*>(q_idx);
  P.q_starts = static_cast<const int32_t*>(q_starts);
  P.cut = static_cast<const int32_t*>(cut);
  P.win = static_cast<const int32_t*>(win);
  P.s_idx = static_cast<const int32_t*>(s_idx);
  P.matrix = static_cast<const int32_t*>(matrix);
  P.red_map = static_cast<const int8_t*>(red_map);
  P.shape_pos = static_cast<const int32_t*>(shape_pos);
  P.cur = static_cast<const uint64_t*>(cur);
  P.prev = static_cast<const uint64_t*>(prev);
  P.part_tbl = static_cast<const int16_t*>(part_tbl);
  P.shape_mask = shape_mask;
  P.seedp_mask = seedp_mask;
  P.n_e = n_e;
  P.n_pairs = n_pairs;
  P.red_size = red_size;
  P.weight = weight;
  P.shape_len = shape_len;
  P.cur_n = cur_n;
  P.prev_n = prev_n;
  P.part_lo = part_lo;
  P.part_hi = part_hi;
  P.hamming_id = hamming_id;
  P.first_shape = first_shape;
  P.chunked = chunked;
  P.do_leftmost = do_leftmost;
  P.self_search = self_search;
  const int grid = (n_pairs + THREADS - 1) / THREADS;
  join_eval_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<uint8_t*>(score), static_cast<int32_t*>(tile_count));
  return int(cudaGetLastError());
}

// The rows of that call: tile_end int32 is the inclusive prefix sum of
// tile_count; rows int32 [tile_end[-1]][4] out.
extern "C" int stage12_join_rows(const void* e_qp, const void* e_sbeg,
                                 const void* e_pstart, int n_e, int n_pairs,
                                 const void* s_pos, const void* q_idx,
                                 const void* q_starts, const void* score,
                                 const void* tile_end, void* rows,
                                 void* stream) {
  if (n_pairs <= 0) return 0;
  Params P = {};
  P.e_qp = static_cast<const int32_t*>(e_qp);
  P.e_sbeg = static_cast<const int32_t*>(e_sbeg);
  P.e_pstart = static_cast<const int32_t*>(e_pstart);
  P.s_pos = static_cast<const int32_t*>(s_pos);
  P.q_idx = static_cast<const int32_t*>(q_idx);
  P.q_starts = static_cast<const int32_t*>(q_starts);
  P.n_e = n_e;
  P.n_pairs = n_pairs;
  const int grid = (n_pairs + THREADS - 1) / THREADS;
  join_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const uint8_t*>(score),
      static_cast<const int32_t*>(tile_end), static_cast<int32_t*>(rows));
  return int(cudaGetLastError());
}
