// Score-only banded Smith-Waterman of one shared profile against a batch of
// target rows with a uniform band: the Hopper kernel behind
// ops/swipe_uniform_device (the benchmark, the direct DP route and the
// sharded full-matrix scores of --mesh).
//
// Replaces the TPU kernel diamond_tpu/ops/swipe_pallas.py:36-145
// (_make_kernel + banded_swipe_pallas).  The function is that kernel's:
// target row b walks columns j = 0..T-1; band row r of column j is profile
// row p = j + r and scores prof_t[letter_j][p] (the profile stored
// transposed, [32][T + band]); a cell exists for r in [0, band) and is
// valid where band_mask[b][r] != 0 and its score > NEG / 2; invalid cells
// end at 0 but pass E and F on; H, E and the lazy-F prefix max are those of
// ops/swipe_uniform.column_step.  Outputs (best, max_col, max_row): max_col
// the first column where the best rises strictly, max_row the highest band
// row among that column's ties, (0, 0, 0) when nothing scores.
//
// What bounds it on the card: int32 ALU work, 11 operations per cell in
// the row-serial form, 8 as the wide-band walk issues them with DPX.
// Device-memory traffic is one target letter per column and the profile,
// which every row of the batch reads.  A target's columns form one serial
// chain, so what counts is the work and latency of one column step.  Two
// paths, chosen by the band:
//   - bands <= 512 (uniform_shape: ceil(band / 32) rows a lane): one warp
//     per target, lane l holding band rows [l*R, (l+1)*R) in registers, R a
//     template parameter; the column step after the score is
//     warp_band.cuh's (shared with the banded extension kernel): a lazy F,
//     DPX max-plus steps, the E shift by one __shfl_down_sync, per-lane
//     best tracking; no __syncthreads and no shared-memory pass on the
//     chain.  Up to 16 targets (warps) share a CTA, fewer when the batch
//     would not fill the card's SMs.  The profile, which every target of
//     the launch reads, is read through L1 with __ldg: lane l's row k of
//     column j is profile column j + l*R + k, R rows a lane at constant
//     offsets from one pointer.  (Staging it in shared memory once per CTA,
//     laid out [letter][p % R][p / R] so that 32 lanes read 32 consecutive
//     words, measured slower on the H100: the per-cell index arithmetic
//     costs more than the L1 hits it saves.)
//   - bands 513..8192: one warp per target walks the profile's rows, not
//     the band's, as the diagonal-band sweep (swipe_sweep.cu) does.  Only
//     the live rows [p_lo, p_hi) can matter (the rows where some letter
//     scores > NEG / 2; the packing finds them on the host, the wrapper on
//     the card when a caller hands in bare tensors): a row above p_lo
//     never holds a non-zero H, E or F (with gap costs >= 0), so it passes
//     nothing down, and a row from p_hi on passes nothing up.  The walk
//     takes rows [p_hi - strips * 32R, p_hi) in strips of 32R <= 512 rows
//     (uniform_shape: R and strips from p_hi - p_lo), lane l holding R
//     consecutive rows of a strip; the few rows it takes above p_lo are
//     such dead rows, so no row past p_hi is ever walked.
//     * The column step: the diagonal moves down one row by one
//       __shfl_up_sync, E stays in place, F takes K2's lazy form (each lane
//       runs its rows with nothing entering, one shuffle hands its outgoing
//       F on, and a 5-step max-plus scan runs only when an __any_sync vote
//       finds a lane whose outgoing F rose); DPX max-plus steps.  No
//       barrier of any kind on the column chain, and none in the kernel.
//     * A strip's last row (H, and the F leaving it) goes per column to
//       the target's scratch (two buffers of T, taken in turn); the next
//       strip's lanes read it back 32 columns at a time.  Columns from the
//       strip's first row on read 0 there (that row has left the band).
//     * The profile is read through L1 with __ldg: lane l's row k is
//       profile row base + k of the column's letter, R rows at constant
//       offsets from one pointer.  (Staging each strip's profile in shared
//       memory as [letter][k][lane], as swipe_sweep.cu does, measured no
//       faster on --swipe --mesh 1's largest launch and slower on the
//       benchmark's full-matrix row, whose 64 targets stage with one warp
//       a CTA: chip_ab.py, PERF.md.)
//     * The mask is kept as bits, one word per 32 band rows in shared
//       memory per warp, padded with a zero word on each side: a lane's R
//       band rows at a column are one funnel shift.  Mask and letters are
//       read 16 bytes at a time where the rows are aligned to 16.
//     * A strip walks only the columns where one of its live rows lies in
//       the band, from one column earlier (whose last row above seeds the
//       diagonal).  Columns before the first target letter that scores > 0
//       somewhere in the live rows (`pos`, found with p_lo) hold only
//       zeros, and columns after the last such letter cannot raise the
//       best (every score there is <= 0), so the walk skips both ends; pad
//       columns (letter 31) score like any other and are skipped only so.
//     * Edge rules (the `edge` column step): a cell whose band row lies
//       below 0 does not exist (its row has left the band at the top): its
//       E and its cur0 are 0, so it passes no F; a cell past the band's
//       last row, or out of the mask, or scoring <= NEG / 2, is invalid: H
//       0, E and F passing through, and its score is not read.  Between
//       the columns where every live row of the strip lies in the band and
//       in the mask's leading run (and when every live cell's score is
//       valid, `all_valid`, and the strip holds no row before profile row
//       0), the plain step runs with no per-cell check, in a loop of its
//       own; the full-matrix jobs of sharded_full_scores take it on every
//       column but one a strip.
//     * Each lane keeps its best, the first column it reached it and its
//       highest row there (a tie at an earlier column, or at the same
//       column in a later strip, replaces it); three warp reductions at the
//       end give the tie rules, band row = profile row - column.
//     Up to 8 targets (warps) share a CTA, fewer when the batch would not
//     fill the card's SMs.
// Target letters come 32 columns at a time, one per lane, and a
// __shfl_sync hands each column's letter to the warp.  The kernel
// allocates nothing, does not synchronise, and launches on the caller's
// stream; the C entry point returns cudaGetLastError().

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_band.cuh"

namespace {

constexpr int NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_TARGETS = 16;  // most targets (warps) of a warp-path CTA
constexpr int ROW_TARGETS = 8;    // most targets (warps) of a row-walk CTA
constexpr int MAX_BAND = 8192;

// -- bands <= 512: one warp per target -------------------------------------

template <int R>
__global__ void __launch_bounds__(WARP_TARGETS * 32)
uniform_warp_kernel(const int8_t* __restrict__ t_idx,
                    const int8_t* __restrict__ band_mask,
                    const int32_t* __restrict__ prof_t, int B, int T,
                    int band, int go, int ge, int per_cta,
                    int32_t* __restrict__ best_out,
                    int32_t* __restrict__ col_out,
                    int32_t* __restrict__ row_out) {
  // profile row length; an int, so that the row offset a * P is one
  // 32x32->64 multiply-add (a 64-bit P measured 6 % slower on the H100)
  const int P = T + band;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * per_cta + (threadIdx.x >> 5);
  if (b >= B) return;
  const int r0 = lane * R;
  const int8_t* t = t_idx + size_t(b) * T;

  unsigned inb = 0;  // bit k: row r0 + k lies in the band
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = r0 + k;
    if (r < band && band_mask[size_t(b) * band + r] != 0) inb |= 1u << k;
  }
  int H[R], E[R];
#pragma unroll
  for (int k = 0; k < R; ++k) H[k] = E[k] = 0;
  int tnext = lane < T ? (int(t[lane]) & 31) : 0;
  int tword = 0;
  int lb = 0, lc = 0, lr = 0;
  for (int j = 0; j < T; ++j) {
    if ((j & 31) == 0) {  // take this block's letters, load the next block's
      tword = tnext;
      const int jj = j + 32 + lane;
      tnext = jj < T ? (int(t[jj]) & 31) : 0;
    }
    const int a = __shfl_sync(FULL, tword, j & 31);
    const int32_t* prow = prof_t + size_t(a) * P + j + r0;
    int s[R];
    unsigned valid = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int x = (inb >> k) & 1u ? __ldg(prow + k) : NEG;
      if (x > NEG / 2) valid |= 1u << k;
      s[k] = x;
    }
    warp_band::column<R>(H, E, s, valid, lane, r0, j, go, ge, lb, lc, lr);
  }
  const warp_band::Best res = warp_band::band_result(lb, lc, lr);
  if (lane == 0) {
    best_out[b] = res.best;
    col_out[b] = res.col;
    row_out[b] = res.row;
  }
}

template <int R>
int launch_warp(const int8_t* t_idx, const int8_t* band_mask,
                const int32_t* prof_t, int B, int T, int band, int go, int ge,
                int32_t* best, int32_t* col, int32_t* row,
                cudaStream_t stream) {
  // spread a small batch over the card's SMs, a CTA of fewer warps each
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int spread = (B + sms - 1) / sms;  // >= 1 since B > 0
  const int per_cta = spread < WARP_TARGETS ? spread : WARP_TARGETS;
  uniform_warp_kernel<R><<<(B + per_cta - 1) / per_cta, per_cta * 32, 0,
                           stream>>>(t_idx, band_mask, prof_t, B, T, band, go,
                                     ge, per_cta, best, col, row);
  return 0;
}

// -- bands 513..8192: one warp per target over the profile's rows -------

// One column of a strip: H, E updated in place; sp the column letter's
// profile at the lane's row 0 (row k at sp[k]); d_in the H entering the
// lane's row 0 from above at the previous column; c_f the F the strip above
// leaves (lane 0 only).  With EDGE, mbits bit k: row k's band row lies in
// the mask (0 outside the band; only such rows are read, so a row before
// profile row 0 never is), and the lane's first ntop rows lie above the
// band.  Returns the F leaving the lane's last row; lmax is the lane's
// column maximum.
template <int R, bool EDGE>
__device__ __forceinline__ int rows_column(int (&H)[R], int (&E)[R],
                                           const int32_t* sp, unsigned mbits,
                                           int ntop, int d_in, int c_f,
                                           int lane, int go, int ge,
                                           int& lmax) {
  int cur0[R], g[R];
  unsigned valid = 0;
  int fo = 0;  // the lane's outgoing F with nothing entering its first row
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int diag = k == 0 ? d_in : H[k - 1];
    int s, e = E[k];
    if (EDGE) {
      s = (mbits >> k) & 1u ? __ldg(sp + k) : NEG;
      if (s > NEG / 2)
        valid |= 1u << k;
      else
        s = NEG;
      if (k < ntop) e = 0;
    } else {
      s = __ldg(sp + k);
    }
    cur0[k] = __viaddmax_s32_relu(diag, s, e);
    g[k] = cur0[k] - go;
    fo = __viaddmax_s32_relu(fo, -ge, g[k]);
  }
  int f_in = __shfl_up_sync(FULL, fo, 1);
  if (lane == 0) f_in = c_f;
  const int kge = R * ge;  // decay of a vertical gap across one lane
  const int nf = __viaddmax_s32(f_in, -kge, fo);
  if (__any_sync(FULL, nf != fo)) {  // carry on exactly: inclusive scan
    int incl = nf;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = __viaddmax_s32(o, -off * kge, incl);
    }
    f_in = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) f_in = c_f;
  }
  int f = f_in;  // F entering row k
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int hn = max(cur0[k], f);
    if (EDGE && !((valid >> k) & 1u)) hn = 0;
    f = __viaddmax_s32_relu(f, -ge, g[k]);
    E[k] = __viaddmax_s32_relu(E[k], -ge, hn - go);
    H[k] = hn;
  }
  int m = 0;
#pragma unroll
  for (int k = 0; k + 1 < R; k += 2) m = __vimax3_s32(m, H[k], H[k + 1]);
  if (R & 1) m = max(m, H[R - 1]);
  lmax = m;
  return f;
}

// One strip's walk of one target: lane l's rows base .. base + R - 1 of
// the strip's first row S0, over columns js..je in up to three runs (edge
// columns, plain columns, edge columns), each its own loop so that the
// plain run's body stays compact.
template <int R>
struct StripWalk {
  const int8_t* t;         // the target's letters
  const int2* cin;         // the strip above's last row per column, or null
  int2* cout;              // this strip's, or null
  const int32_t* sp_lane;  // profile row base of letter 0
  const unsigned* mw;      // the target's mask bits
  size_t P;                // profile row length
  int js, S0, base, band, go, ge, lane;
  int H[R], E[R];
  int tword, tnext, d_prev;
  int2 cword, cnext;
  int lbest, lcol, lrow;

  __device__ __forceinline__ void start(int je) {
#pragma unroll
    for (int k = 0; k < R; ++k) H[k] = E[k] = 0;
    // 32 target letters (and carries) per block of columns, one per lane,
    // loaded one block ahead; the row above the strip lies in the band
    // only before column S0
    const int jj = js + lane;
    tnext = jj <= je ? (int(t[jj]) & 31) : 0;
    cnext = cin && jj <= je && jj < S0 ? cin[jj] : make_int2(0, 0);
    tword = 0;
    cword = make_int2(0, 0);
    d_prev = 0;  // H of the row above the strip, previous column
  }

  template <bool EDGE>
  __device__ __forceinline__ void walk(int j0, int j1, int je) {
    for (int j = j0; j <= j1; ++j) {
      const int src = (j - js) & 31;
      if (src == 0) {
        tword = tnext;
        cword = cnext;
        const int jj = j + 32 + lane;
        tnext = jj <= je ? (int(t[jj]) & 31) : 0;
        if (cin) cnext = jj <= je && jj < S0 ? cin[jj] : make_int2(0, 0);
      }
      const int32_t* sp = sp_lane + __shfl_sync(FULL, tword, src) * P;
      int c_h = 0, c_f = 0;  // the strip above: its last row's H and F
      if (cin) {             // warp-uniform
        c_h = __shfl_sync(FULL, cword.x, src);
        c_f = __shfl_sync(FULL, cword.y, src);
      }
      int d_in = __shfl_up_sync(FULL, H[R - 1], 1);
      if (lane == 0) d_in = d_prev;
      unsigned mbits = 0;
      int ntop = 0;
      if (EDGE) {
        const int r0 = base - j;  // band row of the lane's row 0
        if (r0 > -32 && r0 < band) {
          const int x = r0 + 32;
          mbits = __funnelshift_r(mw[x >> 5], mw[(x >> 5) + 1], x & 31);
        }
        ntop = min(max(-r0, 0), R);
      }
      int lmax;
      const int f_out = rows_column<R, EDGE>(H, E, sp, mbits, ntop, d_in, c_f,
                                             lane, go, ge, lmax);
      if (cout && lane == 31) cout[j] = make_int2(H[R - 1], f_out);
      d_prev = c_h;
      // a rise, or a tie that an earlier column (of a later strip) or a
      // higher row of the same column wins: the lane's row
      if (lmax > lbest || (lmax == lbest && lmax > 0 && j <= lcol)) {
        int kr = 0;
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (H[k] == lmax) kr = k;
        const int p = base + kr;
        if (lmax > lbest || j < lcol || p > lrow) {
          lbest = lmax;
          lcol = j;
          lrow = p;
        }
      }
    }
  }
};

// Bits of the 16 bytes of v that are not 0, byte i at bit i.
__device__ __forceinline__ unsigned nonzero_bits16(int4 v) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned m = __vcmpne4(unsigned(w[i]), 0u) & 0x80808080u;
    bits |= ((m >> 7 | m >> 14 | m >> 21 | m >> 28) & 0xfu) << (4 * i);
  }
  return bits;
}

// p0: the profile row of the first strip's first row (p_hi - strips * 32R,
// perhaps below 0); p_lo: the first live row; pos bit a: letter a scores
// > 0 in some live row; all_valid: every letter scores > NEG / 2 in every
// live row.  scratch: int2 [B][2][T] when strips > 1.
template <int R>
__global__ void __launch_bounds__(ROW_TARGETS * 32)
uniform_rows_kernel(const int8_t* __restrict__ t_idx,
                    const int8_t* __restrict__ band_mask,
                    const int32_t* __restrict__ prof_t, int B, int T,
                    int band, int go, int ge, int p0, int strips, int p_lo,
                    unsigned pos, int all_valid, int per_cta,
                    int2* __restrict__ scratch, int32_t* __restrict__ best_out,
                    int32_t* __restrict__ col_out,
                    int32_t* __restrict__ row_out) {
  constexpr int ROWS = 32 * R;
  extern __shared__ unsigned smem[];
  const int nw = (band + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's mask bits: mw[1 + w] holds band rows 32w..32w+31
  unsigned* mw = smem + warp * (nw + 2);
  const int b = blockIdx.x * per_cta + warp;
  if (b >= B) return;  // warp-uniform; the warps share nothing
  const int8_t* t = t_idx + size_t(b) * T;
  const size_t P = size_t(T) + band;  // profile row length

  int m0 = band;     // the mask's leading run: band rows [0, m0)
  int jf = INT_MAX;  // the first and last column whose letter can score
  int jl = -1;
  {
    const int8_t* bm = band_mask + size_t(b) * band;
    int m0l = INT_MAX;
    if ((band & 15) == 0 && (reinterpret_cast<uintptr_t>(bm) & 15) == 0) {
      // a band of 16 mod 32 ends halfway through its last word: that
      // word's upper 16 rows lie past the band and are not read
      const int4* bm4 = reinterpret_cast<const int4*>(bm);
#pragma unroll 4
      for (int w = lane; w < nw; w += 32) {
        unsigned bits = nonzero_bits16(__ldg(bm4 + 2 * w));
        if (32 * w + 16 < band)
          bits |= nonzero_bits16(__ldg(bm4 + 2 * w + 1)) << 16;
        mw[1 + w] = bits;
        if (bits != FULL) m0l = min(m0l, 32 * w + __ffs(~bits) - 1);
      }
    } else {
      for (int w = lane; w < nw; w += 32) {
        unsigned bits = 0;
#pragma unroll 8
        for (int i = 0; i < 32; ++i) {
          const int r = 32 * w + i;
          if (r < band && bm[r] != 0) bits |= 1u << i;
        }
        mw[1 + w] = bits;
        if (bits != FULL) m0l = min(m0l, 32 * w + __ffs(~bits) - 1);
      }
    }
    if (lane == 0) {
      mw[0] = 0;
      mw[nw + 1] = 0;
    }
    m0 = min(band, __reduce_min_sync(FULL, m0l));
    if ((T & 15) == 0 && (reinterpret_cast<uintptr_t>(t) & 15) == 0) {
      const int4* t4 = reinterpret_cast<const int4*>(t);
#pragma unroll 2
      for (int x = lane; x < T / 16; x += 32) {
        const int4 v = __ldg(t4 + x);
        const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if ((pos >> ((w[c >> 2] >> (8 * (c & 3))) & 31)) & 1u) {
            jf = min(jf, 16 * x + c);
            jl = max(jl, 16 * x + c);
          }
      }
    } else {
      for (int j = lane; j < T; j += 32)
        if ((pos >> (int(t[j]) & 31)) & 1u) {
          jf = min(jf, j);
          jl = j;
        }
    }
    jf = __reduce_min_sync(FULL, jf);
    jl = __reduce_max_sync(FULL, jl);
    __syncwarp();
  }

  StripWalk<R> w;
  w.t = t;
  w.mw = mw;
  w.band = band;
  w.go = go;
  w.ge = ge;
  w.lane = lane;
  w.lbest = 0;
  w.lcol = INT_MAX;
  w.lrow = -1;
  // strip carries: buffer (s & 1) holds strip s's last row per column
  int2* carry0 = nullptr;
  int2* carry1 = nullptr;
  if (strips > 1) {
    carry0 = scratch + size_t(b) * 2 * T;
    carry1 = carry0 + T;
  }
  for (int s = 0; s < strips; ++s) {
    const int S0 = p0 + s * ROWS;  // profile row of the strip's first row
    const int S1 = S0 + ROWS;
    const int L0 = max(S0, p_lo);  // the strip's first live row
    // columns where a live row of the strip lies in the band, from one
    // earlier (the row above's H there is the diagonal of the next)
    w.js = max(max(0, jf), L0 - band);
    const int je = min(min(T - 1, jl), S1 - 1);
    if (w.js > je) continue;  // no carry of it is read: the next strip's
                              // columns start past this one's end
    // the plain step's columns: every live row in the band and the mask's
    // leading run, every live cell valid, no row before profile row 0
    const int flo = all_valid && S0 >= 0 ? max(w.js, S1 - m0) : INT_MAX;
    const int fhi = min(je, L0);
    w.S0 = S0;
    w.base = S0 + lane * R;
    w.sp_lane = prof_t + w.base;  // perhaps before row 0: see rows_column
    w.P = P;
    w.cin = s > 0 ? ((s - 1) & 1 ? carry1 : carry0) : nullptr;
    w.cout = s + 1 < strips ? (s & 1 ? carry1 : carry0) : nullptr;
    w.start(je);
    const int e1 = min(je, flo - 1);  // the edge columns before the plain
    w.template walk<true>(w.js, e1, je);
    w.template walk<false>(max(w.js, flo), fhi, je);
    w.template walk<true>(max(max(w.js, e1 + 1), fhi + 1), je, je);
    __syncwarp();  // this strip's carries are read by the next
  }
  // best; the first column any lane reached it; the highest row there
  const int best = __reduce_max_sync(FULL, w.lbest);
  const bool top = best > 0 && w.lbest == best;
  const int col = __reduce_min_sync(FULL, top ? w.lcol : INT_MAX);
  const int row = __reduce_max_sync(FULL, top && w.lcol == col ? w.lrow : -1);
  if (lane == 0) {
    best_out[b] = best;
    col_out[b] = best > 0 ? col : 0;
    row_out[b] = best > 0 ? row - col : 0;
  }
}

template <int R>
int launch_rows(const int8_t* t_idx, const int8_t* band_mask,
                const int32_t* prof_t, int B, int T, int band, int go, int ge,
                int p0, int strips, int p_lo, unsigned pos, int all_valid,
                int2* scratch, int32_t* best, int32_t* col, int32_t* row,
                cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int spread = (B + sms - 1) / sms;  // >= 1 since B > 0
  const int per_cta = spread < ROW_TARGETS ? spread : ROW_TARGETS;
  const int nw = (band + 31) >> 5;
  const int smem = int(sizeof(unsigned)) * per_cta * (nw + 2);
  e = cudaFuncSetAttribute(uniform_rows_kernel<R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  uniform_rows_kernel<R><<<(B + per_cta - 1) / per_cta, per_cta * 32, smem,
                           stream>>>(t_idx, band_mask, prof_t, B, T, band, go,
                                     ge, p0, strips, p_lo, pos, all_valid,
                                     per_cta, scratch, best, col, row);
  return 0;
}

using WarpFn = int (*)(const int8_t*, const int8_t*, const int32_t*, int, int,
                       int, int, int, int32_t*, int32_t*, int32_t*,
                       cudaStream_t);
using RowsFn = int (*)(const int8_t*, const int8_t*, const int32_t*, int, int,
                       int, int, int, int, int, int, unsigned, int, int2*,
                       int32_t*, int32_t*, int32_t*, cudaStream_t);

constexpr WarpFn LAUNCH_WARP[16] = {
    launch_warp<1>,  launch_warp<2>,  launch_warp<3>,  launch_warp<4>,
    launch_warp<5>,  launch_warp<6>,  launch_warp<7>,  launch_warp<8>,
    launch_warp<9>,  launch_warp<10>, launch_warp<11>, launch_warp<12>,
    launch_warp<13>, launch_warp<14>, launch_warp<15>, launch_warp<16>};

constexpr RowsFn LAUNCH_ROWS[16] = {
    launch_rows<1>,  launch_rows<2>,  launch_rows<3>,  launch_rows<4>,
    launch_rows<5>,  launch_rows<6>,  launch_rows<7>,  launch_rows<8>,
    launch_rows<9>,  launch_rows<10>, launch_rows<11>, launch_rows<12>,
    launch_rows<13>, launch_rows<14>, launch_rows<15>, launch_rows<16>};

}  // namespace

// K4: t_idx int8 [B][T], band_mask int8 [B][band], prof_t int32
// [32][T + band]; outputs int32 [B].  band <= 512: the warp path, R band
// rows a lane (1..16, band <= 32 R; strips and the row arguments unused).
// band 513..8192: the row walk over profile rows [p_hi - strips * 32 R,
// p_hi), R rows a lane (1..16), the live rows [p_lo, p_hi) within them,
// pos and all_valid as the kernel takes them, gap costs >= 0, scratch int2
// [B][2][T] when strips > 1.
extern "C" int uniform_swipe_mask_launch(
    int rows_per_lane, int strips, const void* t_idx, const void* band_mask,
    const void* prof_t, int B, int T, int band, int go, int ge, int p_lo,
    int p_hi, int pos, int all_valid, void* scratch, void* best, void* col,
    void* row, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int R = rows_per_lane;
  if (R < 1 || R > 16) return int(cudaErrorInvalidValue);
  auto ti = static_cast<const int8_t*>(t_idx);
  auto bm = static_cast<const int8_t*>(band_mask);
  auto pf = static_cast<const int32_t*>(prof_t);
  auto bo = static_cast<int32_t*>(best);
  auto co = static_cast<int32_t*>(col);
  auto ro = static_cast<int32_t*>(row);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (band <= 32 * 16) {
    if (32 * R < band) return int(cudaErrorInvalidValue);
    err = LAUNCH_WARP[R - 1](ti, bm, pf, B, T, band, go, ge, bo, co, ro, s);
  } else {
    const int p0 = p_hi - strips * 32 * R;
    if (band > MAX_BAND || strips < 1 || p_lo < 0 || p_hi > T + band ||
        p_lo >= p_hi || p0 > p_lo || go < 0 || ge < 0 ||
        (strips > 1 && scratch == nullptr))
      return int(cudaErrorInvalidValue);
    err = LAUNCH_ROWS[R - 1](ti, bm, pf, B, T, band, go, ge, p0, strips, p_lo,
                             unsigned(pos), all_valid,
                             static_cast<int2*>(scratch), bo, co, ro, s);
  }
  if (err) return err;
  return int(cudaGetLastError());
}
