// Score-only banded Smith-Waterman of one shared profile against a batch of
// target rows with a uniform band: the Hopper kernel behind
// ops/swipe_uniform_device (the benchmark and the direct DP route).
//
// Replaces the TPU kernel diamond_tpu/ops/swipe_pallas.py:36-145
// (_make_kernel + banded_swipe_pallas): band rows valid where
// band_mask[b][r].  Target row b walks columns j = 0..T-1; band row r of
// column j scores prof_t[letter_j][j + r] (the profile stored transposed,
// [32][T + band], so a column's band reads one contiguous run of a profile
// row), NEG where the row is out of band.  A cell is valid iff its score >
// NEG / 2; invalid cells end at 0.  H, E and the lazy-F prefix max are
// those of ops/swipe_uniform.column_step; outputs (best, max_col, max_row)
// with max_col the first column where the best rises strictly and max_row
// the highest band row among that column's ties.
//
// What bounds it on the card: int32 ALU work, 11 operations per cell (the
// recurrence; the scans add a few).  Device-memory traffic is one target
// letter per column and the profile, which every row of the batch reads.
// A target's columns form one serial chain, so what counts is the work
// and latency of one column step.  Two paths, chosen by the band:
//   - bands <= 512 (uniform_shape gives 32 threads): one warp per target,
//     lane l holding band rows [l*R, (l+1)*R) in registers, R = ceil(band
//     / 32) a template parameter; the column step after the score is
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
//   - bands 513..8192: one CTA per target row, up to 512 threads; thread t
//     holds band rows [t * R, (t + 1) * R) (R = 8 or 16); the F prefix max
//     is an in-thread scan, a 5-step __shfl_up_sync warp scan, and one
//     shared-memory pass over the warp totals; the one-row E shift crosses
//     threads by __shfl_down_sync and warps by shared memory; the column
//     maximum is a warp __reduce_max_sync plus a shared-memory pass, and
//     the row of a new best is found only on a rise; two __syncthreads a
//     column (warp totals written before the first and read between the
//     two, column maxima and E carries written between the two and read
//     before the next column's first); DPX max-plus steps.
// Target letters come 32 columns at a time, one per lane, and a
// __shfl_sync hands each column's letter to the warp.  Rows past the band
// score NEG, so their H and E stay 0 and they change nothing below them.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_band.cuh"

namespace {

constexpr int NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int WARP_TARGETS = 16;  // most targets (warps) of a warp-path CTA

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

// -- bands 513..8192: one CTA per target -----------------------------------

template <int R>
__global__ void __launch_bounds__(MAX_THREADS)
uniform_cta_kernel(const int8_t* __restrict__ t_idx,
                   const int8_t* __restrict__ band_mask,
                   const int32_t* __restrict__ prof_t, int T, int band,
                   int go, int ge, int32_t* __restrict__ best_out,
                   int32_t* __restrict__ col_out,
                   int32_t* __restrict__ row_out) {
  __shared__ int s_tot[MAX_WARPS];  // inclusive g-scan total of each warp
  __shared__ int s_max[MAX_WARPS];  // column maximum of each warp
  __shared__ int s_e[MAX_WARPS];    // E_out of each warp's first row
  __shared__ int s_row[MAX_WARPS];  // highest tied row of each warp

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int r0 = tid * R;
  const int8_t* t = t_idx + size_t(b) * T;
  const size_t P = size_t(T) + band;  // profile row length

  unsigned inb = 0;  // bit k: row r0 + k lies in the band
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = r0 + k;
    if (r < band && band_mask[size_t(b) * band + r] != 0) inb |= 1u << k;
  }

  int H[R], E[R];
#pragma unroll
  for (int k = 0; k < R; ++k) H[k] = E[k] = 0;
  int best = 0, max_col = 0, max_row = 0;
  int tword = 0;
  for (int j = 0; j < T; ++j) {
    if ((j & 31) == 0) {  // 32 target letters, one per lane
      const int jj = j + lane;
      tword = jj < T ? (int(t[jj]) & 31) : 0;
    }
    const int32_t* prow = prof_t + size_t(__shfl_sync(FULL, tword, j & 31)) * P
                          + j + r0;

    // cur0 = max(H + s, E, 0) and the in-thread inclusive prefix max of
    // g = cur0 - go + r * ge
    int cur0[R], g[R];
    unsigned valid = 0;
    int run = NEG;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int s = (inb >> k) & 1u ? __ldg(prow + k) : NEG;
      if (s > NEG / 2) valid |= 1u << k;
      cur0[k] = __viaddmax_s32_relu(H[k], s, E[k]);
      run = max(run, cur0[k] - go + (r0 + k) * ge);
      g[k] = run;
    }
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEG;
    if (lane == 31) s_tot[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = max(excl, s_tot[w]);

    // F at row r is max(prefix max through r - r * ge, 0); row r takes the
    // F of row r - 1
    int fs = r0 > 0 ? max(excl - (r0 - 1) * ge, 0) : 0;
    int lmax = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int f = max(max(g[k], excl) - (r0 + k) * ge, 0);
      H[k] = (valid >> k) & 1u ? max(cur0[k], fs) : 0;
      fs = f;
      lmax = max(lmax, H[k]);
    }
    const int wmax = __reduce_max_sync(FULL, lmax);

    // E for the next column: E_out of the row below (same query position)
    const int Eo0 = __viaddmax_s32_relu(E[0], -ge, H[0] - go);
#pragma unroll
    for (int k = 0; k < R - 1; ++k)
      E[k] = __viaddmax_s32_relu(E[k + 1], -ge, H[k + 1] - go);
    int e_in = __shfl_down_sync(FULL, Eo0, 1);
    if (lane == 0) {
      s_max[warp] = wmax;
      s_e[warp] = Eo0;
    }
    __syncthreads();
    if (lane == 31) e_in = warp + 1 < n_warps ? s_e[warp + 1] : 0;
    E[R - 1] = e_in;
    int cbest = s_max[0];
    for (int w = 1; w < n_warps; ++w) cbest = max(cbest, s_max[w]);
    if (cbest > best) {  // block-uniform
      int lrow = -1;
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (H[k] == cbest) lrow = r0 + k;  // highest row of the tie
      lrow = __reduce_max_sync(FULL, lrow);
      if (lane == 0) s_row[warp] = lrow;
      __syncthreads();
      int row = s_row[0];
      for (int w = 1; w < n_warps; ++w) row = max(row, s_row[w]);
      best = cbest;
      max_col = j;
      max_row = row;
    }
  }
  if (tid == 0) {
    best_out[b] = best;
    col_out[b] = max_col;
    row_out[b] = max_row;
  }
}

template <int R>
int launch_cta(const int8_t* t_idx, const int8_t* band_mask,
               const int32_t* prof_t, int B, int T, int band, int go, int ge,
               int threads, int32_t* best, int32_t* col, int32_t* row,
               cudaStream_t stream) {
  uniform_cta_kernel<R><<<B, threads, 0, stream>>>(
      t_idx, band_mask, prof_t, T, band, go, ge, best, col, row);
  return 0;
}

using WarpFn = int (*)(const int8_t*, const int8_t*, const int32_t*, int, int,
                       int, int, int, int32_t*, int32_t*, int32_t*,
                       cudaStream_t);

constexpr WarpFn LAUNCH_WARP[16] = {
    launch_warp<1>,  launch_warp<2>,  launch_warp<3>,  launch_warp<4>,
    launch_warp<5>,  launch_warp<6>,  launch_warp<7>,  launch_warp<8>,
    launch_warp<9>,  launch_warp<10>, launch_warp<11>, launch_warp<12>,
    launch_warp<13>, launch_warp<14>, launch_warp<15>, launch_warp<16>};

}  // namespace

// K4: t_idx int8 [B][T], band_mask int8 [B][band], prof_t int32
// [32][T + band]; outputs int32 [B].  threads == 32: the warp path (R in
// 1..16, band <= 32 R); otherwise one CTA of `threads` threads per target
// (R 8 or 16, band <= threads * R <= 8192).
extern "C" int uniform_swipe_mask_launch(
    int rows_per_thread, int threads, const void* t_idx, const void* band_mask,
    const void* prof_t, int B, int T, int band, int go, int ge, void* best,
    void* col, void* row, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int R = rows_per_thread;
  auto ti = static_cast<const int8_t*>(t_idx);
  auto bm = static_cast<const int8_t*>(band_mask);
  auto pf = static_cast<const int32_t*>(prof_t);
  auto bo = static_cast<int32_t*>(best);
  auto co = static_cast<int32_t*>(col);
  auto ro = static_cast<int32_t*>(row);
  auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (threads == 32) {
    if (R < 1 || R > 16 || 32 * R < band) return int(cudaErrorInvalidValue);
    err = LAUNCH_WARP[R - 1](ti, bm, pf, B, T, band, go, ge, bo, co, ro, s);
  } else {
    if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
        threads * R < band)
      return int(cudaErrorInvalidValue);
    if (R == 8)
      err = launch_cta<8>(ti, bm, pf, B, T, band, go, ge, threads, bo, co, ro,
                          s);
    else if (R == 16)
      err = launch_cta<16>(ti, bm, pf, B, T, band, go, ge, threads, bo, co,
                           ro, s);
    else
      return int(cudaErrorInvalidValue);
  }
  if (err) return err;
  return int(cudaGetLastError());
}
