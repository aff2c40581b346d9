// Score-only full-matrix Smith-Waterman of one query against a length class
// of target rows, with the best cell's position: the Hopper kernel behind
// ops/swipe_device.swipe_sweep (SwipeSweep).
//
// Replaces the TPU kernel diamond_tpu/ops/swipe_device.py:516-629
// (_make_kernel_sweep + banded_swipe_pallas_sweep).  The function is that
// kernel's: target row b walks columns j = 0..T-1 of t_idx; band row r of
// column j is profile row p = j + r and scores prof_t[letter_j][p] (NEG out
// of the query), valid where r < band_len[b] and the score > NEG / 2;
// invalid cells end at 0; H, E and the lazy-F prefix max are those of
// ops/swipe_uniform.column_step.  Outputs (best, max_col, max_row): max_col
// is the first column where the best rises strictly, max_row the highest
// band row among that column's ties, (0, 0, 0) when nothing scores.
//
// The TPU kernel walks the whole band, qlen + C diagonals by T columns, to
// cover a matrix of q_len x t_len cells (5.9x the cells on SwipeSweep's
// largest launch).  This kernel walks the query's rows instead, as the
// full-matrix kernel (csrc/full_swipe.cu) does: only profile rows
// [q_off, q_off + q_len), which must lie inside the band at every column
// (q_off >= T - 1 and q_off + q_len <= band; the caller's profile is NEG
// outside them, so the band's other rows hold no cell that scores or
// passes a gap on).  Per cell it keeps the band's validity, r = p - j <
// band_len[b], so pad columns (letter 31) score exactly as in the band,
// even where a positive query bias makes them score.
//
// What bounds it on the card: int32 ALU work, 11 operations per cell;
// device-memory traffic is one target letter per column and the profile,
// which a block stages once per strip.  What the design does about it:
//   - one warp per target row; lane l holds query rows [l*R, (l+1)*R) of a
//     strip of 32*R rows in registers (R a template parameter, 1..16) and
//     walks the row one column per step;
//   - a query above one strip (512 rows) takes several; the strip's last
//     row (H, and the vertical gap leaving it) goes per column to the row's
//     scratch and the next strip's lane 0 reads it back 32 columns at a time;
//   - the block stages the strip's profile in shared memory as
//     [letter][k][lane], so 32 lanes reading one letter's scores for their
//     k-th row hit 32 consecutive words;
//   - the diagonal moves down one row by one __shfl_up_sync, F by an in-lane
//     scan plus a 5-step __shfl_up_sync scan; E stays in place;
//   - columns before the first one in which the strip holds a valid cell are
//     skipped (there every H and E is 0);
//   - each lane keeps its best, the first column it reached it and its
//     highest row there (a tie at an earlier column, or at the same column
//     in a later strip, replaces it); three warp reductions at the end give
//     the tie rules of the band, since the band row of query row i at
//     column j is q_off + i - j.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps (target rows) per block

template <int R>
__global__ void __launch_bounds__(WARPS * 32)
swipe_sweep_kernel(const int8_t* __restrict__ t_idx,
                   const int32_t* __restrict__ band_len,
                   const int32_t* __restrict__ prof_t, int B, int T, int P,
                   int q_off, int q_len, int go, int ge,
                   int2* __restrict__ scratch, int32_t* __restrict__ best_out,
                   int32_t* __restrict__ col_out,
                   int32_t* __restrict__ row_out) {
  extern __shared__ int32_t sprof[];  // [32 letters][R][32 lanes]
  constexpr int ROWS = 32 * R;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool active = b < B;  // warp-uniform; idle warps still stage
  const int bl = active ? band_len[b] : 0;
  const int8_t* t = t_idx + size_t(active ? b : 0) * T;
  const int strips = (q_len + ROWS - 1) / ROWS;
  // strip carries: buffer (s & 1) holds strip s's last row per column
  int2* carry0 = nullptr;
  int2* carry1 = nullptr;
  if (strips > 1 && active) {
    carry0 = scratch + size_t(b) * 2 * T;
    carry1 = carry0 + T;
  }

  int lbest = 0, lcol = INT_MAX, lrow = -1;
  for (int s = 0; s < strips; ++s) {
    const int p0 = q_off + s * ROWS;  // profile row of the strip's first row
    __syncthreads();  // every warp is done with the previous strip
    for (int x = threadIdx.x; x < 32 * ROWS; x += blockDim.x) {
      const int a = x / ROWS, rho = x - a * ROWS;
      sprof[(a * R + rho % R) * 32 + rho / R] =
          s * ROWS + rho < q_len ? prof_t[size_t(a) * P + p0 + rho] : NEG;
    }
    __syncthreads();
    if (!active) continue;

    const int rbase = s * ROWS + lane * R;  // query row of the lane's row 0
    // before column p0 - bl + 1 no row of the strip is in the band
    // (p - j >= band_len); one column earlier sets the diagonal carry
    const int j_start = max(0, p0 - bl);
    int H[R], E[R];
#pragma unroll
    for (int k = 0; k < R; ++k) H[k] = E[k] = 0;
    const int2* cin = s > 0 ? ((s - 1) & 1 ? carry1 : carry0) : nullptr;
    int2* cout = s + 1 < strips ? (s & 1 ? carry1 : carry0) : nullptr;
    // 32 target letters (and carries) per block of columns, one per lane,
    // loaded one block ahead
    int jj = j_start + lane;
    int tnext = jj < T ? (int(t[jj]) & 31) : 0;
    int2 cnext = cin && jj < T ? cin[jj] : make_int2(0, 0);
    int tword = 0;
    int2 cword = make_int2(0, 0);
    int d_prev = 0;  // H of the row above the strip, previous column
    for (int j = j_start; j < T; ++j) {
      const int src = (j - j_start) & 31;
      if (src == 0) {
        tword = tnext;
        cword = cnext;
        jj = j + 32 + lane;
        tnext = jj < T ? (int(t[jj]) & 31) : 0;
        if (cin) cnext = jj < T ? cin[jj] : make_int2(0, 0);
      }
      const int32_t* srow =
          sprof + __shfl_sync(FULL, tword, src) * (R * 32) + lane;
      int c_h = 0, c_f = 0;  // the strip above: its last row's H and F
      if (cin) {             // warp-uniform
        c_h = __shfl_sync(FULL, cword.x, src);
        c_f = __shfl_sync(FULL, cword.y, src);
      }

      int d_in = __shfl_up_sync(FULL, H[R - 1], 1);
      if (lane == 0) d_in = d_prev;
      // row k lies in the band iff q_off + rbase + k - j < band_len
      const int lim = j + bl - q_off - rbase;
      // cur0 = max(diag + s, E, 0); g = cur0 - go + row * ge, prefix max
      // over the strip, started by the gap the strip above leaves
      int cur0[R], g[R];
      unsigned valid = 0;
      int run = lane == 0 ? c_f - ge : NEG;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int diag = k == 0 ? d_in : H[k - 1];
        const int sc = k < lim ? srow[k * 32] : NEG;
        if (sc > NEG / 2) valid |= 1u << k;
        cur0[k] = __viaddmax_s32_relu(diag, sc, E[k]);
        run = max(run, cur0[k] - go + (lane * R + k) * ge);
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
      // F[k]: the vertical gap leaving row k (entering row k + 1)
      int F[R];
#pragma unroll
      for (int k = 0; k < R; ++k)
        F[k] = max(max(g[k], excl) - (lane * R + k) * ge, 0);
      int f_in = __shfl_up_sync(FULL, F[R - 1], 1);
      if (lane == 0) f_in = c_f;

      int lmax = 0;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int fs = k == 0 ? f_in : F[k - 1];
        const int hn = (valid >> k) & 1u ? max(cur0[k], fs) : 0;
        lmax = max(lmax, hn);
        E[k] = __viaddmax_s32_relu(E[k], -ge, hn - go);
        H[k] = hn;
      }
      if (cout && lane == 31) cout[j] = make_int2(H[R - 1], F[R - 1]);
      d_prev = c_h;
      if (lmax > 0 && lmax >= lbest) {  // a rise or a tie: the lane's row
        int kr = 0;
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (H[k] == lmax) kr = k;
        const int i = rbase + kr;
        if (lmax > lbest || j < lcol || (j == lcol && i > lrow)) {
          lbest = lmax;
          lcol = j;
          lrow = i;
        }
      }
    }
  }
  if (!active) return;
  // best; the first column any lane reached it; the highest row there
  const int best = __reduce_max_sync(FULL, lbest);
  const bool top = best > 0 && lbest == best;
  const int col = __reduce_min_sync(FULL, top ? lcol : INT_MAX);
  const int row = __reduce_max_sync(FULL, top && lcol == col ? lrow : -1);
  if (lane == 0) {
    best_out[b] = best;
    col_out[b] = best > 0 ? col : 0;
    row_out[b] = best > 0 ? q_off + row - col : 0;
  }
}

template <int R>
int launch(const int8_t* t_idx, const int32_t* band_len,
           const int32_t* prof_t, int B, int T, int P, int q_off, int q_len,
           int go, int ge, int2* scratch, int32_t* best, int32_t* col,
           int32_t* row, cudaStream_t stream) {
  const int smem = 32 * 32 * R * int(sizeof(int32_t));
  const cudaError_t e = cudaFuncSetAttribute(
      swipe_sweep_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  swipe_sweep_kernel<R><<<grid, block, smem, stream>>>(
      t_idx, band_len, prof_t, B, T, P, q_off, q_len, go, ge, scratch, best,
      col, row);
  return 0;
}

using LaunchFn = int (*)(const int8_t*, const int32_t*, const int32_t*, int,
                         int, int, int, int, int, int, int2*, int32_t*,
                         int32_t*, int32_t*, cudaStream_t);

constexpr LaunchFn LAUNCH[16] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

// t_idx int8 [B][T], band_len int32 [B], prof_t int32 [32][T + band];
// query rows [q_off, q_off + q_len) of the profile, rows_per_lane R with
// q_len <= 16 strips of 32 R rows; scratch int2 [B][2][T] when the query
// takes more than one strip; outputs int32 [B].
extern "C" int swipe_sweep_launch(int rows_per_lane, const void* t_idx,
                                  const void* band_len, const void* prof_t,
                                  int B, int T, int band, int q_off,
                                  int q_len, int go, int ge, void* scratch,
                                  void* best, void* col, void* row,
                                  void* stream) {
  if (B <= 0 || T <= 0 || q_len <= 0) return 0;
  if (rows_per_lane < 1 || rows_per_lane > 16 || q_off < T - 1 ||
      q_off + q_len > band)
    return int(cudaErrorInvalidValue);
  const int err = LAUNCH[rows_per_lane - 1](
      static_cast<const int8_t*>(t_idx), static_cast<const int32_t*>(band_len),
      static_cast<const int32_t*>(prof_t), B, T, T + band, q_off, q_len, go,
      ge, static_cast<int2*>(scratch), static_cast<int32_t*>(best),
      static_cast<int32_t*>(col), static_cast<int32_t*>(row),
      static_cast<cudaStream_t>(stream));
  if (err) return err;
  return int(cudaGetLastError());
}
