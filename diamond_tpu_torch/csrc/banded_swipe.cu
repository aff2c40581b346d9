// Score-only banded Smith-Waterman over a ragged batch of (query, target,
// band) jobs: the Hopper kernel behind ops/swipe_device.DeviceDP.
//
// Replaces the TPU kernel diamond_tpu/ops/swipe_device.py:155-294
// (_make_kernel + banded_swipe_pallas_multi).  Same function, job for job:
// local affine-gap DP restricted to diagonals [d0, d0 + band), profile
// matrix[q][t] + bias[i], NEG outside the query, lazy F by prefix max,
// outputs (best, max_col, max_row) with max_col the first column where the
// running best rises strictly and max_row the highest band row among that
// column's ties.
//
// What bounds it on the card: int32 ALU work.  The recurrence needs 12
// int32 max/add operations per cell; the whole DP state (H and E for one
// column of the band) lives in registers, and each column reads one target
// letter per job, so device-memory traffic is a few bytes per column
// against band x 12 operations.  Tensor cores do not apply (max-plus, not
// multiply-add).  A job's columns form one serial chain.  What the design
// does about it:
//   - one warp per job; lane l holds band rows [l*R, (l+1)*R) in
//     registers, R = ceil(band / 32) a template parameter (one launch per
//     band class, every R in 1..16), so a band of 129 walks 160 rows, not
//     the 256 of a power-of-two class;
//   - the column step after the score is warp_band.cuh's, shared with the
//     uniform-band kernel: a lazy F (one carry from the previous lane, the
//     5-step warp scan only when a lane's gap rose), DPX max-plus steps,
//     the E row shift by one __shfl_down_sync, per-lane best tracking with
//     three reductions at the end;
//   - the query window slides one row per column through registers and a
//     __shfl_down_sync; target letters and packed query positions come 32
//     columns at a time, one per lane, loaded one block of 32 columns
//     ahead, and reach the warp by __shfl_sync: no device-memory load sits
//     on the column's chain;
//   - the score lookup reads the 32x32 matrix, stored transposed in shared
//     memory (4 KB): for one target letter the 32 lanes read one row
//     indexed by their query letters, which falls in distinct banks;
//   - jobs are ordered longest first by the caller, so long warps start
//     first and short ones fill in behind them.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_band.cuh"

namespace {

constexpr int NEG = -(1 << 20);
constexpr int INVALID = INT32_MIN;  // packed query slot outside the query
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // warps (jobs) per block
constexpr int JOB_COLS = 5;         // t_off, t_len, d0, band, req

// Query letter and bias of query position i packed into one int
// (bias * 32 + letter), or INVALID outside [0, q_len).
__device__ __forceinline__ int load_q(const int8_t* __restrict__ q,
                                      const int8_t* __restrict__ qb,
                                      int q_len, int i) {
  if (i < 0 || i >= q_len) return INVALID;
  return int(qb[i]) * 32 + (int(q[i]) & 31);
}

template <int R>
__global__ void __launch_bounds__(WARPS * 32)
banded_swipe_multi_kernel(const int8_t* __restrict__ t_cat,
                          const int8_t* __restrict__ q_cat,
                          const int8_t* __restrict__ bias_cat,
                          const int32_t* __restrict__ jobs,
                          const int32_t* __restrict__ reqs,
                          const int32_t* __restrict__ matrix,
                          int n_jobs, int go, int ge,
                          int32_t* __restrict__ best_out,
                          int32_t* __restrict__ col_out,
                          int32_t* __restrict__ row_out) {
  __shared__ int32_t Mt[32 * 32];  // Mt[t * 32 + q] = matrix[q][t]
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x)
    Mt[(k & 31) * 32 + (k >> 5)] = matrix[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (job >= n_jobs) return;
  const int32_t* J = jobs + JOB_COLS * job;
  const int t_off = J[0], t_len = J[1], d0 = J[2], band = J[3], req = J[4];
  const int q_off = reqs[2 * req], q_len = reqs[2 * req + 1];
  const int8_t* t = t_cat + t_off;
  const int8_t* q = q_cat + q_off;
  const int8_t* qb = bias_cat + q_off;
  const int r0 = lane * R;

  int H[R], E[R], P[R];
  unsigned inb = 0;  // bit k: row r0 + k lies in the band
#pragma unroll
  for (int k = 0; k < R; ++k) {
    H[k] = 0;
    E[k] = 0;
    if (r0 + k < band) inb |= 1u << k;
    P[k] = load_q(q, qb, q_len, d0 + r0 + k);  // column 0: i = d0 + r
  }
  // prefetch, one lane per column: the target letter of column j and the
  // query position that enters the window after column j (d0 + j + 32R)
  int tnext = lane < t_len ? (int(t[lane]) & 31) : 0;
  int qnext = load_q(q, qb, q_len, d0 + lane + 32 * R);
  int tword = 0, qword = 0;
  int lb = 0, lc = 0, lr = 0;
  for (int j = 0; j < t_len; ++j) {
    if ((j & 31) == 0) {  // take this block's words, load the next block's
      tword = tnext;
      qword = qnext;
      const int jj = j + 32 + lane;
      tnext = jj < t_len ? (int(t[jj]) & 31) : 0;
      qnext = load_q(q, qb, q_len, d0 + jj + 32 * R);
    }
    const int32_t* mrow = Mt + 32 * __shfl_sync(FULL, tword, j & 31);

    int s[R];
    unsigned valid = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool v = ((inb >> k) & 1u) && P[k] != INVALID;
      if (v) valid |= 1u << k;
      s[k] = v ? mrow[P[k] & 31] + (P[k] >> 5) : NEG;
    }
    warp_band::column<R>(H, E, s, valid, lane, r0, j, go, ge, lb, lc, lr);

    // slide the query window one row: row r now holds i = j + 1 + d0 + r
    int p_in = __shfl_down_sync(FULL, P[0], 1);
    const int p_new = __shfl_sync(FULL, qword, j & 31);
    if (lane == 31) p_in = p_new;
#pragma unroll
    for (int k = 0; k < R - 1; ++k) P[k] = P[k + 1];
    P[R - 1] = p_in;
  }
  const warp_band::Best res = warp_band::band_result(lb, lc, lr);
  if (lane == 0) {
    best_out[job] = res.best;
    col_out[job] = res.col;
    row_out[job] = res.row;
  }
}

template <int R>
int launch(const int8_t* t_cat, const int8_t* q_cat, const int8_t* bias_cat,
           const int32_t* jobs, const int32_t* reqs, const int32_t* matrix,
           int n_jobs, int go, int ge, int32_t* best, int32_t* col,
           int32_t* row, cudaStream_t stream) {
  const dim3 grid((n_jobs + WARPS - 1) / WARPS), block(WARPS * 32);
  banded_swipe_multi_kernel<R><<<grid, block, 0, stream>>>(
      t_cat, q_cat, bias_cat, jobs, reqs, matrix, n_jobs, go, ge, best, col,
      row);
  return 0;
}

using LaunchFn = int (*)(const int8_t*, const int8_t*, const int8_t*,
                         const int32_t*, const int32_t*, const int32_t*, int,
                         int, int, int32_t*, int32_t*, int32_t*,
                         cudaStream_t);

constexpr LaunchFn LAUNCH[16] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

// rows_per_lane R in 1..16: every job's band <= 32 R.
extern "C" int banded_swipe_multi_launch(
    int rows_per_lane, const void* t_cat, const void* q_cat,
    const void* bias_cat, const void* jobs, const void* reqs,
    const void* matrix, int n_jobs, int go, int ge, void* best, void* col,
    void* row, void* stream) {
  if (n_jobs <= 0) return 0;
  if (rows_per_lane < 1 || rows_per_lane > 16)
    return int(cudaErrorInvalidValue);
  LAUNCH[rows_per_lane - 1](
      static_cast<const int8_t*>(t_cat), static_cast<const int8_t*>(q_cat),
      static_cast<const int8_t*>(bias_cat),
      static_cast<const int32_t*>(jobs), static_cast<const int32_t*>(reqs),
      static_cast<const int32_t*>(matrix), n_jobs, go, ge,
      static_cast<int32_t*>(best), static_cast<int32_t*>(col),
      static_cast<int32_t*>(row), static_cast<cudaStream_t>(stream));
  return int(cudaGetLastError());
}
