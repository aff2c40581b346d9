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
// int32 max/add operations per cell (the lazy-F scan below spends a few
// more); the whole DP state (H and E for one column of the band) lives in
// registers, and each column reads one target letter per job, so
// device-memory traffic is a few bytes per column against band x 12
// operations.  Tensor cores do not apply (max-plus, not
// multiply-add).  What the design does about it:
//   - one warp per job; lane l holds band rows [l*R, (l+1)*R) in
//     registers, R a template parameter (one launch per band class:
//     R = 1/2/4/8/16 for band <= 32/64/128/256/512), so a job's columns
//     run without touching memory except for one letter;
//   - the query window slides one row per column through registers and a
//     __shfl_down_sync, the lazy-F prefix max is an in-lane scan plus a
//     5-step __shfl_up_sync scan, the E row shift is one __shfl_down_sync;
//   - the score lookup reads the 32x32 matrix, stored transposed in shared
//     memory (4 KB): for one target letter the 32 lanes read one row
//     indexed by their query letters, which falls in distinct banks;
//   - the column maximum is one __reduce_max_sync; its row is only found
//     when the best score rises;
//   - jobs are ordered longest first by the caller, so long warps start
//     first and short ones fill in behind them.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

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
  bool inb[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    H[k] = 0;
    E[k] = 0;
    inb[k] = r0 + k < band;
    P[k] = load_q(q, qb, q_len, d0 + r0 + k);  // column 0: i = d0 + r
  }
  int best = 0, max_col = 0, max_row = 0;
  int tword = 0;
  for (int j = 0; j < t_len; ++j) {
    if ((j & 31) == 0) {  // 32 target letters, one per lane
      const int jj = j + lane;
      tword = jj < t_len ? (int(t[jj]) & 31) : 0;
    }
    const int32_t* mrow = Mt + 32 * __shfl_sync(FULL, tword, j & 31);

    // cur0 = max(H + s, E, 0); in-lane inclusive prefix max of
    // g = cur0 - go + r * ge
    int cur0[R], g[R];
    bool valid[R];
    int run = NEG;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      valid[k] = inb[k] && P[k] != INVALID;
      const int s = valid[k] ? mrow[P[k] & 31] + (P[k] >> 5) : NEG;
      cur0[k] = max(max(H[k] + s, E[k]), 0);
      run = max(run, cur0[k] - go + (r0 + k) * ge);
      g[k] = run;
    }
    // warp scan of the lane totals -> exclusive prefix for this lane
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEG;
    // F[r] = max(prefix max - r * ge, 0), used one row down
    int F[R];
#pragma unroll
    for (int k = 0; k < R; ++k)
      F[k] = max(max(g[k], excl) - (r0 + k) * ge, 0);
    int f_in = __shfl_up_sync(FULL, F[R - 1], 1);
    if (lane == 0) f_in = 0;

    int lmax = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int fs = k == 0 ? f_in : F[k - 1];
      H[k] = valid[k] ? max(cur0[k], fs) : 0;
      lmax = max(lmax, H[k]);
    }
    const int cbest = __reduce_max_sync(FULL, lmax);
    if (cbest > best) {  // warp-uniform
      int lrow = -1;
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (H[k] == cbest) lrow = r0 + k;  // highest row of the tie
      max_row = __reduce_max_sync(FULL, lrow);
      best = cbest;
      max_col = j;
    }

    // E for the next column: E_out of the row above (same query index)
    int Eo[R];
#pragma unroll
    for (int k = 0; k < R; ++k) Eo[k] = max(max(E[k] - ge, H[k] - go), 0);
    int e_in = __shfl_down_sync(FULL, Eo[0], 1);
    if (lane == 31) e_in = 0;
#pragma unroll
    for (int k = 0; k < R - 1; ++k) E[k] = Eo[k + 1];
    E[R - 1] = e_in;

    // slide the query window one row: row r now holds i = j + 1 + d0 + r
    int p_in = __shfl_down_sync(FULL, P[0], 1);
    if (lane == 31) p_in = load_q(q, qb, q_len, j + d0 + 32 * R);
#pragma unroll
    for (int k = 0; k < R - 1; ++k) P[k] = P[k + 1];
    P[R - 1] = p_in;
  }
  if (lane == 0) {
    best_out[job] = best;
    col_out[job] = max_col;
    row_out[job] = max_row;
  }
}

template <int R>
void launch(const int8_t* t_cat, const int8_t* q_cat, const int8_t* bias_cat,
            const int32_t* jobs, const int32_t* reqs, const int32_t* matrix,
            int n_jobs, int go, int ge, int32_t* best, int32_t* col,
            int32_t* row, cudaStream_t stream) {
  const dim3 grid((n_jobs + WARPS - 1) / WARPS), block(WARPS * 32);
  banded_swipe_multi_kernel<R><<<grid, block, 0, stream>>>(
      t_cat, q_cat, bias_cat, jobs, reqs, matrix, n_jobs, go, ge, best, col,
      row);
}

}  // namespace

extern "C" int banded_swipe_multi_launch(
    int rows_per_lane, const void* t_cat, const void* q_cat,
    const void* bias_cat, const void* jobs, const void* reqs,
    const void* matrix, int n_jobs, int go, int ge, void* best, void* col,
    void* row, void* stream) {
  if (n_jobs <= 0) return 0;
  auto tc = static_cast<const int8_t*>(t_cat);
  auto qc = static_cast<const int8_t*>(q_cat);
  auto bc = static_cast<const int8_t*>(bias_cat);
  auto jb = static_cast<const int32_t*>(jobs);
  auto rq = static_cast<const int32_t*>(reqs);
  auto mx = static_cast<const int32_t*>(matrix);
  auto b = static_cast<int32_t*>(best);
  auto c = static_cast<int32_t*>(col);
  auto r = static_cast<int32_t*>(row);
  auto s = static_cast<cudaStream_t>(stream);
  switch (rows_per_lane) {
    case 1: launch<1>(tc, qc, bc, jb, rq, mx, n_jobs, go, ge, b, c, r, s); break;
    case 2: launch<2>(tc, qc, bc, jb, rq, mx, n_jobs, go, ge, b, c, r, s); break;
    case 4: launch<4>(tc, qc, bc, jb, rq, mx, n_jobs, go, ge, b, c, r, s); break;
    case 8: launch<8>(tc, qc, bc, jb, rq, mx, n_jobs, go, ge, b, c, r, s); break;
    case 16: launch<16>(tc, qc, bc, jb, rq, mx, n_jobs, go, ge, b, c, r, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
