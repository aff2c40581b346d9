// Score-only full-matrix Smith-Waterman for every (query, target) pair of a
// launch: the Hopper kernel behind ops/swipe_device.FullSweep (--swipe).
//
// Replaces the TPU kernel diamond_tpu/ops/swipe_device.py:735-832
// (_make_kernel_full + full_swipe_pallas_sweep).  Same function, pair for
// pair: local affine-gap DP over the whole q_len x t_len matrix, state
// indexed by query row, profile matrix[q][t] + bias[i], F by lazy prefix
// max, H, E and F floored at 0; output the best score only.  That equals
// ops/banded_swipe.banded_swipe_batch_np with the band [-(t_len-1), q_len).
//
// What bounds it on the card: int32 ALU work.  The recurrence needs 11
// int32 operations per cell and the DP state (H and E of one column of a
// strip) stays in registers; each column reads one target letter, so
// device-memory traffic is one byte per column against 11 x q_len
// operations.  Tensor cores do not apply (max-plus).  What the design does
// about it:
//   - one warp per pair; lane l holds query rows [l*R, (l+1)*R) of a strip
//     of 32*R rows in registers (R a template parameter, 1..16, chosen per
//     query so that a strip wastes fewer than 32 rows), and walks the target
//     one column per step;
//   - a query longer than 512 rows takes several strips; the strip's last
//     row (H, and the vertical gap leaving it) is written per column to the
//     pair's scratch, and the next strip's lane 0 reads it back 32 columns at
//     a time, so no query-length cap follows from registers;
//   - the diagonal moves down one row by one __shfl_up_sync, F by an in-lane
//     scan plus a 5-step __shfl_up_sync scan; E stays in place (row-indexed);
//   - the 32x32 matrix sits transposed in shared memory, so 32 lanes reading
//     one target letter's row by their query letters hit distinct banks;
//   - each lane keeps its own best, reduced once at the end;
//   - the caller orders pairs by the cells a warp walks, most first, so long
//     warps start first and short ones fill in behind them.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int INVALID = INT32_MIN;  // query row outside the query
constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 20);
constexpr int WARPS = 4;            // warps (pairs) per block

// Query letter and bias of row i packed into one int (bias * 32 + letter),
// or INVALID outside [0, q_len).
__device__ __forceinline__ int load_q(const int8_t* __restrict__ q,
                                      const int8_t* __restrict__ qb,
                                      int q_len, int i) {
  if (i >= q_len) return INVALID;
  return int(qb[i]) * 32 + (int(q[i]) & 31);
}

template <int R>
__global__ void __launch_bounds__(WARPS * 32)
full_swipe_kernel(const int8_t* __restrict__ t_cat,
                  const int32_t* __restrict__ targets,
                  const int8_t* __restrict__ q_cat,
                  const int8_t* __restrict__ bias_cat,
                  const int32_t* __restrict__ reqs,
                  const int32_t* __restrict__ pairs,
                  const int32_t* __restrict__ matrix, int n_pairs,
                  int n_out_cols, int go, int ge, int2* __restrict__ scratch,
                  int t_letters, int32_t* __restrict__ out) {
  __shared__ int32_t Mt[32 * 32];  // Mt[t * 32 + q] = matrix[q][t]
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x)
    Mt[(k & 31) * 32 + (k >> 5)] = matrix[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;
  const int req = pairs[2 * pair], tgt = pairs[2 * pair + 1];
  const int q_off = reqs[3 * req], q_len = reqs[3 * req + 1];
  const int slot = reqs[3 * req + 2];
  const int t_off = targets[2 * tgt], t_len = targets[2 * tgt + 1];
  const int8_t* t = t_cat + t_off;
  const int8_t* q = q_cat + q_off;
  const int8_t* qb = bias_cat + q_off;
  constexpr int ROWS = 32 * R;
  const int strips = (q_len + ROWS - 1) / ROWS;
  // strip carries: buffer (s & 1) holds strip s's last row per column
  int2* carry0 = nullptr;
  int2* carry1 = nullptr;
  if (slot >= 0) {
    carry0 = scratch + (size_t(slot) * 2) * t_letters + t_off;
    carry1 = carry0 + t_letters;
  }

  int lbest = 0;
  for (int s = 0; s < strips; ++s) {
    const int r0 = s * ROWS + lane * R;
    int H[R], E[R], P[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      H[k] = 0;
      E[k] = 0;
      P[k] = load_q(q, qb, q_len, r0 + k);
    }
    const int2* cin = s > 0 ? ((s - 1) & 1 ? carry1 : carry0) : nullptr;
    int2* cout = s + 1 < strips ? (s & 1 ? carry1 : carry0) : nullptr;
    int tword = 0;
    int2 cword = make_int2(0, 0);
    int d_prev = 0;  // H of the row above the strip, previous column
    for (int j = 0; j < t_len; ++j) {
      const int src = j & 31;
      if (src == 0) {  // 32 target letters (and carries), one per lane
        const int jj = j + lane;
        tword = jj < t_len ? (int(t[jj]) & 31) : 0;
        if (cin) cword = jj < t_len ? cin[jj] : make_int2(0, 0);
      }
      const int32_t* mrow = Mt + 32 * __shfl_sync(FULL, tword, src);
      int c_h = 0, c_f = 0;  // the strip above: its last row's H and F
      if (cin) {             // warp-uniform
        c_h = __shfl_sync(FULL, cword.x, src);
        c_f = __shfl_sync(FULL, cword.y, src);
      }

      // diagonal: H of row i - 1 at the previous column
      int d_in = __shfl_up_sync(FULL, H[R - 1], 1);
      if (lane == 0) d_in = d_prev;
      // g = cur0 - go + row * ge, prefix max over the strip; the gap the
      // strip above leaves (c_f, entering row 0) starts lane 0's scan as
      // the term of row -1, so the warp scan carries it to every lane
      int cur0[R], g[R];
      int run = lane == 0 ? c_f - ge : NEG;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int diag = k == 0 ? d_in : H[k - 1];
        const int sc = P[k] != INVALID ? mrow[P[k] & 31] + (P[k] >> 5) : NEG;
        cur0[k] = max(max(diag + sc, E[k]), 0);
        run = max(run, cur0[k] - go + (lane * R + k) * ge);
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
      // F[k]: the vertical gap leaving row k (entering row k + 1)
      int F[R];
#pragma unroll
      for (int k = 0; k < R; ++k)
        F[k] = max(max(g[k], excl) - (lane * R + k) * ge, 0);
      int f_in = __shfl_up_sync(FULL, F[R - 1], 1);
      if (lane == 0) f_in = c_f;

#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int fs = k == 0 ? f_in : F[k - 1];
        const int hn = P[k] != INVALID ? max(cur0[k], fs) : 0;
        lbest = max(lbest, hn);
        E[k] = max(max(E[k] - ge, hn - go), 0);
        H[k] = hn;
      }
      if (cout && lane == 31) cout[j] = make_int2(H[R - 1], F[R - 1]);
      d_prev = c_h;
    }
    __syncwarp();  // this strip's carries are read by the next
  }
  const int best = __reduce_max_sync(FULL, lbest);
  if (lane == 0) out[size_t(req) * n_out_cols + tgt] = best;
}

template <int R>
void launch(const int8_t* t_cat, const int32_t* targets, const int8_t* q_cat,
            const int8_t* bias_cat, const int32_t* reqs, const int32_t* pairs,
            const int32_t* matrix, int n_pairs, int n_out_cols, int go,
            int ge, int2* scratch, int t_letters, int32_t* out,
            cudaStream_t stream) {
  const dim3 grid((n_pairs + WARPS - 1) / WARPS), block(WARPS * 32);
  full_swipe_kernel<R><<<grid, block, 0, stream>>>(
      t_cat, targets, q_cat, bias_cat, reqs, pairs, matrix, n_pairs,
      n_out_cols, go, ge, scratch, t_letters, out);
}

using LaunchFn = void (*)(const int8_t*, const int32_t*, const int8_t*,
                          const int8_t*, const int32_t*, const int32_t*,
                          const int32_t*, int, int, int, int, int2*, int,
                          int32_t*, cudaStream_t);

constexpr LaunchFn LAUNCH[16] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

extern "C" int full_swipe_launch(int rows_per_lane, const void* t_cat,
                                 const void* targets, const void* q_cat,
                                 const void* bias_cat, const void* reqs,
                                 const void* pairs, const void* matrix,
                                 int n_pairs, int n_out_cols, int go, int ge,
                                 void* scratch, int t_letters, void* out,
                                 void* stream) {
  if (n_pairs <= 0) return 0;
  if (rows_per_lane < 1 || rows_per_lane > 16)
    return int(cudaErrorInvalidValue);
  LAUNCH[rows_per_lane - 1](
      static_cast<const int8_t*>(t_cat), static_cast<const int32_t*>(targets),
      static_cast<const int8_t*>(q_cat), static_cast<const int8_t*>(bias_cat),
      static_cast<const int32_t*>(reqs), static_cast<const int32_t*>(pairs),
      static_cast<const int32_t*>(matrix), n_pairs, n_out_cols, go, ge,
      static_cast<int2*>(scratch), t_letters, static_cast<int32_t*>(out),
      static_cast<cudaStream_t>(stream));
  return int(cudaGetLastError());
}
