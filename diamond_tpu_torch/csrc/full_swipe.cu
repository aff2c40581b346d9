// Score-only full-matrix Smith-Waterman for every (query, target) pair of a
// launch: the Hopper kernel behind ops/swipe_device.FullSweep (--swipe).
//
// Replaces the TPU kernel diamond_tpu/ops/swipe_device.py:735-832
// (_make_kernel_full + full_swipe_pallas_sweep).  Same function, pair for
// pair: local affine-gap DP over the whole q_len x t_len matrix, state
// indexed by query row, profile matrix[q][t] + bias[i], H, E and F floored
// at 0; output the best score only.  That equals
// ops/banded_swipe.banded_swipe_batch_np with the band [-(t_len-1), q_len).
//
// What bounds it on the card: int32 ALU issue.  The DP state (H and E of
// one column of a strip) stays in registers and each column reads one
// target letter, so device-memory traffic is one byte per column against
// q_len cells of work.  Tensor cores do not apply (max-plus).  What the
// design does about it:
//   - one warp per pair; lane l holds query rows [l*R, (l+1)*R) of a strip
//     of 32*R rows in registers (R a template parameter, 1..16, chosen per
//     query so that a strip wastes fewer than 32 rows), and walks the target
//     one column per step;
//   - a query longer than 512 rows takes several strips; the strip's last
//     row (H, and the vertical gap leaving it) is written per column to the
//     pair's scratch, and the next strip's lane 0 reads it back 32 columns at
//     a time, so no query-length cap follows from registers;
//   - the column step (column() below): the diagonal moves down one row by
//     one __shfl_up_sync, E stays in place (row-indexed), and the vertical
//     gap F crosses lanes lazily, as in warp_band.cuh: each lane runs its R
//     rows with nothing entering, one shuffle hands its outgoing F to the
//     next lane (lane 0 takes the gap the strip above leaves), and only when
//     an __any_sync vote finds a lane whose outgoing F rose does a 5-step
//     max-plus warp scan carry the gaps on;
//   - the max-plus steps are Hopper's DPX instructions (__viaddmax_s32_relu
//     = max(a + b, c, 0), __viaddmax_s32, __vimax3_s32), and cur0 - go is
//     computed once per cell for both passes of F;
//   - the score of a cell is one shared-memory load at an immediate
//     offset: the block's WARPS warps walk pairs of one query (FullSweep
//     packs them so), and before each strip the block writes that strip's
//     query profile to shared memory, int16 with the bias folded in (a
//     matrix entry plus an int8 bias; FullSweep holds the matrix within
//     +-16,000), laid out [target letter][k][lane] so that 32 lanes read 32
//     consecutive halves; a block whose warps hold several queries takes
//     one round per query;
//   - rows past q_len in the last strip score NEG16 and run unmasked.  No
//     value flows up out of them: the diagonal and F move down a row, E
//     stays in its row, and a strip with padding rows is the query's last,
//     so it carries nothing on.  Their own H never raises the best: with a
//     score <= 0, a padding row's H is at most the largest of the diagonal
//     H above it, its E and the F entering it, and each of those is at most
//     an H already counted (F and E at most go below one), so the best, a
//     maximum, is unchanged;
//   - each lane keeps its own best, reduced once at the end;
//   - the caller orders pairs by the cells a warp walks, most first, so long
//     warps start first and short ones fill in behind them.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG16 = -(1 << 14);   // profile score past the query
constexpr int WARPS = 4;            // warps (pairs) per block

// One target column of a strip: H, E updated in place; sc[k] the score of
// row r0 + k; d_in the H entering row r0 from above at the previous column;
// c_f the F the strip above leaves (lane 0 only).  Returns F leaving the
// lane's last row.
template <int R>
__device__ __forceinline__ int column(int (&H)[R], int (&E)[R],
                                      const int (&sc)[R], int d_in, int c_f,
                                      int lane, int go, int ge, int& lbest) {
  int cur0[R], T[R];
  int fo = 0;  // the lane's outgoing F with nothing entering its first row
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int diag = k == 0 ? d_in : H[k - 1];
    cur0[k] = __viaddmax_s32_relu(diag, sc[k], E[k]);
    T[k] = cur0[k] - go;
    fo = __viaddmax_s32_relu(fo, -ge, T[k]);
  }
  // the previous lane's outgoing F (the strip above's, for lane 0) enters
  // this lane's first row
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
    const int hn = max(cur0[k], f);
    f = __viaddmax_s32_relu(f, -ge, T[k]);
    E[k] = __viaddmax_s32_relu(E[k], -ge, hn - go);
    H[k] = hn;
  }
#pragma unroll
  for (int k = 0; k + 1 < R; k += 2)
    lbest = __vimax3_s32(lbest, H[k], H[k + 1]);
  if (R & 1) lbest = max(lbest, H[R - 1]);
  return f;
}

// Walks strip s of one pair against the whole target: lane l's rows
// s * 32R + l * R .. + R - 1, their scores from the strip's query profile
// prof[(a * R + k) * 32 + l] (target letter a, row l * R + k); cin the strip
// above's carries (or null), cout this strip's (or null).
template <int R>
__device__ __forceinline__ void walk_strip(const int16_t* prof,
                                           const int8_t* __restrict__ t,
                                           int t_len, const int2* cin,
                                           int2* cout, int lane, int go,
                                           int ge, int& lbest) {
  int H[R], E[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    H[k] = 0;
    E[k] = 0;
  }
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
    const int16_t* p = prof + __shfl_sync(FULL, tword, src) * (32 * R) + lane;
    int c_h = 0, c_f = 0;  // the strip above: its last row's H and F
    if (cin) {             // warp-uniform
      c_h = __shfl_sync(FULL, cword.x, src);
      c_f = __shfl_sync(FULL, cword.y, src);
    }
    // diagonal: H of row i - 1 at the previous column
    int d_in = __shfl_up_sync(FULL, H[R - 1], 1);
    if (lane == 0) d_in = d_prev;
    int sc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) sc[k] = p[k * 32];
    const int f_out = column<R>(H, E, sc, d_in, c_f, lane, go, ge, lbest);
    if (cout && lane == 31) cout[j] = make_int2(H[R - 1], f_out);
    d_prev = c_h;
  }
  __syncwarp();  // this strip's carries are read by the next
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
  constexpr int ROWS = 32 * R;
  __shared__ int32_t Mt[32 * 32];  // Mt[t * 32 + q] = matrix[q][t]
  __shared__ int16_t prof[32 * ROWS];
  __shared__ int sreq[WARPS];
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x)
    Mt[(k & 31) * 32 + (k >> 5)] = matrix[k];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * WARPS + warp;
  const bool active = pair < n_pairs;
  const int req = active ? pairs[2 * pair] : -1;
  const int tgt = active ? pairs[2 * pair + 1] : 0;
  if (lane == 0) sreq[warp] = req;
  __syncthreads();
  const int t_off = active ? targets[2 * tgt] : 0;
  const int t_len = active ? targets[2 * tgt + 1] : 0;
  int lbest = 0;
  // one round per distinct query of the block (one when FullSweep packed
  // it); every warp of the block builds the profiles, the query's walk
  for (int w0 = 0; w0 < WARPS; ++w0) {
    const int qr = sreq[w0];
    bool seen = qr < 0;
    for (int w = 0; w < w0; ++w) seen |= sreq[w] == qr;
    if (seen) continue;  // block-uniform
    const int q_off = reqs[3 * qr], q_len = reqs[3 * qr + 1];
    const int slot = reqs[3 * qr + 2];
    const int8_t* q = q_cat + q_off;
    const int8_t* qb = bias_cat + q_off;
    const int strips = (q_len + ROWS - 1) / ROWS;
    // strip carries: buffer (s & 1) holds strip s's last row per column
    int2* carry0 = nullptr;
    int2* carry1 = nullptr;
    if (slot >= 0) {
      carry0 = scratch + (size_t(slot) * 2) * t_letters + t_off;
      carry1 = carry0 + t_letters;
    }
    for (int s = 0; s < strips; ++s) {
      __syncthreads();  // no warp reads the previous strip's profile
      for (int e = threadIdx.x; e < ROWS; e += blockDim.x) {
        const int l = e & 31, k = e >> 5;  // strip row l * R + k
        const int r = s * ROWS + l * R + k;
        int16_t* p = prof + k * 32 + l;
        if (r < q_len) {
          const int32_t* mc = Mt + (int(q[r]) & 31);
          const int b = qb[r];
#pragma unroll 8
          for (int a = 0; a < 32; ++a) p[a * ROWS] = int16_t(mc[a * 32] + b);
        } else {
#pragma unroll 8
          for (int a = 0; a < 32; ++a) p[a * ROWS] = int16_t(NEG16);
        }
      }
      __syncthreads();
      if (req != qr) continue;
      const int2* cin = s > 0 ? ((s - 1) & 1 ? carry1 : carry0) : nullptr;
      int2* cout = s + 1 < strips ? (s & 1 ? carry1 : carry0) : nullptr;
      walk_strip<R>(prof, t_cat + t_off, t_len, cin, cout, lane, go, ge,
                    lbest);
    }
  }
  if (!active) return;
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
