// The extension's traceback refill (D4): banded local affine-gap DP that
// keeps four trace planes, then the walk back from the best cell, for a
// ragged batch of (query, target, band) jobs of many queries.  The kernel
// behind ops/traceback_device.banded_traceback_multi.
//
// Replaces the host C++ that both packages run in the traceback round,
// banded_swipe_tb_multi (diamond_tpu/native/src/banded_swipe.cc:369: the
// fill swipe_one, :38, and the walk walk_one, :189); no Pallas kernel did
// this work.  Same function, job for job: out (score, max_col, max_row),
// 12 stats (q_begin, q_end, s_begin, s_end, identities, mismatches,
// positives, gap openings, gaps, length, ops, ok) and the ops in walk
// order, each as swipe_one and walk_one give them (for jobs whose band
// starts below diagonal -(t_len - 1), as the numpy oracle gives them).
//
// What bounds it on the card: the fill's int32 ALU work (K1's 12
// operations a cell plus the four plane compares), and the walk's chain
// of dependent loads, one or two plane words a step.  The design:
//   - the fill is K1's (banded_swipe.cu): one warp per job, lane l holds
//     band rows [l*R, (l+1)*R) in registers, R = ceil(band / 32) a
//     template parameter (one launch per band class), the query window
//     sliding through registers, target letters and query positions
//     loaded 32 columns ahead, the matrix transposed in shared memory;
//     the column step is warp_band.cuh's (lazy F: one carry, the warp scan
//     only when a lane's gap rose; DPX max-plus), whose per-row hook
//     (PlaneWords) votes the planes from each row's H, F and E;
//   - only live columns run (the first with a row in the query to the
//     last), as swipe_one skips the dead ones; the walk reads none of the
//     others;
//   - each plane of a column is R ballots: word (j, p, k) holds band row
//     l*R + k at bit l, so lane k keeps word k and lanes 0..R-1 store a
//     plane's R words in one coalesced store: 4R words a column, planes
//     interleaved so that one step of the walk finds gapv and gaph of a
//     cell in one cache line;
//   - the walk is one thread's serial chain; it runs in lane 0 of the
//     fill's warp right after the fill, while the planes are in L2 (a
//     second kernel of one thread a job was timed in turns against it on
//     an H100 and was slower; chip_ab.py --kernel d4 --parent times a
//     layout against this one);
//   - ops go to per-job slots of t_len + q_len + 2 (a walk writes at most
//     q_len + t_len ops), then one launch copies each job's used ops to
//     the offsets the wrapper scanned from stats[k][10], so only those
//     cross to the host.
// The kernels allocate nothing, do not synchronise and launch on the
// caller's stream; each C entry point returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_band.cuh"

namespace {

constexpr int NEG = -(1 << 20);
constexpr int INVALID = INT32_MIN;  // packed query slot outside the query
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // warps (jobs) per block of the fill
constexpr int JOB_COLS = 7;         // q_off, q_len, use_bias, t_off, t_len,
                                    // d0, band
enum { GV = 0, GH = 1, OV = 2, OH = 3 };

struct Job {
  const int8_t* q;
  const int32_t* bias;  // nullptr: no bias
  const int8_t* t;
  int q_len, t_len, d0, band;
};

__device__ __forceinline__ Job load_job(const int64_t* __restrict__ jobs,
                                        int k, const int8_t* q_base,
                                        const int32_t* bias_base,
                                        const int8_t* t_cat) {
  const int64_t* J = jobs + (int64_t)JOB_COLS * k;
  Job b;
  b.q = q_base + J[0];
  b.q_len = int(J[1]);
  b.bias = J[2] ? bias_base + J[0] : nullptr;
  b.t = t_cat + J[3];
  b.t_len = int(J[4]);
  b.d0 = int(J[5]);
  b.band = int(J[6]);
  return b;
}

// Query letter and bias of query position i packed into one int
// (bias * 32 + letter; the wrapper keeps |bias| < 2^25), or INVALID
// outside [0, q_len).
__device__ __forceinline__ int load_q(const Job& b, int i) {
  if (i < 0 || i >= b.q_len) return INVALID;
  return (b.bias ? b.bias[i] * 32 : 0) + (int(b.q[i]) & 31);
}

// warp_band::column's per-row hook: the four planes' words of
// row-in-lane k, one ballot each, kept by lane k (k < R).  f is the F of
// the row (the vertical gap entering it), e its E on entry (the
// horizontal gap into it), h its new H.
struct PlaneWords {
  int go, ge, lane;
  unsigned word[4];
  __device__ __forceinline__ void operator()(int k, int h, int f, int e) {
    const int opn = max(h - go, 0);
    const unsigned gv = __ballot_sync(FULL, h == f);
    const unsigned gh = __ballot_sync(FULL, h == e);
    const unsigned ov = __ballot_sync(FULL, opn >= max(f - ge, 0));
    const unsigned oh = __ballot_sync(FULL, opn >= max(e - ge, 0));
    if (lane == k) {
      word[GV] = gv;
      word[GH] = gh;
      word[OV] = ov;
      word[OH] = oh;
    }
  }
};

// Bit of band row r in plane p at column j (word (j, p, r % R), bit r / R).
__device__ __forceinline__ unsigned plane_bit(const uint32_t* pl, int R,
                                              int p, int j, int r) {
  return (pl[((int64_t)j * 4 + p) * R + r % R] >> (r / R)) & 1u;
}

// walk_one: from the best cell, vertical gap > horizontal gap > diagonal;
// a gap run ends at the first set open bit (or i <= 0 / j <= 0).  Writes
// the ops at oc/op and the 12 stats; a walk whose summed score misses the
// best leaves stats 0 and stats[11] = 0.
__device__ void walk(const Job& b, const int32_t* __restrict__ matrix,
                     int go, int ge, const uint32_t* pl, long long best,
                     int max_col, int max_row, int8_t* __restrict__ oc,
                     int32_t* __restrict__ op, int64_t* __restrict__ st) {
  const int R = (b.band + 31) / 32;
  int i = max_row, j = max_col;
  long long score = 0;
  int64_t n_ops = 0, ident = 0, mism = 0, pos = 0, gapo = 0, gaps = 0,
          length = 0;
  bool ok = true;
  while (i >= 0 && j >= 0 && score < best) {
    const int r = i - j - b.d0;
    if (r < 0 || r >= b.band) {
      ok = false;
      break;
    }
    if (plane_bit(pl, R, GV, j, r)) {
      int l = 0;
      for (;;) {
        ++l;
        --i;
        const int rr = i - j - b.d0;
        if (rr < 0 || i <= 0 || (rr < b.band && plane_bit(pl, R, OV, j, rr)))
          break;
      }
      oc[n_ops] = 3;
      op[n_ops++] = l;
      ++gapo;
      gaps += l;
      length += l;
      score -= go + (long long)(l - 1) * ge;
    } else if (plane_bit(pl, R, GH, j, r)) {
      int l = 0;
      for (;;) {
        oc[n_ops] = 2;
        op[n_ops++] = int(b.t[j]) & 31;
        ++l;
        --j;
        const int rr = i - j - b.d0;
        if (rr >= b.band || j <= 0 || (rr >= 0 && plane_bit(pl, R, OH, j, rr)))
          break;
      }
      ++gapo;
      gaps += l;
      length += l;
      score -= go + (long long)(l - 1) * ge;
    } else {
      const int ql = int(b.q[i]) & 31, tl = int(b.t[j]) & 31;
      const int m = matrix[ql * 32 + tl];
      score += m + (b.bias ? b.bias[i] : 0);
      if (b.q[i] == b.t[j]) {
        oc[n_ops] = 0;
        op[n_ops++] = 1;
        ++ident;
        ++pos;
      } else {
        oc[n_ops] = 1;
        op[n_ops++] = tl;
        ++mism;
        if (m > 0) ++pos;
      }
      ++length;
      --i;
      --j;
    }
  }
  if (!ok || score != best) {
    for (int z = 0; z < 12; ++z) st[z] = 0;
    return;
  }
  st[0] = i + 1;
  st[1] = max_row + 1;
  st[2] = j + 1;
  st[3] = max_col + 1;
  st[4] = ident;
  st[5] = mism;
  st[6] = pos;
  st[7] = gapo;
  st[8] = gaps;
  st[9] = length;
  st[10] = n_ops;
  st[11] = 1;
}

// A job's best, with its stats for a score of 0 (ok, nothing to walk).
__device__ __forceinline__ void write_out(int64_t* out, int64_t* st, int k,
                                          const warp_band::Best& res,
                                          int d0) {
  out[3 * (int64_t)k] = res.best;
  out[3 * (int64_t)k + 1] = res.col;
  out[3 * (int64_t)k + 2] = (int64_t)res.col + d0 + res.row;
  if (res.best <= 0) {
    for (int z = 0; z < 11; ++z) st[12 * (int64_t)k + z] = 0;
    st[12 * (int64_t)k + 11] = 1;
  }
}

template <int R>
__global__ void __launch_bounds__(WARPS * 32)
tb_fill_kernel(const int8_t* __restrict__ q_base,
               const int32_t* __restrict__ bias_base,
               const int8_t* __restrict__ t_cat,
               const int64_t* __restrict__ jobs,
               const int32_t* __restrict__ order, int n,
               const int32_t* __restrict__ matrix, int go, int ge,
               uint32_t* __restrict__ planes,
               const int64_t* __restrict__ plane_off,
               const int64_t* __restrict__ slot_off,
               int8_t* __restrict__ codes, int32_t* __restrict__ payload,
               int64_t* __restrict__ out, int64_t* __restrict__ stats) {
  __shared__ int32_t Mt[32 * 32];  // Mt[t * 32 + q] = matrix[q][t]
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x)
    Mt[(k & 31) * 32 + (k >> 5)] = matrix[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n) return;
  const int job = order[w];
  const Job b = load_job(jobs, job, q_base, bias_base, t_cat);
  uint32_t* pl = planes + plane_off[job];
  const int r0 = lane * R;
  const int j_begin = max(0, -b.d0 - b.band + 1);
  const int j_end = min(b.t_len, b.q_len - b.d0);

  int H[R], E[R], P[R];
  unsigned inb = 0;  // bit k: row r0 + k lies in the band
#pragma unroll
  for (int k = 0; k < R; ++k) {
    H[k] = 0;
    E[k] = 0;
    if (r0 + k < b.band) inb |= 1u << k;
    P[k] = load_q(b, j_begin + b.d0 + r0 + k);
  }
  int tnext = j_begin + lane < j_end ? (int(b.t[j_begin + lane]) & 31) : 0;
  int qnext = load_q(b, b.d0 + j_begin + lane + 32 * R);
  int tword = 0, qword = 0;
  int lb = 0, lc = 0, lr = 0;
  for (int j = j_begin; j < j_end; ++j) {
    const int c = j - j_begin;
    if ((c & 31) == 0) {  // take this block's words, load the next block's
      tword = tnext;
      qword = qnext;
      const int jj = j + 32 + lane;
      tnext = jj < j_end ? (int(b.t[jj]) & 31) : 0;
      qnext = load_q(b, b.d0 + jj + 32 * R);
    }
    const int32_t* mrow = Mt + 32 * __shfl_sync(FULL, tword, c & 31);

    int s[R];
    unsigned valid = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool v = ((inb >> k) & 1u) && P[k] != INVALID;
      if (v) valid |= 1u << k;
      s[k] = v ? mrow[P[k] & 31] + (P[k] >> 5) : NEG;
    }
    PlaneWords pw{go, ge, lane, {0u, 0u, 0u, 0u}};
    warp_band::column<R>(H, E, s, valid, lane, r0, j, go, ge, lb, lc, lr,
                         pw);
    if (lane < R) {
      uint32_t* wj = pl + (int64_t)j * 4 * R + lane;
#pragma unroll
      for (int p = 0; p < 4; ++p) wj[p * R] = pw.word[p];
    }

    int p_in = __shfl_down_sync(FULL, P[0], 1);
    const int p_new = __shfl_sync(FULL, qword, c & 31);
    if (lane == 31) p_in = p_new;
#pragma unroll
    for (int k = 0; k < R - 1; ++k) P[k] = P[k + 1];
    P[R - 1] = p_in;
  }
  const warp_band::Best res = warp_band::band_result(lb, lc, lr);
  if (lane == 0) write_out(out, stats, job, res, b.d0);
  __syncwarp();  // lanes 0..R-1 stored the planes lane 0 now reads
  if (lane == 0 && res.best > 0)
    walk(b, matrix, go, ge, pl, res.best, res.col, res.col + b.d0 + res.row,
         codes + slot_off[job], payload + slot_off[job],
         stats + 12 * (int64_t)job);
}

// Each job's used ops (stats[k][10]) from its slots to op_off[k]: one warp
// per job.
__global__ void tb_compact_kernel(int n, const int64_t* __restrict__ stats,
                                  const int64_t* __restrict__ slot_off,
                                  const int64_t* __restrict__ op_off,
                                  const int8_t* __restrict__ slot_codes,
                                  const int32_t* __restrict__ slot_payload,
                                  int8_t* __restrict__ codes,
                                  int32_t* __restrict__ payload) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (k >= n) return;
  const int64_t m = stats[12 * (int64_t)k + 10];
  const int64_t src = slot_off[k], dst = op_off[k];
  for (int64_t x = lane; x < m; x += 32) {
    codes[dst + x] = slot_codes[src + x];
    payload[dst + x] = slot_payload[src + x];
  }
}

template <int R>
void launch_fill(const int8_t* q, const int32_t* bias, const int8_t* t,
                 const int64_t* jobs, const int32_t* order, int n,
                 const int32_t* m, int go, int ge, uint32_t* planes,
                 const int64_t* plane_off, const int64_t* slot_off,
                 int8_t* codes, int32_t* payload, int64_t* out,
                 int64_t* stats, cudaStream_t stream) {
  const dim3 grid((n + WARPS - 1) / WARPS), block(WARPS * 32);
  tb_fill_kernel<R><<<grid, block, 0, stream>>>(
      q, bias, t, jobs, order, n, m, go, ge, planes, plane_off, slot_off,
      codes, payload, out, stats);
}

using FillFn = void (*)(const int8_t*, const int32_t*, const int8_t*,
                        const int64_t*, const int32_t*, int, const int32_t*,
                        int, int, uint32_t*, const int64_t*, const int64_t*,
                        int8_t*, int32_t*, int64_t*, int64_t*, cudaStream_t);

constexpr FillFn FILL[16] = {
    launch_fill<1>,  launch_fill<2>,  launch_fill<3>,  launch_fill<4>,
    launch_fill<5>,  launch_fill<6>,  launch_fill<7>,  launch_fill<8>,
    launch_fill<9>,  launch_fill<10>, launch_fill<11>, launch_fill<12>,
    launch_fill<13>, launch_fill<14>, launch_fill<15>, launch_fill<16>};

}  // namespace

// The fill and walk of the n jobs order[0..n), all of band class
// rows_per_lane R (1..16: every band <= 32 R).
extern "C" int tb_fill_launch(int rows_per_lane, const void* q_base,
                              const void* bias_base, const void* t_cat,
                              const void* jobs, const void* order, int n,
                              const void* matrix, int go, int ge,
                              void* planes, const void* plane_off,
                              const void* slot_off, void* codes,
                              void* payload, void* out, void* stats,
                              void* stream) {
  if (n <= 0) return 0;
  if (rows_per_lane < 1 || rows_per_lane > 16)
    return int(cudaErrorInvalidValue);
  FILL[rows_per_lane - 1](
      static_cast<const int8_t*>(q_base),
      static_cast<const int32_t*>(bias_base),
      static_cast<const int8_t*>(t_cat), static_cast<const int64_t*>(jobs),
      static_cast<const int32_t*>(order), n,
      static_cast<const int32_t*>(matrix), go, ge,
      static_cast<uint32_t*>(planes), static_cast<const int64_t*>(plane_off),
      static_cast<const int64_t*>(slot_off), static_cast<int8_t*>(codes),
      static_cast<int32_t*>(payload), static_cast<int64_t*>(out),
      static_cast<int64_t*>(stats), static_cast<cudaStream_t>(stream));
  return int(cudaGetLastError());
}

// The used ops of n jobs to their scanned offsets.
extern "C" int tb_compact_launch(int n, const void* stats,
                                 const void* slot_off, const void* op_off,
                                 const void* slot_codes,
                                 const void* slot_payload, void* codes,
                                 void* payload, void* stream) {
  if (n <= 0) return 0;
  const int warps = 8;
  tb_compact_kernel<<<(n + warps - 1) / warps, warps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int64_t*>(stats),
      static_cast<const int64_t*>(slot_off),
      static_cast<const int64_t*>(op_off),
      static_cast<const int8_t*>(slot_codes),
      static_cast<const int32_t*>(slot_payload), static_cast<int8_t*>(codes),
      static_cast<int32_t*>(payload));
  return int(cudaGetLastError());
}
