// Score-only banded 3-frame Smith-Waterman over a ragged batch of jobs: the
// Hopper kernel behind ops/swipe3_device.banded_swipe3 (blastx -F and
// --long-reads).
//
// Replaces the TPU kernel diamond_tpu/ops/swipe3_pallas.py:51-157
// (_make_kernel3 + banded_swipe3_pallas).  Same function, job for job
// (ops/swipe3._forward_np): the band interleaves the three frame
// translations of one query strand, row r = 3 * query offset + frame, and
// moves one query position per target column.  A cell takes the max of the
// same-frame diagonal (row r of the previous column) + s, rows r - 1 and
// r + 1 of the previous column + s - fs, the horizontal gap state of row
// r + 3 of the previous column, the frame's vertical gap (lazy prefix max
// over rows r - 3, r - 6, ...) and 0.  Reads past the band's ends are 0 (the
// reference's zero padding).  Outputs (best, max_col): max_col is the first
// column where the best rises strictly, -1 when nothing scores.
//
// What bounds it on the card: int32 ALU work.  The recurrence needs 15 int32
// operations per cell and the whole DP state (S and the horizontal-gap state
// for one column of the band) stays in registers; each column reads one
// target letter and one query position's three letters, so device-memory
// traffic is a few bytes per column against 3 x band x 15 operations.
// Tensor cores do not apply (max-plus).  A job's columns form one serial
// chain, so the kernel is only as fast as that chain is short and as many
// chains as the card holds run at once.  What the design does about it:
//   - the caller batches the score-only jobs of many reads into one launch
//     per band class, longest first, so thousands of warps fill the card;
//   - one warp per job; lane l owns query offsets [l*K, (l+1)*K) with all
//     three frame rows of each (K a template parameter, one launch per band
//     class: K = 1/2/4/8/16 for band <= 32/64/128/256/512 offsets), so the
//     frame rows r - 1, r + 1 and r + 3 are in the lane except at its ends:
//     one shuffle each for r - 1 and r + 1, three for r + 3;
//   - the vertical gap is a lazy F: each lane runs its K offsets with
//     nothing entering, takes the previous lane's outgoing F (one shuffle
//     per frame) and votes (__any_sync) whether that raised any lane's
//     outgoing F; only then a 5-step warp scan carries the gaps on, exactly
//     (repeating the one-lane carry until no lane rises was slower: a gap
//     of BLOSUM62's extension cost 1 crosses several lanes, so most columns
//     took several votes).  The F values are clamped at 0, which changes no
//     H (every H candidate is >= 0);
//   - target letters and packed query positions come 32 columns at a time,
//     one per lane, loaded one block of 32 columns ahead, and reach the warp
//     by __shfl_sync: no device-memory load sits on the column's chain.  The
//     query window slides one offset per column through registers and a
//     __shfl_down_sync; the three letters of an offset and which frames are
//     valid there (the stop row of _forward_np) are packed in one int;
//   - the max-plus steps use Hopper's DPX instructions (__vimax3_s32_relu,
//     __viaddmax_s32, __viaddmax_s32_relu);
//   - the 32x32 matrix sits transposed in shared memory, so 32 lanes reading
//     one target letter's row by their query letters hit distinct banks;
//   - each lane keeps its own best and the first column it was reached; one
//     max and one min reduction at the end give (best, max_col), so no
//     reduction runs per column.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;        // warps (jobs) per block
constexpr int JOB_COLS = 5;     // t_off, t_len, i0, band, req
constexpr int REQ_COLS = 4;     // q_off, len0, len1, len2

// The three frame letters of query position i (5 bits each) and, in bits
// 15-17, which frames are computed there: frame f at i is valid when
// 0 <= i < len0 and 3 * i + f < stop.  0 outside the query.
__device__ __forceinline__ int load_q3(const int8_t* __restrict__ q0,
                                       const int8_t* __restrict__ q1,
                                       const int8_t* __restrict__ q2,
                                       int len0, int stop, int i) {
  if (i < 0 || i >= len0) return 0;
  const int a = 3 * i;
  int w = int(q0[i]) & 31;
  int m = a < stop ? 1 : 0;
  if (a + 1 < stop) {  // implies i < len1
    w |= (int(q1[i]) & 31) << 5;
    m |= 2;
  }
  if (a + 2 < stop) {  // implies i < len2
    w |= (int(q2[i]) & 31) << 10;
    m |= 4;
  }
  return w | (m << 15);
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
banded_swipe3_kernel(const int8_t* __restrict__ t_cat,
                     const int8_t* __restrict__ q_cat,
                     const int32_t* __restrict__ jobs,
                     const int32_t* __restrict__ reqs,
                     const int32_t* __restrict__ matrix, int n_jobs, int go,
                     int ge, int fs, int32_t* __restrict__ best_out,
                     int32_t* __restrict__ col_out) {
  __shared__ int32_t Mt[32 * 32];  // Mt[t * 32 + q] = matrix[q][t]
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x)
    Mt[(k & 31) * 32 + (k >> 5)] = matrix[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (job >= n_jobs) return;
  const int32_t* J = jobs + JOB_COLS * job;
  const int t_off = J[0], t_len = J[1], i0 = J[2], band = J[3], req = J[4];
  const int32_t* Rq = reqs + REQ_COLS * req;
  const int len0 = Rq[1], len1 = Rq[2], len2 = Rq[3];
  const int stop = min(3 * len1 + 1, 3 * len2 + 2);
  const int8_t* q0 = q_cat + Rq[0];
  const int8_t* q1 = q0 + len0;
  const int8_t* q2 = q1 + len1;
  const int8_t* t = t_cat + t_off;
  const int o0 = lane * K;
  const int kge = K * ge;  // decay of a vertical gap across one lane

  int S[K][3], Hg[K][3], P[K];
  unsigned inb = 0;  // bit k: offset o0 + k lies in the band
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (o0 + k < band) inb |= 1u << k;
    P[k] = load_q3(q0, q1, q2, len0, stop, i0 + o0 + k);  // column 0
#pragma unroll
    for (int f = 0; f < 3; ++f) S[k][f] = Hg[k][f] = 0;
  }
  // prefetch, one lane per column: the target letter of column j and the
  // query position that enters the window after column j (i0 + j + 32K)
  int tnext = lane < t_len ? (int(t[lane]) & 31) : 0;
  int qnext = load_q3(q0, q1, q2, len0, stop, i0 + lane + 32 * K);
  int tword = 0, qword = 0;
  int lbest = 0, lcol = -1;
  for (int j = 0; j < t_len; ++j) {
    if ((j & 31) == 0) {  // take this block's words, load the next block's
      tword = tnext;
      qword = qnext;
      const int jj = j + 32 + lane;
      tnext = jj < t_len ? (int(t[jj]) & 31) : 0;
      qnext = load_q3(q0, q1, q2, len0, stop, i0 + jj + 32 * K);
    }
    const int32_t* mrow = Mt + 32 * __shfl_sync(FULL, tword, j & 31);

    // previous-column values across the lane's ends
    int s_up = __shfl_up_sync(FULL, S[K - 1][2], 1);  // row before the first
    if (lane == 0) s_up = 0;
    int s_dn = __shfl_down_sync(FULL, S[0][0], 1);    // row after the last
    if (lane == 31) s_dn = 0;
    int h_dn[3];                                      // rows r + 3 past the end
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      h_dn[f] = __shfl_down_sync(FULL, Hg[0][f], 1);
      if (lane == 31) h_dn[f] = 0;
    }

    // cur0 = max(diag + s, max(r-1, r+1) + s - fs, hg, 0); the lane's
    // outgoing vertical gap per frame with nothing entering its first row
    int C[K][3];
    int fo[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const bool v = ((inb >> k) & 1u) && ((P[k] >> (15 + f)) & 1);
        const int s = mrow[(P[k] >> (5 * f)) & 31];
        const int up = f > 0 ? S[k][f - 1] : (k > 0 ? S[k - 1][2] : s_up);
        const int dn = f < 2 ? S[k][f + 1] : (k < K - 1 ? S[k + 1][0] : s_dn);
        const int hg = k < K - 1 ? Hg[k + 1][f] : h_dn[f];
        const int c = __vimax3_s32_relu(S[k][f] + s, max(up, dn) + (s - fs),
                                        hg);
        C[k][f] = c;
        fo[f] = __viaddmax_s32_relu(fo[f], -ge, v ? c - go : NEG);
      }
    }
    // lazy F: each lane takes the previous lane's outgoing gap; if that
    // raises any lane's outgoing gap, a warp scan carries it on exactly
    int f_in[3];
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      f_in[f] = __shfl_up_sync(FULL, fo[f], 1);
      if (lane == 0) f_in[f] = 0;
    }
    bool rise = false;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int nf = __viaddmax_s32(f_in[f], -kge, fo[f]);
      rise |= nf != fo[f];
      fo[f] = nf;
    }
    if (__any_sync(FULL, rise)) {  // inclusive max-plus scan over lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const int o = __shfl_up_sync(FULL, fo[f], off);
          if (lane >= off) fo[f] = __viaddmax_s32(o, -off * kge, fo[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        f_in[f] = __shfl_up_sync(FULL, fo[f], 1);
        if (lane == 0) f_in[f] = 0;
      }
    }

    // H, the vertical gap entering each row, the horizontal-gap state
    int lmax = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const bool v = ((inb >> k) & 1u) && ((P[k] >> (15 + f)) & 1);
        const int hg = k < K - 1 ? Hg[k + 1][f] : h_dn[f];  // not yet updated
        const int hn = v ? max(C[k][f], f_in[f]) : 0;
        f_in[f] = __viaddmax_s32_relu(f_in[f], -ge, hn - go);
        lmax = max(lmax, hn);
        Hg[k][f] = v ? __viaddmax_s32(hg, -ge, hn - go) : 0;
        S[k][f] = hn;
      }
    }
    if (lmax > lbest) {
      lbest = lmax;
      lcol = j;
    }

    // slide the query window one offset: offset o now holds i0 + j + 1 + o
    int p_in = __shfl_down_sync(FULL, P[0], 1);
    const int p_new = __shfl_sync(FULL, qword, j & 31);
    if (lane == 31) p_in = p_new;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) P[k] = P[k + 1];
    P[K - 1] = p_in;
  }
  // best = max over lanes; max_col = the first column any lane reached it
  const int best = __reduce_max_sync(FULL, lbest);
  const int col = __reduce_min_sync(FULL, lbest == best ? lcol : INT_MAX);
  if (lane == 0) {
    best_out[job] = best;
    col_out[job] = col;
  }
}

template <int K>
void launch(const int8_t* t_cat, const int8_t* q_cat, const int32_t* jobs,
            const int32_t* reqs, const int32_t* matrix, int n_jobs, int go,
            int ge, int fs, int32_t* best, int32_t* col, cudaStream_t stream) {
  const dim3 grid((n_jobs + WARPS - 1) / WARPS), block(WARPS * 32);
  banded_swipe3_kernel<K><<<grid, block, 0, stream>>>(
      t_cat, q_cat, jobs, reqs, matrix, n_jobs, go, ge, fs, best, col);
}

}  // namespace

extern "C" int banded_swipe3_launch(int offsets_per_lane, const void* t_cat,
                                    const void* q_cat, const void* jobs,
                                    const void* reqs, const void* matrix,
                                    int n_jobs, int go, int ge, int fs,
                                    void* best, void* col, void* stream) {
  if (n_jobs <= 0) return 0;
  auto tc = static_cast<const int8_t*>(t_cat);
  auto qc = static_cast<const int8_t*>(q_cat);
  auto jb = static_cast<const int32_t*>(jobs);
  auto rq = static_cast<const int32_t*>(reqs);
  auto mx = static_cast<const int32_t*>(matrix);
  auto b = static_cast<int32_t*>(best);
  auto c = static_cast<int32_t*>(col);
  auto s = static_cast<cudaStream_t>(stream);
  switch (offsets_per_lane) {
    case 1: launch<1>(tc, qc, jb, rq, mx, n_jobs, go, ge, fs, b, c, s); break;
    case 2: launch<2>(tc, qc, jb, rq, mx, n_jobs, go, ge, fs, b, c, s); break;
    case 4: launch<4>(tc, qc, jb, rq, mx, n_jobs, go, ge, fs, b, c, s); break;
    case 8: launch<8>(tc, qc, jb, rq, mx, n_jobs, go, ge, fs, b, c, s); break;
    case 16: launch<16>(tc, qc, jb, rq, mx, n_jobs, go, ge, fs, b, c, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
