// Fused stage-1/2 seeding filter over card-resident letter blocks: the
// Hopper kernel behind ops/stage12_device.stage12_pairs.
//
// Replaces diamond_tpu/ops/stage12_jax.py:35-78 (_stage12_kernel, jit/XLA
// code on the TPU, no Pallas).  Same function, pair for pair.  For a pair
// with seed positions qp (query block) and sp (target block), per-pair
// window w and cutoff c, at offsets o from the seed:
//   ident = #{o in [-16, 32) : (q[qp+o] & 31) == (s[sp+o] & 31)}, the
//           window not clipped (two delimiters count as a match);
//   wl    = the k in [0, w - 1) of the first raw delimiter (q == 31, the
//           byte as stored: masked letters carry high bits) at qp - 1 - k,
//           else w;
//   wr    = the k in [0, w) of the first raw delimiter at qp + k, else w;
//   best  = max over o in [-wl, wr) of st, st = min(max(st + v, 0), 255),
//           v = M[q & 31][s & 31] (uint8-saturating Kadane; st is 0 outside
//           the range, so the walk covers the range only);
//   keep  = ident >= hamming_id && best > c.
// best is written for every pair, stage-1 failures included.
//
// The design is the simple one: one thread per pair, a grid-stride loop;
// the letters read byte by byte through the read-only path (__ldg) from the
// two blocks, which the card's L2 holds; a left and a right walk for the
// clip; the Kadane walk only over [-wl, wr); the 32 x 32 matrix in shared
// memory, each row rotated by its letter as in csrc/stage2.cu so that the
// lanes' lookups spread over the banks.  The caller guarantees that every
// pair's reads, [qp - max(16, w), qp + max(32, w)) and the same around sp,
// lie inside the blocks (stage12_device checks it on the host).
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // the grid: enough resident warps to
                                  // cover the loads' L2 latency
constexpr int FP_LEFT = 16;       // fingerprint span [-16, +32)
constexpr int FP_RIGHT = 32;
constexpr int DELIM = 31;

__global__ void __launch_bounds__(THREADS)
stage12_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ s,
               const int32_t* __restrict__ matrix,
               const int32_t* __restrict__ qp, const int32_t* __restrict__ sp,
               const int32_t* __restrict__ windows,
               const int32_t* __restrict__ cutoffs, int n, int hamming_id,
               uint8_t* __restrict__ keep, int32_t* __restrict__ best_out) {
  // M[a * 32 + ((a + b) & 31)] = matrix[a][b]
  __shared__ int32_t M[32 * 32];
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x)
    M[(k & ~31) | ((k + (k >> 5)) & 31)] = matrix[k];
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int8_t* qa = q + qp[i];
    const int8_t* sa = s + sp[i];
    const int w = windows[i];
    int ident = 0;
#pragma unroll 8
    for (int o = -FP_LEFT; o < FP_RIGHT; ++o)
      ident += ((__ldg(qa + o) ^ __ldg(sa + o)) & 31) == 0;
    int wl = w;
    for (int k = 0; k < w - 1; ++k)
      if (__ldg(qa - 1 - k) == DELIM) {
        wl = k;
        break;
      }
    int wr = w;
    for (int k = 0; k < w; ++k)
      if (__ldg(qa + k) == DELIM) {
        wr = k;
        break;
      }
    int st = 0, best = 0;
    for (int o = -wl; o < wr; ++o) {
      const int a = __ldg(qa + o) & 31, b = __ldg(sa + o) & 31;
      st = min(__viaddmax_s32_relu(st, M[a * 32 + ((a + b) & 31)], 0), 255);
      best = max(best, st);
    }
    keep[i] = ident >= hamming_id && best > cutoffs[i];
    best_out[i] = best;
  }
}

}  // namespace

// q, s int8 letter blocks; matrix int32 [32][32]; qp, sp, windows, cutoffs
// int32 [n]; keep uint8 [n], best int32 [n].
extern "C" int stage12_launch(const void* q, const void* s, const void* matrix,
                              const void* qp, const void* sp,
                              const void* windows, const void* cutoffs, int n,
                              int hamming_id, void* keep, void* best,
                              void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int grid = std::min((n + THREADS - 1) / THREADS,
                            std::max(sms, 1) * BLOCKS_PER_SM);
  stage12_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(s),
      static_cast<const int32_t*>(matrix), static_cast<const int32_t*>(qp),
      static_cast<const int32_t*>(sp), static_cast<const int32_t*>(windows),
      static_cast<const int32_t*>(cutoffs), n, hamming_id,
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(best));
  return int(cudaGetLastError());
}
