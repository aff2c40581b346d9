// Stage-2 seeding filter over host-pregathered windows: the Hopper kernel
// behind ops/stage2_device.stage2_filter.
//
// Replaces the TPU kernel diamond_tpu/ops/stage2_pallas.py:37-121
// (_make_kernel + stage2_pallas).  Same function, pair for pair: over a
// pair's W = 2 * max_window window letters (offset o = w - max_window),
//   ident = #{o in [-16, 32) : q == s}   (the fingerprint identity count),
//   best  = max over the walk of st, st = min(max(st + M[q][s], 0), 255) for
//           o in [-wl, wr), st = 0 outside (uint8-saturating Kadane),
//   keep  = ident >= hamming_id && best > cutoff.
// Letters are in 0..31 (pregather_windows masks them); the matrix lookup
// reads M[q & 31][s & 31].
//
// What bounds it on the card: device-memory bytes.  Each pair reads 2 * W
// window bytes and 12 bytes of (wl, wr, cutoff) and writes 9 bytes, against
// a handful of integer operations per window letter.  What the design does:
//   - one thread per pair; the [W][N] layout makes each step's loads
//     coalesced across the warp (32 neighbouring pairs, 32 bytes);
//   - the int8 windows are read as they are, with no int32 copy;
//   - the 32 x 32 matrix sits in shared memory (4 KB);
//   - the Kadane walk and the identity count stay in registers.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FP_LEFT = 16;  // fingerprint span [-16, +32)
constexpr int FP_RIGHT = 32;

__global__ void __launch_bounds__(THREADS)
stage2_kernel(const int8_t* __restrict__ qw, const int8_t* __restrict__ sw,
              const int32_t* __restrict__ meta,
              const int32_t* __restrict__ matrix, int W, int N,
              int max_window, int hamming_id, uint8_t* __restrict__ keep,
              int32_t* __restrict__ best_out,
              int32_t* __restrict__ ident_out) {
  __shared__ int32_t M[32 * 32];
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x) M[k] = matrix[k];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int wl = meta[n], wr = meta[N + n], cut = meta[2 * N + n];
  int st = 0, best = 0, ident = 0;
  for (int w = 0; w < W; ++w) {
    const int q = qw[size_t(w) * N + n];
    const int s = sw[size_t(w) * N + n];
    const int off = w - max_window;
    st = off >= -wl && off < wr
             ? min(max(st + M[(q & 31) * 32 + (s & 31)], 0), 255)
             : 0;
    best = max(best, st);
    ident += off >= -FP_LEFT && off < FP_RIGHT && q == s;
  }
  keep[n] = ident >= hamming_id && best > cut;
  best_out[n] = best;
  ident_out[n] = ident;
}

}  // namespace

// qw, sw int8 [W][N]; meta int32 [3][N] rows (wl, wr, cutoff); matrix int32
// [32][32]; keep uint8 [N], best and ident int32 [N].
extern "C" int stage2_launch(const void* qw, const void* sw, const void* meta,
                             const void* matrix, int W, int N, int max_window,
                             int hamming_id, void* keep, void* best,
                             void* ident, void* stream) {
  if (N <= 0) return 0;
  stage2_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qw), static_cast<const int8_t*>(sw),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(matrix),
      W, N, max_window, hamming_id, static_cast<uint8_t*>(keep),
      static_cast<int32_t*>(best), static_cast<int32_t*>(ident));
  return int(cudaGetLastError());
}
