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
//   - a block stages tiles of TILE pairs: rows [W][TILE] of both windows,
//     copied into shared memory with asynchronous copies of VEC bytes
//     (cp.async; 16 where N and the pointers allow it, else 8 or 4, and
//     plain byte loads when N is odd), consecutive threads on consecutive
//     pieces of a row;
//   - the tiles are double-buffered: a block walks tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ... and copies the next while it computes the
//     current, and the grid holds as many blocks as fit on the SMs, so
//     enough bytes are in flight to keep the memory busy;
//   - the ragged tail (a tile past N) copies only the pairs below N;
//   - a thread then walks its pair from shared memory: the Kadane walk
//     only over the pair's window [max_window - wl, max_window + wr), where
//     st is 0 outside, and the identity count only over the 48 fingerprint
//     rows [max_window - 16, max_window + 32), so no step tests bounds; a
//     row in both is read once;
//   - the 32 x 32 matrix sits in shared memory (4 KB), each row rotated so
//     that the lanes' lookups spread over the banks.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;    // pairs of a tile, one thread each
constexpr int FP_LEFT = 16;  // fingerprint span [-16, +32)
constexpr int FP_RIGHT = 32;
// dynamic shared memory a block may take: Hopper's 227 KB a block less the
// kernel's static 32 x 32 int32 matrix, so W <= 446 (stage2_device.MAX_ROWS)
constexpr int MAX_SMEM = 227 * 1024 - 32 * 32 * 4;

// n of the VEC bytes at src (n in 0..VEC) to dst, the rest zero-filled;
// asynchronous unless VEC is 1.
template <int VEC>
__device__ __forceinline__ void copy_async(int8_t* dst, const int8_t* src,
                                           int n) {
  if constexpr (VEC == 1) {
    *dst = n > 0 ? *src : 0;
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (VEC == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(src), "r"(n));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                   "l"(src), "n"(VEC), "r"(n));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Tile t's rows of both windows into buf ([2][W][TILE] bytes).
template <int VEC>
__device__ __forceinline__ void stage_tile(int8_t* buf,
                                           const int8_t* __restrict__ qw,
                                           const int8_t* __restrict__ sw,
                                           int W, int N, int t) {
  constexpr int PIECES = TILE / VEC;  // pieces of a row
  const int p0 = t * TILE;
  for (int c = threadIdx.x; c < 2 * W * PIECES; c += blockDim.x) {
    const int row = c / PIECES, k = c - row * PIECES;  // row: array * W + w
    const int a = row >= W, w = row - a * W;
    const int p = p0 + k * VEC;
    const int n = min(max(N - p, 0), VEC);
    const int8_t* src = (a ? sw : qw) + size_t(w) * N + (n > 0 ? p : 0);
    copy_async<VEC>(buf + row * TILE + k * VEC, src, n);
  }
}

template <int VEC>
__global__ void __launch_bounds__(TILE)
stage2_kernel(const int8_t* __restrict__ qw, const int8_t* __restrict__ sw,
              const int32_t* __restrict__ meta,
              const int32_t* __restrict__ matrix, int W, int N,
              int max_window, int hamming_id, uint8_t* __restrict__ keep,
              int32_t* __restrict__ best_out,
              int32_t* __restrict__ ident_out) {
  extern __shared__ __align__(16) int8_t tiles[];  // 2 x [2][W][TILE]
  // M[a * 32 + ((a + b) & 31)] = matrix[a][b], row a rotated by a: the
  // bank of a lookup depends on both letters, where matrix[a][b] at
  // a * 32 + b would put the 32 lanes in the 20 banks of the letters b
  __shared__ int32_t M[32 * 32];
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x)
    M[(k & ~31) | ((k + (k >> 5)) & 31)] = matrix[k];
  const int n_tiles = (N + TILE - 1) / TILE;
  const int buf_bytes = 2 * W * TILE;
  const int fp_lo = max(max_window - FP_LEFT, 0);
  const int fp_hi = min(max_window + FP_RIGHT, W);
  int t = blockIdx.x;
  if (t < n_tiles) stage_tile<VEC>(tiles, qw, sw, W, N, t);
  copy_commit();
  for (int i = 0; t < n_tiles; ++i, t += gridDim.x) {
    const int8_t* cur = tiles + (i & 1) * buf_bytes;
    const int n = t * TILE + threadIdx.x;
    int wl = 0, wr = 0, cut = 0;
    if (n < N) {  // in flight while the tile lands
      wl = meta[n];
      wr = meta[N + n];
      cut = meta[2 * N + n];
    }
    if (t + int(gridDim.x) < n_tiles) {
      stage_tile<VEC>(tiles + ((i + 1) & 1) * buf_bytes, qw, sw, W, N,
                      t + gridDim.x);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (n < N) {
      const int8_t* q = cur + threadIdx.x;
      const int8_t* s = q + W * TILE;
      int st = 0, best = 0, ident = 0;
      auto kadane = [&](int w) {
        const int a = q[w * TILE] & 31, b = s[w * TILE] & 31;
        st = min(__viaddmax_s32_relu(st, M[a * 32 + ((a + b) & 31)], 0), 255);
        best = max(best, st);
      };
      auto same = [&](int w) { ident += q[w * TILE] == s[w * TILE]; };
      // the Kadane window [lo, hi) in order, the fingerprint rows in any
      // order, each row's letters read once where the two overlap
      const int lo = max(max_window - wl, 0), hi = min(max_window + wr, W);
      const int mid_lo = max(lo, fp_lo), mid_hi = min(hi, fp_hi);
      for (int w = lo; w < min(hi, fp_lo); ++w) kadane(w);
      for (int w = fp_lo; w < min(lo, fp_hi); ++w) same(w);
      for (int w = mid_lo; w < mid_hi; ++w) {
        const int a = q[w * TILE], b = s[w * TILE];
        st = min(__viaddmax_s32_relu(
                     st, M[(a & 31) * 32 + ((a + b) & 31)], 0), 255);
        best = max(best, st);
        ident += a == b;
      }
      for (int w = max(fp_hi, lo); w < hi; ++w) kadane(w);
      for (int w = max(hi, fp_lo); w < fp_hi; ++w) same(w);
      keep[n] = ident >= hamming_id && best > cut;
      best_out[n] = best;
      ident_out[n] = ident;
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }
}

// One VEC's launch setup on one device, kept across calls: the dynamic
// shared-memory size its attribute was set to and the blocks that fit on
// the card at that size.
struct Setup {
  int smem = -1;
  int blocks = 0;
};

constexpr int MAX_DEVICES = 64;

template <int VEC>
int launch(const int8_t* qw, const int8_t* sw, const int32_t* meta,
           const int32_t* matrix, int W, int N, int max_window,
           int hamming_id, uint8_t* keep, int32_t* best, int32_t* ident,
           cudaStream_t stream) {
  const int smem = 2 * 2 * W * TILE;
  if (smem > MAX_SMEM) return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  static Setup setup[MAX_DEVICES];
  static std::mutex mu;  // callers may launch from several host threads
  int blocks = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    Setup& su = setup[dev];
    if (su.smem != smem) {  // the first call, or another window size
      int per_sm = 0, sms = 0;
      err = cudaFuncSetAttribute(stage2_kernel<VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, stage2_kernel<VEC>, TILE, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return int(err);
      su.smem = smem;
      su.blocks = std::max(per_sm, 1) * sms;
    }
    blocks = su.blocks;
  }
  const int n_tiles = (N + TILE - 1) / TILE;
  const int grid = std::min(n_tiles, blocks);
  stage2_kernel<VEC><<<grid, TILE, smem, stream>>>(
      qw, sw, meta, matrix, W, N, max_window, hamming_id, keep, best, ident);
  return int(cudaGetLastError());
}

}  // namespace

// qw, sw int8 [W][N]; meta int32 [3][N] rows (wl, wr, cutoff); matrix int32
// [32][32]; keep uint8 [N], best and ident int32 [N].
extern "C" int stage2_launch(const void* qw, const void* sw, const void* meta,
                             const void* matrix, int W, int N, int max_window,
                             int hamming_id, void* keep, void* best,
                             void* ident, void* stream) {
  if (N <= 0) return 0;
  const auto* q = static_cast<const int8_t*>(qw);
  const auto* s = static_cast<const int8_t*>(sw);
  const auto* m = static_cast<const int32_t*>(meta);
  const auto* x = static_cast<const int32_t*>(matrix);
  auto* k = static_cast<uint8_t*>(keep);
  auto* b = static_cast<int32_t*>(best);
  auto* d = static_cast<int32_t*>(ident);
  auto st = static_cast<cudaStream_t>(stream);
  // the widest copy that every row start is aligned to
  const auto align = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(qw) | reinterpret_cast<uintptr_t>(sw) |
      static_cast<uintptr_t>(N));
  if (align % 16 == 0)
    return launch<16>(q, s, m, x, W, N, max_window, hamming_id, k, b, d, st);
  if (align % 8 == 0)
    return launch<8>(q, s, m, x, W, N, max_window, hamming_id, k, b, d, st);
  if (align % 4 == 0)
    return launch<4>(q, s, m, x, W, N, max_window, hamming_id, k, b, d, st);
  return launch<1>(q, s, m, x, W, N, max_window, hamming_id, k, b, d, st);
}
