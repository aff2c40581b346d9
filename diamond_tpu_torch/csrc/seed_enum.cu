// The query-indexed route's DB-side seed enumeration and probe: the Hopper
// kernels behind ops/seed_enum_device.enumerate_filtered.
//
// Replaces no TPU kernel: the pass is host C++ in both packages,
// enumerate_seeds_filtered (diamond_tpu/native/src/stages.cc and
// diamond_tpu_torch/native/src/stages.cc:558), which
// search/pipeline._enumerate_t_qindex runs once a shape on every
// query-indexed search, a single thread over every position of the DB
// block.  Same function, bit for bit: for each sequence s with L >= span
// and each window start p in [start, start + L - span], the letters at the
// shape's 1 positions reduce through a 256-entry table (the wrapper applies
// the Reduction to every byte value); the window is a seed when each
// reduces into [0, base), its key the base-`base` number of those letters,
// most significant first, in uint64 arithmetic; a seed survives when its
// key is in the query key set.  The survivors come out in sequence order,
// then position order within a sequence, as the host pass writes them.
// Which windows exist is decided from the starts and lengths alone, never
// from delimiters: a window that straddled a delimiter falling on a 0 of
// the shape would otherwise form a false seed.
//
// What bounds it on the card: neither, by much.  The benchmark's block
// (5.81 M letters, 15,000 sequences) has ~5.6 M windows a shape, each ~10
// byte loads, 10 table lookups, 10 64-bit multiply-adds and one hash probe:
// ~45 int32 ops a window, ~15 us of the int32 rate; the letters are 5.8 MB,
// ~2 us of HBM.  The kernels are short against their launches and the
// host's copies, so the design keeps the passes few and the host's part
// small:
//   - the windows are numbered across the block (win_off, an exclusive
//     prefix of each sequence's window count, made by the wrapper), and a
//     warp takes a tile of TILE consecutive window numbers, PER a lane,
//     neighbouring lanes on neighbouring windows, so the letter loads of a
//     step are coalesced; lanes 0 and 1 find the tile's first and last
//     sequences by a binary search of win_off, and each window searches
//     only that range (one or two steps at the benchmark's lengths);
//   - the reduction table (256 bytes) and the shape's positions sit in
//     shared memory;
//   - the query keys go into an open-addressing hash set built on the card
//     with atomicCAS (the host pass's mix and linear probing, capacity the
//     power of two >= 2 nq, at least 16; ~0 marks a free slot, keys being
//     < 2^63); ~6 k keys (20 queries) to ~0.4 M (1,000) keep it in L2;
//   - the survivors are compacted in order without atomics: a count pass
//     writes each tile's survivors, one block scans the counts into
//     offsets, the wrapper reads the total (its one sync before the write)
//     and a write pass, the same walk again, puts each survivor at its
//     tile's offset plus its rank among the warp's (a ballot a step), so
//     only the survivors come back.
// The kernels allocate nothing, do not synchronise, and launch on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                  // warps a block
constexpr int THREADS = 32 * WARPS;       // == 256, one a table entry
constexpr int PER = 16;                   // windows a lane in a tile
constexpr int TILE = 32 * PER;            // windows a warp
constexpr int MAX_WEIGHT = 32;            // the longest shape has 32 letters
constexpr int SCAN_THREADS = 1024;
constexpr unsigned ALL = 0xffffffffu;
constexpr unsigned long long EMPTY = ~0ull;

static_assert(THREADS == 256, "one thread a reduction table entry");

// The host pass's hash of a key (stages.cc filter_keys).
__device__ __forceinline__ unsigned long long mix(unsigned long long k) {
  k *= 0x9e3779b97f4a7c15ull;
  k ^= k >> 29;
  k *= 0xbf58476d1ce4e5b9ull;
  k ^= k >> 32;
  return k;
}

// The last sequence s in [lo, hi] whose first window number is <= w: the
// sequence that holds window w (one with no windows shares its number with
// the next and is passed over).
__device__ __forceinline__ long long seq_of(const long long* win_off,
                                            long long lo, long long hi,
                                            long long w) {
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (win_off[mid] <= w)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__global__ void hash_kernel(const unsigned long long* __restrict__ q_keys,
                            long long nq, unsigned long long* table,
                            unsigned long long hmask) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nq; i += step) {
    const unsigned long long k = q_keys[i];
    unsigned long long h = mix(k) & hmask;
    for (;;) {
      const unsigned long long prev = atomicCAS(table + h, EMPTY, k);
      if (prev == EMPTY || prev == k) break;  // a duplicate key is there
      h = (h + 1) & hmask;
    }
  }
}

struct Block {
  const int8_t* letters;        // the block's letters
  const int8_t* table;          // [256] the reduced letter of each byte
  const long long* starts;      // [n_seqs] each sequence's first letter
  const long long* win_off;     // [n_seqs + 1] its first window number
  long long n_seqs;
  long long n_windows;          // win_off[n_seqs]
  const int* shape;             // [weight] the shape's 1 positions
  int weight;
  int base;
  const unsigned long long* hash;  // the query key set
  unsigned long long hmask;        // its capacity - 1
};

// One warp a tile of TILE window numbers.  WRITE = false: each tile's
// survivors into counts; WRITE = true: the survivors' keys and positions
// from offsets[tile] on, in window order.
template <bool WRITE>
__global__ void __launch_bounds__(THREADS)
enum_kernel(Block a, long long n_tiles, int* __restrict__ counts,
            const long long* __restrict__ offsets,
            long long* __restrict__ out_keys,
            long long* __restrict__ out_pos) {
  __shared__ int8_t red[256];
  __shared__ int shape[MAX_WEIGHT];
  red[threadIdx.x] = a.table[threadIdx.x];
  if (threadIdx.x < a.weight) shape[threadIdx.x] = a.shape[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // the whole warp: no block sync follows
  const long long w0 = tile * TILE;
  const long long w1 = min(w0 + TILE, a.n_windows);
  long long s = 0;
  if (lane < 2) s = seq_of(a.win_off, 0, a.n_seqs - 1, lane ? w1 - 1 : w0);
  const long long s_lo = __shfl_sync(ALL, s, 0);
  const long long s_hi = __shfl_sync(ALL, s, 1);
  long long out = WRITE ? offsets[tile] : 0;
  for (int j = 0; j < PER; ++j) {
    const long long w = w0 + j * 32 + lane;
    bool hit = false;
    unsigned long long key = 0;
    long long p = 0;
    if (w < w1) {
      const long long q = seq_of(a.win_off, s_lo, s_hi, w);
      p = a.starts[q] + (w - a.win_off[q]);
      bool valid = true;
      for (int c = 0; c < a.weight; ++c) {
        const int r = red[(uint8_t)a.letters[p + shape[c]]];
        valid &= (r >= 0) & (r < a.base);
        key = key * (unsigned long long)a.base + (unsigned long long)r;
      }
      if (valid) {
        unsigned long long h = mix(key) & a.hmask;
        for (unsigned long long t; (t = a.hash[h]) != EMPTY;
             h = (h + 1) & a.hmask)
          if (t == key) {
            hit = true;
            break;
          }
      }
    }
    const unsigned b = __ballot_sync(ALL, hit);
    if (WRITE && hit) {
      const long long o = out + __popc(b & ((1u << lane) - 1u));
      out_keys[o] = (long long)key;
      out_pos[o] = p;
    }
    out += __popc(b);
  }
  if (!WRITE && lane == 0) counts[tile] = (int)out;
}

// offsets[i] = counts[0] + ... + counts[i - 1] for i <= n: one block, each
// thread a run of consecutive counts.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int* __restrict__ counts, long long n,
            long long* __restrict__ offsets) {
  __shared__ long long warp_sum[SCAN_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const long long per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long lo = min((long long)t * per, n), hi = min(lo + per, n);
  long long sum = 0;
  for (long long i = lo; i < hi; ++i) sum += counts[i];
  long long x = sum;  // the inclusive scan of the threads' sums
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(ALL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    long long v = warp_sum[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(ALL, v, d);
      if (lane >= d) v += y;
    }
    warp_sum[lane] = v;
  }
  __syncthreads();
  long long run = x - sum + (wid ? warp_sum[wid - 1] : 0);
  for (long long i = lo; i < hi; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (t == SCAN_THREADS - 1) offsets[n] = warp_sum[SCAN_THREADS / 32 - 1];
}

}  // namespace

// phase 0: the query key set into `hash` (cap slots, a power of two),
// each tile's survivors into `counts` and their prefix into `offsets`
// (offsets[n_tiles] the total); phase 1: the survivors into out_keys and
// out_pos.  n_tiles = ceil(n_windows / TILE); n_windows > 0 and nq > 0.
extern "C" int seed_enum_launch(
    int phase, const int8_t* letters, const int8_t* table,
    const long long* starts, const long long* win_off,
    unsigned long long n_seqs, unsigned long long n_windows,
    const int* shape, int weight, int base,
    const unsigned long long* q_keys, unsigned long long nq,
    unsigned long long* hash, unsigned long long cap, int* counts,
    long long* offsets, long long* out_keys, long long* out_pos,
    cudaStream_t stream) {
  if (weight < 1 || weight > MAX_WEIGHT || n_windows == 0 || nq == 0 ||
      (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const Block a{letters, table, starts, win_off, (long long)n_seqs,
                (long long)n_windows, shape, weight, base, hash, cap - 1};
  const long long n_tiles = ((long long)n_windows + TILE - 1) / TILE;
  const unsigned blocks = (unsigned)((n_tiles + WARPS - 1) / WARPS);
  if (phase == 0) {
    const cudaError_t err =
        cudaMemsetAsync(hash, 0xff, cap * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return (int)err;
    const long long hb = min(((long long)nq + 255) / 256, 4096LL);
    hash_kernel<<<(unsigned)hb, 256, 0, stream>>>(q_keys, (long long)nq,
                                                  hash, cap - 1);
    enum_kernel<false><<<blocks, THREADS, 0, stream>>>(
        a, n_tiles, counts, nullptr, nullptr, nullptr);
    scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts, n_tiles, offsets);
  } else {
    enum_kernel<true><<<blocks, THREADS, 0, stream>>>(
        a, n_tiles, nullptr, offsets, out_keys, out_pos);
  }
  return (int)cudaGetLastError();
}
