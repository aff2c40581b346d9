// tantan's repeat-probability scan and the hard mask it drives: the Hopper
// kernel behind ops/tantan_device.tantan_mask.
//
// Replaces no TPU kernel: it takes the place of the host C++ scan
// tantan_repeat_prob_many / tantan_repeat_prob (native/src/tantan.cc:52-157)
// that search/pipeline._mask_block runs on every tantan-masked block, a
// single thread over every sequence.  Same function, bit for bit: the
// float32 operations of tantan.cc in its order, so that P(repeat) >= p_mask
// falls the same way on every position:
//   forward   f[k] = (f[k] * f2f + b * d[k]) * e[i][k],
//             b = b * b2b + f_sum * p_repeat_end, f_sum = sum(f),
//             every 16th position s = 1 / b and b, f, f_sum scaled by s,
//             pb[i] = b;
//   backward  P = 1 - pb[i] * b * zinv, the scale of position i applied,
//             fe = f * e[i], t = sum(fe * d), f = fe * f2f + p_repeat_end * b,
//             b = b2b * b + t;
// e[i][k] = ratios[s[i]][s[i - k - 1]] (0 before the start), s = letters
// & 31, and every sum of the 50 states in numpy's pairwise order (eight
// accumulators r[j] over k < 48, each in k order, ((r0 + r1) + (r2 + r3))
// + ((r4 + r5) + (r6 + r7)), then + a[48] + a[49]).  Every operation is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn): nothing
// is contracted into an FMA, the division is IEEE, and denormals are kept
// (the build sets no fast-math flag).
//
// What bounds it on the card: the serial chain along a sequence.  The work
// is ~10 fp32 operations a letter and state over both passes (5.81 M
// letters x 50 states: ~0.09 ms at the non-FMA fp32 rate), but each
// position depends on the one before, and the longest sequence's chain of
// sums sets a floor as large.  A warp issues in order, so a position costs
// the latency of its dependent instructions plus those it issues.  What the
// design does about both:
//   - eight lanes per sequence, four sequences a warp: lane j holds the
//     states j + 8m (m < 6), numpy's accumulator r[j], which it adds up in
//     order with no shuffle; three xor shuffles inside the eight lanes make
//     the tree (float addition commutes, so both partners of a level add
//     the same pair and every lane ends with the total); lanes 0 and 1 also
//     hold k = 48, 49, which the others take by two shuffles off the chain;
//   - the letters s[i - k - 1] of a lane's states stay in registers and
//     move one state a position, one shuffle a slot from the neighbouring
//     lane, so a position reads one new letter from memory; positions
//     before the start hold a sentinel letter whose column of the shared
//     32 x 33 ratio table is 0, so no lookup tests a bound;
//   - the next position's window and ratios are made first, off the chain,
//     the letter two positions ahead and pb one ahead are loaded, and a
//     step has no branch (the forward pass runs in blocks of 16 with the
//     scaling in the last; the backward pass scales by a factor that is 1
//     elsewhere, a product with 1 being exact); the L x 50 emission matrix
//     of tantan.cc is never stored;
//   - sequences are taken longest first (the wrapper's order), so a warp's
//     four have about one length and the long chains start first; a warp
//     steps to its longest, the groups past their end compute what nobody
//     reads;
//   - the forward pass keeps b per position (pb) and the scale of every
//     16 positions in scratch the wrapper allocates; the backward pass
//     writes MASK_LETTER over the masked letters in place, inside
//     [start, start + len) only.  A position is written after every read of
//     it: it is read for steps i .. i + 51, which the backward pass has
//     passed when it writes position i.
// The layouts timed on the card (H100 80GB HBM3, 700 W; kernel only, in one
// call): the benchmark's block (15,000 proteins, longest 2,872) 1.18 ms
// here against 1.64 ms for a warp a sequence (two states a lane, each
// accumulator gathered by shuffles, the letters loaded each position) and
// 1.53 ms for four lanes a sequence; one 2,872-letter sequence alone 0.84 /
// 1.23 / 1.14 ms; 15,000 sequences of 387 letters 0.52 / 1.28 / 0.57 ms.
// The kernel allocates nothing, does not synchronise, and launches on the
// caller's stream; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int S = 7;           // slots a lane: states j + 8m (m < 6), 48 + j
constexpr int LANES = 8;       // lanes a sequence
constexpr int SEQS = 32 / LANES;
constexpr int WARPS = 4;       // warps a block
constexpr int COLS = 33;       // a ratio row: 32 letters and the sentinel
constexpr int NONE = 32;       // the letter before the start: ratio 0
constexpr unsigned ALL = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// numpy's pairwise sum of a sequence's 50 states over its eight lanes: lane
// j holds the states j + 8m in a[m] (m < 6), numpy's accumulator r[j],
// which it adds up in order; three xor shuffles make the tree, and lanes 0
// and 1's a[6] (states 48, 49) come last.
__device__ __forceinline__ float psum50(const float (&a)[S], int base) {
  const float x48 = __shfl_sync(ALL, a[6], base);
  const float x49 = __shfl_sync(ALL, a[6], base + 1);
  float r = a[0];
#pragma unroll
  for (int m = 1; m < 6; ++m) r = add(r, a[m]);
  r = add(r, __shfl_xor_sync(ALL, r, 1));
  r = add(r, __shfl_xor_sync(ALL, r, 2));
  r = add(r, __shfl_xor_sync(ALL, r, 4));
  return add(add(r, x48), x49);
}

// The ratios of a position whose letter is c, from the letters w of the
// lane's states.
__device__ __forceinline__ void lookup(const float* table, int c,
                                       const int (&w)[S], float (&e)[S]) {
  const float* row = table + c * COLS;
#pragma unroll
  for (int m = 0; m < S; ++m) e[m] = row[w[m]];
}

__device__ __forceinline__ int letter(const int8_t* s, int p) {
  return p >= 0 ? (s[p] & 31) : NONE;
}

// The state a lane carries along its sequence.  w holds the letters
// s[i - k - 1] of its states; moving one position, state k takes state
// k - 1's letter (forward) or k + 1's (backward), one shuffle a slot from
// the neighbouring lane.  The ratios of this position and the next swap
// roles every position.
struct Scan {
  float d[S], f[S];
  float ea[S], eb[S];  // the ratios of this position and the next
  int w[S];
  float b, f_sum;
  int c, c1;           // the letters of this position and the next
};

// Forward step at position i, the same for the warp's four sequences; a
// sequence past its end goes on with values nobody reads.  e holds this
// position's ratios, ne takes the next one's.  SCALE: i % 16 == 15.  At
// the sequence's last position, fin takes b * b2b + sum(f) * p_repeat_end.
template <bool SCALE>
__device__ __forceinline__ void forward_step(
    Scan& z, const float (&e)[S], float (&ne)[S], const int8_t* s, int i,
    int L, const float* table, float* pb, float* scale, int j, int base,
    float b2b, float f2f, float pre, float& fin) {
  const bool act = i < L;
  const int c2 = i + 2 < L ? letter(s, i + 2) : 0;
  // the next position's window and ratios first: they depend on nothing
  // this position computes.  State j + 8m takes lane j - 1's slot m (lane
  // 0: lane 7's slot m - 1, and slot 0 the letter c); 48 takes 47 (lane
  // 7's slot 5) and 49 takes 48 (lane 0's slot 6)
  int F[S];
  const int src = base + ((j + LANES - 1) & (LANES - 1));
#pragma unroll
  for (int m = 0; m < S; ++m) F[m] = __shfl_sync(ALL, z.w[m], src);
  z.w[0] = j ? F[0] : z.c;
#pragma unroll
  for (int m = 1; m < 6; ++m) z.w[m] = j ? F[m] : F[m - 1];
  z.w[6] = j == 0 ? F[5] : (j == 1 ? F[6] : NONE);
  lookup(table, z.c1, z.w, ne);
  const float b_old = z.b;
  z.b = add(mul(b_old, b2b), mul(z.f_sum, pre));
#pragma unroll
  for (int m = 0; m < S; ++m)
    z.f[m] = mul(add(mul(z.f[m], f2f), mul(b_old, z.d[m])), e[m]);
  z.f_sum = psum50(z.f, base);
  float f_now = z.f_sum;  // sum(f) as f leaves the position
  if (SCALE) {
    const float sc = __fdiv_rn(1.0f, z.b);
    if (act && j == 0) scale[i >> 4] = sc;
    z.b = mul(z.b, sc);
#pragma unroll
    for (int m = 0; m < S; ++m) z.f[m] = mul(z.f[m], sc);
    z.f_sum = mul(z.f_sum, sc);
    f_now = psum50(z.f, base);
  }
  if (act && j == 0) pb[i] = z.b;
  fin = i == L - 1 ? add(mul(z.b, b2b), mul(f_now, pre)) : fin;
  z.c = z.c1;
  z.c1 = c2;
}

// Backward step at position i of the lane's sequence (below 0: past its
// start, nothing kept).  The scale of a position i % 16 == 15 is applied as
// a factor, 1 elsewhere (a product with 1 is exact), so the step has no
// branch: the sequences of a warp reach such positions at different steps.
// e holds this position's ratios, ne takes the next one's.
__device__ __forceinline__ void backward_step(
    Scan& z, const float (&e)[S], float (&ne)[S], int8_t* s, int i,
    const float* table, const float* pb, const float* scale, float* prob,
    float& pbi, float& sc_next, int& far, float zinv, int j, int base,
    float b2b, float f2f, float pre, float p_mask, int mask_letter) {
  const bool act = i >= 0;
  const int c2 = i >= 2 ? letter(s, i - 2) : 0;
  const int far2 = letter(s, i - 52);
  const float npb = i >= 1 ? pb[i - 1] : 0.0f;
  // the next position's window and ratios first: state j + 8m takes lane
  // j + 1's slot m (lane 7: lane 0's slot m + 1, and for m = 5 lane 0's
  // slot 6, state 48); 48 takes 49 (lane 1's slot 6) and 49 the letter far
  int G[S];
  const int src = base + ((j + 1) & (LANES - 1));
#pragma unroll
  for (int m = 0; m < S; ++m) G[m] = __shfl_sync(ALL, z.w[m], src);
#pragma unroll
  for (int m = 0; m < 6; ++m) z.w[m] = j < LANES - 1 ? G[m] : G[m + 1];
  z.w[6] = j == 0 ? G[6] : (j == 1 ? far : NONE);
  lookup(table, z.c1, z.w, ne);
  const float pf = __fsub_rn(1.0f, mul(mul(pbi, z.b), zinv));
  const bool scaled = act && (i & 15) == 15;
  const float sc = scaled ? sc_next : 1.0f;
  if (scaled) sc_next = i >= 16 ? scale[(i >> 4) - 1] : 1.0f;
  const float bs = mul(z.b, sc);
  float fd[S];
#pragma unroll
  for (int m = 0; m < S; ++m) {
    z.f[m] = mul(mul(z.f[m], sc), e[m]);
    fd[m] = mul(z.f[m], z.d[m]);
  }
  const float tsum = psum50(fd, base);
  const float pb_b = mul(pre, bs);
#pragma unroll
  for (int m = 0; m < S; ++m) z.f[m] = add(mul(z.f[m], f2f), pb_b);
  z.b = add(mul(b2b, bs), tsum);
  const bool mine = act && j == 0;
  if (mine && prob) prob[i] = pf;
  if (mine && pf >= p_mask) s[i] = static_cast<int8_t>(mask_letter);
  z.c = z.c1;
  z.c1 = c2;
  far = far2;
  pbi = npb;
}

__global__ void __launch_bounds__(WARPS * 32)
tantan_mask_kernel(const int32_t* __restrict__ order,
                   const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ lens,
                   const int64_t* __restrict__ scale_off, int n,
                   int8_t* letters, float* __restrict__ pb_all,
                   float* __restrict__ scale_all, float* __restrict__ probs,
                   const float* __restrict__ tab,
                   const float* __restrict__ d_all, float b2b, float f2f,
                   float pre, float p_mask, int mask_letter) {
  __shared__ float table[32 * COLS];
  for (int t = threadIdx.x; t < 32 * COLS; t += blockDim.x) {
    const int r = t / COLS, c = t % COLS;
    table[t] = c < 32 ? tab[r * 32 + c] : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j = lane & (LANES - 1), base = lane & ~(LANES - 1);
  const int slot = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * SEQS
                   + lane / LANES;
  int L = 0;
  int64_t start = 0, so = 0;
  if (slot < n) {
    const int id = order[slot];
    L = static_cast<int>(lens[id]);
    start = starts[id];
    so = scale_off[id];
  }
  int Lw = L;
#pragma unroll
  for (int x = LANES; x < 32; x *= 2)
    Lw = max(Lw, __shfl_xor_sync(ALL, Lw, x));
  if (Lw <= 0) return;  // the whole warp
  int8_t* s = letters + start;
  float* pb = pb_all + start;
  float* scale = scale_all + so;
  float* prob = probs ? probs + start : nullptr;
  Scan z;
#pragma unroll
  for (int m = 0; m < 6; ++m) z.d[m] = d_all[j + 8 * m];
  z.d[6] = j < 2 ? d_all[48 + j] : 0.0f;

  // forward, in blocks of 16 positions (the last one scales): the window
  // of position 0 lies before the start
#pragma unroll
  for (int m = 0; m < S; ++m) {
    z.w[m] = NONE;
    z.f[m] = 0.0f;
  }
  z.b = 1.0f;
  z.f_sum = 0.0f;
  z.c = L > 0 ? letter(s, 0) : 0;
  z.c1 = L > 1 ? letter(s, 1) : 0;
  lookup(table, z.c, z.w, z.ea);
  float fin = 1.0f;
  for (int i0 = 0; i0 < Lw; i0 += 16) {
#pragma unroll
    for (int u = 0; u < 14; u += 2) {
      forward_step<false>(z, z.ea, z.eb, s, i0 + u, L, table, pb, scale, j,
                          base, b2b, f2f, pre, fin);
      forward_step<false>(z, z.eb, z.ea, s, i0 + u + 1, L, table, pb, scale,
                          j, base, b2b, f2f, pre, fin);
    }
    forward_step<false>(z, z.ea, z.eb, s, i0 + 14, L, table, pb, scale, j,
                        base, b2b, f2f, pre, fin);
    forward_step<true>(z, z.eb, z.ea, s, i0 + 15, L, table, pb, scale, j,
                       base, b2b, f2f, pre, fin);
  }
  const float zinv = __fdiv_rn(1.0f, fin);
  __syncwarp();  // lane j = 0's pb and scale stores before the lanes read

  // backward: step t at position i = L - 1 - t of each sequence
  z.b = b2b;
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    z.f[m] = pre;
    z.w[m] = letter(s, L - 2 - (j + 8 * m));
  }
  z.f[6] = j < 2 ? pre : 0.0f;
  z.w[6] = j < 2 ? letter(s, L - 50 - j) : NONE;
  z.c = L > 0 ? letter(s, L - 1) : 0;
  z.c1 = L > 1 ? letter(s, L - 2) : 0;
  int far = letter(s, L - 52);
  lookup(table, z.c, z.w, z.ea);
  float pbi = L > 0 ? pb[L - 1] : 0.0f;
  float sc_next = L >= 16 ? scale[(L >> 4) - 1] : 1.0f;  // the first scale
  for (int t0 = 0; t0 < Lw; t0 += 16) {
#pragma unroll
    for (int u = 0; u < 16; u += 2) {
      backward_step(z, z.ea, z.eb, s, L - 1 - (t0 + u), table, pb, scale,
                    prob, pbi, sc_next, far, zinv, j, base, b2b, f2f, pre,
                    p_mask, mask_letter);
      backward_step(z, z.eb, z.ea, s, L - 2 - (t0 + u), table, pb, scale,
                    prob, pbi, sc_next, far, zinv, j, base, b2b, f2f, pre,
                    p_mask, mask_letter);
    }
  }
}

}  // namespace

extern "C" int tantan_mask_launch(const void* order, const void* starts,
                                  const void* lens, const void* scale_off,
                                  int n, void* letters, void* pb, void* scale,
                                  void* probs, const void* ratios,
                                  const void* d, float b2b, float f2f,
                                  float p_repeat_end, float p_mask,
                                  int mask_letter, void* stream) {
  if (n <= 0) return 0;
  constexpr int PER_BLOCK = WARPS * SEQS;
  const int blocks = (n + PER_BLOCK - 1) / PER_BLOCK;
  tantan_mask_kernel<<<blocks, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(order), static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(lens),
      static_cast<const int64_t*>(scale_off), n,
      static_cast<int8_t*>(letters), static_cast<float*>(pb),
      static_cast<float*>(scale), static_cast<float*>(probs),
      static_cast<const float*>(ratios), static_cast<const float*>(d), b2b,
      f2f, p_repeat_end, p_mask, mask_letter);
  return static_cast<int>(cudaGetLastError());
}
