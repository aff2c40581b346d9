// One target column of the banded local affine-gap DP for a band held by
// one warp: the column step shared by the banded extension kernel
// (banded_swipe.cu, K1), the uniform-band kernel's warp path
// (uniform_swipe.cu, K4) and the traceback fill (banded_traceback.cu,
// D4).  They differ only in where a cell's score comes from and in what
// they keep of each row (D4: its trace plane bits, through the hook);
// everything after the score is this step.
//
// Layout: lane l holds band rows r0 = l * R .. r0 + R - 1 in registers.
// The recurrence is ops/swipe_uniform.column_step's, exact:
//   cur0[r] = max(H[r] + s[r], E[r], 0)
//   F[r]    = max(F[r-1] - ge, cur0[r] - go, 0), F[-1] = 0 (the lazy-F
//             prefix max; clamping at 0 changes no H since cur0 >= 0)
//   H'[r]   = valid[r] ? max(cur0[r], F[r-1]) : 0
//   E'[r]   = max(E[r+1] - ge, H'[r+1] - go, 0)  (E'[last] = 0)
// cur0 and F run over every row, valid or not, as in column_step.
//
// The vertical gap crosses lanes lazily: each lane runs its R rows with
// nothing entering, takes the previous lane's outgoing F (one shuffle) and
// votes whether that raised any lane's outgoing F; only then a 5-step
// max-plus warp scan carries the gaps on.  If no lane rose, the one carry
// is exact by induction over the lanes.  The max-plus steps are Hopper's
// DPX instructions (__viaddmax_s32_relu = max(a + b, c, 0),
// __viaddmax_s32 = max(a + b, c)).
//
// Best-cell tracking is per lane: a lane keeps its best, the first column
// it reached it and its highest row there.  band_result() reduces them to
// the band's (best, max_col, max_row): max_col the first column where the
// running best rises strictly (the first column any lane reached the
// final best), max_row the highest row among that column's ties, and
// (0, 0, 0) when nothing scores.  No reduction runs per column.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace warp_band {

constexpr unsigned FULL = 0xffffffffu;

struct Best {
  int best = 0, col = 0, row = 0;
};

// The per-row hook of a score-only caller: keeps nothing.
struct NoHook {
  __device__ __forceinline__ void operator()(int, int, int, int) const {}
};

// s[k]: the score of row r0 + k (NEG where the row scores nothing);
// valid bit k: the cell of row r0 + k exists.  H and E are updated in
// place; lb/lc/lr are the lane's best, its first column and highest row.
// hook(k, h, f, e) runs for every row-in-lane k on every lane of the warp
// at once (so it may vote): h the row's new H, f the vertical gap
// entering the row (F of the row above), e its E on entry.
template <int R, class Hook = NoHook>
__device__ __forceinline__ void column(int (&H)[R], int (&E)[R],
                                       const int (&s)[R], unsigned valid,
                                       int lane, int r0, int j, int go,
                                       int ge, int& lb, int& lc, int& lr,
                                       Hook&& hook = Hook()) {
  int cur0[R];
  int fo = 0;  // the lane's outgoing F with nothing entering its first row
#pragma unroll
  for (int k = 0; k < R; ++k) {
    cur0[k] = __viaddmax_s32_relu(H[k], s[k], E[k]);
    fo = __viaddmax_s32_relu(fo, -ge, cur0[k] - go);
  }
  // the previous lane's outgoing F enters this lane's first row
  int f_in = __shfl_up_sync(FULL, fo, 1);
  if (lane == 0) f_in = 0;
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
    if (lane == 0) f_in = 0;
  }

  int lmax = 0;
  int f = f_in;  // F of the row above
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int hn = (valid >> k) & 1u ? max(cur0[k], f) : 0;
    hook(k, hn, f, E[k]);
    f = __viaddmax_s32_relu(f, -ge, cur0[k] - go);
    lmax = max(lmax, hn);
    H[k] = hn;
  }
  if (lmax > lb) {  // a strict rise of the lane's best: its highest row
    int kr = 0;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (H[k] == lmax) kr = k;
    lb = lmax;
    lc = j;
    lr = r0 + kr;
  }

  // E for the next column: row r takes E_out of row r + 1
  const int e0 = __viaddmax_s32_relu(E[0], -ge, H[0] - go);
#pragma unroll
  for (int k = 0; k < R - 1; ++k)
    E[k] = __viaddmax_s32_relu(E[k + 1], -ge, H[k + 1] - go);
  int e_in = __shfl_down_sync(FULL, e0, 1);
  if (lane == 31) e_in = 0;
  E[R - 1] = e_in;
}

// The band's (best, max_col, max_row) from every lane's (lb, lc, lr).
__device__ __forceinline__ Best band_result(int lb, int lc, int lr) {
  Best out;
  out.best = __reduce_max_sync(FULL, lb);
  if (out.best > 0) {  // warp-uniform
    const bool top = lb == out.best;
    out.col = __reduce_min_sync(FULL, top ? lc : INT_MAX);
    out.row = __reduce_max_sync(FULL, top && lc == out.col ? lr : -1);
  }
  return out;
}

}  // namespace warp_band
