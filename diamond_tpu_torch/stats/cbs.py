"""Composition-based statistics (CBS).

Modes follow the reference (reference src/stats/cbs.h:185-214):
  0 = disabled
  1 = Hauser per-position bias correction (default)
  2 = conditional NCBI compositional matrix adjustment + Hauser
  3 = unconditional matrix adjustment
  4 = conditional matrix adjustment (no Hauser)

The Hauser correction (reference src/stats/hauser_correction.cpp:53-106) is
a sliding-window per-query-position score bias; here it is computed for a
whole block of sequences as a vectorized numpy/jax pass instead of the
reference's scalar loop.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.constants.alphabet import MASK_LETTER, TRUE_AA

# mode codes (reference cbs.h:185-194)
CBS_DISABLED = 0
CBS_HAUSER = 1
CBS_DEPRECATED1 = 2
CBS_HAUSER_AND_MATRIX_ADJUST = 3
CBS_MATRIX_ADJUST = 4
CBS_COMP_BASED_STATS_AND_MATRIX_ADJUST = 5
CBS_CONDITIONAL_MATRIX_ADJUST = 6
CBS_COUNT = 7

DEFAULT_WINDOW = 40


def hauser(code: int) -> bool:
    """Does this CBS mode apply the Hauser bias? (reference cbs.h:108-124)"""
    return code in (1, 2, 3)


def matrix_adjust(code: int) -> bool:
    return code in (2, 3, 4, 5, 6)


def conditioned(code: int) -> bool:
    """Matrix adjustment applied conditionally (angle test)?"""
    return code in (2, 3, 5, 6)


def composition(letters: np.ndarray) -> np.ndarray:
    """Normalized AA composition over the 20 true amino acids
    (reference src/stats/comp_based_stats.cpp Stats::composition)."""
    letters = np.asarray(letters)
    counts = np.bincount(letters[letters < TRUE_AA].astype(np.int64), minlength=TRUE_AA)
    n = counts.sum()
    if n == 0:
        return np.zeros(TRUE_AA)
    return counts.astype(np.float64) / n


def hauser_bias_i8(letters, matrix32, background_scores,
                   window: int = DEFAULT_WINDOW):
    """int8 Hauser bias via the native sliding-window kernel when
    available (bit-exact), else the numpy prefix-matrix path."""
    from diamond_tpu_torch import native

    r = native.hauser_bias_native(letters, matrix32, background_scores,
                                  window)
    if r is not None:
        return r
    return hauser_correction(letters, matrix32, background_scores,
                             window)[1]


def hauser_correction(letters: np.ndarray, matrix32: np.ndarray,
                      background_scores: np.ndarray, window: int = DEFAULT_WINDOW):
    """Per-position Hauser bias for one sequence.

    Returns (float_bias, int8_bias).  Mirrors the reference sliding-window
    exactly (reference hauser_correction.cpp:53-106): at position m the
    window covers positions [m-window/2, m+window/2] clipped to the
    sequence, n = window size + 1 capped; the bias is
      background_score[r] - (sum of matrix(r, seq[w]) over window, minus
      matrix(r,r)) / (n-1)
    for r = seq[m] when r < 20, else 0.
    """
    letters = np.asarray(letters, dtype=np.int64)
    L = len(letters)
    out = np.zeros(L, dtype=np.float64)
    if L == 0:
        return out, np.zeros(0, dtype=np.int8)
    window_half = min(window // 2, L - 1)

    # scores[m] = sum over window positions h of matrix(r, seq[h]).
    # Build prefix sums of matrix columns selected by sequence letters:
    # contrib[r, h] = matrix(r, seq[h]) -> prefix over h.
    contrib = matrix32[:TRUE_AA, letters]  # (20, L)
    prefix = np.concatenate([np.zeros((TRUE_AA, 1), dtype=np.int64),
                             np.cumsum(contrib, axis=1, dtype=np.int64)], axis=1)

    # Closed form of the reference's 5-phase h/t/m walk: the window at
    # position m is [t(m), h(m)) with
    #   h(m)  = min(m + window_half + 1, L)
    #   m0    = min(window_half, L - window_half - 1) + 1   (first m where t moves)
    #   t(m)  = 0 for m < m0, else min(m - m0 + 1, L - window_half - 1)
    # For long sequences this is the centered window [m-w/2, m+w/2]; the
    # leading/trailing ramps and the short-sequence frozen tail match the
    # reference loop structure exactly.
    r = letters
    idx_m = np.arange(L)
    h_end = np.minimum(idx_m + window_half + 1, L)
    m0 = min(window_half, L - window_half - 1) + 1
    t_start = np.where(idx_m < m0, 0,
                       np.minimum(idx_m - m0 + 1, L - window_half - 1))
    n_eff = h_end - t_start

    rc = np.clip(r, 0, TRUE_AA - 1)  # letters >= 20 produce 0 bias below
    win_sum = prefix[rc, h_end] - prefix[rc, t_start]
    diag = matrix32[rc, rc]
    denom = np.maximum(n_eff - 1, 1)
    vals = background_scores[rc] - ((win_sum - diag).astype(np.float64) / denom)
    out = np.where(r < TRUE_AA, vals, 0.0)
    i8 = np.where(out < 0.0, out - 0.5, out + 0.5).astype(np.int8)
    return out, i8


def adjust_rule(query_comp, query_len, code: int, target_letters,
                background_freqs) -> int:
    """Which adjustment rule applies for this target (reference
    cbs.cpp:94-110 adjust_matrix)."""
    from diamond_tpu_torch.stats import matrix_adjust as ma

    if not matrix_adjust(code) or len(target_letters) == 0 or query_len == 0:
        return ma.RULE_DONT
    c = composition(target_letters)
    if conditioned(code):
        rule = ma.conditional_rule(query_comp, query_len, c,
                                   len(target_letters), background_freqs)
        if code == CBS_COMP_BASED_STATS_AND_MATRIX_ADJUST:
            return rule
        return rule if rule == ma.RULE_USER_RE else ma.RULE_DONT
    return ma.RULE_USER_RE


def target_matrix(score_matrix, query_comp, query_len: int, code: int,
                  target_letters, rule: int, scale: int = 1):
    """Adjusted [query_letter, target_letter] 32x32 int32 matrix for the DP
    (reference cbs.cpp:112-173 TargetMatrix; note the reference stores the
    transpose and indexes matrix[target*32+query])."""
    from diamond_tpu_torch.stats import matrix_adjust as ma

    c = composition(target_letters)
    n_true = int((np.asarray(target_letters) < TRUE_AA).sum())
    s = None
    if rule == ma.RULE_USER_RE:
        s = ma.composition_matrix_adjust(
            query_len, n_true, query_comp, c, scale,
            score_matrix.ideal_lambda, score_matrix.joint_probs,
            score_matrix.background_freqs)
    if s is None:
        return None
    # embed into 32x32 [query, target]; non-adjusted letters fall back to the
    # base matrix (reference cbs.cpp:148-166)
    out = np.zeros((32, 32), dtype=np.int32)
    base = np.maximum(score_matrix.matrix32 * scale, -128)
    out[:, :] = base
    adj = np.array([i for i in range(26) if i < 20 or i == MASK_LETTER])
    qq, tt = np.meshgrid(adj, adj, indexing="ij")
    out[qq, tt] = np.clip(s[qq, tt], -128, 127)
    score_min = int(s[qq, tt].min())
    score_max = int(s[qq, tt].max())
    return out, score_min, score_max
