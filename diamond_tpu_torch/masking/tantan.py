"""Tantan repeat masking (Frith 2011), float32 forward-backward.

Re-implementation of the reference's vectorized tantan
(reference src/masking/tantan.cpp:115-215, src/masking/masking.cpp:132-168)
with the same float32 arithmetic order so mask decisions agree:
  - 50 repeat-offset states, likelihood ratios exp(lambda * score),
  - scaling by 1/b every 16 positions,
  - mask position i when P(repeat) >= 0.9.

The per-position loop is sequential (HMM scan) but vectorizes across the 50
states here, and across whole sequence batches in the jax twin (a
lax.scan over positions with [batch, 50] state).
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_COUNT, LETTER_MASK, MASK_LETTER

WINDOW = 50


def lambda_calculator(matrix20: np.ndarray) -> float:
    """Matrix lambda via inverse-sum balancing (reference
    src/lib/tantan/LambdaCalculator.cc:261-410): the unique lambda where the
    entries of inv(exp(lambda*S)) sum to 1 (giving valid letter probs)."""
    S = np.asarray(matrix20, dtype=np.float64)
    n = S.shape[0]

    # upper bound (LambdaCalculator::find_ub)
    r_max_min = min(S.max(axis=1).min(), S.max(axis=0).min())
    ub = 1.1 * np.log(float(n)) / r_max_min
    lb = ub * 1e-6

    def inv_sum(lam):
        try:
            y = np.linalg.inv(np.exp(lam * S))
        except np.linalg.LinAlgError:
            return None
        return float(y.sum())

    # find a sign-bracketing pair deterministically
    lo, hi = lb, ub
    grid = np.linspace(lb, ub, 64)
    vals = [(g, inv_sum(g)) for g in grid]
    vals = [(g, v) for g, v in vals if v is not None and np.isfinite(v)]
    bracket = None
    for (g1, v1), (g2, v2) in zip(vals, vals[1:]):
        if (v1 - 1.0) * (v2 - 1.0) <= 0:
            bracket = (g1, v1, g2, v2)
            break
    if bracket is None:
        raise RuntimeError("tantan lambda: no bracket found")
    l, l_sum, r, r_sum = bracket
    while l_sum != 1.0 and r_sum != 1.0:
        mid = (l + r) / 2.0
        if mid == l or mid == r:
            break
        mid_sum = inv_sum(mid)
        if mid_sum is None:
            break
        if (l_sum < 1.0 <= mid_sum) or (l_sum > 1.0 >= mid_sum):
            r, r_sum = mid, mid_sum
        else:
            l, l_sum = mid, mid_sum
    return l if abs(l_sum - 1.0) < abs(r_sum - 1.0) else r


class Tantan:
    """Repeat masker with a precomputed likelihood-ratio matrix."""

    def __init__(self, matrix32: np.ndarray, p_repeat: float = 0.005,
                 p_repeat_end: float = 0.05, repeat_growth: float = 1.0 / 0.9,
                 p_mask: float = 0.9):
        lam = lambda_calculator(matrix32[:20, :20])
        self.lam = lam
        # 64x64 likelihood table like the reference (alphabet_size=26 rows
        # used); entries outside the alphabet never get read because letters
        # are masked to 0..31 and delimiter rows give ratio 0.
        self.ratios = np.zeros((32, 32), dtype=np.float32)
        n = AMINO_ACID_COUNT
        self.ratios[:n, :n] = np.exp(lam * matrix32[:n, :n].astype(np.float64)).astype(np.float32)
        self.p_repeat = np.float32(p_repeat)
        self.p_repeat_end = np.float32(p_repeat_end)
        self.repeat_growth = np.float32(repeat_growth)
        self.p_mask = np.float32(p_mask)
        self.b2b = np.float32(1.0 - p_repeat)
        self.f2f = np.float32(1.0 - p_repeat_end)
        g = np.float32(repeat_growth)
        b2f0 = np.float32(p_repeat) * (np.float32(1.0) - g) / (
            np.float32(1.0) - g ** np.float32(WINDOW))
        d = np.zeros(WINDOW, dtype=np.float32)
        d[WINDOW - 1] = b2f0
        for i in range(WINDOW - 2, -1, -1):
            d[i] = d[i + 1] * g
        self.d = d

    def repeat_prob(self, letters: np.ndarray) -> np.ndarray:
        """P(position is repeat) per position, float32 forward-backward.

        The repeat-offset state e-values: at position i, state off (0-based)
        refers to a repeat of period (off+1); its emission ratio is
        ratio(seq[i], seq[i-off-1]) (0 when out of range).

        Runs the native C++ scan when available (bit-identical float32
        order; diamond_tpu/native/src/tantan.cc); this Python body is the
        fallback and test oracle."""
        from diamond_tpu_torch import native

        r = native.tantan_repeat_prob(
            np.asarray(letters, dtype=np.int8), self.ratios,
            float(self.p_repeat), float(self.p_repeat_end),
            float(self.repeat_growth))
        if r is not None:
            return r
        seq = (np.asarray(letters).astype(np.uint8) & LETTER_MASK).astype(np.int64)
        L = len(seq)
        if L == 0:
            return np.zeros(0, dtype=np.float32)
        # Emission table: e[i, off] = ratios[seq[i], seq[i-off-1]], 0 if i-off-1 < 0
        # (reference builds per-letter reversed rows; same values.)
        idx = np.arange(L)[:, None] - (np.arange(WINDOW)[None, :] + 1)
        valid = idx >= 0
        e = np.where(valid, self.ratios[seq[:, None], seq[np.clip(idx, 0, L - 1)]],
                     np.float32(0.0)).astype(np.float32)

        f = np.zeros(WINDOW, dtype=np.float32)
        b = np.float32(1.0)
        f_sum = np.float32(0.0)
        pb = np.zeros(L, dtype=np.float32)
        scale = np.zeros((L + 15) // 16, dtype=np.float32)
        d = self.d
        f2f, b2b, pre = self.f2f, self.b2b, self.p_repeat_end

        for i in range(L):
            b_old = b
            f = (f * f2f + b_old * d) * e[i]
            f_sum_new = np.float32(f.sum(dtype=np.float32))
            b = b_old * b2b + f_sum * pre
            f_sum = f_sum_new
            if (i & 15) == 15:
                s = np.float32(1.0) / b
                scale[i // 16] = s
                b *= s
                f *= s
                f_sum *= s
            pb[i] = b

        z = b * b2b + np.float32(f.sum(dtype=np.float32)) * pre
        zinv = np.float32(1.0) / z

        out = np.zeros(L, dtype=np.float32)
        b = b2b
        f = np.full(WINDOW, pre, dtype=np.float32)
        for i in range(L - 1, -1, -1):
            pf = np.float32(1.0) - pb[i] * b * zinv
            if (i & 15) == 15:
                s = scale[i // 16]
                b *= s
                f *= s
            # backward step
            fe = f * e[i]
            tsum = np.float32((fe * d).sum(dtype=np.float32))
            f = fe * f2f + pre * b
            b = b2b * b + tsum
            out[i] = pf
        return out

    def mask(self, letters: np.ndarray, hard: bool = True):
        """Return (masked copy, ranges list) with P(repeat) >= p_mask masked."""
        prob = self.repeat_prob(letters)
        sel = prob >= self.p_mask
        out = np.array(letters, copy=True)
        if hard:
            out[sel] = MASK_LETTER
        ranges = _to_ranges(np.nonzero(sel)[0])
        return out, ranges


def _to_ranges(idx: np.ndarray):
    if len(idx) == 0:
        return []
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    starts = np.concatenate([[idx[0]], idx[breaks + 1]])
    ends = np.concatenate([idx[breaks] + 1, [idx[-1] + 1]])
    return list(zip(starts.tolist(), ends.tolist()))
