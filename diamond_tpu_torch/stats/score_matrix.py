"""Scoring matrices with Karlin-Altschul statistics.

TPU-native equivalent of the reference ScoreMatrix (reference
src/stats/score_matrix.h:58-247, score_matrix.cpp).  The 32x32 padded layout
is kept because it gives power-of-two strides for device gathers, but all
matrices live as numpy/jax arrays instead of aligned C arrays.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from diamond_tpu_torch.constants._matrix_data import MATRICES
from diamond_tpu_torch.constants.alphabet import AMINO_ACID_COUNT, TRUE_AA, encode
from diamond_tpu_torch.stats import evalue as ev

LN_2 = math.log(2.0)

# Mapping of our alphabet order (ARNDCQEGHILKMFPSTWYV) into the NCBIstdaa
# ordering used by the frequency-ratio tables (reference
# src/stats/comp_based_stats.cpp:70).
ALPH_TO_NCBI = np.array(
    [1, 16, 13, 4, 3, 15, 5, 7, 8, 9, 11, 10, 12, 6, 14, 17, 18, 20, 22, 19],
    dtype=np.int64,
)

# Robinson & Robinson amino-acid background frequencies (public data,
# reference src/stats/comp_based_stats.cpp:476-499), in our alphabet order.
_ROBINSON = {
    "A": 78.05, "C": 19.25, "D": 53.64, "E": 62.95, "F": 38.56, "G": 73.77,
    "H": 21.99, "I": 51.42, "K": 57.44, "L": 90.19, "M": 22.43, "N": 44.87,
    "P": 52.03, "Q": 42.64, "R": 51.29, "S": 71.20, "T": 58.41, "V": 64.41,
    "W": 13.30, "Y": 32.16,
}


def robinson_freqs() -> np.ndarray:
    bg = np.zeros(TRUE_AA)
    for c, v in _ROBINSON.items():
        bg[int(encode(c)[0])] = v
    return bg / bg.sum()


def karlin_lambda(probs: np.ndarray, lo: int, hi: int, lambda0: float = 0.5) -> float:
    """Solve sum_s p(s) * exp(lambda*s) = 1 for lambda > 0.

    Same root as NCBI's NlmKarlinLambdaNR (reference
    src/stats/comp_based_stats.cpp / blast); solved here by Newton iteration
    on f(L) = sum p_s exp(L*s) - 1 with bisection safeguarding.
    """
    s = np.arange(lo, hi + 1, dtype=np.float64)
    p = np.asarray(probs, dtype=np.float64)

    def f(lam):
        return float(np.sum(p * np.exp(lam * s)) - 1.0)

    def fp(lam):
        return float(np.sum(p * s * np.exp(lam * s)))

    # bracket the positive root
    a, b = 1e-10, lambda0
    while f(b) < 0:
        a = b
        b *= 2.0
        if b > 100:
            return -1.0
    lam = 0.5 * (a + b)
    for _ in range(100):
        v = f(lam)
        if v > 0:
            b = lam
        else:
            a = lam
        d = fp(lam)
        nl = lam - v / d if d != 0 else 0.5 * (a + b)
        lam = nl if a < nl < b else 0.5 * (a + b)
        if b - a < 1e-15 * lam:
            break
    return lam


def matrix_score_probs(matrix20: np.ndarray, bg_row: np.ndarray, bg_col: np.ndarray):
    """Probability of each score value under background frequencies."""
    lo = int(matrix20.min())
    hi = int(matrix20.max())
    probs = np.zeros(hi - lo + 1)
    w = np.outer(bg_row, bg_col)
    np.add.at(probs, (matrix20 - lo).ravel(), w.ravel())
    return probs, lo, hi


def _padded(scores: np.ndarray, n: int, stop_match_score: int = 1, bias: int = 0,
            modulo: int = 32, offset: int = 0, fill: int = -128) -> np.ndarray:
    """Build the 32x32 padded matrix (reference score_matrix.h:35-44)."""
    out = np.full((32, 32), fill, dtype=np.int32)
    for i in range(32):
        for j in range(32):
            j2 = j % modulo + offset
            if i < n and j2 < n:
                out[i, j] = int(scores[i * n + j2]) + bias
    if stop_match_score != 1:
        out[24, 24] = stop_match_score
    return out


def parse_custom_matrix(path: str, mask_score: int):
    """Parse a custom scoring matrix file (reference
    score_matrix.cpp:110-155 custom_scores): a header row of letters,
    then one row per letter; unspecified pairs get mask_score, and the
    SUPER_HARD_MASK letter scores min_score against everything."""
    from diamond_tpu_torch.constants.alphabet import AMINO_ACID_COUNT, encode

    scores = np.full((AMINO_ACID_COUNT, AMINO_ACID_COUNT), mask_score,
                     dtype=np.int64)
    pos = None
    n = 0
    min_score = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            if pos is None:
                pos = [int(encode(ch)[0]) for ch in line.split()]
                continue
            if n >= len(pos):
                break
            toks = line.split()
            row_letter = int(encode(toks[0])[0])
            if row_letter != pos[n]:
                raise ValueError("Invalid custom scoring matrix file format.")
            for i, tok in enumerate(toks[1 : len(pos) + 1]):
                v = int(tok)
                scores[pos[n], pos[i]] = v
                min_score = v if min_score is None else min(min_score, v)
            n += 1
    if min_score is not None:
        from diamond_tpu_torch.constants.alphabet import SUPER_HARD_MASK

        scores[:, SUPER_HARD_MASK] = min_score
        scores[SUPER_HARD_MASK, :] = min_score
    return scores


def custom_matrix(path: str, gap_open: int, gap_extend: int,
                  stop_match_score: int = 1, seed: int = 1):
    """ScoreMatrix for a --custom-matrix file (reference
    score_matrix.cpp:156-192): scores from the file, BLOSUM62 background
    frequencies, and gapped Gumbel/FSC parameters from the exact ALP
    evaluer port (stats/alp_exact.py — reproduces the reference's
    initGapped output; tests/test_alp_oracle.py pins it against the
    committed oracle vectors).  Parameters are cached per
    (file, penalties, seed)."""
    import hashlib
    import json
    import os
    import tempfile

    from diamond_tpu_torch.constants.alphabet import AMINO_ACID_COUNT, TRUE_AA
    from diamond_tpu_torch.stats import evalue as ev

    if gap_open < 0 or gap_extend < 0:
        raise ValueError("--custom-matrix requires explicit --gapopen and "
                         "--gapextend")
    scores = parse_custom_matrix(path, -gap_extend)
    m = ScoreMatrix.__new__(ScoreMatrix)
    m.name = "custom"
    m._data = None
    m.gap_open = gap_open
    m.gap_extend = gap_extend
    m.frame_shift = 0
    m.stop_match_score = stop_match_score
    m.db_letters = 0
    m.scale = 1
    n = AMINO_ACID_COUNT
    m.matrix32 = _padded(scores.ravel(), n, stop_match_score)
    m.matrix8 = m.matrix32.astype(np.int8)
    m.matrix16 = m.matrix32.astype(np.int16)
    aa = m.matrix32[:n, :n]
    iu = np.triu_indices(n, k=1)
    m.low_score = int(np.int8(aa[iu].min()))
    m.high_score = int(np.int8(aa[np.triu_indices(n)].max()))
    m.bias = -m.low_score
    m.matrix8u = _padded(scores.ravel(), n, stop_match_score,
                         bias=m.bias).astype(np.uint8)
    bg = np.asarray(MATRICES["BLOSUM62"]["background_freqs"],
                    dtype=np.float64)[:TRUE_AA]
    bg = bg / bg.sum()
    m.background_freqs = bg
    m.joint_probs = None
    m.freq_ratios = None
    m.background_scores = m.matrix32[:TRUE_AA, :TRUE_AA].astype(
        np.float64) @ bg
    probs, lo, hi = matrix_score_probs(m.matrix32[:TRUE_AA, :TRUE_AA],
                                       bg, bg)
    m.ideal_lambda = karlin_lambda(probs, lo, hi)
    m.ungapped_lambda = m.ideal_lambda
    m.matrix32_scaled = None  # CBS matrix adjust unsupported (no ratios)

    with open(path, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(tempfile.gettempdir(),
                         f"diamond_tpu_alp_{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    key = os.path.join(cache, f"{h}_{gap_open}_{gap_extend}_{seed}.json")
    if os.path.exists(key):
        with open(key) as f:
            d = json.load(f)
        m.gumbel = ev.GumbelParams(**d)
    else:
        from diamond_tpu_torch.stats.alp_exact import gapped_params_exact

        m20 = np.ascontiguousarray(m.matrix32[:TRUE_AA, :TRUE_AA],
                                   dtype=np.int32)
        r = gapped_params_exact(m20, bg, None, gap_open, gap_extend,
                                seed=seed)
        m.gumbel = ev.GumbelParams(
            lam=r["lambda"], K=r["K"], a_I=r["a_I"], b_I=r["b_I"],
            a_J=r["a_J"], b_J=r["b_J"], alpha_I=r["alpha_I"],
            beta_I=r["beta_I"], alpha_J=r["alpha_J"],
            beta_J=r["beta_J"], sigma=r["sigma"], tau=r["tau"])
        with open(key, "w") as f:
            json.dump({k: v for k, v in m.gumbel.__dict__.items()
                       if not k.startswith("_")}, f)
    m.ln_k = m.gumbel.ln_k
    m._ungapped = None
    m._gapped = None
    return m


class ScoreMatrix:
    """A named scoring matrix with gap penalties and Gumbel statistics."""

    def __init__(self, name: str = "BLOSUM62", gap_open: int = -1, gap_extend: int = -1,
                 frame_shift: int = 0, stop_match_score: int = 1,
                 db_letters: int = 0, scale: int = 1):
        data = MATRICES.get(name.upper())
        if data is None:
            raise ValueError(f"Unknown scoring matrix: {name}")
        self.name = name.upper()
        self._data = data
        self.gap_open = data["default_gap_exist"] if gap_open == -1 else gap_open
        self.gap_extend = data["default_gap_extend"] if gap_extend == -1 else gap_extend
        self.frame_shift = frame_shift
        self.stop_match_score = stop_match_score
        self.db_letters = db_letters
        self.scale = scale

        n = data["score_n"]
        scores = np.asarray(data["scores"], dtype=np.int32)
        self.matrix32 = _padded(scores, n, stop_match_score)
        self.matrix8 = self.matrix32.astype(np.int8)
        self.matrix16 = self.matrix32.astype(np.int16)

        aa = self.matrix32[:AMINO_ACID_COUNT, :AMINO_ACID_COUNT]
        iu = np.triu_indices(AMINO_ACID_COUNT, k=1)
        self.low_score = int(np.int8(aa[iu].min()))
        self.high_score = int(np.int8(aa[np.triu_indices(AMINO_ACID_COUNT)].max()))
        self.bias = -self.low_score
        self.matrix8u = _padded(scores, n, stop_match_score, bias=self.bias).astype(np.uint8)

        # Gumbel statistics from the precomputed table.
        params = data["params"]
        self._ungapped = params[0]
        gapped = None
        for row in params:
            if row[0] == self.gap_open and row[1] == self.gap_extend:
                gapped = row
                break
        if gapped is None:
            raise ValueError(
                "Gap penalty settings are outside the supported range for this scoring matrix.")
        self._gapped = gapped
        self.gumbel = ev.from_standard_params(gapped, self._ungapped, self.gap_open, self.gap_extend)
        self.ln_k = self.gumbel.ln_k

        self.background_freqs = np.asarray(data["background_freqs"], dtype=np.float64)
        self.joint_probs = np.asarray(data["joint_probs"], dtype=np.float64)
        self.freq_ratios = np.asarray(data["freq_ratios"], dtype=np.float64)
        # per-letter expected score against background (reference
        # score_matrix.cpp:241-248 init_background_scores, always blosum62 bg)
        b62 = np.asarray(MATRICES["BLOSUM62"]["background_freqs"], dtype=np.float64)
        self.background_scores = self.matrix32[:TRUE_AA, :TRUE_AA].astype(np.float64) @ b62

        # lambda of this matrix under Robinson background freqs (for CBS).
        bg = robinson_freqs()
        probs, lo, hi = matrix_score_probs(self.matrix32[:TRUE_AA, :TRUE_AA], bg, bg)
        self.ideal_lambda = karlin_lambda(probs, lo, hi)
        self.ungapped_lambda = self._ungapped[3]

        # CBS-scaled matrix from frequency ratios (reference
        # score_matrix.cpp:193-205): round(log(fr)/ungapped_lambda*scale).
        fr = self.freq_ratios
        idx = ALPH_TO_NCBI
        m = np.full((32, 32), -128, dtype=np.int32)
        with np.errstate(divide="ignore"):
            core = np.log(fr[np.ix_(idx, idx)]) / self._ungapped[3] * scale
        m[:TRUE_AA, :TRUE_AA] = np.round(core).astype(np.int32)
        mask = np.zeros((32, 32), dtype=bool)
        mask[:n, :n] = True
        mask[:TRUE_AA, :TRUE_AA] = False
        m[mask] = (self.matrix32 * scale)[mask]
        self.matrix32_scaled = m

    # -- score lookups -----------------------------------------------------
    def __call__(self, a, b) -> int:
        return int(self.matrix32[int(a), int(b)])

    def row(self, a) -> np.ndarray:
        return self.matrix32[int(a)]

    # -- statistics ---------------------------------------------------------
    @property
    def lam(self) -> float:
        return self.gumbel.lam

    @property
    def k(self) -> float:
        return self.gumbel.K

    def set_db_letters(self, n: int):
        self.db_letters = n

    def bitscore(self, raw_score) -> float:
        if not isinstance(raw_score, np.ndarray):
            # scalar fast path; round-half-even matches np.round
            s = float(round(float(raw_score) / self.scale))
            return (self.gumbel.lam * s - self.ln_k) / LN_2
        s = np.round(np.asarray(raw_score, np.float64) / self.scale)  # BLAST compat
        return (self.gumbel.lam * s - self.ln_k) / LN_2

    def rawscore(self, bit_score) -> int:
        return int(math.ceil((bit_score * LN_2 + self.ln_k) / self.gumbel.lam))

    def evalue(self, raw_score, query_len, subject_len):
        """E-value vs the whole database (reference score_matrix.cpp:217-220)."""
        if not isinstance(raw_score, np.ndarray):
            e = ev.evalue1(self.gumbel, float(raw_score) / self.scale,
                           query_len, subject_len)
            return e * float(self.db_letters) / float(subject_len)
        e = ev.evalue(self.gumbel, np.asarray(raw_score, np.float64) / self.scale,
                      query_len, subject_len)
        return e * float(self.db_letters) / np.asarray(subject_len, np.float64)

    def evalue_norm(self, raw_score, query_len, subject_len):
        if not isinstance(raw_score, np.ndarray):
            e = ev.evalue1(self.gumbel, float(raw_score) / self.scale,
                           query_len, subject_len)
            return e * 1e9 / float(subject_len)
        e = ev.evalue(self.gumbel, np.asarray(raw_score, np.float64) / self.scale,
                      query_len, subject_len)
        return e * 1e9 / np.asarray(subject_len, np.float64)

    def bitscore_corrected(self, raw_score, query_len, subject_len):
        if not isinstance(raw_score, np.ndarray):
            return ev.bitscore_corrected1(self.gumbel, raw_score,
                                          query_len, subject_len)
        return ev.bitscore_corrected(self.gumbel, raw_score, query_len, subject_len)

    def report_cutoff(self, score, evalue_, max_evalue=0.001, min_bit_score=0.0):
        if min_bit_score != 0:
            return self.bitscore(score) >= min_bit_score
        return evalue_ <= max_evalue

    def avg_id_score(self) -> float:
        return float(np.trace(self.matrix32[:TRUE_AA, :TRUE_AA])) / TRUE_AA

    def __repr__(self):
        return (f"(Matrix={self.name} Lambda={self.lam} K={self.k} "
                f"Penalties={self.gap_open}/{self.gap_extend})")


@lru_cache(maxsize=16)
def get_matrix(name: str = "BLOSUM62", gap_open: int = -1, gap_extend: int = -1,
               frame_shift: int = 0, stop_match_score: int = 1, scale: int = 1) -> ScoreMatrix:
    return ScoreMatrix(name, gap_open, gap_extend, frame_shift, stop_match_score, scale=scale)
