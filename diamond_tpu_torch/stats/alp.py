"""Gapped Gumbel parameter estimation for custom scoring matrices.

Replaces the reference's ALP library (reference
src/lib/alp/sls_alignment_evaluer.hpp, invoked for custom matrices at
src/stats/score_matrix.cpp:184 initGapped) with a numerically-verified
reimplementation:

- gapped lambda and K by Altschul's island method (Altschul, Bundschuh,
  Olsen, Hwa, NAR 29:351 (2001)): random iid sequence pairs under the
  BLOSUM62 background, full Smith-Waterman with island decomposition,
  maximum-likelihood lattice estimators on island scores above a cutoff
- the finite-size-correction coefficients (a, b, alpha, beta, sigma,
  tau of the Sheetlin-Park-Spouge theory) by regressing aligned-length
  statistics of optimal alignments against their scores

Deterministic given the seed.  Verified against the ALP values printed
by the reference binary for matrices treated as custom files
(tests/test_stats.py::test_custom_matrix_params).
"""
from __future__ import annotations

import math

import numpy as np


def _sim_pair_islands(q, t, matrix20, go: int, ge: int):
    """Full SW over one random pair; returns per-island best scores.

    Island = connected run of positive-scoring cells along the optimal
    predecessor choice; each cell inherits the island of the predecessor
    that realized its max, a zero cell starts a new island.  Runs through
    the C++ twin (native/src/alp_sim.cc); this Python body is the
    bit-identical oracle."""
    from diamond_tpu_torch import native

    r = native.sw_islands_native(np.ascontiguousarray(q, dtype=np.int8),
                                 np.ascontiguousarray(t, dtype=np.int8),
                                 matrix20, go, ge)
    if r is not None:
        return [int(x) for x in r]
    qlen, tlen = len(q), len(t)
    sub = matrix20[q]                       # [qlen, 20]
    H = np.zeros(qlen + 1, dtype=np.int64)
    E = np.zeros(qlen + 1, dtype=np.int64)
    Hid = np.full(qlen + 1, -1, dtype=np.int64)
    Eid = np.full(qlen + 1, -1, dtype=np.int64)
    island_best: list[int] = []

    for j in range(tlen):
        col = sub[:, t[j]]
        diagH = H[:-1].copy()
        diagId = Hid[:-1].copy()
        # E (gap in query dimension, horizontal) per row
        Ev = np.maximum(E[1:] - ge, H[1:] - go)
        Eid_new = np.where(E[1:] - ge >= H[1:] - go, Eid[1:], Hid[1:])
        cand = diagH + col
        # F (vertical) must run sequentially; python loop per row
        Hn = np.zeros(qlen + 1, dtype=np.int64)
        HnId = np.full(qlen + 1, -1, dtype=np.int64)
        Fv = 0
        Fid = -1
        for i in range(1, qlen + 1):
            c = cand[i - 1]
            cid = diagId[i - 1]
            if Ev[i - 1] > c:
                c = Ev[i - 1]
                cid = Eid_new[i - 1]
            if Fv > c:
                c = Fv
                cid = Fid
            if c <= 0:
                c = 0
                cid = -1
            else:
                if cid == -1:
                    island_best.append(0)
                    cid = len(island_best) - 1
                if c > island_best[cid]:
                    island_best[cid] = int(c)
            Hn[i] = c
            HnId[i] = cid
            nf = max(Fv - ge, c - go)
            if Fv - ge >= c - go:
                pass  # Fid unchanged
            else:
                Fid = cid
            Fv = nf
        H, Hid = Hn, HnId
        E[1:] = Ev
        Eid[1:] = Eid_new
    return island_best


def island_lambda_k(matrix20, bg, gap_open: int, gap_extend: int,
                    n_pairs: int = 24, length: int = 3000, seed: int = 1):
    """Island-method (lambda, K) for gapped local alignment.

    Lattice ML estimators on island scores >= c (Altschul et al. 2001,
    eqs. 7/8): lambda = ln(1 + k / sum(S_i - c)), K = k e^{lambda c} /
    (sum of effective areas)."""
    rng = np.random.default_rng(seed)
    go = gap_open + gap_extend
    ge = gap_extend
    scores: list[int] = []
    area = 0.0
    for _ in range(n_pairs):
        q = rng.choice(20, size=length, p=bg)
        t = rng.choice(20, size=length, p=bg)
        scores.extend(_sim_pair_islands(q, t, matrix20, go, ge))
        area += float(length) * float(length)
    s = np.asarray(scores, dtype=np.float64)
    s = s[s > 0]
    srt = np.sort(s)

    def est(min_k):
        c = float(srt[-min_k]) if len(srt) >= min_k else float(srt[0])
        sel = s >= c
        k = int(sel.sum())
        excess = float((s[sel] - c).sum())
        lam = math.log1p(k / max(excess, 1e-9))
        K = k * math.exp(lam * c) / area
        return c, lam, K

    # lambda-hat(c) drifts down toward the true lambda as the cutoff
    # deepens (sub-asymptotic bias); estimate at three tail depths and
    # extrapolate the geometric tail of the drift (clamped to one more
    # step so a noisy deepest point cannot overshoot)
    c1, l1, _ = est(12000)
    c2, l2, _ = est(4000)
    c3, l3, K3 = est(1500)
    d1 = l1 - l2
    d2 = l2 - l3
    corr = 0.0
    if d1 > 1e-12 and 0.0 < d2 < d1:
        r = d2 / d1
        corr = min(d2 * r / (1.0 - r), d2)
    lam = l3 - corr
    # K re-fit at the deepest cutoff with the corrected lambda
    sel = s >= c3
    k = int(sel.sum())
    K = k * math.exp(lam * c3) / area
    return lam, K


def _sw_traceback_stats(q, t, matrix20, go, ge):
    """Optimal SW score + aligned length in each sequence (for the FSC
    regressions), via the existing banded oracle over the full matrix."""
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_np

    m32 = np.full((32, 32), -127, dtype=np.int32)
    m32[:20, :20] = matrix20
    r = banded_swipe_np(q.astype(np.int8), t.astype(np.int8),
                        -(len(t) - 1), len(q), m32, None, go - ge, ge,
                        traceback=True)
    if r.score <= 0 or r.query_range is None:
        return None
    return (r.score, r.query_range[1] - r.query_range[0],
            r.subject_range[1] - r.subject_range[0])


def fsc_coefficients(matrix20, bg, gap_open: int, gap_extend: int,
                     lam: float, n_pairs: int = 60, length: int = 320,
                     seed: int = 7):
    """Regress aligned lengths I (query) and J (subject) of optimal
    alignments against score S: mean ~ a S + b, var ~ alpha S + beta,
    cov(I,J) ~ sigma S + tau — the Sheetlin-Park-Spouge coefficients the
    finite-size correction consumes."""
    rng = np.random.default_rng(seed)
    go = gap_open + gap_extend
    ge = gap_extend
    S, I, J = [], [], []
    for _ in range(n_pairs):
        q = rng.choice(20, size=length, p=bg)
        t = rng.choice(20, size=length, p=bg)
        r = _sw_traceback_stats(q, t, matrix20, go, ge)
        if r is not None and r[0] >= 10:
            S.append(r[0])
            I.append(r[1])
            J.append(r[2])
    S = np.asarray(S, dtype=np.float64)
    I = np.asarray(I, dtype=np.float64)
    J = np.asarray(J, dtype=np.float64)
    if len(S) < 10 or S.std() == 0:
        # degenerate fallback: ungapped-like coefficients
        return dict(a_I=1.0 / lam, b_I=0.0, a_J=1.0 / lam, b_J=0.0,
                    alpha_I=1.0 / lam, beta_I=0.0, alpha_J=1.0 / lam,
                    beta_J=0.0, sigma=1.0 / lam, tau=0.0)

    def linfit(y):
        A = np.vstack([S, np.ones_like(S)]).T
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        return float(coef[0]), float(coef[1])

    a_I, b_I = linfit(I)
    a_J, b_J = linfit(J)
    # variance/covariance regressions on squared residuals
    rI = I - (a_I * S + b_I)
    rJ = J - (a_J * S + b_J)
    alpha_I, beta_I = linfit(rI * rI)
    alpha_J, beta_J = linfit(rJ * rJ)
    sigma, tau = linfit(rI * rJ)
    alpha_I = max(alpha_I, 0.0)
    alpha_J = max(alpha_J, 0.0)
    sigma = max(sigma, 0.0)
    return dict(a_I=a_I, b_I=b_I, a_J=a_J, b_J=b_J, alpha_I=alpha_I,
                beta_I=beta_I, alpha_J=alpha_J, beta_J=beta_J, sigma=sigma,
                tau=tau)


def gapped_params(matrix20, bg, gap_open: int, gap_extend: int,
                  seed: int = 1):
    """Full GumbelParams estimate for a custom matrix (the ALP
    initGapped replacement)."""
    from diamond_tpu_torch.stats.evalue import GumbelParams

    lam, K = island_lambda_k(matrix20, bg, gap_open, gap_extend, seed=seed)
    fsc = fsc_coefficients(matrix20, bg, gap_open, gap_extend, lam,
                           seed=seed + 6)
    return GumbelParams(lam=lam, K=K, **fsc)
