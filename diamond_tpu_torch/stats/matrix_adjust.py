"""NCBI compositional matrix adjustment (CBS modes 2-6).

Port of the constrained Newton optimizer and score generation (reference
src/stats/blast/matrix_adjust.cpp (scalar paths), src/stats/matrix_adjust.cpp,
src/stats/comp_based_stats.cpp) in float64 numpy.  The optimizer finds target
frequencies x (20x20) minimizing relative entropy to the matrix's joint
probabilities subject to row/column marginals and a fixed relative entropy
0.44 (kFixedReBlosum62), then converts to a rounded integer score matrix at
the ideal ungapped lambda.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_COUNT, MASK_LETTER, TRUE_AA

N = 20
N2 = 400
MA = 39  # number of linear constraints
M = 40

K_FIXED_RE_BLOSUM62 = 0.44
PSEUDOCOUNTS = 20
COMPO_SCORE_MIN = -128.0
K_MAX_X_SCORE = -1.0
HIGH_PAIR_THRESHOLD = 0.4
LENGTH_LOWER_THRESHOLD = 50


def _multiply_by_A(beta, y, alpha, x):
    """y = beta*y + alpha*A*x  (A = constraint matrix; reference
    MultiplyByA20)."""
    if beta == 0.0:
        y[:] = 0.0
    elif beta != 1.0:
        y *= beta
    xm = x.reshape(N, N)
    y[:N] += alpha * xm.sum(axis=0)        # column sums -> y[0..19]
    y[N:MA] += alpha * xm[1:].sum(axis=1)  # row sums i>=1 -> y[20..38]
    return y


def _multiply_by_A_transpose(beta, y, alpha, x):
    """y = beta*y + alpha*A^T*x (reference MultiplyByATranspose20)."""
    if beta == 0.0:
        y[:] = 0.0
    elif beta != 1.0:
        y *= beta
    add_row = np.zeros(N)
    add_row[1:] = x[N:MA]
    y += (alpha * (x[None, :N] + add_row[:, None])).reshape(N2)
    return y


def _scaled_symmetric_product_A(dinv):
    """W = A * diag(dinv) * A^T, lower triangle (reference
    ScaledSymmetricProductA20).  Returns full symmetric [MA, MA]."""
    D = dinv.reshape(N, N)
    W = np.zeros((M, M))
    # col-col block: W[j1,j2] = sum_i D[i,j] delta(j1==j2) -> diagonal only
    W[:N, :N][np.diag_indices(N)] = D.sum(axis=0)
    # row i (i>=1) vs col j: W[19+i, j] = D[i, j]
    W[N:MA, :N] = D[1:, :]
    W[:N, N:MA] = D[1:, :].T
    # row-row: diagonal W[19+i,19+i] = sum_j D[i,j]
    idx = np.arange(N, MA)
    W[idx, idx] = D[1:].sum(axis=1)
    return W


def _euclidean_norm(v):
    return float(np.linalg.norm(v))


def optimize_target_frequencies(q, row_sums, col_sums, constrain_re=True,
                                relative_entropy=K_FIXED_RE_BLOSUM62,
                                tol=1e-8, maxits=2000):
    """reference New_OptimizeTargetFrequencies.  Returns (x, converged)."""
    q = np.asarray(q, dtype=np.float64).reshape(N2)
    row_sums = np.asarray(row_sums, dtype=np.float64)
    col_sums = np.asarray(col_sums, dtype=np.float64)

    old_scores = np.log(q.reshape(N, N) /
                        (row_sums[:, None] * col_sums[None, :])).reshape(N2)
    x = q.copy()
    z = np.zeros(M)
    its = 0
    rnorm = 0.0
    while its <= maxits:
        t = np.log(x / q)
        grads0 = t + 1.0
        u = t + old_scores
        grads1 = u + 1.0
        values = (float(np.sum(x * t)), float(np.sum(x * u)))

        # residuals
        eta = z[MA]
        resids_x = -grads0 + eta * grads1
        _multiply_by_A_transpose(1.0, resids_x, 1.0, z)
        norm_x = _euclidean_norm(resids_x)
        resids_z = np.zeros(M)
        resids_z[:N] = col_sums
        resids_z[N:MA] = row_sums[1:]
        _multiply_by_A(1.0, resids_z[:MA], -1.0, x)
        resids_z[MA] = relative_entropy - values[1]
        norm_z = _euclidean_norm(resids_z)
        rnorm = float(np.sqrt(norm_x * norm_x + norm_z * norm_z))
        if not (rnorm > tol):
            break
        its += 1
        if its <= maxits:
            # factor Newton system
            s = 1.0 / (1.0 - eta)
            dinv = x * s
            W = _scaled_symmetric_product_A(dinv)
            grad_re = grads1.copy()
            workspace = dinv * grad_re
            W[MA, MA] = float(np.sum(grad_re * workspace))
            wrow = np.zeros(MA)
            _multiply_by_A(0.0, wrow, 1.0, workspace)
            W[MA, :MA] = wrow
            W[:MA, MA] = wrow
            L = np.linalg.cholesky(W)
            # solve
            step_x = resids_x
            step_z = resids_z
            ws2 = step_x * dinv
            _multiply_by_A(1.0, step_z[:MA], -1.0, ws2)
            step_z[MA] -= float(np.sum(grad_re * ws2))
            y = np.linalg.solve(L, step_z)
            step_z = np.linalg.solve(L.T, y)
            step_x = step_x + grad_re * step_z[MA]
            _multiply_by_A_transpose(1.0, step_x, 1.0, step_z)
            step_x *= dinv
            # step bound
            with np.errstate(divide="ignore", invalid="ignore"):
                alpha_i = -x / step_x
            alpha_i = alpha_i[(alpha_i >= 0) & np.isfinite(alpha_i)]
            alpha = min(1.0 / 0.95, float(alpha_i.min()) if len(alpha_i) else 1.0 / 0.95)
            alpha *= 0.95
            x = x + alpha * step_x
            z = z + alpha * step_z

    converged = its <= maxits and rnorm <= tol and z[MA] < 1.0
    return x, converged


def apply_pseudocounts(probs, n_obs, background):
    """reference Blast_ApplyPseudocounts (matrix_adjust.cpp:63-85)."""
    probs = np.asarray(probs, dtype=np.float64).copy()
    s = probs.sum()
    if s == 0.0:
        s = 1.0
    w = PSEUDOCOUNTS / (n_obs + PSEUDOCOUNTS)
    return (1.0 - w) * probs / s + w * np.asarray(background)


def _round_half_away(x):
    """C std::round: half away from zero (np.round is banker's)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


def scores_from_target_freqs(target_freqs, row_prob, col_prob, lam):
    """Target freqs -> rounded integer 26x26 matrix (reference
    s_ScoresStdAlphabet, comp_based_stats.cpp:295-412)."""
    tf = np.asarray(target_freqs, dtype=np.float64).reshape(N, N)
    tf = tf / tf.sum()
    full = np.zeros((AMINO_ACID_COUNT, AMINO_ACID_COUNT))
    core = tf.copy()
    mask_rp = row_prob > 0
    core[mask_rp, :] /= row_prob[mask_rp, None]
    mask_cp = col_prob > 0
    core[:, mask_cp] /= col_prob[None, mask_cp]
    full[:N, :N] = core
    # FreqRatioToScore over the whole 26x26: zero entries -> COMPO_SCORE_MIN
    with np.errstate(divide="ignore"):
        scores = np.where(full == 0.0, COMPO_SCORE_MIN, np.log(np.where(full > 0, full, 1.0)) / lam)
    # X row/column: probability-weighted average scores, capped at -1
    avg_iX = scores[:N, :N] @ col_prob
    scores[:N, MASK_LETTER] = np.minimum(avg_iX, K_MAX_X_SCORE)
    score_XX = float(np.sum(avg_iX * row_prob))
    scores[MASK_LETTER, :N] = np.minimum(row_prob @ scores[:N, :N], K_MAX_X_SCORE)
    scores[MASK_LETTER, MASK_LETTER] = min(score_XX, K_MAX_X_SCORE)
    return _round_half_away(scores)


def composition_matrix_adjust(query_len, target_len, query_comp, target_comp,
                              scale, ungapped_lambda, joint_probs,
                              background_freqs, tol=1e-8, maxits=2000):
    """reference CompositionMatrixAdjust / Blast_CompositionMatrixAdj.
    Returns 26x26 int matrix [query_letter, target_letter] or None."""
    row_probs = apply_pseudocounts(query_comp, query_len, background_freqs)
    col_probs = apply_pseudocounts(target_comp, target_len, background_freqs)
    x, ok = optimize_target_frequencies(joint_probs, row_probs, col_probs,
                                        True, K_FIXED_RE_BLOSUM62, tol, maxits)
    if not ok:
        return None
    return scores_from_target_freqs(x, row_probs, col_probs,
                                    ungapped_lambda / scale)


def relative_entropy_dist(A, B):
    """reference Blast_GetRelativeEntropy."""
    A = np.asarray(A)[:N]
    B = np.asarray(B)[:N]
    t = (A + B) / 2
    v = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        va = np.where((t > 0) & (A > 0), A * np.log(np.where(A > 0, A, 1) / np.where(t > 0, t, 1)) / 2, 0.0)
        vb = np.where((t > 0) & (B > 0), B * np.log(np.where(B > 0, B, 1) / np.where(t > 0, t, 1)) / 2, 0.0)
    v = float(va.sum() + vb.sum())
    return np.sqrt(max(v, 0.0))


def _high_pair_frequencies(probs, length):
    if length <= LENGTH_LOWER_THRESHOLD:
        return False
    s = np.sort(np.asarray(probs)[:N])[::-1]
    return (s[0] + s[1]) > HIGH_PAIR_THRESHOLD


RULE_DONT = -1
RULE_COMPO_SCALE_OLD = 0
RULE_USER_RE = 4


def conditional_rule(query_comp, query_len, target_comp, target_len,
                     background_freqs, angle_thr=50.0, dist_thr=-1.0,
                     len_ratio_thr=-1.0):
    """reference s_TestToApplyREAdjustmentConditional
    (matrix_adjust.cpp:385-455).

    The runtime thresholds come from the global `CBS comp_based_stats(0,
    -1.0, -1.0, -1.0)` (reference cbs.cpp:30-52): its constructor leaves
    angle at 50 deg but sets BOTH the query-match-distance and length-ratio
    thresholds to -1, so those two conditions are always true and the angle
    alone decides.  (The NCBI values 0.16/3.0 appear only in commented-out
    code.)  A NaN angle (degenerate compositions) compares false and falls
    through to the relative-entropy rule, as in the reference."""
    pq = np.asarray(query_comp)[:N]
    pm = np.asarray(target_comp)[:N]
    pmat = np.asarray(background_freqs)[:N]
    D_m_mat = relative_entropy_dist(pm, pmat)
    D_q_mat = relative_entropy_dist(pq, pmat)
    D_m_q = relative_entropy_dist(pm, pq)
    with np.errstate(invalid="ignore", divide="ignore"):
        angle = np.degrees(np.arccos(
            (D_m_mat * D_m_mat + D_q_mat * D_q_mat - D_m_q * D_m_q)
            / 2.0 / D_m_mat / D_q_mat))
    len_large = max(query_len, target_len)
    len_small = min(query_len, target_len)
    if _high_pair_frequencies(pq, query_len) or _high_pair_frequencies(pm, target_len):
        return RULE_USER_RE
    if (D_m_q > dist_thr and len_large / max(len_small, 1) > len_ratio_thr
            and angle > angle_thr):
        return RULE_COMPO_SCALE_OLD
    return RULE_USER_RE
