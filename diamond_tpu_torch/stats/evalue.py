"""Gumbel / finite-size-correction e-value engine.

Reimplements the ALP library's evaluer math used by the reference
(reference src/lib/alp/sls_alignment_evaluer.{hpp,cpp},
src/lib/alp/sls_pvalues.cpp:367-544) from its published formulas:

  evalue(S, m, n)   = area(S, m, n) * K * exp(-lambda * S)
  area(S, m, n)     = p1 * p2 + c_y * P(m_F) * P(n_F)      (finite-size corr.)

with P the standard normal CDF.  Parameters for the standard matrices come
precomputed from the NCBI BLAST tables (reference
src/stats/score_matrix.cpp:43-47 `alp_params`); no Monte-Carlo simulation is
needed for the standard matrices.

Everything here is vectorized numpy so a whole block of (score, qlen, slen)
triples is evaluated at once — the reference evaluates per hit in scalar C++.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

SQRT_2 = math.sqrt(2.0)
CONST_VAL = 1.0 / math.sqrt(2.0 * math.pi)
NAT_CUTOFF = 2.0  # nat cut-off used in the finite-size correction
LN_2 = math.log(2.0)


@dataclass(frozen=True)
class GumbelParams:
    """Gumbel parameters with finite-size correction coefficients.

    Field names follow the Sheetlin-Park-Frith-Spouge FSC paper; the
    I/J split mirrors the ALP `ALP_set_of_parameters` mapping
    (reference sls_alignment_evaluer.cpp:656-740).
    """

    lam: float
    K: float
    a_I: float
    b_I: float
    a_J: float
    b_J: float
    alpha_I: float
    beta_I: float
    alpha_J: float
    beta_J: float
    sigma: float
    tau: float

    # thresholds are pure functions of the frozen fields; the scalar
    # e-value fast path reads them ~5 times per reported hit, so they
    # are computed once and cached (object.__setattr__ because frozen)
    def _cache_thresholds(self):
        object.__setattr__(self, "_ln_k", math.log(self.K))
        object.__setattr__(self, "_vi_y_thr",
                           max(NAT_CUTOFF * self.alpha_I / self.lam, 0.0))
        object.__setattr__(self, "_vj_y_thr",
                           max(NAT_CUTOFF * self.alpha_J / self.lam, 0.0))
        object.__setattr__(self, "_c_y_thr",
                           max(NAT_CUTOFF * self.sigma / self.lam, 0.0))

    @property
    def ln_k(self) -> float:
        if not hasattr(self, "_ln_k"):
            self._cache_thresholds()
        return self._ln_k

    @property
    def vi_y_thr(self) -> float:
        if not hasattr(self, "_vi_y_thr"):
            self._cache_thresholds()
        return self._vi_y_thr

    @property
    def vj_y_thr(self) -> float:
        if not hasattr(self, "_vj_y_thr"):
            self._cache_thresholds()
        return self._vj_y_thr

    @property
    def c_y_thr(self) -> float:
        if not hasattr(self, "_c_y_thr"):
            self._cache_thresholds()
        return self._c_y_thr


def from_standard_params(p, u, gap_open: int, gap_extend: int) -> GumbelParams:
    """Build Gumbel params from a precomputed Karlin-Altschul table row.

    `p` = gapped row, `u` = ungapped row of the matrix's parameter table;
    the intercept construction matches reference score_matrix.cpp:43-47.
    Table row layout: (gap_exist, gap_extend, reserved, Lambda, K, H, alpha,
    beta, C, alpha_v, sigma).
    """
    G = gap_open + gap_extend
    p_lambda, p_K, p_alpha, p_alpha_v, p_sigma = p[3], p[4], p[6], p[9], p[10]
    u_alpha, u_alpha_v = u[6], u[9]
    b = 2.0 * G * (u_alpha - p_alpha)
    beta = 2.0 * G * (u_alpha_v - p_alpha_v)
    tau = 2.0 * G * (u_alpha_v - p_sigma)
    # ALP initParameters maps d_a1->a_J, d_a2->a_I etc.; here both sequences
    # use the same (symmetric) parameters so I == J.
    return GumbelParams(
        lam=p_lambda, K=p_K,
        a_I=p_alpha, b_I=b, a_J=p_alpha, b_J=b,
        alpha_I=p_alpha_v, beta_I=beta, alpha_J=p_alpha_v, beta_J=beta,
        sigma=p_sigma, tau=tau,
    )


def _normal_cdf(x):
    from scipy.special import erfc  # scipy is available via jax deps

    return 0.5 * erfc(-x / SQRT_2)


_erfc = None


def _load_erfc():
    global _erfc
    try:
        from scipy.special import erfc as _e

        _erfc = _e
    except ImportError:  # pragma: no cover
        _erfc = np.vectorize(lambda t: math.erfc(t))


# scipy.special takes ~0.5 s to import; start it on a daemon thread at
# module load so the cost overlaps the masking/seeding phases instead of
# landing on the first e-value computation
import threading as _threading  # noqa: E402

_threading.Thread(target=_load_erfc, daemon=True).start()


def _normal_cdf_np(x):
    # erfc via math is scalar; use vectorized complement through numpy
    if _erfc is None:
        _load_erfc()  # blocks on the import lock if the prewarm is mid-way
    return 0.5 * _erfc(-np.asarray(x) / SQRT_2)


def area(params: GumbelParams, score, qlen, slen):
    """Finite-size-corrected search-space area.

    Mirrors get_appr_tail_prob_with_cov_without_errors with blast_=false
    (reference sls_pvalues.cpp:367-535): m_ = subject length, n_ = query
    length (the evaluer is called as area(score, seqlen1=qlen, seqlen2=slen)
    and forwards m_=seqlen2_, n_=seqlen1_).
    """
    y = np.asarray(score, dtype=np.float64)
    m = np.asarray(slen, dtype=np.float64)
    n = np.asarray(qlen, dtype=np.float64)

    m_li_y = m - (params.a_I * y + params.b_I)
    vi_y = np.maximum(params.vi_y_thr, params.alpha_I * y + params.beta_I)
    sqrt_vi_y = np.sqrt(vi_y)
    m_F = np.where(sqrt_vi_y == 0.0, 1e100, m_li_y / np.where(sqrt_vi_y == 0.0, 1.0, sqrt_vi_y))
    P_m_F = _normal_cdf_np(m_F)
    E_m_F = -CONST_VAL * np.exp(-0.5 * m_F * m_F)
    p1 = m_li_y * P_m_F - sqrt_vi_y * E_m_F

    n_lj_y = n - (params.a_J * y + params.b_J)
    vj_y = np.maximum(params.vj_y_thr, params.alpha_J * y + params.beta_J)
    sqrt_vj_y = np.sqrt(vj_y)
    n_F = np.where(sqrt_vj_y == 0.0, 1e100, n_lj_y / np.where(sqrt_vj_y == 0.0, 1.0, sqrt_vj_y))
    P_n_F = _normal_cdf_np(n_F)
    E_n_F = -CONST_VAL * np.exp(-0.5 * n_F * n_F)
    p2 = n_lj_y * P_n_F - sqrt_vj_y * E_n_F

    c_y = np.maximum(params.c_y_thr, params.sigma * y + params.tau)
    return p1 * p2 + c_y * P_m_F * P_n_F


def evalue(params: GumbelParams, score, qlen, slen):
    """E-value for score against one subject of length slen (per-pair)."""
    a = area(params, score, qlen, slen)
    return a * params.K * np.exp(-params.lam * np.asarray(score, dtype=np.float64))


def area1(params: GumbelParams, score: float, qlen, slen) -> float:
    """Scalar twin of area() — bit-identical, ~5x faster per call.

    Pure-Python float arithmetic is the same IEEE double stream as numpy's
    elementwise loop; sqrt is correctly rounded in both, and the two
    implementation-defined functions (exp, erfc) go through the *same*
    numpy/scipy ufuncs as the vectorized path so results match to the bit
    (pinned by tests/test_stats.py).  math.exp/math.erfc would be ~10x
    faster still but differ in ulps from the numpy ufuncs.
    """
    y = float(score)
    m = float(slen)
    n = float(qlen)

    m_li_y = m - (params.a_I * y + params.b_I)
    vi_y = params.alpha_I * y + params.beta_I
    if vi_y < params.vi_y_thr:
        vi_y = params.vi_y_thr
    sqrt_vi_y = math.sqrt(vi_y)
    m_F = m_li_y / sqrt_vi_y if sqrt_vi_y != 0.0 else 1e100
    P_m_F = 0.5 * float(_erfc_scalar(-m_F / SQRT_2))
    E_m_F = -CONST_VAL * float(np.exp(-0.5 * m_F * m_F))
    p1 = m_li_y * P_m_F - sqrt_vi_y * E_m_F

    n_lj_y = n - (params.a_J * y + params.b_J)
    vj_y = params.alpha_J * y + params.beta_J
    if vj_y < params.vj_y_thr:
        vj_y = params.vj_y_thr
    sqrt_vj_y = math.sqrt(vj_y)
    n_F = n_lj_y / sqrt_vj_y if sqrt_vj_y != 0.0 else 1e100
    P_n_F = 0.5 * float(_erfc_scalar(-n_F / SQRT_2))
    E_n_F = -CONST_VAL * float(np.exp(-0.5 * n_F * n_F))
    p2 = n_lj_y * P_n_F - sqrt_vj_y * E_n_F

    c_y = params.sigma * y + params.tau
    if c_y < params.c_y_thr:
        c_y = params.c_y_thr
    return p1 * p2 + c_y * P_m_F * P_n_F


def _erfc_scalar(x: float):
    if _erfc is None:
        _load_erfc()
    return _erfc(x)


def evalue1(params: GumbelParams, score: float, qlen, slen) -> float:
    """Scalar twin of evalue() — bit-identical to the vectorized path.

    The five transcendental ufunc calls of area1+exp batch into two
    (one erfc over 2 elements, one exp over 3): numpy's elementwise
    loops produce the same bits as its scalar calls (the same ufunc
    inner loop; pinned with the vectorized path by tests/test_stats.py),
    and ufunc call overhead dominates the scalar path's cost."""
    if _erfc is None:
        _load_erfc()
    y = float(score)
    m = float(slen)
    n = float(qlen)
    m_li_y = m - (params.a_I * y + params.b_I)
    vi_y = params.alpha_I * y + params.beta_I
    if vi_y < params.vi_y_thr:
        vi_y = params.vi_y_thr
    sqrt_vi_y = math.sqrt(vi_y)
    m_F = m_li_y / sqrt_vi_y if sqrt_vi_y != 0.0 else 1e100
    n_lj_y = n - (params.a_J * y + params.b_J)
    vj_y = params.alpha_J * y + params.beta_J
    if vj_y < params.vj_y_thr:
        vj_y = params.vj_y_thr
    sqrt_vj_y = math.sqrt(vj_y)
    n_F = n_lj_y / sqrt_vj_y if sqrt_vj_y != 0.0 else 1e100
    er = _erfc(np.array([-m_F / SQRT_2, -n_F / SQRT_2]))
    ex = np.exp(np.array([-0.5 * m_F * m_F, -0.5 * n_F * n_F,
                          -params.lam * y]))
    P_m_F = 0.5 * float(er[0])
    P_n_F = 0.5 * float(er[1])
    E_m_F = -CONST_VAL * float(ex[0])
    E_n_F = -CONST_VAL * float(ex[1])
    p1 = m_li_y * P_m_F - sqrt_vi_y * E_m_F
    p2 = n_lj_y * P_n_F - sqrt_vj_y * E_n_F
    c_y = params.sigma * y + params.tau
    if c_y < params.c_y_thr:
        c_y = params.c_y_thr
    a = p1 * p2 + c_y * P_m_F * P_n_F
    return a * params.K * float(ex[2])


def bitscore_corrected1(params: GumbelParams, raw_score, qlen, slen) -> float:
    """Scalar twin of bitscore_corrected()."""
    a = area1(params, raw_score, qlen, slen)
    tiny = 2.2250738585072014e-308  # np.finfo(float64).tiny
    la = float(np.log(a if a > tiny else tiny))
    return (params.lam * float(raw_score) - params.ln_k - la) / LN_2


def log_area(params: GumbelParams, score, qlen, slen):
    """log(area) with care for extreme scores (reference sls_pvalues.cpp:log_area).

    Sufficient for bitscore_corrected; we compute via the plain area and fall
    back to the asymptotic p1*p2 ~ m*n when area underflows.
    """
    a = area(params, score, qlen, slen)
    a = np.maximum(a, np.finfo(np.float64).tiny)
    return np.log(a)


def bitscore(params: GumbelParams, raw_score):
    return (params.lam * np.asarray(raw_score, dtype=np.float64) - params.ln_k) / LN_2


def bitscore_corrected(params: GumbelParams, raw_score, qlen, slen):
    """Edge-effect corrected bitscore (reference score_matrix.cpp:227-232)."""
    la = log_area(params, raw_score, qlen, slen)
    return (params.lam * np.asarray(raw_score, np.float64) - params.ln_k - la) / LN_2


def rawscore(params: GumbelParams, bit_score):
    return (bit_score * LN_2 + params.ln_k) / params.lam

