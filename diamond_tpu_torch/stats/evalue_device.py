"""E-values of a batch of scores on the device (the counterpart of
``diamond_tpu/stats/evalue.py:evalue_jax``), for cutoff filtering next to
the kernels.  ``stats/evalue.py`` stays a verbatim copy of the host module.
"""
from __future__ import annotations

import torch

from diamond_tpu_torch.stats.evalue import CONST_VAL, SQRT_2, GumbelParams


def evalue_torch(params: GumbelParams, score, qlen, slen):
    """Twin of ``evalue()`` in tensor ops: float64 for float64 scores, else
    float32; ``slen`` a tensor or number, on the scores' device."""
    dt = torch.float64 if score.dtype == torch.float64 else torch.float32
    y = score.to(dt)
    m = torch.as_tensor(slen, device=y.device).to(dt)
    n = torch.as_tensor(qlen, device=y.device).to(dt)

    def ncdf(x):
        return 0.5 * torch.special.erfc(-x / SQRT_2)

    m_li_y = m - (params.a_I * y + params.b_I)
    vi_y = (params.alpha_I * y + params.beta_I).clamp_min(params.vi_y_thr)
    svi = torch.sqrt(vi_y)
    m_F = torch.where(svi == 0.0, 1e30,
                      m_li_y / torch.where(svi == 0.0, 1.0, svi))
    P_m = ncdf(m_F)
    p1 = m_li_y * P_m + svi * CONST_VAL * torch.exp(-0.5 * m_F * m_F)

    n_lj_y = n - (params.a_J * y + params.b_J)
    vj_y = (params.alpha_J * y + params.beta_J).clamp_min(params.vj_y_thr)
    svj = torch.sqrt(vj_y)
    n_F = torch.where(svj == 0.0, 1e30,
                      n_lj_y / torch.where(svj == 0.0, 1.0, svj))
    P_n = ncdf(n_F)
    p2 = n_lj_y * P_n + svj * CONST_VAL * torch.exp(-0.5 * n_F * n_F)

    c_y = (params.sigma * y + params.tau).clamp_min(params.c_y_thr)
    a = p1 * p2 + c_y * P_m * P_n
    return a * params.K * torch.exp(-params.lam * y)
