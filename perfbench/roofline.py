"""The yardstick of a kernel launch: the operations and bytes the function
needs, from the launch's own shapes, and the least time the card could
take for them (``data/h100.json``).

Each count is the work of the recurrence, whatever kernel computes it:
the fewest int32 instructions Hopper can issue a cell (a DPX add-max
counted as one), times the cells the inputs make.  Bytes: each input read
once, each output written once.
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "data", "h100.json")) as _f:
    PEAK = json.load(_f)

# a banded affine-gap cell with a query bias, score only (K1): bias add,
# H+s with max E and max 0 (one DPX), H-go (shared by E and F), F-ge with
# max for F (one DPX), max F into H, valid select, best max, E-ge with max
# for E (one DPX)
K1_OPS = 8
# the same cell with its four trace-plane compares (cur == F, cur == E, the
# two open compares) (D4's fill)
D4_OPS = 12
# a traceback walk step: the band row (2), the plane bit (2), the matrix
# index and the score with its bias (3), the letter compare (1), the two
# decrements (2)
D4_WALK_OPS = 10
# a full-matrix affine-gap cell, bias folded into the profile (K2): H+s
# with max E and max 0, cur0-go, F-ge with max for F, max F into H, H-go,
# E-ge with max for E, best max
K2_OPS = 7


def int32_ops_per_s() -> float:
    return PEAK["sms"] * PEAK["int32_lanes_per_sm"] * PEAK["clock_hz"]


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / int32_ops_per_s(), nbytes / PEAK["hbm_bytes_per_s"])


def band_cells(t_len, q_len, d0, band) -> int:
    """In-query cells of banded jobs: band row r of column j is query
    position j + d0 + r."""
    t_len, q_len, d0, band = (np.asarray(a, np.int64)
                              for a in (t_len, q_len, d0, band))
    cells = 0
    for r in range(int(band.max()) if len(band) else 0):
        d = d0 + r
        n = np.minimum(t_len, q_len - d) - np.maximum(0, -d)
        cells += int(np.where(r < band, np.maximum(n, 0), 0).sum())
    return cells


def k1_work(jobs: np.ndarray, reqs: np.ndarray, n_t: int, n_q: int):
    """(ops, bytes) of one DeviceDP launch: jobs rows (t_off, t_len, d0,
    band, req), reqs rows (q_off, q_len); the batch's target and query
    letters."""
    q_len = reqs[jobs[:, 4], 1]
    cells = band_cells(jobs[:, 1], q_len, jobs[:, 2], jobs[:, 3])
    nbytes = n_t + 2 * n_q + jobs.size * 4 + reqs.size * 4 + len(jobs) * 12
    return K1_OPS * cells, nbytes


def d4_work(jobs: np.ndarray, n_ops: np.ndarray, n_t: int, n_q: int):
    """(ops, bytes) of one traceback fill-and-walk call: jobs rows (q_off,
    q_len, use_bias, t_off, t_len, d0, band), n_ops the ops each walk
    wrote."""
    cells = band_cells(jobs[:, 4], jobs[:, 1], jobs[:, 5], jobs[:, 6])
    walk = int(np.sum(n_ops))
    nbytes = n_t + 5 * n_q + jobs.size * 8 + len(jobs) * (24 + 96) + 5 * walk
    return D4_OPS * cells + D4_WALK_OPS * walk, nbytes


def k2_work(pairs: np.ndarray, reqs: np.ndarray, targets: np.ndarray,
            n_t: int, n_q: int):
    """(ops, bytes) of one full-matrix launch: pairs rows (req, tgt), reqs
    rows (q_off, q_len, slot), targets rows (t_off, t_len)."""
    cells = int((reqs[pairs[:, 0], 1].astype(np.int64)
                 * targets[pairs[:, 1], 1]).sum())
    nbytes = n_t + 2 * n_q + pairs.size * 4 + len(pairs) * 4
    return K2_OPS * cells, nbytes
