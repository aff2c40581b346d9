"""The roofline arithmetic: cells from a launch's shapes, the least time,
and a share that never passes 100 %."""
import numpy as np
import pytest

import roofline


def test_band_cells_hand_worked():
    # a target of 4 letters, query of 3, band rows d0 .. d0 + band - 1
    # row r of column j is query position j + d0 + r
    assert roofline.band_cells([4], [3], [0], [1]) == 3      # j = 0, 1, 2
    assert roofline.band_cells([4], [3], [-1], [2]) == 3 + 3  # rows -1, 0
    assert roofline.band_cells([4], [3], [-3], [1]) == 1      # j = 3
    assert roofline.band_cells([4], [3], [-4], [1]) == 0
    assert roofline.band_cells([4, 4], [3, 3], [0, 0], [1, 2]) == 3 + 5


def test_band_cells_equal_a_brute_count():
    rng = np.random.default_rng(0)
    t = rng.integers(1, 60, 40)
    q = rng.integers(1, 60, 40)
    d0 = rng.integers(-70, 60, 40)
    band = rng.integers(1, 40, 40)
    want = sum(1 for k in range(40) for j in range(t[k]) for r in range(band[k])
               if 0 <= j + d0[k] + r < q[k])
    assert roofline.band_cells(t, q, d0, band) == want


def test_least_time_is_the_larger_bound():
    ops_s = roofline.int32_ops_per_s()
    assert ops_s == pytest.approx(132 * 64 * 1.98e9)
    assert roofline.least_s(ops_s, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(ops_s, 2 * 3.35e12) == pytest.approx(2.0)


def test_work_counts():
    jobs = np.array([[0, 4, 0, 1, 0]])          # t_off, t_len, d0, band, req
    reqs = np.array([[0, 3]])
    ops, nb = roofline.k1_work(jobs, reqs, n_t=4, n_q=3)
    assert ops == roofline.K1_OPS * 3
    assert nb == 4 + 6 + 20 + 8 + 12
    tb = np.array([[0, 3, 0, 0, 4, 0, 1]])       # q_off, q_len, ., t_off, t_len, d0, band
    ops, _ = roofline.d4_work(tb, np.array([5]), n_t=4, n_q=3)
    assert ops == roofline.D4_OPS * 3 + roofline.D4_WALK_OPS * 5
    ops, _ = roofline.k2_work(np.array([[0, 0], [0, 1]]),
                              np.array([[0, 3, -1]]),
                              np.array([[0, 4], [4, 5]]), n_t=9, n_q=3)
    assert ops == roofline.K2_OPS * (3 * 4 + 3 * 5)


def test_share_reader_reads_percent_and_nothing_without_launches():
    import run

    read = run.metric_reader("k1_roofline")
    assert read({"kernels": {}}) is None
    assert read({"kernels": {"k1": dict(ms=4.0, least_ms=1.0, calls=2)}}) == 25.0
