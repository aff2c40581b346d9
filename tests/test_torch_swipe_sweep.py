"""The port's diagonal-band full-matrix sweep (SwipeSweep on the CPU, the
plain version of the uniform-band kernel's per-row-length entry point)
against diamond_tpu's SwipeSweep with its Pallas kernel in interpret mode
and against the full-band host DP oracle.  Tolerance: exact int32 equality.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

import diamond_tpu.ops.swipe_device as jsd  # noqa: E402
from diamond_tpu.ops.banded_swipe import banded_swipe_batch_np  # noqa: E402
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.ops import swipe_device as sd  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _sweep_case(seed=7, n_queries=3, n_targets=40):
    """Seeded full-matrix case as tests/test_device.py builds it: queries of
    20-300 letters (bias on every other), targets of 10-400, plus two short
    targets with no positive cell against most queries."""
    rng = np.random.default_rng(seed)
    queries = []
    for r in range(n_queries):
        qlen = int(rng.integers(20, 300))
        q = rng.integers(0, 20, qlen).astype(np.int8)
        bias = rng.integers(-4, 5, qlen).astype(np.int32) if r % 2 else None
        queries.append((q, bias))
    targets = [rng.integers(0, 20, int(rng.integers(10, 400))).astype(np.int8)
               for _ in range(n_targets)]
    return queries, targets + [np.full(3, 23, np.int8), np.full(1, 23, np.int8)]


@pytest.fixture(scope="module")
def jax_run():
    """diamond_tpu's SwipeSweep in interpret mode, every kernel call's
    inputs and outputs recorded."""
    m = ScoreMatrix("BLOSUM62")
    queries, targets = _sweep_case()
    calls = []
    orig = jsd.banded_swipe_pallas_sweep

    def spy(*args):  # SwipeSweep(interpret=True) calls spy.__wrapped__
        out = orig.__wrapped__(*args)
        calls.append(([np.asarray(a) for a in args[:6]], args[6:],
                      [np.asarray(o) for o in out]))
        return out

    spy.__wrapped__ = spy
    jsd.banded_swipe_pallas_sweep = spy
    try:
        res = jsd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend,
                             interpret=True).run(queries, targets)
    finally:
        jsd.banded_swipe_pallas_sweep = orig
    return m, queries, targets, res, calls


def test_plain_matches_pallas_interpret(jax_run):
    """from_pallas_sweep_batch carries each recorded call across; the plain
    version equals the Pallas kernel row for row (dead rows included)."""
    calls = jax_run[4]
    assert calls
    for (t2, bl, ql, qb, qv, m32), (go, ge, band, T, tile_b, _), want in calls:
        x = {k: torch.from_numpy(v) for k, v in sd.from_pallas_sweep_batch(
            t2, bl, ql, qb, qv, T, band, tile_b).items()}
        prof_t = sd.sweep_profile(x["q_let"], x["q_bias"], x["q_valid"],
                                  torch.from_numpy(m32.astype(np.int32)))
        got = sd.swipe_sweep(x["t_idx"], x["band_len"], prof_t, go, ge)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert sd.swipe_sweep.launches == 0  # CPU: the plain version


def test_swipe_sweep_matches_reference(jax_run):
    """Port SwipeSweep on the CPU == the full-band host DP oracle triple for
    triple, and == diamond_tpu's SwipeSweep wherever the score is positive
    (at score 0 diamond_tpu reports chunk-relative positions; the port
    reports the host oracle's)."""
    m, queries, targets, jax_res, _ = jax_run
    sd.reset_dispatch_stats()
    sweep = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cpu")
    res = sweep.run(queries, targets)
    assert sd.dispatch_count == len(queries) * len(sweep.chunks(targets)) > 1
    n_zero = 0
    for (q, bias), row, jrow in zip(queries, res, jax_res):
        ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                              for t in targets],
                                    m.matrix32, m.gap_open, m.gap_extend)
        assert row == [tuple(r) for r in ref]
        for g, j in zip(row, jrow):
            assert g[0] == j[0]
            if g[0] > 0:
                assert g == j
            else:
                n_zero += 1
    assert n_zero >= 1


def test_swipe_sweep_host_route_past_cap(jax_run, monkeypatch):
    """Length classes whose band would pass the kernel's cap take the host
    DP, with the same output."""
    m, queries, targets, _, _ = jax_run
    sweep = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cpu")
    whole = sweep.run(queries, targets)
    monkeypatch.setattr(sd, "MAX_UNIFORM_BAND", 400)
    sd.reset_dispatch_stats()
    assert sweep.run(queries, targets) == whole
    assert 0 < sd.dispatch_count < len(queries) * len(sweep.chunks(targets))


def test_swipe_sweep_query_rows(jax_run):
    """The card's kernel walks only the query's rows [C, C + qlen) of each
    launch's band; the plain version given those rows (the rest of the
    profile set to NEG) equals the whole band on SwipeSweep's profiles, and
    rows that leave the band at some column are refused."""
    m, queries, targets, _, _ = jax_run
    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    sweep = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cpu")
    chunks = sweep.chunks(targets)
    n = 0
    for q, bias in queries:
        for ch, band, bl, prof_t in sweep.query_launches(q, bias, chunks):
            whole = sd.swipe_sweep(ch.t_idx, bl, prof_t, go, ge)
            rows = sd.swipe_sweep(ch.t_idx, bl, prof_t, go, ge, ch.C, len(q))
            for a, b in zip(whole, rows):
                assert torch.equal(a, b)
            assert band == ch.C + len(q)
            n += 1
            with pytest.raises(ValueError):
                sd.swipe_sweep(ch.t_idx, bl, prof_t, go, ge, ch.C - 1, len(q))
            with pytest.raises(ValueError):
                sd.swipe_sweep(ch.t_idx, bl, prof_t, go, ge, ch.C, len(q) + 1)
    assert n == len(queries) * len(chunks)
    assert sd.swipe_sweep.launches == 0
