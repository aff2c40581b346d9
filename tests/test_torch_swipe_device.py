"""The port's banded-SWIPE kernel (plain PyTorch version on the CPU) and its
DeviceDP batcher against diamond_tpu: the Pallas kernel in interpret mode,
diamond_tpu's DeviceDP and the host DP oracle.  Tolerance: exact int32
equality throughout (the DP is integer arithmetic).

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


def _requests(seed, n_queries=4, max_jobs=12, max_band=300):
    """Seeded DeviceDP requests with a planted match per job: bias on every
    other query, d0 < 0, band 1, bands above 128, targets shorter than the
    band, and one job with no in-query cell (score 0)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(n_queries):
        qlen = int(rng.integers(15, 260))
        q = rng.integers(0, 20, qlen).astype(np.int8)
        bias = (rng.integers(-4, 5, qlen).astype(np.int32)
                if r % 2 else None)
        jobs = []
        for _ in range(int(rng.integers(2, max_jobs))):
            tl = int(rng.integers(8, 300))
            t = rng.integers(0, 20, tl).astype(np.int8)
            k = max(min(qlen - 1, tl - 2, 20), 0)
            t[2 : 2 + k] = q[1 : 1 + k]
            d0 = int(rng.integers(-tl + 1, max(-tl + 2, qlen - 5)))
            d1 = min(d0 + int(rng.integers(4, max_band)), qlen)
            if d1 <= d0:
                d1 = d0 + 1
            jobs.append((t, d0, d1))
        t = rng.integers(0, 20, 40).astype(np.int8)
        jobs.append((t, 2, 3))                       # band 1
        jobs.append((t[:10], -5, 200))               # target shorter than band
        jobs.append((t[:6], -30, -20))               # no cell in the query
        reqs.append((q, bias, jobs))
    return reqs


@pytest.fixture(scope="module")
def blosum():
    return ScoreMatrix("BLOSUM62")


def _band_requests(seed, band):
    """Seeded requests whose jobs all have band ``band``: a query holding a
    segment twice (ties between rows), targets holding it twice (ties
    between columns) on a band diagonal, d0 < 0, bias on the second query,
    and a job with no in-query cell (score 0)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r in range(2):
        qlen = int(rng.integers(60, 160))
        q = rng.integers(0, 20, qlen).astype(np.int8)
        seg = q[4:16].copy()
        q[qlen // 2: qlen // 2 + 12] = seg
        bias = rng.integers(-4, 5, qlen).astype(np.int32) if r else None
        jobs = []
        for _ in range(3):
            tl = int(rng.integers(30, 90))
            t = rng.integers(0, 20, tl).astype(np.int8)
            t[2:14] = seg
            t[tl - 14: tl - 2] = seg
            # diagonal 2 in the band, which starts at a diagonal the target
            # has (the host oracle's native scorer errs below -(tl - 1))
            d0 = max(2 - int(rng.integers(0, band)), -(tl - 1))
            jobs.append((t, d0, d0 + band))
        jobs.append((t[:8], qlen + 5, qlen + 5 + band))  # no query cell
        reqs.append((q, bias, jobs))
    return reqs


def _jax_device_dp(reqs, blosum):
    """diamond_tpu's DeviceDP in interpret mode on ``reqs``: its output and
    every Pallas call's packed inputs and outputs."""
    calls = []
    orig = jsd.banded_swipe_pallas_multi

    def spy(*args):
        out = orig(*args)
        calls.append(([np.asarray(a) for a in args[:6]], args[6:],
                      [np.asarray(o) for o in out]))
        return out

    jsd.banded_swipe_pallas_multi = spy
    try:
        dev = jsd.DeviceDP(blosum.matrix32, blosum.gap_open, blosum.gap_extend,
                           tile_b=8, interpret=True)
        out = dev.run_many(reqs)
    finally:
        jsd.banded_swipe_pallas_multi = orig
    return out, calls


@pytest.fixture(scope="module")
def jax_run(blosum):
    """diamond_tpu's DeviceDP in interpret mode on seeded requests, with
    every Pallas call's packed inputs and outputs recorded."""
    reqs = _requests(seed=7)
    return (reqs, *_jax_device_dp(reqs, blosum))


def _torch_inputs(packed):
    return {k: torch.from_numpy(v) for k, v in packed.items()}


def test_plain_matches_pallas_interpret(jax_run):
    """from_pallas_batch carries each recorded Pallas batch across; the
    plain version's (best, max_col, max_row) equal the Pallas kernel's
    row for row."""
    _, _, calls = jax_run
    assert calls
    for (t2, bm, ql, qb, qv, m32), (go, ge, band, T, tile_b, _), want in calls:
        packed, R = sd.from_pallas_batch(t2, bm, ql, qb, qv, T, band, tile_b)
        x = _torch_inputs(packed)
        got = sd.banded_swipe_multi(x["t_cat"], x["q_cat"], x["bias_cat"],
                                    x["jobs"], x["reqs"],
                                    torch.from_numpy(m32.copy()), go, ge, R)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_devicedp_matches_reference(jax_run, blosum):
    """Port DeviceDP on the CPU == the host DP oracle, triple for triple,
    and == diamond_tpu's DeviceDP wherever the score is positive (at score
    0 diamond_tpu reports group-relative positions; the port reports the
    host oracle's)."""
    reqs, jax_out, _ = jax_run
    sd.reset_dispatch_stats()
    port = sd.DeviceDP(blosum.matrix32, blosum.gap_open, blosum.gap_extend,
                       device="cpu").run_many(reqs)
    assert sd.dispatch_count > 0
    n_zero = 0
    for (q, bias, jobs), got, jx in zip(reqs, port, jax_out):
        ref = banded_swipe_batch_np(q, bias, jobs, blosum.matrix32,
                                    blosum.gap_open, blosum.gap_extend)
        assert got == ref
        for g, j in zip(got, jx):
            assert g[0] == j[0]
            if g[0] > 0:
                assert g == j
            else:
                n_zero += 1
    assert n_zero >= len(reqs)  # the no-cell jobs


@pytest.mark.parametrize("band", [1, 31, 33, 65, 97, 129, 200, 257, 480, 512])
def test_exact_band_class_matches_pallas_and_host(band, blosum):
    """Jobs of one band fall in the kernel's exact class ceil(band / 32).
    The plain version at that class and at the Pallas batch's padded class
    equals the Pallas kernel row for row (from_pallas_batch); DeviceDP
    equals the host DP oracle triple for triple (tied bests and a score-0
    job included) and diamond_tpu's DeviceDP wherever the score is
    positive."""
    reqs = _band_requests(100 + band, band)
    jax_out, calls = _jax_device_dp(reqs, blosum)
    assert calls
    for (t2, bm, ql, qb, qv, m32), (go, ge, pband, T, tile_b, _), want in calls:
        packed, R_pad = sd.from_pallas_batch(t2, bm, ql, qb, qv, T, pband,
                                             tile_b)
        x = _torch_inputs(packed)
        R_exact = sd.rows_per_lane(int(packed["jobs"][:, 3].max()))
        assert R_exact == -(-band // 32) <= R_pad
        for R in {R_exact, R_pad}:
            got = sd.banded_swipe_multi(x["t_cat"], x["q_cat"], x["bias_cat"],
                                        x["jobs"], x["reqs"],
                                        torch.from_numpy(m32.copy()), go, ge,
                                        R)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
    p = sd.pack_requests(reqs, "cpu")
    assert [R for R, _, _ in p.classes] == [-(-band // 32)]
    assert p.walk_cells == sum(len(t) for _, _, j in reqs
                               for t, _, _ in j) * 32 * -(-band // 32)
    port = sd.DeviceDP(blosum.matrix32, blosum.gap_open, blosum.gap_extend,
                       device="cpu").run_many(reqs)
    scores = []
    for (q, bias, jobs), got, jx in zip(reqs, port, jax_out):
        assert got == banded_swipe_batch_np(q, bias, jobs, blosum.matrix32,
                                            blosum.gap_open, blosum.gap_extend)
        for g, j in zip(got, jx):
            assert g[0] == j[0]
            if g[0] > 0:
                assert g == j
            scores.append(g[0])
    assert min(scores) == 0 and max(scores) > 0


def test_devicedp_splits_batches_above_letter_cap(jax_run, blosum,
                                                 monkeypatch):
    reqs = jax_run[0]
    dp = sd.DeviceDP(blosum.matrix32, blosum.gap_open, blosum.gap_extend,
                     device="cpu")
    whole = dp.run_many(reqs)
    sd.reset_dispatch_stats()
    monkeypatch.setattr(sd, "MAX_BATCH_LETTERS", 600)
    assert dp.run_many(reqs) == whole
    assert sd.dispatch_count > 2 * len(reqs)  # most requests alone in a batch


def test_plain_rejects_bad_inputs():
    x = dict(t_cat=torch.zeros(4, dtype=torch.int8),
             q_cat=torch.zeros(4, dtype=torch.int8),
             bias_cat=torch.zeros(4, dtype=torch.int8),
             jobs=torch.zeros(1, 5, dtype=torch.int32),
             reqs=torch.zeros(1, 2, dtype=torch.int32))
    m = torch.zeros(32, 32, dtype=torch.int32)
    with pytest.raises(TypeError):
        sd.banded_swipe_multi(x["t_cat"].int(), x["q_cat"], x["bias_cat"],
                              x["jobs"], x["reqs"], m, 12, 1, 1)
    for bad_rows in (0, 17):  # band classes are 1..16 rows per lane
        with pytest.raises(ValueError):
            sd.banded_swipe_multi(x["t_cat"], x["q_cat"], x["bias_cat"],
                                  x["jobs"], x["reqs"], m, 12, 1, bad_rows)
    assert sd.banded_swipe_multi.launches == 0


def test_job_fits_device(monkeypatch):
    """A job fits by its padded band alone, against MAX_DEVICE_BAND as the
    module holds it at the call: the target's length does not decide."""
    assert sd.job_fits_device(10, 0, 512)
    assert sd.job_fits_device(1, -200, 312)
    assert not sd.job_fits_device(10, 0, 513)
    assert not sd.job_fits_device(100000, 0, 513)
    monkeypatch.setattr(sd, "MAX_DEVICE_BAND", 64)
    assert sd.job_fits_device(10, 0, 50)  # padded to 64
    assert sd.job_fits_device(100000, 0, 64)
    assert not sd.job_fits_device(20, 0, 65)


def test_native_oracle_low_diagonal_fault_is_the_references(blosum):
    """A fault of the reference's native host scorer that the port copies
    on purpose (ROADMAP.md section 3): a band starting below diagonal
    -(t_len - 1) lets it score a match outside the band (153 here, the
    planted diagonal 55 lies outside [-246, 11)).  The numpy single-job
    path and K1 (its plain version) score the band (29); from
    d0 = -(t_len - 1) the native scorer agrees again."""
    from diamond_tpu_torch.ops.banded_swipe import (
        banded_swipe_batch_np as port_batch, banded_swipe_np)

    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, 105).astype(np.int8)
    t = rng.integers(0, 20, 49).astype(np.int8)
    t[5:30] = q[60:85]
    m = blosum
    args = (m.matrix32, m.gap_open, m.gap_extend)
    assert banded_swipe_batch_np(q, None, [(t, -246, 11)], *args) == \
        port_batch(q, None, [(t, -246, 11)], *args) == [(153, 29, 84)]
    assert banded_swipe_np(q, t, -246, 11, m.matrix32, None, m.gap_open,
                           m.gap_extend).score == 29
    dp = sd.DeviceDP(*args, device="cpu")
    assert dp.run_many([(q, None, [(t, -246, 11)])])[0][0][0] == 29
    assert port_batch(q, None, [(t, -48, 11)], *args)[0][0] == 29
