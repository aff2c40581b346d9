"""The port's uniform-band SWIPE against diamond_tpu: the kernel's plain
PyTorch version (the CPU side of ``banded_swipe_uniform_cuda``) against the
Pallas kernel ``banded_swipe_pallas`` in interpret mode and the host DP
oracle, the one-hot path ``banded_swipe_uniform`` against its XLA twin, and
the direct DP route ``align/extend._device_dp_scores`` against diamond_tpu's.
Tolerance: exact int32 equality throughout (the DP is integer arithmetic).

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

from jax.experimental import pallas as pl  # noqa: E402

import diamond_tpu.ops.swipe_pallas as jsp  # noqa: E402
from diamond_tpu.align import extend as jext  # noqa: E402
from diamond_tpu.ops import swipe_jax  # noqa: E402
from diamond_tpu.ops.banded_swipe import banded_swipe_batch_np  # noqa: E402
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.align import extend as pext  # noqa: E402
from diamond_tpu_torch.ops import swipe_uniform as su  # noqa: E402
from diamond_tpu_torch.ops import swipe_uniform_device as sud  # noqa: E402
from diamond_tpu_torch.stats.score_matrix import ScoreMatrix as PortMatrix  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _query_jobs(seed, qlen, n_jobs, max_band, max_tl=60):
    """One seeded query (bias on odd seeds) and jobs with a planted match:
    d0 < 0, targets shorter than the band, a band-1 job and one job with
    no in-query cell (score 0)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, qlen).astype(np.int8)
    bias = rng.integers(-4, 5, qlen).astype(np.int32) if seed % 2 else None
    jobs = []
    for _ in range(n_jobs):
        tl = int(rng.integers(6, max_tl))
        t = rng.integers(0, 20, tl).astype(np.int8)
        k = min(qlen - 2, tl - 3, 16)
        t[2:2 + k] = q[1:1 + k]
        d0 = int(rng.integers(-tl + 1, qlen - 1))
        jobs.append((t, d0, min(d0 + int(rng.integers(1, max_band)), qlen)))
    t = rng.integers(0, 20, 30).astype(np.int8)
    jobs += [(t[:5], -4, max_band - 4), (t, 2, 3), (t[:6], -30, -20)]
    return q, bias, jobs


_PALLAS = jsp.banded_swipe_pallas.__wrapped__  # the kernel call, unjitted


def _pallas_interpret(tgt, bmask, ppad, go, ge, band, tile_b):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return [np.asarray(o) for o in _PALLAS(tgt, bmask, ppad, go, ge, band,
                                               tile_b=tile_b)]
    finally:
        pl.pallas_call = orig


@pytest.fixture(scope="module")
def blosum():
    return ScoreMatrix("BLOSUM62")


def _torch(packed):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in packed.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_interpret(seed, blosum):
    """from_pallas_uniform_batch carries a prepare_pallas_batch batch across;
    the plain version equals the Pallas kernel row for row (padded rows
    included)."""
    q, bias, jobs = _query_jobs(seed, 40, 6, 40)
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    tgt, bmask, ppad, band, _ = jsp.prepare_pallas_batch(
        q, bias, blosum.matrix32, jobs, tile_b=16)
    want = _pallas_interpret(tgt, bmask, ppad, go, ge, band, 16)
    x = _torch(sud.from_pallas_uniform_batch(tgt, bmask, ppad, band))
    got = sud.banded_swipe_uniform_cuda(x["t_idx"], x["band_mask"], x["prof_t"],
                                        go, ge)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert sud.banded_swipe_uniform_cuda.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("seed,max_band", [(2, 100), (3, 700)])
def test_plain_matches_host_oracle(seed, max_band, blosum):
    """pack_uniform_batch + the plain version == banded_swipe_batch_np in the
    kernel's best-effort coordinates, bands above 512 included."""
    q, bias, jobs = _query_jobs(seed, 300, 8, max_band, max_tl=400)
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    best, mc, mr, meta = sud.uniform_scores(q, bias, blosum.matrix32, jobs,
                                            go, ge, "cpu")
    assert meta["band"] == su.pad_band(max(d1 - d0 for _, d0, d1 in jobs))
    got = [(int(best[k]), max(int(mc[k]) - meta["shifts"][k], 0), int(mr[k]))
           for k in range(len(jobs))]
    ref = banded_swipe_batch_np(q, bias, jobs, blosum.matrix32,
                                blosum.gap_open, blosum.gap_extend)
    assert got == sud.host_as_uniform(ref, jobs)
    assert any(s == 0 for s, _, _ in ref) and any(s > 0 for s, _, _ in ref)


@pytest.mark.parametrize("width,warp", [(500, True), (600, False)])
def test_warp_and_cta_bands_match_pallas_and_host(width, warp, blosum):
    """A band on each side of 512: pack_uniform_batch pads 500 to 512 (the
    kernel's warp path) and 600 to 1024 (its CTA path).  The plain version
    equals the Pallas kernel in interpret mode row for row
    (from_pallas_uniform_batch) and the host DP oracle in the kernel's
    best-effort coordinates."""
    q, bias, jobs = _query_jobs(8 + warp, 300, 4, width, max_tl=50)
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    best, mc, mr, meta = sud.uniform_scores(q, bias, blosum.matrix32, jobs,
                                            go, ge, "cpu")
    assert (su.uniform_shape(meta["band"])[1] == 32) == warp
    tgt, bmask, ppad, band, _ = jsp.prepare_pallas_batch(
        q, bias, blosum.matrix32, jobs, tile_b=8)
    assert band == meta["band"]
    want = _pallas_interpret(tgt, bmask, ppad, go, ge, band, 8)
    x = _torch(sud.from_pallas_uniform_batch(tgt, bmask, ppad, band))
    got = sud.banded_swipe_uniform_cuda(x["t_idx"], x["band_mask"], x["prof_t"],
                                        go, ge)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    ref = banded_swipe_batch_np(q, bias, jobs, blosum.matrix32,
                                blosum.gap_open, blosum.gap_extend)
    assert [(int(best[k]), max(int(mc[k]) - meta["shifts"][k], 0), int(mr[k]))
            for k in range(len(jobs))] == sud.host_as_uniform(ref, jobs)
    assert any(s == 0 for s, _, _ in ref) and any(s > 0 for s, _, _ in ref)


def test_banded_swipe_uniform_matches_xla(blosum):
    """The one-hot path and SwipeBatcher == diamond_tpu's swipe_jax."""
    q, bias, jobs = _query_jobs(5, 50, 5, 30)
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    j1h, jbm, jpp, jband, jmeta = swipe_jax.prepare_uniform_batch(
        q, bias, blosum.matrix32, jobs)
    want = swipe_jax.banded_swipe_uniform(j1h, jbm, jpp, go, ge, jband)
    t1h, bm, pp, band, meta = su.prepare_uniform_batch(q, bias, blosum.matrix32,
                                                       jobs, "cpu")
    assert (band, meta) == (jband, jmeta)
    np.testing.assert_array_equal(t1h.numpy(), np.asarray(j1h))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jpp))
    got = su.banded_swipe_uniform(t1h, bm, pp, go, ge, band)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (su.SwipeBatcher(blosum.matrix32, blosum.gap_open, blosum.gap_extend,
                            device="cpu").run(q, bias, jobs)
            == swipe_jax.SwipeBatcher(blosum.matrix32, blosum.gap_open,
                                      blosum.gap_extend).run(q, bias, jobs))


def test_device_dp_scores_matches_jax(blosum, monkeypatch):
    """The direct DP route on the CPU == diamond_tpu's (its Pallas kernel in
    interpret mode), positions mapped best-effort alike; bands past the
    kernel's cap take the host DP with the same output."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(jsp, "banded_swipe_pallas",
                        lambda *a, **kw: _pallas_interpret(*a, tile_b=256))
    pm = PortMatrix("BLOSUM62")
    for seed in (6, 7):
        q, bias, jobs = _query_jobs(seed, 45, 5, 48)
        want = jext._device_dp_scores(q, bias, jobs, blosum)
        got = pext._device_dp_scores(q, bias, jobs, pm)
        assert got == want
        monkeypatch.setattr(su, "MAX_UNIFORM_BAND", 32)
        assert pext._device_dp_scores(q, bias, jobs, pm) == want
        monkeypatch.setattr(su, "MAX_UNIFORM_BAND", 8192)


def test_wrapper_rejects_bad_inputs():
    t = torch.zeros(2, 8, dtype=torch.int8)
    bm = torch.ones(2, 4, dtype=torch.int8)
    p = torch.zeros(32, 12, dtype=torch.int32)
    with pytest.raises(TypeError):
        sud.banded_swipe_uniform_cuda(t.int(), bm, p, 12, 1)
    with pytest.raises(ValueError):
        sud.banded_swipe_uniform_cuda(t, bm[:, :3], p, 12, 1)
    with pytest.raises(ValueError):  # band past the cap
        sud.banded_swipe_uniform_cuda(
            t, torch.ones(2, 8193, dtype=torch.int8),
            torch.zeros(32, 8 + 8193, dtype=torch.int32), 12, 1)
    # bands <= 512: one warp per target, ceil(band / 32) rows a lane;
    # wider: one CTA per target
    assert [su.uniform_shape(b) for b in (16, 128, 1024, 5120, 8192)] == [
        (1, 32), (4, 32), (8, 128), (16, 320), (16, 512)]
    assert [su.uniform_shape(b) for b in (1, 33, 200, 500, 512, 513)] == [
        (1, 32), (2, 32), (7, 32), (16, 32), (16, 32), (8, 96)]
