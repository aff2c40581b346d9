"""The port's uniform-band SWIPE against diamond_tpu: the kernel's plain
PyTorch version (the CPU side of ``banded_swipe_uniform_cuda``) against the
Pallas kernel ``banded_swipe_pallas`` in interpret mode and the host DP
oracle, and the one-hot path ``banded_swipe_uniform`` against its XLA twin.
A numpy model of the wide-band walk's order and edge rules (profile rows
[p_lo, p_hi) in strips, the columns each strip walks, absent against
invalid cells, the tie reduction at the end) is held against all three.
Tolerance: exact int32 equality throughout (the DP is integer arithmetic).

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

from jax.experimental import pallas as pl  # noqa: E402

import diamond_tpu.ops.swipe_pallas as jsp  # noqa: E402
from diamond_tpu.ops import swipe_jax  # noqa: E402
from diamond_tpu.ops.banded_swipe import banded_swipe_batch_np  # noqa: E402
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.ops import swipe_uniform as su  # noqa: E402
from diamond_tpu_torch.ops import swipe_uniform_device as sud  # noqa: E402
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _walk_model(t_idx, band_mask, prof_t, go, ge, strip_rows=512):
    """The wide-band walk's function, as a model of its order: per target,
    profile rows [p_hi - strips * strip_rows, p_hi) in strips (the rows
    above p_lo score nothing), each strip over the columns where one of its
    live rows lies in the band, cut to the first and last column whose
    letter scores > 0 in some live row; a strip reads the H and F that the
    strip above left in its last row (0 in a column it did not walk).  A
    cell above the band's top row (band row < 0) is absent: no E, no cur0,
    no F; a cell past its last row, out of the mask or scoring <= NEG / 2 is
    invalid: H 0, E and F pass.  The best cell: the largest H, then the
    least column, then the highest row.  Returns int32 (best, max_col,
    max_row) [B] like the kernel."""
    NEG = su.NEG
    t_idx, band_mask, prof_t = (np.asarray(a, np.int64)
                                for a in (t_idx, band_mask, prof_t))
    B, T = t_idx.shape
    band = prof_t.shape[1] - T
    live = np.nonzero((prof_t > NEG // 2).any(0))[0]
    out = np.zeros((3, B), np.int32)
    if not len(live):
        return out
    p_lo, p_hi = int(live[0]), int(live[-1]) + 1
    pos = (prof_t[:, p_lo:p_hi] > 0).any(1)
    strips = -(-(p_hi - p_lo) // strip_rows)
    p0 = p_hi - strips * strip_rows
    for b in range(B):
        letters = t_idx[b] & 31
        can = np.nonzero(pos[letters])[0]
        if not len(can):
            continue
        jf, jl = int(can[0]), int(can[-1])
        mask = band_mask[b] != 0
        carry_h, carry_f = np.zeros(T, np.int64), np.zeros(T, np.int64)
        best, col, row = 0, T, -1
        for s in range(strips):
            S0 = p0 + s * strip_rows
            p = np.arange(S0, S0 + strip_rows)
            k = np.arange(strip_rows)
            js = max(0, jf, max(S0, p_lo) - band + 1)
            je = min(T - 1, jl, S0 + strip_rows - 1)
            H = np.zeros(strip_rows, np.int64)
            E = np.zeros(strip_rows, np.int64)
            new_h, new_f = np.zeros(T, np.int64), np.zeros(T, np.int64)
            for j in range(js, je + 1):
                r = p - j
                inband = (r >= 0) & (r < band)
                sc = np.where(p >= 0, prof_t[letters[j], np.clip(p, 0, None)],
                              NEG)
                valid = inband & mask[np.clip(r, 0, band - 1)] \
                    & (sc > NEG // 2)
                s_eff = np.where(valid, sc, NEG)
                diag = np.concatenate([[carry_h[j - 1] if j else 0], H[:-1]])
                e = np.where(r >= 0, E, 0)
                cur0 = np.maximum(np.maximum(diag + s_eff, e), 0)
                cur0 = np.where(r >= 0, cur0, 0)
                g = np.maximum.accumulate(
                    np.maximum(cur0 - go + k * ge, carry_f[j] - ge))
                f_out = np.maximum(g - k * ge, 0)
                f_in = np.concatenate([[carry_f[j]], f_out[:-1]])
                Hn = np.where(valid, np.maximum(cur0, f_in), 0)
                E = np.maximum(np.maximum(E - ge, Hn - go), 0)
                H = Hn
                new_h[j], new_f[j] = H[-1], f_out[-1]
                m = int(H.max())
                if m > 0:
                    pr = int(p[np.nonzero(H == m)[0][-1]])
                    if (m, -j, pr) > (best, -col, row):
                        best, col, row = m, j, pr
            carry_h, carry_f = new_h, new_f
        if best > 0:
            out[:, b] = best, col, row - col
    return out


def _pallas_of(t_idx, band_mask, prof_t, tile_b=8):
    """Kernel-interface arrays as a banded_swipe_pallas batch (targets
    padded to a tile, 8 prefetch columns of pad letters), so that
    from_pallas_uniform_batch gives them back."""
    B, T = t_idx.shape
    band = prof_t.shape[1] - T
    Bp = -(-B // tile_b) * tile_b
    tgt = np.full((T + 8, Bp), 31, np.int32)
    tgt[:T, :B] = t_idx.T
    bmask = np.zeros((Bp, band), np.int32)
    bmask[:B] = band_mask
    ppad = np.full((T + 8 + band, 32), su.NEG, np.int32)
    ppad[:T + band] = prof_t.T
    return tgt, bmask, ppad, band


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
    kernel's warp path) and 600 to 1024 (its wide-band walk).  The plain
    version equals the Pallas kernel in interpret mode row for row
    (from_pallas_uniform_batch) and the host DP oracle in the kernel's
    best-effort coordinates."""
    q, bias, jobs = _query_jobs(8 + warp, 300, 4, width, max_tl=50)
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    best, mc, mr, meta = sud.uniform_scores(q, bias, blosum.matrix32, jobs,
                                            go, ge, "cpu")
    assert (meta["band"] <= su.MAX_WARP_BAND) == warp
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
    with pytest.raises(ValueError):  # gap costs below 0
        sud.banded_swipe_uniform_cuda(t, bm, p, 12, -1)
    # (rows a lane, strips): bands <= 512 one warp holds the band, ceil(band
    # / 32) band rows a lane; wider bands one warp walks the profile's live
    # rows in strips of at most 512, spread evenly over strips and lanes
    assert [su.uniform_shape(b) for b in (1, 16, 33, 128, 200, 500, 512)] == [
        (1, 1), (1, 1), (2, 1), (4, 1), (7, 1), (16, 1), (16, 1)]
    assert [su.uniform_shape(b, rows) for b, rows in (
        (513, 1), (513, 480), (1024, 512), (1024, 513), (5120, 1100),
        (8192, 4000), (8192, 8192))] == [
        (1, 1), (15, 1), (16, 1), (9, 2), (12, 3), (16, 8), (16, 16)]
    with pytest.raises(ValueError):  # the wide walk's shape needs the rows
        su.uniform_shape(513)


@pytest.mark.parametrize("case", ["none", "one", "ends", "holes", "pos"])
def test_profile_rows(case):
    """What the wide walk needs of a profile, from a CPU tensor (the
    wrapper's reduction) and from a numpy array (the packing's): the live
    rows [p_lo, p_hi), the letters that score > 0 in them, and whether
    every letter scores in every live row."""
    NEG = su.NEG
    p = np.full((32, 40), NEG, np.int32)
    want = (0, 0, 0, 1)
    if case == "one":
        p[3, 17] = -5
        want = (17, 18, 0, 0)
    elif case == "ends":
        p[:, 0] = -1
        p[:, 39] = -2
        p[:, 1:39] = -3
        want = (0, 40, 0, 1)
    elif case == "holes":  # a dead row inside, a row valid for some letters
        p[:, 5:30] = -4
        p[:, 12] = NEG
        p[::2, 20] = NEG // 2
        p[7, 6] = 9
        want = (5, 30, 1 << 7, 0)
    elif case == "pos":  # letters 0 and 31 score > 0; NEG // 2 + 1 counts
        p[:, 10:20] = -1
        p[0, 11] = 1
        p[31, 19] = 4
        p[5, 25] = NEG // 2 + 1
        want = (10, 26, 1 | 1 << 31, 0)
    assert su.profile_rows(torch.from_numpy(p)) == want
    assert su.profile_rows(p) == want


@pytest.mark.parametrize("case", [16, 513, 1024, 3000, 8192, "truncated"])
def test_pack_rows_match_profile_rows(case, blosum):
    """pack_uniform_batch's meta["rows"], found on the query's columns alone
    and handed to the wrapper in place of its read-back, equal
    profile_rows of the whole packed profile, on the host and as a tensor
    (jobs of uniform_batches; "truncated": a query longer than T + band, so
    that the profile holds only its first columns)."""
    if case == "truncated":
        rng = np.random.default_rng(7)
        q = rng.integers(0, 20, 2000).astype(np.int8)
        bias = rng.integers(-4, 5, 2000).astype(np.int32)
        jobs = [(rng.integers(0, 20, 50).astype(np.int8), 0, 600)]
    else:
        q, bias, jobs = _smoke().uniform_batches(70, bands=(case,))[0]
    packed, meta = sud.pack_uniform_batch(q, bias, blosum.matrix32, jobs)
    if case == "truncated":
        assert packed["prof_t"].shape[1] < len(q)
    want = su.profile_rows(packed["prof_t"])
    assert meta["rows"] == want
    assert su.profile_rows(torch.from_numpy(packed["prof_t"])) == want
    assert want[1] > want[0]


EDGES = _smoke().UNIFORM_EDGES


@pytest.mark.parametrize("k", range(len(EDGES)), ids=[c[0] for c in EDGES])
def test_wide_walk_model_edges(k):
    """chip_smoke's wide-band edge case k (UNIFORM_EDGES: holes, dead rows,
    rows leaving and entering the band, several strips, pad columns that
    score, ties, best 0, B = 1, bands 513-8192) at the kernel's interface:
    the walk's model, in the kernel's strips and in strips of 64 rows (more
    strips, every carry rule), equals the plain version (the wrapper on CPU
    tensors) and the Pallas kernel in interpret mode."""
    label, band, t_idx, band_mask, prof_t = _smoke().uniform_edge_cases(
        30, cases=(EDGES[k],))[0]
    go, ge = 12, 1
    got = sud.banded_swipe_uniform_cuda(
        *(torch.from_numpy(a) for a in (t_idx, band_mask, prof_t)), go, ge)
    plain = np.stack([g.numpy() for g in got])
    np.testing.assert_array_equal(_walk_model(t_idx, band_mask, prof_t, go,
                                              ge), plain)
    np.testing.assert_array_equal(_walk_model(t_idx, band_mask, prof_t, go,
                                              ge, strip_rows=64), plain)
    tgt, bmask, ppad, _ = _pallas_of(t_idx, band_mask, prof_t)
    x = sud.from_pallas_uniform_batch(tgt, bmask, ppad, band)
    np.testing.assert_array_equal(x["t_idx"][:len(t_idx)], t_idx)
    want = _pallas_interpret(tgt, bmask, ppad, go, ge, band, 8)
    np.testing.assert_array_equal(np.stack(want)[:, :len(t_idx)], plain)
    if "best 0" in label:
        assert (plain[:, 0] == 0).all()


@pytest.mark.parametrize("width", [513, 700, 1024, 3000, 8192])
def test_wide_walk_model_matches_pallas_and_host(width, blosum):
    """Jobs packed as the direct DP route and sharded_full_scores pack them,
    widest band ``width`` (bands 513-8192 take the wide walk): the walk's
    model equals the plain version, the Pallas kernel in interpret mode row
    for row (prepare_pallas_batch) and the host DP oracle in the kernel's
    best-effort coordinates."""
    q, bias, jobs = _smoke().uniform_batches(50 + width, bands=(width,))[0]
    jobs = jobs[:3] + jobs[-2:]  # the widest, two more, short and empty
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    packed, meta = sud.pack_uniform_batch(q, bias, blosum.matrix32, jobs)
    assert meta["band"] > su.MAX_WARP_BAND
    best, mc, mr, _ = sud.uniform_scores(q, bias, blosum.matrix32, jobs, go,
                                         ge, "cpu")
    model = _walk_model(packed["t_idx"], packed["band_mask"],
                        packed["prof_t"], go, ge)
    np.testing.assert_array_equal(model, np.stack([best, mc, mr]))
    tgt, bmask, ppad, band, _ = jsp.prepare_pallas_batch(
        q, bias, blosum.matrix32, jobs, tile_b=8)
    want = _pallas_interpret(tgt, bmask, ppad, go, ge, band, 8)
    x = sud.from_pallas_uniform_batch(tgt, bmask, ppad, band)
    np.testing.assert_array_equal(
        _walk_model(x["t_idx"], x["band_mask"], x["prof_t"], go, ge),
        np.stack(want))
    ref = banded_swipe_batch_np(q, bias, jobs, blosum.matrix32,
                                blosum.gap_open, blosum.gap_extend)
    assert [(int(best[k]), max(int(mc[k]) - meta["shifts"][k], 0), int(mr[k]))
            for k in range(len(jobs))] == sud.host_as_uniform(ref, jobs)
    assert any(s == 0 for s, _, _ in ref) and any(s > 0 for s, _, _ in ref)
