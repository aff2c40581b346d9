"""The port's 3-frame banded-SWIPE kernel (plain PyTorch version on the CPU)
against diamond_tpu: the Pallas kernel ``banded_swipe3_pallas`` in interpret
mode and the numpy oracle ``ops/swipe3._forward_np``.  Tolerance: exact int32
equality (the DP is integer arithmetic).

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

from diamond_tpu.ops.swipe3 import _forward_np  # noqa: E402
from diamond_tpu.ops.swipe3_pallas import (banded_swipe3_pallas,  # noqa: E402
                                           prepare_swipe3_batch)
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.ops import swipe3_device as s3  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

FS = 15


def _batches(seed, trials):
    """Seeded 3-frame batches built as tests/test_swipe3_pallas.py builds
    them (frames of unequal length, so the stop row bites), plus band 1, a
    target shorter than the band, a job that starts above the query and one
    wholly past its end."""
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        qlen0 = int(rng.integers(40, 200))
        qlens = [qlen0, max(qlen0 - int(rng.integers(0, 2)), 1),
                 max(qlen0 - int(rng.integers(0, 2)), 1)]
        q_frames = [rng.integers(0, 24, L).astype(np.int8) for L in qlens]
        jobs = []
        for _ in range(int(rng.integers(3, 9))):
            tlen = int(rng.integers(30, 250))
            t = rng.integers(0, 24, tlen).astype(np.int8)
            d0 = int(rng.integers(-tlen + 2, qlen0 - 3))
            d1 = min(d0 + int(rng.integers(4, 40)), qlen0)
            if d1 <= d0:
                d1 = d0 + 1
            # plant the query's frame-0 letters so most jobs score well
            k = int(rng.integers(0, min(tlen, qlen0) // 2))
            n = min(20, tlen - k, qlen0 - k - max(d0, 0))
            if n > 0:
                t[k:k + n] = q_frames[0][k + max(d0, 0):k + max(d0, 0) + n]
            jobs.append((t, d0, d1))
        t = rng.integers(0, 24, 60).astype(np.int8)
        jobs += [(t, 3, 4), (t[:5], -2, 30), (t[:8], -7, -3),
                 (t, qlen0 - 1, qlen0)]
        yield q_frames, qlens, jobs


def _oracle(q_frames, qlens, t, d0, d1, m):
    band = d1 - d0
    i1 = max(d1 - 1, 0)
    i0 = i1 + 1 - band
    j0 = i1 - (d1 - 1)
    q64 = [np.asarray(f, dtype=np.int64) & 31 for f in q_frames]
    t64 = np.asarray(t, dtype=np.int64) & 31
    if len(t) - j0 <= 0:
        return 0, -1
    _S, best, max_col, _ = _forward_np(
        q64, qlens, t64, qlens[0], len(t), m.matrix32,
        m.gap_open + m.gap_extend, m.gap_extend, FS, i0, i1, j0, band * 3,
        len(t) - j0)
    return best, max_col


@pytest.fixture(scope="module")
def blosum():
    return ScoreMatrix("BLOSUM62")


def _m32(m):
    return torch.from_numpy(np.ascontiguousarray(m.matrix32, dtype=np.int32))


@pytest.mark.parametrize("seed", [4, 9])
def test_plain_matches_pallas_interpret(seed, blosum):
    """from_pallas_swipe3_batch carries each Pallas batch across; the plain
    version's (best, max_col) equal the Pallas kernel's row for row."""
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    for q_frames, _qlens, jobs in _batches(seed, 3):
        t_idx, bmask, prof, band_q, _meta = prepare_swipe3_batch(
            q_frames, blosum.matrix32, jobs, tile_b=8)
        want = banded_swipe3_pallas(t_idx, bmask, prof, go, ge, FS, band_q,
                                    tile_b=8, interpret=True)
        packed, K = s3.from_pallas_swipe3_batch(
            np.asarray(t_idx), np.asarray(bmask), np.asarray(prof),
            blosum.matrix32)
        x = {k: torch.from_numpy(v) for k, v in packed.items()}
        got = s3.banded_swipe3(x["t_cat"], x["q_cat"], x["jobs"], x["reqs"],
                               _m32(blosum), go, ge, FS, K)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scores_match_forward_oracle(blosum):
    """swipe3_scores over both strands of a query == _forward_np job for job
    (best, and max_col wherever something scores)."""
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    batches = list(_batches(21, 4))
    n_pos = 0
    for (fa, la, ja), (fb, lb, jb) in zip(batches[::2], batches[1::2]):
        jobs = [(0, t, d0, d1) for t, d0, d1 in ja] + \
               [(1, t, d0, d1) for t, d0, d1 in jb]
        best, mc = s3.swipe3_scores([fa, fb], jobs, blosum.matrix32, go, ge,
                                    FS, "cpu")
        for k, (strand, t, d0, d1) in enumerate(jobs):
            frames, lens = (fa, la) if strand == 0 else (fb, lb)
            b, c = _oracle(frames, lens, t, d0, d1, blosum)
            assert (best[k], mc[k]) == (b, c), (k, strand, d0, d1)
            n_pos += b > 0
    assert n_pos > 10


def test_pack_classes_and_caps(blosum):
    assert [s3.offsets_per_lane(b) for b in (1, 32, 33, 64, 65, 512)] == \
        [1, 1, 2, 2, 4, 16]
    f = [np.zeros(10, np.int8)] * 3
    with pytest.raises(ValueError):
        s3.swipe3_scores([f, f], [(0, np.zeros(5, np.int8), 0, 513)],
                         blosum.matrix32, 12, 1, FS, "cpu")
    x = s3.pack_swipe3([f, f], [(1, np.arange(9, dtype=np.int8), -3, 5)])
    assert x["reqs"].tolist() == [[0, 10, 10, 10], [30, 10, 10, 10]]
    # d0 = -3, d1 = 5: band 8, first query row i0 = -3, no column skipped
    assert x["jobs"].tolist() == [[0, 9, -3, 8, 1]]


def test_plain_rejects_bad_inputs():
    x = dict(t_cat=torch.zeros(4, dtype=torch.int8),
             q_cat=torch.zeros(4, dtype=torch.int8),
             jobs=torch.zeros(1, 5, dtype=torch.int32),
             reqs=torch.zeros(1, 4, dtype=torch.int32))
    m = torch.zeros(32, 32, dtype=torch.int32)
    with pytest.raises(TypeError):
        s3.banded_swipe3(x["t_cat"].int(), x["q_cat"], x["jobs"], x["reqs"],
                         m, 12, 1, FS, 1)
    with pytest.raises(ValueError):
        s3.banded_swipe3(x["t_cat"], x["q_cat"], x["jobs"], x["reqs"], m,
                         12, 1, FS, 3)
    with pytest.raises(ValueError):
        s3.banded_swipe3(x["t_cat"], x["q_cat"], x["jobs"][:, :4].contiguous(),
                         x["reqs"], m, 12, 1, FS, 1)
    assert s3.banded_swipe3.launches == 0


def _reads(seed, n_reads):
    """Seeded reads for the cross-read batch: per read both strands' frame
    translations (unequal lengths) and 3-9 jobs per strand in bands of
    1-100 offsets, as _batches builds them."""
    out = []
    for k in range(n_reads):
        strands, jobs = [], []
        for s, (q_frames, _qlens, sj) in enumerate(_batches(seed + k, 2)):
            strands.append(q_frames)
            jobs += [(s, t, d0, d1) for t, d0, d1 in sj]
        out.append((strands, jobs))
    return out


def test_cross_read_windows_match_pallas_and_host(blosum, monkeypatch):
    """The score-only jobs of many reads, scored a window at a time (as
    align/frameshift batches a block's reads: one swipe3_scores call per
    window, one launch per band class), equal each read's own results from
    diamond_tpu's banded_swipe3_pallas in interpret mode (mapped as its
    device route maps them, and carried across by from_pallas_swipe3_batch
    into the plain version) and from the host DP, exactly."""
    from types import SimpleNamespace

    from diamond_tpu.ops.swipe3 import banded_3frame_swipe_np
    from diamond_tpu_torch.align import frameshift as fs

    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    reads = _reads(31, 6)
    items = []
    for strands, jobs in reads:
        frames = {s * 3 + f: (strands[s][f], None)
                  for s in range(2) for f in range(3)}
        work = [(None, t, len(t), s, d0, d1) for s, t, d0, d1 in jobs]
        items.append((work, frames))
    total = sum(fs._work_letters(SimpleNamespace(work=w)) for w, _ in items)
    monkeypatch.setattr(fs, "WINDOW_LETTERS", total // 3)
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("DIAMOND_TPU_TORCH_DEVICE_DP", raising=False)
    mat = ScoreMatrix("BLOSUM62", frame_shift=FS)
    cfg = SimpleNamespace(matrix=mat)
    s3.dispatch_count = 0
    got, windows = [], 0
    for window in fs._windows(items, lambda x: fs._work_letters(
            SimpleNamespace(work=x[0]))):
        got += fs._device_swipe3_scores(window, cfg)
        windows += 1
    assert 1 < windows < len(reads)
    assert s3.dispatch_count < len(reads) * 2  # launches per window, not read
    m32 = _m32(blosum)
    n_pos = 0
    for (strands, jobs), res in zip(reads, got):
        assert res is not None and len(res) == len(jobs)
        for s in range(2):
            idx = [k for k, j in enumerate(jobs) if j[0] == s]
            sj = [jobs[k][1:] for k in idx]
            t_idx, bmask, prof, band_q, meta = prepare_swipe3_batch(
                strands[s], blosum.matrix32, sj, tile_b=8)
            pb, pc = (np.asarray(o) for o in banded_swipe3_pallas(
                t_idx, bmask, prof, go, ge, FS, band_q, tile_b=8,
                interpret=True))
            packed, K = s3.from_pallas_swipe3_batch(
                np.asarray(t_idx), np.asarray(bmask), np.asarray(prof),
                blosum.matrix32)
            x = {k: torch.from_numpy(v) for k, v in packed.items()}
            cb, cc = s3.banded_swipe3(x["t_cat"], x["q_cat"], x["jobs"],
                                      x["reqs"], m32, go, ge, FS, K)
            np.testing.assert_array_equal(cb.numpy(), pb)
            np.testing.assert_array_equal(cc.numpy(), pc)
            for n, k in enumerate(idx):
                want = (int(pb[n]), int(pc[n]) - meta["shifts"][n])
                if want[0] <= 0:
                    want = (0, -1)
                assert res[k] == want, (k, s)
                r = banded_3frame_swipe_np(strands[s], s, 0, *sj[n],
                                           blosum.matrix32, go, ge, FS,
                                           traceback=False)
                assert res[k] == ((r.score, r.max_col) if r else (0, -1))
                n_pos += want[0] > 0
    assert n_pos > 20
