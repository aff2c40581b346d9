"""The port's CUDA kernels on the card (``pytest -m gpu tests/test_torch_*.py``).

The banded-SWIPE kernel (K1, every band class), the 3-frame kernel (K3,
read by read and many reads in one batch), the full-matrix sweep (K2, also
at its own interface: every rows-per-lane class with padding rows, 2-16
strips, low-complexity runs with small gaps), the uniform-band kernel (K4,
its warp and CTA paths), the diagonal-band sweep (K5, also on queries above
one strip, positive biases, tied bests, score-0 rows and pad cells that
score) and the stage-2 filter (K6, also on pair counts of no multiple of
16, zero-width windows and hamming_id at the edge) against their plain
PyTorch versions on the same card tensors and against the host DP or a
numpy oracle; exact integer equality.
Skips without a card: a CUDA kernel has no CPU mode.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_banded_swipe_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import dp_requests
    finally:
        sys.path.remove(REPO)
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    reqs = dp_requests(seed=11, n_queries=6)
    p = sd.pack_requests(reqs, "cuda")
    # every band class up to 512: rows per lane 1..16
    assert [R for R, _, _ in p.classes] == list(sd.ROWS_PER_LANE)
    dp = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    launches = sd.banded_swipe_multi.launches
    got = dp.launch(p)
    want = dp.launch(p, kernel=sd.banded_swipe_multi_plain)
    torch.cuda.synchronize()
    assert sd.banded_swipe_multi.launches == launches + len(p.classes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for (q, bias, jobs), res in zip(reqs, dp.run_many(reqs)):
        assert res == banded_swipe_batch_np(q, bias, jobs, m.matrix32,
                                            m.gap_open, m.gap_extend)


def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.mark.gpu
def test_swipe3_kernel_matches_plain_and_native_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch import native
    from diamond_tpu_torch.ops import swipe3_device as s3
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    go, ge, fs = m.gap_open + m.gap_extend, m.gap_extend, 15
    classes = set()
    for strands, jobs in _smoke().swipe3_jobs(seed=12, n_queries=3):
        launches = s3.banded_swipe3.launches
        kb, kc = s3.swipe3_scores(strands, jobs, m.matrix32, go, ge, fs, "cuda")
        assert s3.banded_swipe3.launches > launches
        pb, pc = s3.swipe3_scores(strands, jobs, m.matrix32, go, ge, fs, "cuda",
                                  kernel=s3.banded_swipe3_plain)
        np.testing.assert_array_equal(kb, pb)
        np.testing.assert_array_equal(kc, pc)
        for k, (s, t, d0, d1) in enumerate(jobs):
            classes.add(s3.offsets_per_lane(d1 - d0))
            fwd = native.banded_3frame_forward_native(strands[s], t, d0, d1,
                                                      m.matrix32, go, ge, fs)
            want = (0, -1) if fwd is None or fwd[1] <= 0 else fwd[1:3]
            assert (kb[k], kc[k]) == tuple(want), (k, d0, d1)
    assert classes == set(s3.OFFSETS_PER_LANE)


@pytest.mark.gpu
def test_swipe3_kernel_batched_across_reads_on_gpu():
    """Many reads' jobs in one swipe3_scores call (every band class, one
    launch each) equal the plain version and the reads scored one by one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import swipe3_device as s3
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    go, ge, fs = m.gap_open + m.gap_extend, m.gap_extend, 15
    reads = _smoke().swipe3_jobs(seed=17, n_queries=12)
    strands, jobs, one = [], [], []
    for st, jb in reads:
        jobs += [(len(strands) + s, t, d0, d1) for s, t, d0, d1 in jb]
        strands += st
        one.append(s3.swipe3_scores(st, jb, m.matrix32, go, ge, fs, "cuda"))
    classes = {s3.offsets_per_lane(d1 - d0) for _, _, d0, d1 in jobs}
    assert classes == set(s3.OFFSETS_PER_LANE)
    launches = s3.banded_swipe3.launches
    kb, kc = s3.swipe3_scores(strands, jobs, m.matrix32, go, ge, fs, "cuda")
    assert s3.banded_swipe3.launches == launches + len(classes)
    pb, pc = s3.swipe3_scores(strands, jobs, m.matrix32, go, ge, fs, "cuda",
                              kernel=s3.banded_swipe3_plain)
    np.testing.assert_array_equal(kb, pb)
    np.testing.assert_array_equal(kc, pc)
    np.testing.assert_array_equal(kb, np.concatenate([b for b, _ in one]))
    np.testing.assert_array_equal(kc, np.concatenate([c for _, c in one]))


@pytest.mark.gpu
def test_full_swipe_kernel_matches_plain_and_host_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    queries, targets = _smoke().sweep_inputs(seed=13)
    tb = Block.from_sequences(targets, [f"t{i}" for i in range(len(targets))])
    t_order = np.arange(len(targets))
    sweep = sd.FullSweep(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    launches = sd.full_swipe.launches
    S = sweep.run_block(queries, tb, t_order)
    n = len(sweep.pack(queries, tb, t_order).launches)
    assert sd.full_swipe.launches == launches + n
    P = sweep.dispatch_block(queries, tb, t_order,
                             kernel=sd.full_swipe_plain).wait()
    np.testing.assert_array_equal(S, P)
    for r, (q, bias) in enumerate(queries):
        ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                              for t in targets],
                                    m.matrix32, m.gap_open, m.gap_extend)
        assert S[r].tolist() == [x[0] for x in ref], r


@pytest.mark.gpu
def test_uniform_swipe_kernel_matches_plain_and_host_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    bands = []
    for q, bias, jobs in _smoke().uniform_batches(seed=14):
        launches = sud.banded_swipe_uniform_cuda.launches
        kb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda")
        assert sud.banded_swipe_uniform_cuda.launches == launches + 1
        pb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda",
                                kernel=sud.banded_swipe_uniform_cuda_plain)
        for g, w in zip(kb[:3], pb[:3]):
            np.testing.assert_array_equal(g, w)
        ref = sud.host_as_uniform(banded_swipe_batch_np(
            q, bias, jobs, m.matrix32, m.gap_open, m.gap_extend), jobs)
        got = [(int(kb[0][k]), max(int(kb[1][k]) - kb[3]["shifts"][k], 0),
                int(kb[2][k])) for k in range(len(jobs))]
        assert got == ref
        bands.append(kb[3]["band"])
    assert max(bands) == 8192
    # at the kernel's interface: the warp path (bands <= 512) and the CTA
    # path, bands of no power of two, masks that are no prefix
    warp_path = set()
    for band, *arrs in _smoke().uniform_direct_cases(seed=20):
        t_idx, bm, prof = (torch.from_numpy(a).cuda() for a in arrs)
        got = sud.banded_swipe_uniform_cuda(t_idx, bm, prof, go, ge)
        want = sud.banded_swipe_uniform_cuda_plain(t_idx, bm, prof, go, ge)
        for g, w in zip(got, want):
            assert torch.equal(g, w), band
        warp_path.add(sud.uniform_shape(band)[1] == 32)
        bands.append(band)
    assert warp_path == {True, False}
    assert {16, 128, 500, 512, 513, 1024} <= set(bands)


@pytest.mark.gpu
def test_swipe_sweep_kernel_matches_plain_and_host_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    queries, targets = _smoke().sweep_case(seed=15)
    sweep = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    launches = sd.swipe_sweep.launches
    res = sweep.run(queries, targets)
    assert sd.swipe_sweep.launches == (launches + len(queries)
                                       * len(sweep.chunks(targets)))
    assert sweep.run(queries, targets, kernel=sd.swipe_sweep_plain) == res
    for (q, bias), row in zip(queries, res):
        ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                              for t in targets],
                                    m.matrix32, m.gap_open, m.gap_extend)
        assert row == [tuple(r) for r in ref]


@pytest.mark.gpu
def test_swipe_sweep_kernel_edges_on_gpu():
    """K5 walks only the query's rows: queries above one strip, positive
    biases, tied bests and score-0 rows through SwipeSweep equal the plain
    version and the full-band host DP; on a profile whose pad cells score
    (and a dead row) the kernel equals the plain version's whole band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    smoke = _smoke()
    queries, targets = smoke.sweep_edges(seed=18)
    assert max(len(q) for q, _ in queries) > sd.STRIP_ROWS
    sweep = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    res = sweep.run(queries, targets)
    assert sweep.run(queries, targets, kernel=sd.swipe_sweep_plain) == res
    zeros = 0
    for (q, bias), row in zip(queries, res):
        ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                              for t in targets],
                                    m.matrix32, m.gap_open, m.gap_extend)
        assert row == [tuple(r) for r in ref]
        zeros += sum(r[0] == 0 for r in row)
    assert zeros > 0
    # the segment three times against the segment: three tied alignments,
    # the highest query row's is reported
    assert res[2][1][0] == res[3][1][0] and res[2][1][2] > res[3][1][2]
    top = 0
    for t_idx, bl, prof_t, q_off, q_len in smoke.sweep_pad_case(
            sweep, targets, seed=19):
        got = sd.swipe_sweep(t_idx, bl, prof_t, go, ge, q_off, q_len)
        want = sd.swipe_sweep_plain(t_idx, bl, prof_t, go, ge)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int(got[0][0]) == 0  # the dead row
        top = max(top, int(got[0].max()))
    assert top > 0


@pytest.mark.gpu
def test_stage2_kernel_matches_plain_and_oracle_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import stage2_device as s2
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    smoke = _smoke()
    pairs = smoke.stage2_pairs(seed=16, n=1000)
    max_window = int(pairs[4].max())
    launches = s2.stage2_filter.launches
    keep, best = s2.stage2_pregathered(*pairs, m.matrix32, 26, max_window,
                                       device="cuda")
    assert s2.stage2_filter.launches == launches + 1
    keep_p, best_p = s2.stage2_pregathered(*pairs, m.matrix32, 26, max_window,
                                           device="cuda",
                                           kernel=s2.stage2_filter_plain)
    np.testing.assert_array_equal(keep, keep_p)
    np.testing.assert_array_equal(best, best_p)
    qw, sw, wl, wr = s2.pregather_windows(*pairs[:5], max_window)
    keep_o, best_o, _ = smoke.stage2_oracle(
        qw, sw, np.stack([wl, wr, pairs[5]]), m.matrix32[:32, :32], 26,
        max_window)
    np.testing.assert_array_equal(keep, keep_o)
    np.testing.assert_array_equal(best, best_o)
    assert keep.any() and not keep.all()


@pytest.mark.gpu
def test_full_swipe_kernel_edges_on_gpu():
    """K2 at its own interface: every rows-per-lane class with 1, 31 and
    32R - 1 padding rows in its one strip (the rows past the query run
    unmasked), queries of 2 to 16 strips, low-complexity runs with gap
    open 1 and extend 1 (vertical gaps cross lanes and strips, the vote's
    rare path), bias on and off, and one launch whose blocks hold pairs of
    several queries (two of them multi-strip): equal to the plain version
    and the full-band host DP."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    m32 = torch.from_numpy(m.matrix32.astype(np.int32)).cuda()
    smoke = _smoke()
    seen = set()
    for label, q, bias, R, targets, gap_open, gap_ext in \
            smoke.k2_edge_cases(seed=21):
        arrs, slots = smoke.k2_direct_inputs(q, bias, targets, R)
        x = {k: torch.from_numpy(v).cuda() for k, v in arrs.items()}
        scratch = torch.empty((slots, 2, len(arrs["t_cat"]), 2),
                              dtype=torch.int32, device="cuda")
        outs = []
        for fn in (sd.full_swipe, sd.full_swipe_plain):
            o = torch.zeros((1, len(targets)), dtype=torch.int32,
                            device="cuda")
            outs.append(fn(x["t_cat"], x["targets"], x["q_cat"],
                           x["bias_cat"], x["reqs"], x["pairs"], m32,
                           gap_open + gap_ext, gap_ext, R, scratch, o))
        assert torch.equal(outs[0], outs[1]), label
        ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                              for t in targets],
                                    m.matrix32, gap_open, gap_ext)
        assert outs[0][0].tolist() == [r[0] for r in ref], label
        strips = -(-len(q) // (32 * R))
        seen.add((R, strips * 32 * R - len(q)))
        seen.add(("strips", strips))
    assert {(R, 32 * R - 1) for R in range(1, 17)} <= seen
    assert {(R, 1) for R in range(1, 17)} <= seen
    assert {("strips", s) for s in (2, 3, 5, 9, 16)} <= seen

    qs, bs, ts, R, arrs, slots = smoke.k2_mixed_inputs(seed=22)
    x = {k: torch.from_numpy(v).cuda() for k, v in arrs.items()}
    scratch = torch.empty((slots, 2, len(arrs["t_cat"]), 2),
                          dtype=torch.int32, device="cuda")
    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    outs = [fn(x["t_cat"], x["targets"], x["q_cat"], x["bias_cat"],
               x["reqs"], x["pairs"], m32, go, ge, R, scratch,
               torch.zeros((len(qs), len(ts)), dtype=torch.int32,
                           device="cuda"))
            for fn in (sd.full_swipe, sd.full_swipe_plain)]
    assert torch.equal(outs[0], outs[1])
    blocks = arrs["pairs"][:len(arrs["pairs"]) // 4 * 4, 0].reshape(-1, 4)
    assert any(len(set(b)) > 2 for b in blocks.tolist())
    got = outs[0].cpu().numpy()
    for qi, ti in arrs["pairs"]:
        q, t = qs[qi], ts[ti]
        ref = banded_swipe_batch_np(q, bs[qi], [(t, -(len(t) - 1), len(q))],
                                    m.matrix32, m.gap_open, m.gap_extend)
        assert got[qi, ti] == ref[0][0], (qi, ti)


@pytest.mark.gpu
def test_stage2_kernel_edges_on_gpu():
    """K6 at its own interface: pair counts that are no multiple of 16 or
    of a block, windows clipped to zero width, hamming_id at the edge of
    the identity count, windows of the kernel's most rows: equal to the
    plain version and the numpy oracle; a window of more rows is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import stage2_device as s2
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    m2 = np.ascontiguousarray(m.matrix32[:32, :32], dtype=np.int32)
    smoke = _smoke()
    kept = set()
    for label, qw, sw, meta, hid, max_window in \
            smoke.stage2_edge_cases(seed=22):
        x = [torch.from_numpy(a).cuda() for a in (qw, sw, meta, m2)]
        launches = s2.stage2_filter.launches
        got = s2.stage2_filter(*x, hid, max_window)
        assert s2.stage2_filter.launches == launches + 1
        want = s2.stage2_filter_plain(*x, hid, max_window)
        for g, w in zip(got, want):
            assert torch.equal(g, w), label
        oracle = smoke.stage2_oracle(qw, sw, meta, m2, hid, max_window)
        for g, w in zip(got, oracle):
            np.testing.assert_array_equal(g.cpu().numpy(), w, err_msg=label)
        assert not got[1][meta[0] + meta[1] == 0].any()  # zero-width
        kept.add(bool(got[0][0]))
    assert kept == {True, False}
    W = s2.MAX_ROWS + 2
    x = [torch.zeros((W, 5), dtype=torch.int8, device="cuda")] * 2
    meta = torch.zeros((3, 5), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        s2.stage2_filter(*x, meta, torch.from_numpy(m2).cuda(), 26, W // 2)


@pytest.mark.gpu
def test_stage12_kernel_matches_plain_on_gpu(monkeypatch):
    """D1 (the fused stage-1/2 filter) on chip_smoke's edge batches: pair
    counts of no multiple of a block, every window width 1 to 48,
    delimiters at and around the seed, masked letters with high bits,
    hamming_id 0 to 49: keep and best equal to the plain version on the
    same card tensors and to the CPU's; Stage12Device's chunks on the card
    equal the CPU's; run_join on the card (groups over 512 pairs through
    the one-hot product, tiles split over three products) equals the
    CPU's run_join; and a pair reading past its block is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch.ops import stage12_device as d1
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    m32 = torch.from_numpy(np.ascontiguousarray(m.matrix32[:32, :32],
                                                dtype=np.int32))
    kept = set()
    for label, case, hid in _smoke().stage12_edge_cases(seed=31):
        q, s, qp, sp, win, cut = case
        cpu = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
               for a, dt in ((q, np.int8), (s, np.int8))] + [m32] + [
            torch.from_numpy(a.astype(np.int32)) for a in (qp, sp, win, cut)]
        x = [t.cuda() for t in cpu]
        launches = d1.stage12_pairs.launches
        got = d1.stage12_pairs(*x, hid)
        assert d1.stage12_pairs.launches == launches + 1
        want = d1.stage12_pairs_torch(*x, hid)
        host = d1.stage12_pairs(*cpu, hid)
        for g, w, h in zip(got, want, host):
            assert torch.equal(g, w), label
            assert torch.equal(g.cpu(), h), label
        card = d1.Stage12Device(m.matrix32, device="cuda", chunk=1000)
        k, b = card.run(q, s, qp, sp, win, cut, hid)
        np.testing.assert_array_equal(k, host[0].numpy(), err_msg=label)
        np.testing.assert_array_equal(b, host[1].numpy(), err_msg=label)
        kept.update(bool(v) for v in got[0].cpu().numpy()[:50])
    assert kept == {True, False}
    letters, join, qp, sp, win, cut = _smoke().stage12_join_case(5)
    monkeypatch.setattr(d1, "GROUP_TILES", 100)
    want = d1.Stage12Device(m.matrix32, device="cpu").run_join(
        letters, letters, join, qp, sp, win, cut, 11)
    d1.reset_dispatch_stats()
    launches = d1.stage12_pairs.launches
    got = d1.Stage12Device(m.matrix32, device="cuda").run_join(
        letters, letters, join, qp, sp, win, cut, 11)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].any()
    assert d1.dispatch_count == 4  # three products and one kernel chunk
    assert d1.stage12_pairs.launches == launches + 1
    bad = x[3].clone()
    bad[0] = x[0].numel() - 8
    with pytest.raises(ValueError, match="outside"):
        d1.stage12_pairs(x[0], x[1], x[2], bad, *x[4:], 11)
