"""The port's CUDA kernels on the card (``pytest -m gpu tests/test_torch_*.py``).

The banded-SWIPE kernel (K1, every band class), the 3-frame kernel (K3,
read by read and many reads in one batch), the full-matrix sweep (K2, also
at its own interface: every rows-per-lane class with padding rows, 2-16
strips, low-complexity runs with small gaps), the uniform-band kernel (K4,
its warp and CTA paths), the diagonal-band sweep (K5, also on queries above
one strip, positive biases, tied bests, score-0 rows and pad cells that
score), the stage-2 filter (K6, also on pair counts of no multiple of
16, zero-width windows and hamming_id at the edge), the stage-1/2 pair
filter (D1) and D1's whole fused pass over seed joins (stage12_join, also
against the native host pass, whole and in chunks) and the traceback
refill (D4, its planes too), tantan's scan (the masking, against the
native host scan too) and the query-indexed route's DB-side seed
enumeration (against the native fused pass too; a blastp through it
against its host route) against their plain PyTorch versions on the
same card tensors and against the host DP or a numpy oracle; exact
integer equality.  MCL's dense step (D3, torch ops)
on a 512-node component against the same ops on the CPU and the numpy
loop (equal cluster assignments, TF32 off), and blocked blastp (-b) with
K1 on the card against the host DP.  ``--mesh`` on the card's shards:
``DeviceDP(mesh=...)`` (K1) against the unsharded DeviceDP and
``sharded_full_scores`` (K4) against the host DP; the ``test`` command on
the card.
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
def test_uniform_swipe_kernel_matches_plain_and_host_on_gpu(monkeypatch):
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
    # at the kernel's interface: the warp path (bands <= 512) and the
    # wide-band walk, bands of no power of two, masks that are no prefix,
    # and the walk's edges (UNIFORM_EDGES: dead rows, rows leaving the band,
    # several strips, pad columns that score, ties, best 0, B = 1)
    warp_path = set()
    cases = [(str(c[0]), *c) for c in _smoke().uniform_direct_cases(seed=20)]
    cases += _smoke().uniform_edge_cases(seed=30)
    for label, band, *arrs in cases:
        t_idx, bm, prof = (torch.from_numpy(a).cuda() for a in arrs)
        got = sud.banded_swipe_uniform_cuda(t_idx, bm, prof, go, ge)
        want = sud.banded_swipe_uniform_cuda_plain(t_idx, bm, prof, go, ge)
        # the live rows from the host, as the packing hands them over
        given = sud.banded_swipe_uniform_cuda(
            t_idx, bm, prof, go, ge, rows=sud.profile_rows(arrs[2]))
        for g, h, w in zip(got, given, want):
            assert torch.equal(g, w) and torch.equal(h, w), label
        warp_path.add(band <= sud.MAX_WARP_BAND)
        bands.append(band)
    assert warp_path == {True, False}
    assert {16, 128, 500, 512, 513, 700, 1024, 1040, 3000, 8192} <= set(bands)
    # strip carries past SCRATCH_BYTES: one launch a target
    for label, band, *arrs in _smoke().uniform_edge_cases(seed=30):
        if "strips" not in label:
            continue
        t_idx, bm, prof = (torch.from_numpy(a).cuda() for a in arrs)
        want = sud.banded_swipe_uniform_cuda(t_idx, bm, prof, go, ge)
        monkeypatch.setattr(sud, "SCRATCH_BYTES", 1)
        launches = sud.banded_swipe_uniform_cuda.launches
        got = sud.banded_swipe_uniform_cuda(t_idx, bm, prof, go, ge)
        assert sud.banded_swipe_uniform_cuda.launches - launches == len(t_idx)
        monkeypatch.undo()
        for g, w in zip(got, want):
            assert torch.equal(g, w), label
    # thousands of targets in one call, full-matrix jobs, against the plain
    # version and the host DP
    q, bias, jobs = _smoke().uniform_many(seed=40)
    kb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda")
    pb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda",
                            kernel=sud.banded_swipe_uniform_cuda_plain)
    for g, w in zip(kb[:3], pb[:3]):
        np.testing.assert_array_equal(g, w)
    assert kb[3]["band"] > sud.MAX_WARP_BAND
    ref = sud.host_as_uniform(banded_swipe_batch_np(
        q, bias, jobs, m.matrix32, m.gap_open, m.gap_extend), jobs)
    assert [(int(kb[0][k]), max(int(kb[1][k]) - kb[3]["shifts"][k], 0),
             int(kb[2][k])) for k in range(len(jobs))] == ref


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


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1 << 25, 3000])
def test_stage12_join_kernel_matches_plain_on_gpu(cap):
    """The fused stage-1/2 pass (stage12_join, csrc/stage12_join.cu) on
    chip_smoke's seeded joins (STAGE12_FUSED_EDGES: self-search on and
    off, a chunked index with and without the part table, group_keep, the
    first shape and later ones, translated short-query windows, skip_lm,
    seeds beside delimiters), whole and in chunks of at most 3,000 pairs:
    the card's rows equal the plain version's on the CPU and the native
    pass's, row for row; one launch a chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from diamond_tpu_torch import native
    from diamond_tpu_torch.ops import stage12_device as d1

    smoke = _smoke()
    for k, (label, kw) in enumerate(smoke.STAGE12_FUSED_EDGES):
        c = smoke.stage12_fused_case(50 + k, **kw)
        want = smoke.stage12_native_rows(native, c)
        d1.reset_dispatch_stats()
        launches = d1.stage12_join.launches
        got = smoke.stage12_fused_rows(
            d1.Stage12Device(c["matrix32"], device="cuda"), c, cap=cap)
        assert d1.stage12_join.launches == launches + d1.dispatch_count
        plain = smoke.stage12_fused_rows(
            d1.Stage12Device(c["matrix32"], device="cpu"), c, cap=cap)
        np.testing.assert_array_equal(got, want, err_msg=label)
        np.testing.assert_array_equal(plain, want, err_msg=label)
        assert len(want), label


@pytest.mark.gpu
def test_stage12_route_memory_is_flat_across_shapes_on_gpu():
    """A --sensitive search (16 shapes, a chunked index with partition
    tables) with stage 1/2 on the card: after its first call, which caches
    the blocks and the per-query tables, no Stage12Device.join_rows call
    leaves memory allocated on the card, so the memory a call starts from
    does not grow with the shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    calls = _smoke().stage12_route_memory("cuda")
    assert len(calls) >= 16 and any(c["part_tbl"] for c in calls)
    assert {c["cached"] for c in calls} == {calls[0]["cached"]}
    assert all(c["after"] == c["before"] == calls[1]["before"]
               for c in calls[1:])


@pytest.mark.gpu
def test_mcl_dense_step_on_gpu():
    """MCL's dense step (D3) on the card against the same torch ops on the
    CPU on a 512-node component: equal cluster assignments; every product
    runs with TF32 off, whatever the global setting, which is restored."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chip_smoke = _smoke()
    from diamond_tpu_torch.cluster import mcl

    M = chip_smoke.mcl_matrix(*chip_smoke.mcl_graph(9, (512,)))
    seen = []
    matmul = torch.Tensor.__matmul__

    def spy(x, y):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(x, y)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.Tensor.__matmul__ = spy
    try:
        launches = mcl.mcl_dense_torch.launches
        got = mcl.mcl_dense_torch(M, 2, 2.0, 100, "cuda")
        assert torch.backends.cuda.matmul.allow_tf32  # restored
        assert mcl.mcl_dense_torch.launches == launches + 1
    finally:
        torch.Tensor.__matmul__ = matmul
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen and not any(seen)
    cpu = mcl.mcl_dense_torch(M, 2, 2.0, 100, "cpu")
    npl = mcl._mcl_dense(M.copy(), 2, 2.0, 100, None)
    want = mcl._clusters_from_matrix(cpu)
    assert len(np.unique(want)) > 1
    assert np.array_equal(mcl._clusters_from_matrix(got), want)
    assert np.array_equal(mcl._clusters_from_matrix(npl), want)
    assert np.abs(got - cpu).max() < 1e-4


@pytest.mark.gpu
def test_blocked_blastp_on_gpu(tmp_path, monkeypatch):
    """blastp -b with K1 on the card prints what the host DP prints
    (DIAMOND_TPU_TORCH_DEVICE_DP=0), over 2 query x 5 target blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chip_smoke = _smoke()
    from diamond_tpu_torch.cli import main
    from diamond_tpu_torch.ops import swipe_device as sd

    monkeypatch.delenv("DIAMOND_TPU_TORCH_DEVICE", raising=False)
    recs = chip_smoke.make_proteins(n_seqs=300, n_families=75, seed=5)
    chip_smoke.write_fasta(tmp_path / "db.faa", recs)
    chip_smoke.write_fasta(tmp_path / "q.faa", recs[:120])
    letters = sum(len(s) for _, s in recs)
    args = ["blastp", "-q", str(tmp_path / "q.faa"), "-d",
            str(tmp_path / "db.faa"), "-b", f"{letters / 4.5 / 1e9:.9f}"]
    outs = {}
    for route in ("card", "host"):
        if route == "host":
            monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE_DP", "0")
        launches = sd.banded_swipe_multi.launches
        assert main(args + ["-o", str(tmp_path / route)]) == 0
        outs[route] = (tmp_path / route).read_bytes()
        assert (sd.banded_swipe_multi.launches > launches) == (route == "card")
    assert outs["card"] and outs["card"] == outs["host"]


@pytest.mark.gpu
def test_sharded_devicedp_and_full_scores_on_gpu():
    """A mesh of the card's shards: DeviceDP(mesh=...) launches K1 on each
    and equals the unsharded DeviceDP; sharded_full_scores launches K4 and
    equals the host DP."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.parallel.sharded import (Mesh, make_mesh,
                                                    sharded_full_scores)
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    reqs = _smoke().dp_requests(seed=12, n_queries=6)
    want = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend,
                       device="cuda").run_many(reqs)
    for mesh in (make_mesh(1), Mesh(["cuda:0"] * 3)):
        launches = sd.banded_swipe_multi.launches
        dp = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend, mesh=mesh)
        assert dp.run_many(reqs) == want
        assert sd.banded_swipe_multi.launches - launches >= 16
    recs = _smoke().make_proteins(n_seqs=41, n_families=10, seed=3)
    tblock = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
    q = tblock.seq(0)
    jobs = [(tblock.seq(t), -(len(tblock.seq(t)) - 1), len(q))
            for t in range(len(tblock))]
    ref = [s for s, _, _ in banded_swipe_batch_np(
        q, None, jobs, m.matrix32, m.gap_open, m.gap_extend)]
    for mesh in (make_mesh(1), Mesh(["cuda:0"] * 4)):
        launches = sud.banded_swipe_uniform_cuda.launches
        got = sharded_full_scores(mesh, q, None, tblock, m.matrix32,
                                  m.gap_open, m.gap_extend)
        assert got.tolist() == ref
        assert sud.banded_swipe_uniform_cuda.launches > launches


@pytest.mark.gpu
def test_self_test_command_on_gpu(tmp_path):
    """``test`` runs DeviceDP's K1 on the card against the host DP."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import subprocess

    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DIAMOND_TPU_TORCH_DEVICE", None)
    r = subprocess.run([sys.executable, "-c",
                        "import sys; from diamond_tpu_torch.cli import main; "
                        "rc = main(['test']); "
                        "from diamond_tpu_torch.ops import swipe_device as sd; "
                        "print('K1', sd.banded_swipe_multi.launches); "
                        "sys.exit(rc)"],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("Self test OK.\n")
    assert int(r.stdout.split("K1 ")[1]) > 0


@pytest.mark.gpu
def test_banded_traceback_kernel_matches_plain_and_native_on_gpu():
    """D4 (csrc/banded_traceback.cu) on the card against its plain version
    on the same card tensors (every output: out, stats, op offsets, codes,
    payloads), whole and with the planes in 64 KB slices; its four planes,
    decoded from its scratch, against the plain fill's on the live
    columns; and through tb_multi_device against the native host call
    (jobs starting at diagonal -(t_len - 1) or above) and the numpy oracle
    (the others)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cs = _smoke()
    from diamond_tpu_torch.ops import traceback_device as tbd
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62")
    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    m32 = torch.from_numpy(m.matrix32.astype(np.int32)).cuda()
    for seed, kw in ((21, {}), (22, dict(bands=(1, 31, 32, 33, 512))),
                     (23, dict(n_queries=8, max_len=1500))):
        c = cs.tb_jobs(seed, **kw)
        x, jobs = cs.tb_tensors(c, "cuda")
        want = tbd.banded_traceback_multi_plain(*x, m32, go, ge)
        for budget in (tbd.PLANE_BUDGET_BYTES, 1 << 16):
            launches = tbd.banded_traceback_multi.launches
            got = tbd.banded_traceback_multi(*x, m32, go, ge,
                                             plan=tbd.tb_plan(jobs, budget))
            torch.cuda.synchronize()
            assert tbd.banded_traceback_multi.launches > launches
            for g, w in zip(got, want):
                assert g.shape == w.shape and torch.equal(g, w)
        # the planes themselves, from the kernel's scratch (one slice)
        plan = tbd.tb_plan(jobs)
        bufs = tbd.tb_buffers(plan, "cuda")
        out = torch.zeros((len(jobs), 3), dtype=torch.int64, device="cuda")
        stats = torch.zeros((len(jobs), 12), dtype=torch.int64,
                            device="cuda")
        tbd.tb_launch(*x, m32, go, ge, plan, bufs, out, stats)
        code = tbd._fill_plain(*x, m32.long(), go, ge)[3].cpu().numpy()
        assert cs.tb_plane_mismatches(bufs["planes"].cpu().numpy(), plan,
                                      jobs, code) == 0
        assert torch.equal(out, want[0]) and torch.equal(stats, want[1])
        r = tbd.tb_multi_device(*[c[k] for k in cs.TB_KEYS], m.matrix32,
                                go, ge, "cuda")
        nat, orc, low, _ = cs.tb_check(c, r, m.matrix32, m.gap_open,
                                       m.gap_extend)
        assert (nat, orc) == (0, 0)


@pytest.mark.gpu
def test_tantan_mask_kernel_matches_native_on_gpu(monkeypatch):
    """tantan's scan on the card (csrc/tantan.cu) against the port's native
    host scan (held bit-equal to diamond_tpu's by
    tests/test_torch_tantan_device.py, on the CPU: diamond_tpu does not run
    on the card) on the benchmark's block (15,000 proteins of the frozen generator,
    ~5.8 M letters): bit-equal probabilities, byte-equal letters, the
    padding untouched, one launch; then the edge cases of the CPU tests
    (lengths around 16 and 50 and 3,000, letters with high bits, positions
    one ulp either side of p_mask) against the native scan and the plain
    version on the card; and a CUDA _mask_block through the kernel, counted
    in mask.card_letters, under a kernel.mask span inside mask.block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, os.path.join(REPO, "perfbench"))
    try:
        import gen
        import test_torch_tantan_device as cpu_case
    finally:
        sys.path.remove(os.path.join(REPO, "perfbench"))
        sys.path.remove(os.path.join(REPO, "tests"))
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.ops import tantan_device as td
    from diamond_tpu_torch.search import pipeline
    from diamond_tpu_torch.utils import log

    masker, params = cpu_case.MASKER, td.scan_params(cpu_case.MASKER)
    recs = gen.make_proteins(15_000, 3_750, seed=29, size_seed=2500)
    blk = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
    edge = cpu_case._padded(cpu_case.CASES["mixed"], np.random.default_rng(5),
                            high_bits=True)
    for letters, starts, lens in ((blk.letters, blk.starts,
                                   blk.lengths.astype(np.int64)), edge):
        want = cpu_case._native(letters, starts, lens)
        ref = letters.copy()
        np.copyto(ref, 23, where=want >= masker.p_mask)
        x = torch.from_numpy(letters).cuda()
        st, ln = torch.from_numpy(starts).cuda(), torch.from_numpy(lens).cuda()
        probs = torch.full(x.shape, -1.0, device="cuda")
        launches = td.tantan_mask.launches
        td.tantan_mask(x, st, ln, params, probs=probs)
        torch.cuda.synchronize()
        assert td.tantan_mask.launches == launches + 1
        got = probs.cpu().numpy()
        inside = np.zeros(len(letters), bool)
        for s0, n in zip(starts, lens):
            inside[s0:s0 + n] = True
        assert np.array_equal(got.view(np.int32)[inside],
                              want.view(np.int32)[inside])
        assert (got[~inside] == -1.0).all()  # written inside only
        assert np.array_equal(x.cpu().numpy(), ref)
        plain = td.tantan_prob_torch(torch.from_numpy(letters).cuda(), st, ln,
                                     params).cpu().numpy()
        assert np.array_equal(plain.view(np.int32), want.view(np.int32))

    monkeypatch.delenv("DIAMOND_TPU_TORCH_DEVICE", raising=False)
    was = log.enabled()
    log.enable(True)
    try:
        card = Block.from_sequences([s for _, s in recs[:2000]],
                                    [i for i, _ in recs[:2000]])
        host_letters = card.letters.copy()
        p = cpu_case._native(host_letters, card.starts, card.lengths)
        np.copyto(host_letters, 23, where=p >= masker.p_mask)
        n = int(card.lengths.sum())
        c0 = log.prof_calls["mask.card_letters"]
        h0 = log.prof_calls["mask.host_letters"]
        launches = td.tantan_mask.launches
        pipeline.mask_block(card, masker)
        spans = log.spans(prefix="")
    finally:
        log.enable(was)
    assert np.array_equal(card.letters, host_letters)
    assert td.tantan_mask.launches == launches + 1
    assert log.prof_calls["mask.card_letters"] - c0 == n
    assert log.prof_calls["mask.host_letters"] == h0
    outer = [s for s in spans if s.label == "mask.block"][-1]
    inner = [s for s in spans if s.label == "kernel.mask"][-1]
    assert inner.parent == outer.id
    assert inner.fields == dict(letters=n, sequences=len(card),
                                longest=int(card.lengths.max()), states=50)


@pytest.mark.gpu
def test_seed_enum_kernel_matches_native_on_gpu():
    """The query-indexed route's DB-side seed enumeration on the card
    (csrc/seed_enum.cu) against the port's native fused pass (diamond_tpu
    does not run on a card host; tests/test_torch_seed_enum_device.py holds
    this pass, the plain version and diamond_tpu's sliced route equal to
    diamond_tpu's native fused pass on the CPU, on these edge cases) on the
    benchmark's block (15,000 proteins of the frozen generator, ~5.8 M
    letters) with the keys of 20 and of 1,000 queries, both default shapes, the letters
    uploaded once: the same keys and positions in the same order, one
    launch a shape, a kernel.seed_t span with its work; then the CPU
    tests' edge cases (lengths around the span, empty sequences, MASK,
    STOP and high-bit bytes, motif ranges, duplicate keys, no keys, a
    delimiter on a 0 of the shape) against the native pass and the plain
    version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, os.path.join(REPO, "perfbench"))
    try:
        import gen
        import test_torch_seed_enum_device as cpu_case
    finally:
        sys.path.remove(os.path.join(REPO, "perfbench"))
        sys.path.remove(os.path.join(REPO, "tests"))
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.ops import seed_enum_device as sed
    from diamond_tpu_torch.seed.shapes import Shape
    from diamond_tpu_torch.search import stages
    from diamond_tpu_torch.utils import log

    RED = cpu_case.RED
    recs = gen.make_proteins(15_000, 3_750, seed=29, size_seed=2500)
    blk = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
    lens = blk.lengths.astype(np.int64)
    u0 = sed.upload_block.uploads
    card = sed.upload_block(blk.letters, blk.starts, lens,
                            sed.reduce_table(RED), RED.size, "cuda")
    was = log.enabled()
    log.enable(True)
    try:
        for n_q in (20, 1000):
            qb = Block.from_sequences([s for _, s in recs[:n_q]],
                                      [i for i, _ in recs[:n_q]])
            for code in cpu_case.SHAPES[:2]:
                shape = Shape(code)
                qs = stages.enumerate_seeds(qb, shape, RED)[0]
                want = cpu_case._port_native(blk.letters, blk.starts, lens,
                                        shape, qs)
                launches = sed.enumerate_filtered.launches
                got = sed.enumerate_block(card, shape.positions,
                                          shape.length, qs)
                assert sed.enumerate_filtered.launches == launches + 1
                assert len(want[0]) > 1000
                assert np.array_equal(got[0], want[0])
                assert np.array_equal(got[1], want[1])
                span = log.spans(prefix="kernel.seed_t")[-1]
                assert span.fields == dict(
                    positions=card.windows(shape.length), q_keys=len(qs),
                    survivors=len(want[0]), weight=shape.weight)
                assert span.ms() > 0
    finally:
        log.enable(was)
    assert sed.upload_block.uploads == u0 + 1

    edge = dict(cpu_case.CASES)
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 20, 30).astype(np.int8) for _ in range(2))
    edge["delimiter"] = cpu_case._layout([a, b], rng, gaps=(1, 2))
    for name, (letters, starts, lens) in sorted(edge.items()):
        for code in cpu_case.SHAPES:
            shape = Shape(code)
            for kind in ("sorted", "unsorted", "empty"):
                qs = cpu_case._queries(letters, starts, lens, shape,
                                       np.random.default_rng(len(name)), kind)
                if name == "delimiter":  # every window's key, straddling too
                    reduced = RED(letters)
                    qs = np.zeros(len(letters) - shape.length, np.uint64)
                    for c in shape.positions:
                        qs = qs * np.uint64(RED.size) + np.clip(
                            reduced[c:c + len(qs)], 0, RED.size - 1).astype(
                                np.uint64)
                want = cpu_case._port_native(letters, starts, lens, shape, qs)
                x = [torch.from_numpy(v).cuda() for v in (
                    letters, sed.reduce_table(RED), starts, lens,
                    shape.positions.astype(np.int32),
                    np.asarray(qs, np.uint64).view(np.int64))]
                args = (*x[:5], shape.length, RED.size, x[5])
                got = sed.enumerate_filtered(*args)
                plain = sed.enumerate_filtered_torch(*args)
                for k, p in (got, plain):
                    assert np.array_equal(k.cpu().numpy().view(np.uint64),
                                          want[0]), (name, code, kind)
                    assert np.array_equal(p.cpu().numpy(), want[1])


@pytest.mark.gpu
def test_blastp_through_the_seed_kernel_on_gpu(tmp_path, monkeypatch):
    """A query-indexed blastp on the card enumerates the DB's seeds through
    the kernel (one upload, one launch a shape, the DB's positions in
    seed.card_positions, kernel.seed_t inside seed.enumerate_t) and prints
    the bytes it prints with the native pass in the kernel's place (the
    rest of the search on the card alike)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chip_smoke = _smoke()
    from diamond_tpu_torch.cli import main
    from diamond_tpu_torch.ops import seed_enum_device as sed
    from diamond_tpu_torch.search import pipeline
    from diamond_tpu_torch.utils import log

    monkeypatch.delenv("DIAMOND_TPU_TORCH_DEVICE", raising=False)
    recs = chip_smoke.make_proteins(n_seqs=3000, n_families=750, seed=7)
    chip_smoke.write_fasta(tmp_path / "db.faa", recs)
    chip_smoke.write_fasta(tmp_path / "q.faa", recs[:40])
    args = ["blastp", "-q", str(tmp_path / "q.faa"), "-d",
            str(tmp_path / "db.faa"), "-f", "6"]
    host_pass = pipeline.Pipeline._enumerate_t_qindex

    def native_pass(self, shape, q_keys, table, dev):
        with monkeypatch.context() as m:  # the route's device: the CPU
            m.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
            return host_pass(self, shape, q_keys)

    lens = np.array([len(s) for _, s in recs], np.int64)
    windows = sum(int(np.maximum(lens - len(c) + 1, 0).sum())
                  for c in ("111101110111", "111011010010111"))
    outs = {}
    was = log.enabled()
    log.enable(True)
    try:
        for route in ("card", "host"):
            if route == "host":
                monkeypatch.setattr(pipeline.Pipeline, "_enumerate_t_card",
                                    native_pass)
            c0 = log.prof_calls["seed.card_positions"]
            h0 = log.prof_calls["seed.host_positions"]
            u0 = sed.upload_block.uploads
            l0 = sed.enumerate_filtered.launches
            assert main(args + ["-o", str(tmp_path / route)]) == 0
            outs[route] = (tmp_path / route).read_bytes()
            on_card = route == "card"
            assert sed.upload_block.uploads - u0 == on_card
            assert sed.enumerate_filtered.launches - l0 == 2 * on_card
            assert log.prof_calls["seed.card_positions"] - c0 == \
                windows * on_card
            assert log.prof_calls["seed.host_positions"] - h0 == \
                windows * (not on_card)
            if on_card:
                spans = log.spans(prefix="")
                by_id = {s.id: s for s in spans}
                inner = [s for s in spans if s.label == "kernel.seed_t"][-2:]
                assert len(inner) == 2 and all(
                    by_id[s.parent].label == "seed.enumerate_t"
                    for s in inner)
    finally:
        log.enable(was)
    assert outs["card"] and outs["card"] == outs["host"]
