"""The port's stage-1/2 seeding on the device (``ops/stage12_device``: D1's
plain PyTorch version, the CPU side of ``stage12_pairs``, and the
``Stage12Device`` batcher) against diamond_tpu's ``Stage12Device`` (the jitted
``_stage12_kernel`` and the one-hot product, on the CPU) and the fused native
pass's stage-1 and stage-2 functions.  Tolerance: exact integer equality, on
every pair (best included where stage 1 fails).

The whole fused pass (``stage12_join``'s plain version, ``join_rows``, the
card route of the search) against the native ``stage12_pipeline`` of both
packages on seeded joins, ``left_most_torch`` against the numpy oracle of
``left_most_filter_batch``, one block's ``_stage12`` rows against
diamond_tpu's Pipeline with ``DIAMOND_TPU_STAGE12=1``, and ``blastp`` with
``DIAMOND_TPU_TORCH_STAGE12=1`` against diamond_tpu's CLI; rows equal, row
for row.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

from diamond_tpu import native as ref_native  # noqa: E402
from diamond_tpu_torch import native as port_native  # noqa: E402
from diamond_tpu.ops import stage12_jax as jst  # noqa: E402
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.ops import stage12_device as d1  # noqa: E402
from diamond_tpu_torch.search.stages import SeedJoin  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


M = ScoreMatrix("BLOSUM62")


def _tensors(q, s, qp, sp, win, cut):
    return ([torch.from_numpy(np.ascontiguousarray(a, dtype=np.int8))
             for a in (q, s)]
            + [torch.from_numpy(np.ascontiguousarray(M.matrix32[:32, :32],
                                                     dtype=np.int32))]
            + [torch.from_numpy(np.asarray(a, dtype=np.int32))
               for a in (qp, sp, win, cut)])


@pytest.mark.parametrize("k", range(len(_smoke().STAGE12_EDGES)))
def test_stage12_plain_matches_reference_on_every_pair(k):
    """chip_smoke's D1 edge batch k (delimiters sprinkled and at or around
    the seed, masked letters with high bits, windows 1 to 48, cutoffs 0 to
    59, hamming_id 0 to 49): keep and best of the wrapper on CPU tensors
    (the plain version) and of Stage12Device.run on the CPU == diamond_tpu's
    Stage12Device.run on every pair; no kernel launch."""
    label, (q, s, qp, sp, win, cut), hid = _smoke().stage12_edge_cases(7)[k]
    keep_r, best_r = jst.Stage12Device(M.matrix32).run(q, s, qp, sp, win,
                                                       cut, hid)
    launches = d1.stage12_pairs.launches
    keep_p, best_p = d1.stage12_pairs(*_tensors(q, s, qp, sp, win, cut), hid)
    np.testing.assert_array_equal(keep_p.numpy(), keep_r, err_msg=label)
    np.testing.assert_array_equal(best_p.numpy(), best_r, err_msg=label)
    dev = d1.Stage12Device(M.matrix32, device="cpu", chunk=997)
    keep_d, best_d = dev.run(q, s, qp, sp, win, cut, hid)
    np.testing.assert_array_equal(keep_d, keep_r, err_msg=label)
    np.testing.assert_array_equal(best_d, best_r, err_msg=label)
    assert d1.stage12_pairs.launches == launches  # CPU: the plain version
    if len(qp) > 1000 and hid < 48:
        assert keep_r.any() and not keep_r.all()


def test_stage12_clip_reads_raw_bytes_and_window_edges():
    """Hand-made pairs: a delimiter at qp (wr = 0), at qp - 1 (wl = 0), a
    masked delimiter (31 | 128: no clip, yet & 31 scores as 31) and a
    delimiter just outside the window (no clip): best equals the
    reference's on each, and each case scores what its clip implies."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 1000).astype(np.int8)
    q[:100] = q[-100:] = 31
    qp = np.array([200, 300, 400, 500, 450], np.int64)
    win = np.array([48, 48, 48, 10, 1], np.int64)
    q[200] = 31                  # at qp: the walk is [-wl, 0)
    q[299] = 31                  # at qp - 1: the walk starts at the seed
    q[405] = np.int8(31 | -128)  # raw byte != 31: no clip
    q[490] = 31                  # at qp - w: outside the clip's reach
    cut = np.zeros(5, np.int32)
    want = jst.Stage12Device(M.matrix32).run(q, q, qp, qp, win, cut, 0)
    got = d1.stage12_pairs(*_tensors(q, q, qp, qp, win, cut), 0)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    diag = M.matrix32[q & 31, q & 31].astype(np.int64)

    def walk(lo, hi):
        st = best = 0
        for v in diag[lo:hi]:
            st = min(max(st + v, 0), 255)
            best = max(best, st)
        return best

    assert list(want[1]) == [walk(152, 200), walk(300, 348),
                             walk(400 - 48, 448), walk(490, 510),
                             walk(449, 451)]


def test_stage12_run_join_matches_reference(monkeypatch):
    """run_join with seed groups that straddle MATMUL_MIN_PAIRS (512) and
    tiles split on both sides, in products of at most 100 tiles (GROUP_TILES
    cut from 1024, so that the tiles split over three products; chip_smoke's
    stage12_join_case): keep and scores == diamond_tpu's run_join on every
    pair, keep == run's, and scores == run's wherever the product passed
    stage 1; one dispatch a product and one a kernel chunk."""
    letters, join, qp, sp, win, cut = _smoke().stage12_join_case(5)
    sizes = _smoke().STAGE12_JOIN_GROUPS
    ref = jst.Stage12Device(M.matrix32).run_join(letters, letters, join, qp,
                                                 sp, win, cut, 11)
    monkeypatch.setattr(d1, "GROUP_TILES", 100)
    d1.reset_dispatch_stats()
    dev = d1.Stage12Device(M.matrix32, device="cpu")
    got = dev.run_join(letters, letters, join, qp, sp, win, cut, 11)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    tiles = sum(-(-nq // d1.TILE_Q) * -(-ns // d1.TILE_S)
                for nq, ns in sizes if nq * ns >= d1.MATMUL_MIN_PAIRS)
    assert 2 * d1.GROUP_TILES < tiles < 3 * d1.GROUP_TILES
    assert d1.dispatch_count == -(-tiles // d1.GROUP_TILES) + 1
    assert 0 < d1.dispatch_pairs < len(qp)
    keep_all, best_all = dev.run(letters, letters, qp, sp, win, cut, 11)
    np.testing.assert_array_equal(got[0], keep_all)
    np.testing.assert_array_equal(got[1][got[0]], best_all[got[0]])
    assert got[0].any()


def test_stage12_matches_native_pass():
    """Stage12Device.run (CPU) == the native stage-1 filter and stage-2
    scores (fixed window 48, as the fused host pass): keep on every pair,
    scores on the kept ones (the native scorer does not saturate)."""
    from diamond_tpu_torch import native

    q, s, qp, sp, _, _ = _smoke().stage12_case(11, 5000)
    win = np.full(len(qp), 48, np.int64)
    cut = np.full(len(qp), 19, np.int32)
    keep, best = d1.Stage12Device(M.matrix32, device="cpu").run(
        q, s, qp, sp, win, cut, 11)
    for nat in (native, ref_native):
        k1 = nat.stage1_filter_native(q, s, qp, sp, 11)
        assert k1 is not None, "native library unavailable"
        sc = nat.stage2_scores_native(q, s, qp, sp, M.matrix32, 48, True)
        want = k1 & (sc > cut)
        np.testing.assert_array_equal(keep, want)
        np.testing.assert_array_equal(best[keep], np.minimum(sc, 255)[keep])
    assert keep.any() and not keep.all()


def test_stage12_refuses_reads_outside_the_blocks():
    """A window that would read past either end of a block raises, in run,
    run_join and the wrapper; one that just fits does not."""
    q, s, qp, sp, win, cut = _smoke().stage12_case(2, 64)
    dev = d1.Stage12Device(M.matrix32, device="cpu")
    for name, fix in (("qp", lambda a: a[0].__setitem__(0, 47)),
                      ("sp", lambda a: a[1].__setitem__(1, len(s) - 40))):
        a = [qp.copy(), sp.copy(), win.copy()]
        a[2][:2] = 48
        fix(a)
        with pytest.raises(ValueError, match="outside"):
            dev.run(q, s, a[0], a[1], a[2], cut, 11)
        with pytest.raises(ValueError, match="outside"):
            d1.stage12_pairs(*_tensors(q, s, a[0], a[1], a[2], cut), 11)
    a = [qp.copy(), sp.copy(), win.copy()]
    a[0][0], a[1][0], a[2][0] = 48, len(s) - 48, 48
    dev.run(q, s, a[0], a[1], a[2], cut, 11)
    join = SeedJoin(keys=np.zeros(1, np.uint64),
                    q_start=np.array([0, 1]), q_pos=np.array([10]),
                    s_start=np.array([0, 1]), s_pos=np.array([300]))
    with pytest.raises(ValueError, match="outside"):
        dev.run_join(q, s, join, np.array([10]), np.array([300]),
                     np.array([20]), np.array([5], np.int32), 11)


def test_stage12_block_cache_is_not_fooled_by_a_reused_id():
    """The cache keeps the array it copied, so a block made after another
    is freed never finds the freed one's tensor: results follow the
    letters passed."""
    q, s, qp, sp, win, cut = _smoke().stage12_case(4, 300)
    dev = d1.Stage12Device(M.matrix32, device="cpu")
    first = dev.run(q, s.copy(), qp, sp, win, cut, 11)
    for _ in range(3):  # new target arrays, each freed after its run
        s2 = np.where(s == 31, s, (s + 1) % 20).astype(np.int8)
        got = dev.run(q, s2, qp, sp, win, cut, 11)
        want = d1.Stage12Device(M.matrix32, device="cpu").run(
            q, s2, qp, sp, win, cut, 11)
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[1] != first[1]).any()
        del s2


def test_stage12_on_device_never_forks(monkeypatch):
    """A search configured for 4 threads with DIAMOND_TPU_TORCH_STAGE12 set
    forks no child (stage 1/2 and the extension stay in the parent: a
    forked child must not touch the device), dispatches to Stage12Device,
    and writes what the host route writes.  (The CLI's -p does not reach
    SearchConfig.threads in either package, so this drives Pipeline.)"""
    import multiprocessing

    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.output.tabular import format_results
    from diamond_tpu_torch.search import pipeline as pp
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix as PortMatrix

    recs = _smoke().make_proteins(n_seqs=200, n_families=50, seed=5)

    def search(threads):
        qb = Block.from_sequences([s for _, s in recs[:40]],
                                  [i for i, _ in recs[:40]])
        tb = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
        cfg = SearchConfig(matrix=PortMatrix("BLOSUM62"), threads=threads)
        res = pp.Pipeline(cfg, qb, tb).search()
        return list(format_results(res, qb, tb, matrix=cfg.matrix))

    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE_DP", "0")  # extension: host
    monkeypatch.delenv("DIAMOND_TPU_TORCH_STAGE12", raising=False)
    assert pp._can_fork()
    host = search(1)
    get_context = multiprocessing.get_context

    def no_fork(method=None):
        if method == "fork":
            raise RuntimeError("forked while stage 1/2 runs on the device")
        return get_context(method)

    monkeypatch.setattr(multiprocessing, "get_context", no_fork)
    monkeypatch.setenv("DIAMOND_TPU_TORCH_STAGE12", "1")
    assert not pp._can_fork()
    d1.reset_dispatch_stats()
    assert search(4) == host
    assert d1.dispatch_count > 0
    assert len(host) > 40


# -- the whole fused pass over a seed join (stage12_join) ----------------

FUSED = _smoke().STAGE12_FUSED_EDGES


@pytest.mark.parametrize("k", range(len(FUSED)), ids=[label for label, _ in FUSED])
def test_stage12_join_plain_matches_native_pass(k):
    """chip_smoke's seeded join k (self-search on and off, a chunked index
    with and without the part table, group_keep, the first shape and later
    ones, translated short-query windows, skip_lm, seeds beside
    delimiters): the wrapper on CPU tensors (the plain version) and
    Stage12Device.join_rows on the CPU, whole and in chunks of at most
    3,000 pairs, give the rows of the native stage12_pipeline of both
    packages, row for row; no kernel launch."""
    smoke = _smoke()
    label, kw = FUSED[k]
    c = smoke.stage12_fused_case(20 + k, **kw)
    want = smoke.stage12_native_rows(ref_native, c)
    np.testing.assert_array_equal(smoke.stage12_native_rows(port_native, c),
                                  want)
    launches = d1.stage12_join.launches
    for cap, calls in ((d1.JOIN_PAIR_CAP, 1), (3000, None)):
        d1.reset_dispatch_stats()
        got = smoke.stage12_fused_rows(
            d1.Stage12Device(M.matrix32, device="cpu"), c, cap=cap)
        np.testing.assert_array_equal(got, want, err_msg=label)
        assert d1.dispatch_count == calls if calls else d1.dispatch_count > 2
    # the wrapper itself, all groups in one call
    t = {n: torch.from_numpy(np.ascontiguousarray(getattr(c["join"], n)))
         for n in ("q_start", "q_pos", "s_start")}
    dev = d1.Stage12Device(M.matrix32, device="cpu")
    a = _join_args(dev, c)
    keep = c["group_keep"]
    rows = d1.stage12_join(
        torch.from_numpy(c["q_letters"]), torch.from_numpy(c["s_letters"]),
        torch.from_numpy(c["q_seed_mask"].view(np.uint8)), t["q_start"],
        t["q_pos"], t["s_start"],
        torch.from_numpy(c["join"].s_pos.astype(np.int32)),
        None if keep is None else torch.from_numpy(keep), 0,
        len(c["join"].keys), a)
    np.testing.assert_array_equal(rows.numpy(), want, err_msg=label)
    assert d1.stage12_join.launches == launches
    assert len(want)
    if kw.get("skip_lm"):
        return
    no_lm = dict(c, do_leftmost=False)  # the left-most filter drops rows
    assert len(smoke.stage12_native_rows(ref_native, no_lm)) > len(want)


def _join_args(dev, c):
    """The JoinArgs of case c as Stage12Device.join_rows builds them."""
    a = {}

    def grab(*args, **kw):
        a["args"] = args[10]
        return torch.empty((0, 4), dtype=torch.int32)

    real = d1.stage12_join
    d1.stage12_join = grab
    try:
        _smoke().stage12_fused_rows(dev, c)
    finally:
        d1.stage12_join = real
    return a["args"]


def test_left_most_torch_matches_numpy_oracle(monkeypatch):
    """left_most_torch against the numpy body of
    left_most_filter_batch (the native twin switched off), on the pairs of
    chip_smoke's seeded joins that pass stage 1: the first shape unchunked,
    a later shape, a chunked index with the part table and recomputing the
    partitions; every keep flag equal, and each case keeps some and drops
    some."""
    from diamond_tpu_torch import native
    from diamond_tpu_torch.search import left_most_batch as lmb
    from diamond_tpu_torch.search.stages import clip_window, expand_pairs

    monkeypatch.setattr(native, "left_most_filter_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(native, "leftmost_verify_native",
                        lambda *a, **k: None)
    smoke = _smoke()
    for seed, kw in ((1, dict(sid=0)), (2, dict(sid=5)),
                     (3, dict(sid=1, chunked=True)),
                     (4, dict(sid=0, chunked=True, table=False))):
        c = smoke.stage12_fused_case(seed, **kw)
        qp, sp = expand_pairs(c["join"])
        q, s = c["q_letters"], c["s_letters"]
        f = np.arange(-16, 32)
        ident = ((q[qp[:, None] + f] & 31) == (s[sp[:, None] + f] & 31)).sum(1)
        qp, sp = qp[ident >= c["hamming_id"]], sp[ident >= c["hamming_id"]]
        qidx = c["q_idx_tbl"][qp]
        qoff = qp - c["q_starts"][qidx]
        wl, wr = clip_window(q, qp, 48)
        want = lmb.left_most_filter_batch(
            q, s, c["q_seed_mask"], c["reduction"], qp, sp, qoff, wl, wr,
            c["shape"], 0 if c["first_shape"] else 1, c["chunked"],
            c["current"], c["previous"], c["part_lo"], c["part_hi"],
            c["seedp_mask"], c["hamming_id"])
        a = _join_args(d1.Stage12Device(M.matrix32, device="cpu"), c)
        if c["part_tbl"] is None:
            assert a.part_tbl is None
        tt = [torch.from_numpy(x) for x in (qp, sp, qoff, wl, wr)]
        got = d1.left_most_torch(
            torch.from_numpy(q), torch.from_numpy(s),
            torch.from_numpy(c["q_seed_mask"].view(np.uint8)), *tt, a)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
        assert want.any() and not want.all()


@pytest.mark.parametrize("sens,self_search", [("default", False),
                                              ("sensitive", False),
                                              ("default", True)])
def test_stage12_join_rows_match_reference_pipeline(sens, self_search,
                                                    monkeypatch):
    """One block pair through both packages' Pipelines on the CPU, stage 1/2
    on the device (DIAMOND_TPU_TORCH_STAGE12=1: the port's fused pass in its
    plain version; DIAMOND_TPU_STAGE12=1: diamond_tpu's jitted stage 1/2
    and host left-most): every _stage12 call (each shape, each index
    chunk) returns the same rows; the extension is skipped."""
    from diamond_tpu.data.block import Block as RefBlock
    from diamond_tpu.search import pipeline as rp
    from diamond_tpu.search.config import SearchConfig as RefConfig
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.search import pipeline as pp
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix as PortMatrix

    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DIAMOND_TPU_TORCH_STAGE12", "1")
    monkeypatch.setenv("DIAMOND_TPU_STAGE12", "1")
    recs = _smoke().make_proteins(n_seqs=160, n_families=40, seed=9)
    seqs, ids = [s for _, s in recs], [i for i, _ in recs]
    out = {}
    for name, mod, blk, cfg in (
            ("port", pp, Block, SearchConfig(matrix=PortMatrix("BLOSUM62"),
                                             sensitivity=sens,
                                             self_search=self_search)),
            ("ref", rp, RefBlock, RefConfig(matrix=M, sensitivity=sens,
                                            self_search=self_search))):
        calls = []
        real = mod.Pipeline._stage12

        def spy(self, *a, _real=real, _calls=calls, **kw):
            rows = _real(self, *a, **kw)
            _calls.append(np.asarray(rows).copy())
            return rows

        monkeypatch.setattr(mod.Pipeline, "_stage12", spy)
        monkeypatch.setattr(mod.Pipeline, "_extend_all", lambda self, h: {})
        mod.Pipeline(cfg, blk.from_sequences(seqs[:60], ids[:60]),
                     blk.from_sequences(seqs, ids)).search()
        out[name] = calls
    assert len(out["port"]) == len(out["ref"]) >= 4  # shapes x index chunks
    for got, want in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(got, want)
    assert sum(len(r) for r in out["port"]) > 60


def test_stage12_route_caches_no_shape_table():
    """The fused route sends a shape's own tables (its positions, its
    partition table) with each call and caches none of them: over a
    --sensitive search (16 shapes, a chunked index with partition tables)
    the bytes Stage12Device keeps stay those of its first call."""
    calls = _smoke().stage12_route_memory("cpu")
    assert len(calls) >= 16 and any(c["part_tbl"] for c in calls)
    assert {c["cached"] for c in calls} == {calls[0]["cached"]}


@pytest.mark.parametrize("extra", [(), ("--sensitive",)],
                         ids=["default", "sensitive"])
def test_blastp_fused_route_matches_reference_cli(extra, tmp_path):
    """blastp of j2.faa against q2.faa + j2.faa with DIAMOND_TPU_TORCH_STAGE12=1
    (the port on the CPU: the fused pass's plain version through
    Stage12Device.join_rows) writes diamond_tpu.cli's bytes (its default,
    host stage 1/2), at default settings and with --sensitive (16 shapes);
    the run went through join_rows and never through run_join."""
    import subprocess

    gold = os.path.join(REPO, "tests", "goldens")
    db = tmp_path / "q2j2.faa"
    db.write_text("".join(open(os.path.join(gold, n)).read()
                          for n in ("q2.faa", "j2.faa")))
    args = ["blastp", "-q", os.path.join(gold, "j2.faa"), "-d", str(db),
            "-f", "6", "-o", "out.tsv", *extra]
    launch = (
        "import sys\n"
        "from diamond_tpu_torch.ops import stage12_device as d1\n"
        "calls = {'join_rows': 0, 'run_join': 0}\n"
        "def count(name):\n"
        "    real = getattr(d1.Stage12Device, name)\n"
        "    def w(*a, **k):\n"
        "        calls[name] += 1\n"
        "        return real(*a, **k)\n"
        "    setattr(d1.Stage12Device, name, w)\n"
        "count('join_rows'); count('run_join')\n"
        "from diamond_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "print(f'CALLS={calls}', file=sys.stderr)\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO, DIAMOND_TPU_TORCH_DEVICE="cpu",
               DIAMOND_TPU_TORCH_STAGE12="1", OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("DIAMOND_TPU_STAGE12", None)
    runs = {}
    for name, cmd in (("port", [sys.executable, "-c", launch, *args]),
                      ("ref", [sys.executable, "-m", "diamond_tpu.cli",
                               *args])):
        d = tmp_path / name
        d.mkdir()
        r = subprocess.run(cmd, capture_output=True, env=env, cwd=str(d),
                           timeout=600)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        runs[name] = ((d / "out.tsv").read_bytes(), r.stderr.decode())
    assert runs["port"][0] == runs["ref"][0]
    assert runs["port"][0].strip()
    calls = runs["port"][1].rsplit("CALLS=", 1)[1].split("}")[0]
    assert "'run_join': 0" in calls and "'join_rows': 0" not in calls


def test_stage12_join_refuses_reads_outside_the_blocks():
    """join_rows refuses a seed within MARGIN letters of either block end,
    a stage-2 window above MAX_JOIN_WINDOW and a negative cutoff."""
    smoke = _smoke()
    c = smoke.stage12_fused_case(3, big=False)
    dev = d1.Stage12Device(M.matrix32, device="cpu")
    j = c["join"]
    for arr, at in ((j.q_pos, d1.MARGIN - 1),
                    (j.s_pos, len(c["s_letters"]) - d1.MARGIN + 1)):
        saved = arr[0]
        arr[0] = at
        with pytest.raises(ValueError, match="read outside"):
            smoke.stage12_fused_rows(dev, c)
        arr[0] = saved
    with pytest.raises(ValueError, match="windows of at most"):
        smoke.stage12_fused_rows(dev, dict(c, win=c["win"] + 100))
    cut = c["cut"].copy()
    cut[0] = -1
    with pytest.raises(ValueError, match="negative"):
        smoke.stage12_fused_rows(dev, dict(c, cut=cut))
    assert len(smoke.stage12_fused_rows(dev, c))
