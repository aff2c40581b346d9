"""``--mesh``: the port's database-sharded scoring (parallel/sharded.py,
``DeviceDP(mesh=...)``) against diamond_tpu's on its 8 virtual CPU devices
(tests/conftest.py) and the host DP oracle, and both CLIs with ``--mesh 4``
byte for byte.  CPU shards run the kernels' plain versions (K4's for the
full-matrix scores, K1's in DeviceDP); scores are int32 and must be equal.
"""
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

from diamond_tpu.data.block import Block as RefBlock  # noqa: E402
from diamond_tpu.parallel import sharded as ref_sharded  # noqa: E402
from diamond_tpu_torch.data.block import Block  # noqa: E402
from diamond_tpu_torch.ops import swipe_device as sd  # noqa: E402
from diamond_tpu_torch.ops import swipe_uniform  # noqa: E402
from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np  # noqa: E402
from diamond_tpu_torch.parallel import sharded  # noqa: E402
from diamond_tpu_torch.stats.score_matrix import ScoreMatrix  # noqa: E402
from torch_cli import PORT, REPO, run_cli  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REF = "diamond_tpu"


def _proteins(n, seed, max_len=400):
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import make_proteins
    finally:
        sys.path.remove(REPO)
    recs = make_proteins(n_seqs=4 * n, n_families=n, seed=seed)
    return [(i, s) for i, s in recs if len(s) <= max_len][:n]


@pytest.fixture(scope="module")
def blosum():
    return ScoreMatrix("BLOSUM62")


def _oracle(q, tblock, m):
    jobs = [(tblock.seq(t), -(len(tblock.seq(t)) - 1), len(q))
            for t in range(len(tblock))]
    return np.array([s for s, _, _ in banded_swipe_batch_np(
        q, None, jobs, m.matrix32, m.gap_open, m.gap_extend)])


def test_make_mesh_cpu_and_card_count():
    mesh = sharded.make_mesh(8, platform="cpu")
    assert len(mesh) == 8 and not mesh.ranked
    assert mesh.local() == list(range(8))
    assert all(d.type == "cpu" for d in mesh)


@pytest.mark.parametrize("n_shards", [8, 3])
def test_sharded_full_scores_match_reference_and_oracle(blosum, n_shards):
    recs = _proteins(37, seed=3)  # odd count: the shards need padding
    ids, seqs = [i for i, _ in recs], [s for _, s in recs]
    tblock = Block.from_sequences(seqs, ids)
    q = tblock.seq(0)
    m = blosum
    got = sharded.sharded_full_scores(
        sharded.make_mesh(n_shards, platform="cpu"), q, None, tblock,
        m.matrix32, m.gap_open, m.gap_extend)
    rmesh = ref_sharded.make_mesh(platform="cpu")
    assert rmesh.devices.size == 8
    want = ref_sharded.sharded_full_scores(
        rmesh, q, None, RefBlock.from_sequences(seqs, ids), m.matrix32,
        m.gap_open, m.gap_extend)
    assert got.shape == (37,)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, _oracle(q, tblock, m))


def test_sharded_full_scores_wide_bands_take_the_host(blosum, monkeypatch):
    """Jobs whose band exceeds the kernel's cap take the host DP (the cap
    lowered here so that a test-sized set has such jobs)."""
    recs = _proteins(11, seed=4)
    tblock = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
    q = tblock.seq(2)
    monkeypatch.setattr(swipe_uniform, "MAX_UNIFORM_BAND", 256)
    m = blosum
    got = sharded.sharded_full_scores(sharded.make_mesh(4, platform="cpu"),
                                      q, None, tblock, m.matrix32,
                                      m.gap_open, m.gap_extend)
    assert any(len(q) + len(s) - 1 > 256 for _, s in recs)
    assert np.array_equal(got, _oracle(q, tblock, m))


def test_sharded_swipe_topk_matches_reference(blosum):
    from diamond_tpu.ops.swipe_jax import prepare_uniform_batch

    rng = np.random.default_rng(8)
    q = rng.integers(0, 20, 90).astype(np.int8)
    targets = []
    for k in range(40):
        t = rng.integers(0, 20, int(rng.integers(30, 150))).astype(np.int8)
        if k % 3 == 0:
            t[5:35] = q[10:40]
        targets.append(t)
    targets[3] = np.concatenate([targets[3][:5], q[5:85], targets[3][5:]])
    targets[17] = targets[3].copy()  # equal best scores: the tie order
    targets[38] = targets[3].copy()  # of the merge counts
    jobs = [(t, -(len(t) - 1), len(q)) for t in targets]
    t1h, bmask, ppad, band, _ = prepare_uniform_batch(q, None,
                                                      blosum.matrix32, jobs)
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    want = ref_sharded.sharded_swipe_topk(ref_sharded.make_mesh(
        platform="cpu"), t1h, bmask, ppad, go, ge, band, k=7)
    args = (np.asarray(t1h), np.asarray(bmask), np.asarray(ppad), go, ge,
            band)
    for n_shards in (8, 4):
        got = sharded.sharded_swipe_topk(
            sharded.make_mesh(n_shards, platform="cpu"), *args, k=7)
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1], np.asarray(want[1]))
    assert list(got[1][:3]) == [3, 17, 38]


def test_devicedp_mesh_equals_unsharded(blosum):
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import dp_requests
    finally:
        sys.path.remove(REPO)
    reqs = [(q[:300], None if b is None else b[:300],
             [(t[:300], d0, d1) for t, d0, d1 in jobs if d0 < 300])
            for q, b, jobs in dp_requests(seed=2, n_queries=4)]
    m = blosum
    one = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend, device="cpu")
    want = one.run_many(reqs)
    for n_shards in (4, 50):  # 50: more shards than some classes have jobs
        sd.reset_dispatch_stats()
        dp = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend,
                         mesh=sharded.make_mesh(n_shards, platform="cpu"))
        assert dp.run_many(reqs) == want
        assert sd.dispatch_count >= min(n_shards, 16)


@pytest.mark.parametrize("name,args,env", [
    ("blastp", ["blastp", "-q", "q.faa", "-d", "db.faa"], {}),
    ("blastp-swipe", ["blastp", "-q", "q5.faa", "-d", "db.faa", "--swipe"],
     {"host": True}),
    ("blastx-swipe", ["blastx", "-q", "reads.fna", "-d", "db.faa",
                      "--swipe"], {}),
])
def test_cli_mesh_matches_reference_and_no_mesh(tmp_path, name, args, env):
    """--mesh 4 in both packages and the port without --mesh write the
    same bytes (device DP off in both for blastp --swipe, so the mesh
    scores every query; in blastx --swipe it scores the frames but 0)."""
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import make_reads, write_fasta
    finally:
        sys.path.remove(REPO)
    recs = _proteins(30, seed=5, max_len=450)
    write_fasta(tmp_path / "db.faa", recs)
    write_fasta(tmp_path / "q.faa", recs[:12])
    write_fasta(tmp_path / "q5.faa", recs[:5])
    write_fasta(tmp_path / "reads.fna", make_reads(recs, 3, 200, 400,
                                                   seed=6))
    extra = {"DIAMOND_TPU_TORCH_DEVICE_DP": "0"} if env.get("host") else {}
    mesh = args + ["--mesh", "4"]
    _, ref, _, _ = run_cli(REF, mesh, tmp_path)
    _, port, _, n = run_cli(PORT, mesh, tmp_path, extra_env=extra)
    _, plain, _, _ = run_cli(PORT, args, tmp_path, extra_env=extra)
    assert ref.strip()
    assert port == ref
    assert plain == ref
    if name == "blastp":
        assert n > 0  # the sharded DeviceDP launched on its CPU shards
