"""The port's full-matrix sweep kernel (plain PyTorch version on the CPU) and
its FullSweep scheduler against diamond_tpu: the Pallas kernel
``full_swipe_pallas_sweep`` in interpret mode and the host DP oracle
``banded_swipe_batch_np`` with the full band [-(tlen-1), qlen).  Tolerance:
exact int32 equality (the DP is integer arithmetic).

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

import jax.numpy as jnp  # noqa: E402
from diamond_tpu.ops.banded_swipe import banded_swipe_batch_np  # noqa: E402
from diamond_tpu.ops.swipe_device import full_swipe_pallas_sweep  # noqa: E402
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.data.block import Block  # noqa: E402
from diamond_tpu_torch.ops import swipe_device as sd  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def blosum():
    return ScoreMatrix("BLOSUM62")


def _related(rng, n, lo, hi, seeds=()):
    """n sequences of length [lo, hi), each with a stretch of a seed
    sequence planted, so most pairs score above random."""
    out = []
    for _ in range(n):
        s = rng.integers(0, 20, int(rng.integers(lo, hi))).astype(np.int8)
        if len(seeds):
            src = seeds[int(rng.integers(len(seeds)))]
            k = min(len(s), len(src), 30)
            a, b = int(rng.integers(len(s) - k + 1)), int(rng.integers(len(src) - k + 1))
            s[a:a + k] = src[b:b + k]
        out.append(s)
    return out


def _oracle(q, bias, targets, m):
    jobs = [(t, -(len(t) - 1), len(q)) for t in targets]
    return [r[0] for r in banded_swipe_batch_np(q, bias, jobs, m.matrix32,
                                                m.gap_open, m.gap_extend)]


def _pallas_batch(rng, Q, T, tile_b, G, NQ, with_bias):
    """One full_swipe_pallas_sweep call's inputs: G tiles (the last one
    dead, bound 0) of tile_b targets of up to T letters, NQ queries of up
    to Q rows (the last one longer than half of Q)."""
    queries = _related(rng, NQ, 10, Q)
    queries[-1] = rng.integers(0, 20, Q - 3).astype(np.int8)
    targets = _related(rng, (G - 1) * tile_b, 5, T, queries)
    t_idx = np.full((G * tile_b, T), 31, np.int8)
    bounds = np.zeros(G, np.int32)
    for x, t in enumerate(targets):
        t_idx[x, :len(t)] = t
        bounds[x // tile_b] = max(bounds[x // tile_b], len(t))
    t2 = np.ascontiguousarray(
        t_idx.reshape(G, tile_b, T).swapaxes(1, 2)).reshape(G * T, tile_b)
    q_let = np.zeros((NQ, Q), np.int8)
    q_bias = np.zeros((NQ, Q), np.int8)
    q_valid = np.zeros((NQ, Q), np.int8)
    biases = []
    for r, q in enumerate(queries):
        q_let[r, :len(q)] = q
        q_valid[r, :len(q)] = 1
        b = rng.integers(-4, 5, len(q)).astype(np.int8) if with_bias else None
        if b is not None:
            q_bias[r, :len(q)] = b
        biases.append(b)
    arrays = (bounds, t2, q_let.reshape(-1), q_bias.reshape(-1),
              q_valid.reshape(-1))
    return arrays, queries, biases, targets


@pytest.mark.parametrize("Q,with_bias", [(128, False), (256, True)])
def test_plain_matches_pallas_interpret_and_oracle(Q, with_bias, blosum):
    """Two Q classes, bias and no bias, a dead tile: the plain version on
    from_pallas_full_sweep's inputs equals the Pallas kernel's [NQ,
    G*tile_b] matrix, and each real pair equals the host DP oracle."""
    rng = np.random.default_rng(Q)
    T, tile_b, G, NQ = 96, 8, 3, 3
    go, ge = blosum.gap_open + blosum.gap_extend, blosum.gap_extend
    arrays, queries, biases, targets = _pallas_batch(rng, Q, T, tile_b, G,
                                                     NQ, with_bias)
    want = np.asarray(full_swipe_pallas_sweep.__wrapped__(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(blosum.matrix32),
        go, ge, Q, T, tile_b, True))
    packed, launches = sd.from_pallas_full_sweep(*arrays, Q, T, tile_b)
    x = {k: torch.from_numpy(v) for k, v in packed.items()}
    m32 = torch.from_numpy(np.ascontiguousarray(blosum.matrix32, np.int32))
    out = torch.zeros(NQ, G * tile_b, dtype=torch.int32)
    scratch = torch.empty(0, 2, len(packed["t_cat"]), 2, dtype=torch.int32)
    for R, pairs in launches:
        sd.full_swipe(x["t_cat"], x["targets"], x["q_cat"], x["bias_cat"],
                      x["reqs"], torch.from_numpy(pairs), m32, go, ge, R,
                      scratch, out)
    np.testing.assert_array_equal(out.numpy(), want)
    assert (want[:, (G - 1) * tile_b:] == 0).all()  # the dead tile
    assert (want > 0).mean() > 0.5
    for r, (q, b) in enumerate(zip(queries, biases)):
        assert want[r, :len(targets)].tolist() == _oracle(q, b, targets, blosum)


def test_fullsweep_matches_oracle(blosum, monkeypatch):
    """FullSweep on the CPU over a block: several rows-per-lane classes,
    queries of several strips (above the 512-row strip), bias on every
    other query; grouping by pair count and by scratch slots changes
    nothing."""
    rng = np.random.default_rng(3)
    qs = _related(rng, 5, 20, 400) + [
        rng.integers(0, 20, n).astype(np.int8) for n in (25, 530, 1100)]
    seqs = _related(rng, 24, 5, 300, qs) + [rng.integers(0, 20, 700).astype(np.int8)]
    tb = Block.from_sequences(seqs, [f"t{i}" for i in range(len(seqs))])
    t_order = np.array([i for i in range(len(seqs)) if i != 3])
    queries = [(q, rng.integers(-4, 5, len(q)).astype(np.int8) if k % 2 else None)
               for k, q in enumerate(qs)] + [(np.zeros(0, np.int8), None)]
    sweep = sd.FullSweep(blosum.matrix32, blosum.gap_open, blosum.gap_extend,
                         device="cpu")
    b = sweep.pack(queries, tb, t_order)
    assert {L.R for L in b.launches} >= {1, 9, 12}  # 1100 = 3 strips x 12 x 32
    assert sum(L.slots for L in b.launches) == 2
    sd.reset_dispatch_stats()
    S = sweep.run_block(queries, tb, t_order)
    assert S.shape == (len(queries), len(t_order))
    assert sd.dispatch_count == len(b.launches)
    targets = [tb.seq(int(t)) for t in t_order]
    for r, (q, bias) in enumerate(queries[:-1]):
        assert S[r].tolist() == _oracle(q, bias, targets, blosum), r
    assert not S[-1].any()
    monkeypatch.setattr(sd, "MAX_SWEEP_PAIRS", 30)
    monkeypatch.setattr(sd.FullSweep, "SCRATCH_BYTES", 1)
    b2 = sweep.pack(queries, tb, t_order)
    assert len(b2.launches) > len(b.launches)
    assert max(L.slots for L in b2.launches) == 1
    np.testing.assert_array_equal(sweep.run_block(queries, tb, t_order), S)


def test_sweep_shape():
    assert [sd.sweep_shape(n) for n in (1, 32, 33, 300, 512, 513, 1100, 8192)] \
        == [(1, 1), (1, 1), (2, 1), (10, 1), (16, 1), (9, 2), (12, 3),
            (16, 16)]


def test_plain_rejects_bad_inputs():
    z8 = torch.zeros(4, dtype=torch.int8)
    targets = torch.zeros(1, 2, dtype=torch.int32)
    reqs = torch.zeros(1, 3, dtype=torch.int32)
    pairs = torch.zeros(1, 2, dtype=torch.int32)
    m = torch.zeros(32, 32, dtype=torch.int32)
    scratch = torch.empty(0, 2, 4, 2, dtype=torch.int32)
    out = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(TypeError):
        sd.full_swipe(z8.int(), targets, z8, z8, reqs, pairs, m, 12, 1, 1,
                      scratch, out)
    with pytest.raises(ValueError):
        sd.full_swipe(z8, targets, z8, z8, reqs, pairs, m, 12, 1, 17,
                      scratch, out)
    with pytest.raises(ValueError):
        sd.full_swipe(z8, targets, z8, z8, reqs, pairs, m, 12, 1, 1,
                      torch.empty(0, 2, 3, 2, dtype=torch.int32), out)
    assert sd.full_swipe.launches == 0
