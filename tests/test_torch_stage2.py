"""The port's seeding filters against diamond_tpu: the stage-2 kernel's plain
PyTorch version (the CPU side of ``stage2_filter``) against the Pallas
kernel ``stage2_pallas`` in interpret mode and the numpy oracle of
tests/test_stage2_pallas.py, and the stage-1 one-hot product against
``_stage1_matmul_kernel``.  Tolerance: exact integer equality.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side (absent on a card host)

import jax.numpy as jnp  # noqa: E402

from diamond_tpu.ops import stage2_pallas as jst  # noqa: E402
from diamond_tpu.ops.stage12_jax import _stage1_matmul_kernel  # noqa: E402
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.ops import stage2_device as s2  # noqa: E402
from diamond_tpu_torch.ops.stage12 import TILE_Q, TILE_S, stage1_matmul  # noqa: E402
from test_stage2_pallas import _letters, _oracle  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _pairs(seed, N=700):
    """The seeded case of tests/test_stage2_pallas.py: letter streams with
    delimiters, a third of the pairs locally identical."""
    rng = np.random.default_rng(seed)
    q_letters = _letters(rng, 2000)
    s_letters = _letters(rng, 3000)
    qp = rng.integers(64, 64 + 2000, N).astype(np.int64)
    sp = rng.integers(64, 64 + 3000, N).astype(np.int64)
    for k in range(0, N, 3):
        lo, hi = max(0, qp[k] - 20), qp[k] + 36
        s_letters[sp[k] - (qp[k] - lo): sp[k] + (hi - qp[k])] = \
            q_letters[lo:hi]
    windows = rng.integers(10, 49, N).astype(np.int32)
    cutoffs = rng.integers(10, 40, N).astype(np.int32)
    return q_letters, s_letters, qp, sp, windows, cutoffs


@pytest.mark.parametrize("seed", [0, 1])
def test_stage2_pregathered_matches_pallas_and_oracle(seed):
    """N = 700 pairs (not a multiple of the TPU tile): (keep, best) of the
    port == diamond_tpu's stage2_pregathered (interpret) == the oracle."""
    m = ScoreMatrix("BLOSUM62")
    q, s, qp, sp, windows, cutoffs = _pairs(seed)
    max_window, hamming_id = int(windows.max()), 26
    args = (q, s, qp, sp, windows, cutoffs, m.matrix32, hamming_id, max_window)
    keep_ref, score_ref = _oracle(*args)
    keep_j, score_j = jst.stage2_pregathered(*args, interpret=True)
    keep_p, score_p = s2.stage2_pregathered(*args, device="cpu")
    np.testing.assert_array_equal(keep_p, keep_ref)
    np.testing.assert_array_equal(score_p, score_ref)
    np.testing.assert_array_equal(keep_p, np.asarray(keep_j))
    np.testing.assert_array_equal(score_p, np.asarray(score_j))
    assert keep_p.any() and not keep_p.all()
    assert s2.stage2_filter.launches == 0  # CPU: the plain version


def test_stage2_filter_matches_pallas_row_for_row():
    """The filter's three outputs (identity counts included) == the Pallas
    kernel's on one tile of pregathered windows; its meta rows 0-2."""
    m = ScoreMatrix("BLOSUM62")
    q, s, qp, sp, windows, cutoffs = _pairs(2, N=512)
    qw8, sw8, wl, wr = jst.pregather_windows(q, s, qp, sp, windows, 48)
    meta = np.zeros((8, 512), np.int32)
    meta[0], meta[1], meta[2] = wl, wr, cutoffs
    m2 = np.ascontiguousarray(m.matrix32[:32, :32], dtype=np.int32)
    want = jst.stage2_pallas.__wrapped__(
        jnp.asarray(qw8), jnp.asarray(sw8), jnp.asarray(meta), jnp.asarray(m2),
        26, 48, 512, True)
    got = s2.stage2_filter(torch.from_numpy(np.ascontiguousarray(qw8)),
                           torch.from_numpy(np.ascontiguousarray(sw8)),
                           torch.from_numpy(meta[:3].copy()),
                           torch.from_numpy(m2), 26, 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stage2_rejects_bad_inputs():
    x = torch.zeros(96, 4, dtype=torch.int8)
    meta = torch.zeros(3, 4, dtype=torch.int32)
    m2 = torch.zeros(32, 32, dtype=torch.int32)
    with pytest.raises(ValueError):
        s2.stage2_filter(x, x, meta, m2, 26, 40)      # W != 2 * max_window
    with pytest.raises(TypeError):
        s2.stage2_filter(x, x, meta.long(), m2, 26, 48)
    with pytest.raises(ValueError):                   # the fingerprint span
        s2.stage2_pregathered(np.zeros(200, np.int8), np.zeros(200, np.int8),
                              [100], [100], [20], [10], np.zeros((32, 32)),
                              26, max_window=30)


def test_stage1_matmul_matches_xla():
    """Identity counts of the one-hot product == _stage1_matmul_kernel."""
    rng = np.random.default_rng(4)
    L = 4096
    letters = rng.integers(0, 20, L + 512).astype(np.int8)
    letters[rng.integers(0, L, 300)] = 31
    qp = rng.integers(256, L, (6, TILE_Q)).astype(np.int32)
    sp = rng.integers(256, L, (6, TILE_S)).astype(np.int32)
    sp[:, :4] = qp[:, :4]  # some identical windows: count 48
    want = np.asarray(_stage1_matmul_kernel(
        jnp.asarray(letters), jnp.asarray(letters), jnp.asarray(qp),
        jnp.asarray(sp), TILE_Q, TILE_S))
    l_t = torch.from_numpy(letters)
    got = stage1_matmul(l_t, l_t, torch.from_numpy(qp), torch.from_numpy(sp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 48
