"""The port's CUDA kernels on the card (``pytest -m gpu tests/test_torch_*.py``).

The banded-SWIPE kernel against its plain PyTorch version on the same card
tensors, and DeviceDP on the card against the native host DP; exact int32
equality.  Skips without a card: a CUDA kernel has no CPU mode.
"""
import os
import sys

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
    assert len(p.classes) == 5  # every band class up to 512
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
