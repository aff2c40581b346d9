"""The stage-1/2 seeding filter over host-pregathered windows, on the card
(the counterpart of ``diamond_tpu/ops/stage2_pallas.py``).

The host gathers the 2 * max_window letter windows around every candidate
seed pair (``pregather_windows``, numpy, as in diamond_tpu) and the kernel,
``stage2_filter`` (CUDA C++ in ``csrc/stage2.cu``), computes per pair the
fingerprint identity count over [-16, +32), the uint8-saturating Kadane
score inside the query-side delimiter clip [-wl, wr), and keep = ident >=
hamming_id and best > cutoff.  It replaces the TPU kernel
``diamond_tpu/ops/stage2_pallas.py:stage2_pallas``; its plain PyTorch
version ``stage2_filter_plain`` computes the same function with tensor ops
and is what the wrapper runs for tensors on the CPU.

No command-line route reaches it in either package: the benchmark and the
tests drive it (diamond_tpu's routing verdict: the host pregather costs
about as much as the fused host pass).
"""
from __future__ import annotations

import numpy as np
import torch

from diamond_tpu_torch.ops._cuda import check_tensors
from diamond_tpu_torch.utils.device import resolve_device

NEG = -(10 ** 9)
WINDOW_LEFT = 16   # fingerprint window [pos-16, pos+32)
FP_LEN = 48
# the kernel's most window rows: two buffers of both windows' [W][128]
# tiles beside its 4 KB matrix in 227 KB of shared memory (csrc/stage2.cu,
# MAX_SMEM)
MAX_ROWS = 446


def _k6():
    from diamond_tpu_torch.ops import _cuda

    return _cuda.launcher("stage2", "stage2_launch", "ppppiiiipppp")


def stage2_filter(qw8, sw8, meta, m2, hamming_id: int, max_window: int):
    """qw8 / sw8 int8 [W, N] pregathered windows (W = 2 * max_window,
    letters 0..31); meta int32 [3, N] rows (wl, wr, cutoff); m2 int32
    [32, 32].  Returns (keep bool [N], best int32 [N], ident int32 [N]).

    CUDA tensors launch the kernel (counted in ``stage2_filter.launches``),
    which takes W <= MAX_ROWS; CPU tensors run ``stage2_filter_plain``."""
    check_tensors(qw8.device, ("qw8", qw8, torch.int8), ("sw8", sw8, torch.int8),
                  ("meta", meta, torch.int32), ("m2", m2, torch.int32))
    if qw8.dim() != 2 or sw8.shape != qw8.shape:
        raise ValueError("qw8 and sw8 must be [W, N] alike")
    W, N = qw8.shape
    if W != 2 * max_window:
        raise ValueError(f"windows must be 2 * max_window = {2 * max_window} "
                         f"rows, got {W}")
    if tuple(meta.shape) != (3, N) or tuple(m2.shape) != (32, 32):
        raise ValueError("meta must be [3, N] and m2 [32, 32]")
    dev = qw8.device
    if dev.type == "cpu":
        return stage2_filter_plain(qw8, sw8, meta, m2, hamming_id, max_window)
    if dev.type != "cuda":
        raise ValueError(f"stage2_filter runs on cuda or cpu, not {dev}")
    if W > MAX_ROWS:
        raise ValueError(f"stage2_filter's kernel takes windows of at most "
                         f"{MAX_ROWS} rows (max_window {MAX_ROWS // 2}), got "
                         f"{W}")
    # the kernel writes all three for every pair: no memset
    keep = torch.empty(N, dtype=torch.bool, device=dev)
    best = torch.empty(N, dtype=torch.int32, device=dev)
    ident = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return keep, best, ident
    if W * N >= 2 ** 31:
        raise ValueError("stage2_filter batch exceeds int32 offsets")
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _k6()(qw8.data_ptr(), sw8.data_ptr(), meta.data_ptr(),
                    m2.data_ptr(), W, N, int(max_window), int(hamming_id),
                    keep.data_ptr(), best.data_ptr(), ident.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage2_filter launch failed: CUDA error {err}")
    stage2_filter.launches += 1
    return keep, best, ident


stage2_filter.launches = 0


def stage2_filter_plain(qw8, sw8, meta, m2, hamming_id: int, max_window: int):
    """The kernel's function in tensor ops, one window offset per step;
    exact int32, on whatever device the inputs are on."""
    W, N = qw8.shape
    dev = qw8.device
    q = qw8.long() & 31
    s = sw8.long() & 31
    vals = m2.reshape(-1)[q * 32 + s]                      # [W, N] int32
    wl, wr, cut = meta.unbind(0)
    st = torch.zeros(N, dtype=torch.int32, device=dev)
    best = torch.zeros_like(st)
    for w in range(W):
        off = w - max_window
        valid = (off >= -wl) & (off < wr)
        st = torch.where(valid, (st + vals[w]).clamp(0, 255), 0)
        best = torch.maximum(best, st)
    fp = slice(max_window - WINDOW_LEFT, max_window - WINDOW_LEFT + FP_LEN)
    ident = (qw8[fp] == sw8[fp]).sum(dim=0, dtype=torch.int32)
    return (ident >= hamming_id) & (best > cut), best, ident


def pregather_windows(q_letters, s_letters, qp, sp, windows,
                      max_window: int = 48):
    """The HOST half of the pregathered design: gather the per-pair
    2*max_window letter windows and the query-side delimiter clips
    (wl, wr) — the same clip semantics as stage12_jax._stage12_kernel.

    Returns (qw8 [W, N] int8, sw8 [W, N] int8, wl [N] int32, wr [N] int32).
    This is the cost that decides the routing verdict: ~4*max_window
    random bytes per pair, which is the same memory traffic as the entire
    fused host pass."""
    qp = np.asarray(qp, dtype=np.int64)
    sp = np.asarray(sp, dtype=np.int64)
    offs = np.arange(-max_window, max_window, dtype=np.int64)
    qw = q_letters[qp[:, None] + offs[None, :]]
    sw = s_letters[sp[:, None] + offs[None, :]]
    in_win = np.abs(offs)[None, :] < np.asarray(windows)[:, None]
    is_d = (qw == 31) & in_win
    left_half = is_d[:, :max_window][:, ::-1]
    has_l = left_half.any(axis=1)
    first_l = np.argmax(left_half, axis=1)
    wl = np.where(has_l, first_l, windows).astype(np.int32)
    right_half = is_d[:, max_window:]
    has_r = right_half.any(axis=1)
    first_r = np.argmax(right_half, axis=1)
    wr = np.where(has_r, first_r, windows).astype(np.int32)
    return ((qw & 31).T.astype(np.int8), (sw & 31).T.astype(np.int8),
            wl, wr)


def stage2_pregathered(q_letters, s_letters, qp, sp, windows, cutoffs,
                       matrix32, hamming_id: int, max_window: int = 48,
                       device=None, kernel=None):
    """End-to-end pregathered stage-1/2: host gather + one launch of
    ``kernel`` (``stage2_filter`` unless given) on ``device`` (the card
    unless the caller asks for the CPU).  Same (keep, scores) numpy
    contract as diamond_tpu's."""
    # the fingerprint window spans [-16, +32) and the Kadane walk is
    # clipped to max_window: narrower windows silently under-count
    if max_window < 32:
        raise ValueError("max_window must be >= 32 (fingerprint span)")
    if len(qp) and int(np.max(windows)) > max_window:
        raise ValueError("window exceeds max_window (Kadane walk would "
                         "be truncated)")
    qw8, sw8, wl, wr = pregather_windows(q_letters, s_letters, qp, sp,
                                         windows, max_window)
    meta = np.stack([wl, wr, np.asarray(cutoffs, dtype=np.int32)])
    dev = torch.device(resolve_device(device))
    x = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (qw8, sw8, meta.astype(np.int32),
                   np.ascontiguousarray(matrix32[:32, :32], dtype=np.int32))]
    keep, best, _ = (kernel or stage2_filter)(*x, hamming_id, max_window)
    return keep.cpu().numpy(), best.cpu().numpy()
