"""Stage-1/2 seeding on the card: the fused pair filter over letter blocks
kept on the device (the counterpart of ``diamond_tpu/ops/stage12_jax.py``).

For every candidate seed pair (query position qp, target position sp) the
kernel ``stage12_pairs`` (CUDA C++ in ``csrc/stage12.cu``) computes the
fingerprint identity count over [-16, +32) (stage 1), the query-side
delimiter clip of the pair's window and the uint8-saturating Kadane score on
the seed diagonal inside it (stage 2), and keep = ident >= hamming_id and
best > cutoff.  It replaces the TPU code
``diamond_tpu/ops/stage12_jax.py:_stage12_kernel`` (jit/XLA, no Pallas); its
plain PyTorch version ``stage12_pairs_torch`` computes the same function
with tensor ops and is what the wrapper runs for tensors on the CPU.

``Stage12Device`` is the batcher the search pipeline calls
(``search/pipeline._stage12_device``): ``run`` sends pairs in chunks through
the kernel, ``run_join`` first runs stage 1 of the large seed groups as the
one-hot product (``ops/stage12.stage1_matmul``) and sends only its survivors
and the small groups' pairs to the kernel.  Results are exact integers in
expanded-pair order, so the search output does not depend on the route.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from diamond_tpu_torch.ops._cuda import check_tensors
from diamond_tpu_torch.ops.stage12 import TILE_Q, TILE_S, stage1_matmul
from diamond_tpu_torch.utils.device import resolve_device

FP_LEFT, FP_RIGHT = 16, 32   # the fingerprint span [-16, +32)
DELIMITER = 31
# A seed group (all query occurrences x all target occurrences) with at
# least this many pairs runs stage 1 as the one-hot product, in tiles of
# TILE_Q x TILE_S occurrences, at most GROUP_TILES tiles a product
MATMUL_MIN_PAIRS = 512
GROUP_TILES = 1024
# pairs a launch at most: 16 B in and 5 B out each, so the buffers of a
# chunk hold 88 MB on the card and as much pinned on the host
MAX_CHUNK = 1 << 22
PLAIN_CHUNK = 1 << 15        # pairs the plain version gathers at once
MAX_PAIRS = (1 << 31) - (1 << 20)  # the kernel's int32 grid-stride index

# Dispatch telemetry (always on; a few int adds per call).
dispatch_count = 0      # one-hot products and kernel chunks, either device
dispatch_pairs = 0      # pairs the fused filter scored
dispatch_wait_s = 0.0   # wall time inside run / run_join (copies included)


def reset_dispatch_stats():
    global dispatch_count, dispatch_pairs, dispatch_wait_s
    dispatch_count = 0
    dispatch_pairs = 0
    dispatch_wait_s = 0.0


def check_positions(qp, sp, windows, q_len: int, s_len: int):
    """Every pair's reads, [p - max(16, w), p + max(32, w)) around qp in the
    query block and around sp in the target block, lie inside the blocks;
    raises ValueError otherwise (numpy arrays; a CUDA load past a block
    would read whatever lies there)."""
    if not len(qp):
        return
    qp = np.asarray(qp, np.int64)
    sp = np.asarray(sp, np.int64)
    w = np.asarray(windows, np.int64)
    w_max = int(w.max())
    left, right = max(w_max, FP_LEFT), max(w_max, FP_RIGHT)
    if (int(qp.min()) >= left and int(sp.min()) >= left
            and int(qp.max()) + right <= q_len
            and int(sp.max()) + right <= s_len):
        return  # the widest window fits around the extreme positions
    left, right = np.maximum(w, FP_LEFT), np.maximum(w, FP_RIGHT)
    bad = ((qp < left) | (qp + right > q_len) | (sp < left)
           | (sp + right > s_len))
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"stage 1/2 pair {i} (qp {qp[i]}, sp {sp[i]}, window {w[i]}) "
            f"reads outside its blocks ({q_len} and {s_len} letters)")


def _k_d1():
    from diamond_tpu_torch.ops import _cuda

    return _cuda.launcher("stage12", "stage12_launch", "pppppppiippp")


def stage12_pairs(q_blk, s_blk, matrix32, qp, sp, windows, cutoffs,
                  hamming_id: int, checked: bool = False, out=None):
    """The fused stage-1/2 filter of every pair.

    q_blk / s_blk int8 letter blocks (letters in the low 5 bits, 31 the
    delimiter); matrix32 int32 [32, 32]; qp, sp, windows, cutoffs int32 [n].
    Returns (keep bool [n], best int32 [n]); best is the Kadane score of
    every pair, stage-1 failures included.  Every pair's reads must lie
    inside the blocks: the wrapper checks it on host copies (a sync on the
    card) unless ``checked`` says the caller did.  ``out``, a
    (keep uint8 [n], best int32 [n]) pair on the device, takes the outputs.

    CUDA tensors launch the kernel (counted in ``stage12_pairs.launches``);
    CPU tensors run ``stage12_pairs_torch``."""
    dev = q_blk.device
    check_tensors(dev, ("q_blk", q_blk, torch.int8), ("s_blk", s_blk, torch.int8),
                  ("matrix32", matrix32, torch.int32), ("qp", qp, torch.int32),
                  ("sp", sp, torch.int32), ("windows", windows, torch.int32),
                  ("cutoffs", cutoffs, torch.int32))
    n = qp.shape[0]
    if q_blk.dim() != 1 or s_blk.dim() != 1:
        raise ValueError("q_blk and s_blk must be 1-D letter blocks")
    if any(x.shape != (n,) for x in (qp, sp, windows, cutoffs)):
        raise ValueError("qp, sp, windows and cutoffs must be [n] alike")
    if tuple(matrix32.shape) != (32, 32):
        raise ValueError("matrix32 must be [32, 32]")
    if n > MAX_PAIRS:
        raise ValueError(f"stage12_pairs takes at most {MAX_PAIRS} pairs")
    if not checked and n:
        check_positions(qp.cpu().numpy(), sp.cpu().numpy(),
                        windows.cpu().numpy(), q_blk.numel(), s_blk.numel())
    if dev.type == "cpu":
        return stage12_pairs_torch(q_blk, s_blk, matrix32, qp, sp, windows,
                                   cutoffs, hamming_id)
    if dev.type != "cuda":
        raise ValueError(f"stage12_pairs runs on cuda or cpu, not {dev}")
    if out is None:  # the kernel writes both for every pair: no memset
        out = (torch.empty(n, dtype=torch.uint8, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
    keep, best = out
    check_tensors(dev, ("keep", keep, torch.uint8), ("best", best, torch.int32))
    if keep.shape != (n,) or best.shape != (n,):
        raise ValueError("out must be (keep [n], best [n])")
    if n:
        with torch.cuda.device(dev):  # the launch goes to the current device
            err = _k_d1()(q_blk.data_ptr(), s_blk.data_ptr(),
                          matrix32.data_ptr(), qp.data_ptr(), sp.data_ptr(),
                          windows.data_ptr(), cutoffs.data_ptr(), n,
                          int(hamming_id), keep.data_ptr(), best.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stage12_pairs launch failed: CUDA error {err}")
        stage12_pairs.launches += 1
    return keep.view(torch.bool), best


stage12_pairs.launches = 0


def _gather_clip(q_blk, s_blk, q0, s0, w):
    """The windows [-W, W) around each seed (W the widest of w, int64
    positions q0, s0) and the query-side clip: (offs, q2, s2, wl, wr).
    Gather indices outside a block are clamped; they lie outside the
    pair's own window, whose letters alone decide its result."""
    dev = q_blk.device
    W = max(int(w.max()), 1)
    offs = torch.arange(-W, W, device=dev)
    q2 = q_blk[(q0[:, None] + offs).clamp_(0, q_blk.numel() - 1)]
    s2 = s_blk[(s0[:, None] + offs).clamp_(0, s_blk.numel() - 1)]
    is_d = (q2 == DELIMITER) & (offs.abs()[None, :] < w[:, None])
    k = torch.arange(W, device=dev)

    def first(hits):  # index of the first hit of each row, else w
        f = torch.where(hits, k, W).min(dim=1).values
        return torch.where(f == W, w, f)

    wl = first(is_d[:, :W].flip(1))  # column 0: offset -1
    wr = first(is_d[:, W:])          # column 0: offset 0
    return offs, q2, s2, wl, wr


def stage12_pairs_torch(q_blk, s_blk, matrix32, qp, sp, windows, cutoffs,
                        hamming_id: int, chunk: int = PLAIN_CHUNK):
    """The kernel's function in tensor ops, exact int32, on whatever device
    the inputs are on: per chunk of pairs, the windows gathered around each
    seed and clipped (``_gather_clip``), the identity count over the
    fingerprint span, and the Kadane walk one offset per step."""
    dev = q_blk.device
    n = qp.shape[0]
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    m_flat = matrix32.reshape(-1)
    offs_fp = torch.arange(-FP_LEFT, FP_RIGHT, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        q0, s0 = qp[lo:hi].long(), sp[lo:hi].long()
        qf, sf = q_blk[q0[:, None] + offs_fp], s_blk[s0[:, None] + offs_fp]
        ident = (((qf ^ sf) & 31) == 0).sum(dim=1)
        offs, q2, s2, wl, wr = _gather_clip(q_blk, s_blk, q0, s0,
                                            windows[lo:hi].long())
        vals = m_flat[(q2.long() & 31) * 32 + (s2.long() & 31)]
        valid = (offs[None, :] >= -wl[:, None]) & (offs[None, :] < wr[:, None])
        st = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
        b = torch.zeros_like(st)
        for c in range(len(offs)):
            st = torch.where(valid[:, c], (st + vals[:, c]).clamp(0, 255), 0)
            b = torch.maximum(b, st)
        best[lo:hi] = b
        keep[lo:hi] = (ident >= hamming_id) & (b > cutoffs[lo:hi])
    return keep, best


class Stage12Device:
    """Device twin of the fused native stage-1/2 pass
    (native/src/leftmost.cc stage12_pipeline, without its left-most step).

    The letter blocks go to the device once and stay there, cached by the
    numpy array they came from (the cache holds the array, so its id cannot
    be reused by another).  On the card the per-pair inputs of a chunk go
    over in one copy from a pinned buffer, the outputs back in two."""

    def __init__(self, matrix32, device: str | None = None,
                 chunk: int | None = None):
        self.device = torch.device(resolve_device(device))
        m = np.ascontiguousarray(np.asarray(matrix32)[:32, :32],
                                 dtype=np.int32)
        self.m32 = torch.from_numpy(m).to(self.device)
        self.chunk = chunk  # pairs a launch; None: MAX_CHUNK
        self._blocks = {}   # id(letters) -> (letters, device tensor)
        self._staging = None

    def _block(self, letters):
        hit = self._blocks.get(id(letters))
        if hit is None:
            t = torch.from_numpy(np.ascontiguousarray(letters, dtype=np.int8))
            hit = self._blocks[id(letters)] = (letters, t.to(self.device))
        return hit[1]

    def _buffers(self, m: int):
        """Pinned host and device buffers for chunks of up to m pairs:
        inputs int32 [4 * m] (qp, sp, windows, cutoffs rows), keep, best."""
        st = self._staging
        if st is None or st[0] < m:
            dev = self.device
            st = self._staging = (
                m, torch.empty(4 * m, dtype=torch.int32, pin_memory=True),
                torch.empty(4 * m, dtype=torch.int32, device=dev),
                torch.empty(m, dtype=torch.uint8, device=dev),
                torch.empty(m, dtype=torch.int32, device=dev),
                torch.empty(m, dtype=torch.bool, pin_memory=True),
                torch.empty(m, dtype=torch.int32, pin_memory=True))
        return st[1:]

    def run_join(self, q_letters, s_letters, join, qp, sp, windows, cutoffs,
                 hamming_id: int):
        """Like run(), with the seed-group structure: the groups of at least
        MATMUL_MIN_PAIRS pairs run stage 1 as the one-hot product (tiles of
        TILE_Q query x TILE_S target occurrences, in the reference's order:
        group, query rows, target columns), and only their survivors, with
        every pair of the small groups, reach the fused filter.  Returns
        (keep bool [N], scores int32 [N]) in expanded-pair order; a pair
        that fails stage 1 in the product keeps score 0."""
        global dispatch_count, dispatch_wait_s
        check_positions(qp, sp, windows, len(q_letters), len(s_letters))
        q_counts = np.diff(join.q_start)
        s_counts = np.diff(join.s_start)
        totals = (q_counts * s_counts).astype(np.int64)
        is_big_group = totals >= MATMUL_MIN_PAIRS
        big = np.nonzero(is_big_group)[0]
        if len(big) == 0:
            return self.run(q_letters, s_letters, qp, sp, windows, cutoffs,
                            hamming_id, checked=True)
        t0 = time.perf_counter()
        n = len(qp)
        pair_starts = np.zeros(len(totals) + 1, dtype=np.int64)
        np.cumsum(totals, out=pair_starts[1:])
        is_big = np.repeat(is_big_group, totals)
        keep1 = np.zeros(n, dtype=bool)
        # the tiles, group by group, query rows outer, target columns inner
        n_qt = -(-q_counts[big] // TILE_Q)
        n_st = -(-s_counts[big] // TILE_S)
        per = n_qt * n_st
        t_grp = np.repeat(big, per)
        j = (np.arange(int(per.sum()), dtype=np.int64)
             - np.repeat(np.cumsum(per) - per, per))
        n_st_t = np.repeat(n_st, per)
        t_q0, t_s0 = (j // n_st_t) * TILE_Q, (j % n_st_t) * TILE_S
        iq, is_ = np.arange(TILE_Q), np.arange(TILE_S)
        ql_dev, sl_dev = self._block(q_letters), self._block(s_letters)
        for pos in range(0, len(t_grp), GROUP_TILES):
            g = t_grp[pos:pos + GROUP_TILES]
            a, b = t_q0[pos:pos + GROUP_TILES], t_s0[pos:pos + GROUP_TILES]
            nq = np.minimum(TILE_Q, q_counts[g] - a)
            ns = np.minimum(TILE_S, s_counts[g] - b)
            # a tile's padding repeats its last occurrence; masked below
            qp_t = join.q_pos[(join.q_start[g] + a)[:, None]
                              + np.minimum(iq[None, :], nq[:, None] - 1)]
            sp_t = join.s_pos[(join.s_start[g] + b)[:, None]
                              + np.minimum(is_[None, :], ns[:, None] - 1)]
            dispatch_count += 1
            counts = stage1_matmul(
                ql_dev, sl_dev,
                torch.from_numpy(qp_t.astype(np.int32)).to(self.device),
                torch.from_numpy(sp_t.astype(np.int32)).to(self.device),
                TILE_Q, TILE_S).cpu().numpy()
            mask = ((iq[None, :, None] < nq[:, None, None])
                    & (is_[None, None, :] < ns[:, None, None]))
            rows = (pair_starts[g][:, None, None]
                    + (a[:, None, None] + iq[None, :, None])
                    * s_counts[g][:, None, None]
                    + b[:, None, None] + is_[None, None, :])
            keep1[rows[mask]] = counts[mask] >= hamming_id
        dispatch_wait_s += time.perf_counter() - t0

        sel = np.nonzero(~is_big | keep1)[0]
        keep = np.zeros(n, dtype=bool)
        scores = np.zeros(n, dtype=np.int32)
        if len(sel):
            k2, s2 = self.run(q_letters, s_letters, qp[sel], sp[sel],
                              windows[sel], cutoffs[sel], hamming_id,
                              checked=True)
            keep[sel] = k2
            scores[sel] = s2
        return keep, scores

    def run(self, q_letters, s_letters, qp, sp, windows, cutoffs,
            hamming_id: int, checked: bool = False):
        """(keep bool [N], scores int32 [N]) of every pair (numpy in and
        out), in chunks of at most ``chunk`` (MAX_CHUNK) pairs.
        Raises ValueError when a pair reads outside its blocks."""
        global dispatch_wait_s
        t0 = time.perf_counter()
        try:
            if not checked:
                check_positions(qp, sp, windows, len(q_letters),
                                len(s_letters))
            return self._run(q_letters, s_letters, qp, sp, windows, cutoffs,
                             hamming_id)
        finally:
            dispatch_wait_s += time.perf_counter() - t0

    def _run(self, q_letters, s_letters, qp, sp, windows, cutoffs,
             hamming_id: int):
        global dispatch_count, dispatch_pairs
        ql, sl = self._block(q_letters), self._block(s_letters)
        n = len(qp)
        keep = np.empty(n, dtype=bool)
        scores = np.empty(n, dtype=np.int32)
        step = min(self.chunk or MAX_CHUNK, max(n, 1))
        cols = (qp, sp, windows, cutoffs)
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            m = hi - lo
            dispatch_count += 1
            dispatch_pairs += m
            if self.device.type == "cpu":
                x = [torch.from_numpy(np.ascontiguousarray(c[lo:hi],
                                                           dtype=np.int32))
                     for c in cols]
                k, b = stage12_pairs(ql, sl, self.m32, *x, hamming_id,
                                     checked=True)
                keep[lo:hi] = k.numpy()
                scores[lo:hi] = b.numpy()
                continue
            h_in, d_in, d_keep, d_best, h_keep, h_best = self._buffers(step)
            hv = h_in[:4 * m].numpy().reshape(4, m)
            for r, c in enumerate(cols):
                hv[r] = c[lo:hi]
            d = d_in[:4 * m]
            d.copy_(h_in[:4 * m], non_blocking=True)
            d = d.view(4, m)
            k, b = stage12_pairs(ql, sl, self.m32, d[0], d[1], d[2], d[3],
                                 hamming_id, checked=True,
                                 out=(d_keep[:m], d_best[:m]))
            h_keep[:m].copy_(k, non_blocking=True)
            h_best[:m].copy_(b, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            keep[lo:hi] = h_keep[:m].numpy()
            scores[lo:hi] = h_best[:m].numpy()
        return keep, scores
