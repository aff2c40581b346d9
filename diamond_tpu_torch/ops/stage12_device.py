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

The whole fused pass over a seed join, ``stage12_join`` (CUDA C++ in
``csrc/stage12_join.cu``), takes the join's CSR for a range of seed groups
and returns the hit rows of the fused host pass
(``native/src/leftmost.cc stage12_pipeline``) in its order: stage 1, the
self-hit test, the left-most filter and stage 2 of every pair, on the card,
with no pair expanded on the host.  Its plain PyTorch version
``stage12_join_torch`` expands the pairs with ``repeat_interleave``, scores
them with ``stage12_pairs_torch`` and runs the left-most filter as
``left_most_torch`` (a translation of the numpy body of
``search/left_most_batch.left_most_filter_batch``).

``Stage12Device`` is the batcher: ``join_rows`` is the search pipeline's
card route (``search/pipeline._stage12_device``), in chunks of seed groups
of at most ``JOIN_PAIR_CAP`` pairs; ``run`` sends pairs in chunks through the
pair kernel, ``run_join`` first runs stage 1 of the large seed groups as the
one-hot product (``ops/stage12.stage1_matmul``) and sends only its survivors
and the small groups' pairs to the pair kernel.  Results are exact integers,
so the search output does not depend on the route.
"""
from __future__ import annotations

import dataclasses
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


# --- the whole fused pass over a seed join ---------------------------------

# reads around a seed reach [p - MARGIN, p + MARGIN) (the clips, the
# fingerprints of the left-most verification with 16-byte loads, a shape's
# positions): every seed lies that far from either end of its block
MARGIN = 192
MAX_JOIN_WINDOW = 128  # stage-2 windows (48; translated queries <= 85)
JOIN_PAIR_CAP = 1 << 25  # pairs a join_rows chunk (a group larger than
                         # this is a chunk of its own): the bytes of the
                         # chunk's score buffer on the card
LEFT_MOST_SPAN = 49      # the left-most window: 16 + 1 + 32 letters
MASK_LETTER, STOP_LETTER = 23, 24


@dataclasses.dataclass
class JoinArgs:
    """The constants of one fused pass (a shape, a chunk of the index), as
    tensors on the pass's device: the 32 x 32 matrix; per query position
    its query (q_idx), per query its first position, stage-2 cutoff and
    window; per target position its target (s_idx, with self_search); the
    reduction map (int8, >= 32 entries) and its size; the shape's positions,
    length and mask; the current and previous matchers' pattern masks
    (int64); the index chunk's partition range [part_lo, part_hi), the seed
    partition mask and the per-target-position partition table (int16, or
    None: recomputed from the letters); the stage-1 threshold and flags."""
    m32: torch.Tensor
    q_idx: torch.Tensor
    q_starts: torch.Tensor
    cut: torch.Tensor
    win: torch.Tensor
    s_idx: torch.Tensor | None
    red_map: torch.Tensor
    red_size: int
    shape_pos: torch.Tensor
    shape_len: int
    shape_mask: int
    cur: torch.Tensor
    prev: torch.Tensor
    part_lo: int
    part_hi: int
    seedp_mask: int
    part_tbl: torch.Tensor | None
    hamming_id: int
    first_shape: bool
    chunked: bool
    do_leftmost: bool
    self_search: bool


def join_entries(q_start, q_pos, s_start, group_keep, g0: int, g1: int,
                 n_e: int | None = None):
    """The entries of seed groups [g0, g1), one per query occurrence of a
    kept group, in the pass's order: (e_qp int32, e_sbeg int32, e_pstart
    int32 [n_e + 1]) = the occurrence's query position, its group's first
    index into s_pos, and the prefix of the entries' pair counts.  Tensor
    ops on the join's device (int64 q_start / s_start, q_pos); n_e, when
    the caller knows it, spares the card a sync."""
    dev = q_start.device
    qc = q_start[g0 + 1:g1 + 1] - q_start[g0:g1]
    sc = s_start[g0 + 1:g1 + 1] - s_start[g0:g1]
    if group_keep is not None:
        qc = qc * group_keep[g0:g1].long()
    if n_e is None:
        n_e = int(qc.sum())
    grp = torch.repeat_interleave(torch.arange(g1 - g0, device=dev), qc,
                                  output_size=n_e)
    first = torch.cumsum(qc, 0) - qc
    within = torch.arange(n_e, device=dev) - first[grp]
    e_qp = q_pos[q_start[g0:g1][grp] + within].int()
    e_sbeg = s_start[g0:g1][grp].int()
    e_pstart = torch.zeros(n_e + 1, dtype=torch.int64, device=dev)
    torch.cumsum(sc[grp], 0, out=e_pstart[1:])
    return e_qp, e_sbeg, e_pstart.int()


def check_join(q_len: int, s_len: int, q_pos, s_pos, win_max: int,
               shape_len: int):
    """Every seed of the join (numpy positions) lies MARGIN letters inside
    its block, windows reach at most MAX_JOIN_WINDOW letters and shapes 32;
    raises ValueError otherwise (a CUDA load past a block would read
    whatever lies there)."""
    if win_max > MAX_JOIN_WINDOW or shape_len > 32:
        raise ValueError(f"stage12_join takes windows of at most "
                         f"{MAX_JOIN_WINDOW} and shapes of at most 32 "
                         f"letters, not {win_max} and {shape_len}")
    for name, pos, n in (("query", q_pos, q_len), ("target", s_pos, s_len)):
        if len(pos) and (int(pos.min()) < MARGIN
                         or int(pos.max()) + MARGIN > n):
            raise ValueError(f"a {name} seed lies within {MARGIN} letters "
                             f"of its block's end ({n} letters): stage12_join "
                             f"would read outside the block")


def _k_join():
    from diamond_tpu_torch.ops import _cuda

    return (_cuda.launcher("stage12_join", "stage12_join_eval",
                           "ppppppiippppppppipiiqpipiiiqpiiiiippp"),
            _cuda.launcher("stage12_join", "stage12_join_rows",
                           "pppiippppppp"))


def _ptr(x):
    return 0 if x is None or x.numel() == 0 else x.data_ptr()


def stage12_join(q_blk, s_blk, q_mask, q_start, q_pos, s_start, s_pos,
                 group_keep, g0: int, g1: int, a: JoinArgs,
                 counts: tuple[int, int] | None = None):
    """The fused stage-1/2 pass (stage 1, self-hit, left-most, stage 2) over
    seed groups [g0, g1) of a join: int32 rows [m, 4] (query index, target
    position, the seed's offset in its query, min(score, 255)) in the order
    of the fused host pass (group, query occurrence, target occurrence).

    q_blk / s_blk int8 letter blocks, q_mask uint8 (query_seed_mask);
    q_start / s_start int64 [G + 1], q_pos int64, s_pos int32 (the join's
    CSR), group_keep bool [G] or None; ``counts`` = (entries, pairs) of the
    range when the caller knows them.  The caller guarantees check_join.
    CUDA tensors launch the kernels (counted in ``stage12_join.launches``,
    one a call); CPU tensors run ``stage12_join_torch``."""
    dev = q_blk.device
    check_tensors(dev, ("q_blk", q_blk, torch.int8),
                  ("s_blk", s_blk, torch.int8),
                  ("q_mask", q_mask, torch.uint8),
                  ("q_start", q_start, torch.int64),
                  ("q_pos", q_pos, torch.int64),
                  ("s_start", s_start, torch.int64),
                  ("s_pos", s_pos, torch.int32),
                  ("m32", a.m32, torch.int32), ("q_idx", a.q_idx, torch.int32),
                  ("q_starts", a.q_starts, torch.int32),
                  ("cut", a.cut, torch.int32), ("win", a.win, torch.int32),
                  ("red_map", a.red_map, torch.int8),
                  ("shape_pos", a.shape_pos, torch.int32),
                  ("cur", a.cur, torch.int64), ("prev", a.prev, torch.int64),
                  *[(n, x, t) for n, x, t in (
                      ("s_idx", a.s_idx, torch.int32),
                      ("part_tbl", a.part_tbl, torch.int16),
                      ("group_keep", group_keep, torch.bool))
                    if x is not None])
    if a.self_search and a.s_idx is None:
        raise ValueError("self_search needs s_idx")
    if dev.type == "cpu":
        return stage12_join_torch(q_blk, s_blk, q_mask, q_start, q_pos,
                                  s_start, s_pos, group_keep, g0, g1, a)
    if dev.type != "cuda":
        raise ValueError(f"stage12_join runs on cuda or cpu, not {dev}")
    if q_blk.data_ptr() % 16 or s_blk.data_ptr() % 16:
        raise ValueError("stage12_join needs 16-byte aligned letter blocks")
    if len(a.cur) > 64 or len(a.prev) > 64 or len(a.shape_pos) > 32:
        raise ValueError("stage12_join takes at most 64 patterns a matcher "
                         "and 32 shape positions")
    if counts is None:
        qc = q_start[g0 + 1:g1 + 1] - q_start[g0:g1]
        sc = s_start[g0 + 1:g1 + 1] - s_start[g0:g1]
        if group_keep is not None:
            qc = qc * group_keep[g0:g1].long()
        counts = (int(qc.sum()), int((qc * sc).sum()))
    n_e, n_pairs = counts
    if n_pairs > MAX_PAIRS:
        raise ValueError(f"stage12_join takes at most {MAX_PAIRS} pairs a "
                         f"call, not {n_pairs}")
    if n_pairs == 0:
        return torch.empty((0, 4), dtype=torch.int32, device=dev)
    rows = _join_launch(q_blk, s_blk, q_mask, q_start, q_pos, s_start, s_pos,
                        group_keep, g0, g1, a, n_e, n_pairs)
    stage12_join.launches += 1
    return rows


stage12_join.launches = 0


def _join_launch(q_blk, s_blk, q_mask, q_start, q_pos, s_start, s_pos,
                 group_keep, g0, g1, a: JoinArgs, n_e: int, n_pairs: int,
                 entries=None, rows_out=None):
    """stage12_join's two kernels on checked inputs: the entries (unless
    given), the score bytes and CTA counts, their scan, the rows.
    ``rows_out``, int32 [m, 4] when the caller knows the call's row count
    m, takes the rows without the sync that reads m."""
    dev = q_blk.device
    e_qp, e_sbeg, e_pstart = entries or join_entries(
        q_start, q_pos, s_start, group_keep, g0, g1, n_e)
    tiles = -(-n_pairs // 256)
    score = torch.empty(n_pairs, dtype=torch.uint8, device=dev)
    tile_count = torch.empty(tiles, dtype=torch.int32, device=dev)
    k_eval, k_rows = _k_join()
    with torch.cuda.device(dev):  # the launches go to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = k_eval(
            q_blk.data_ptr(), s_blk.data_ptr(), q_mask.data_ptr(),
            e_qp.data_ptr(), e_sbeg.data_ptr(), e_pstart.data_ptr(), n_e,
            n_pairs, s_pos.data_ptr(), a.q_idx.data_ptr(),
            a.q_starts.data_ptr(), a.cut.data_ptr(), a.win.data_ptr(),
            _ptr(a.s_idx), a.m32.data_ptr(), a.red_map.data_ptr(),
            int(a.red_size), _ptr(a.shape_pos), len(a.shape_pos),
            int(a.shape_len), int(a.shape_mask), _ptr(a.cur), len(a.cur),
            _ptr(a.prev), len(a.prev), int(a.part_lo), int(a.part_hi),
            int(a.seedp_mask), _ptr(a.part_tbl), int(a.hamming_id),
            int(a.first_shape), int(a.chunked), int(a.do_leftmost),
            int(a.self_search), score.data_ptr(), tile_count.data_ptr(),
            stream)
        if err != 0:
            raise RuntimeError(f"stage12_join launch failed: CUDA error {err}")
        tile_end = torch.cumsum(tile_count, 0, dtype=torch.int32)
        rows = rows_out
        if rows is None:
            m = int(tile_end[-1])  # the one sync of a call
            rows = torch.empty((m, 4), dtype=torch.int32, device=dev)
        if len(rows):
            err = k_rows(e_qp.data_ptr(), e_sbeg.data_ptr(),
                         e_pstart.data_ptr(), n_e, n_pairs, s_pos.data_ptr(),
                         a.q_idx.data_ptr(), a.q_starts.data_ptr(),
                         score.data_ptr(), tile_end.data_ptr(),
                         rows.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"stage12_join rows launch failed: CUDA "
                                   f"error {err}")
    return rows


def stage12_join_torch(q_blk, s_blk, q_mask, q_start, q_pos, s_start, s_pos,
                       group_keep, g0: int, g1: int, a: JoinArgs):
    """stage12_join's function in tensor ops, exact, on whatever device the
    inputs are on: the pairs expanded with repeat_interleave, stage 1 and
    stage 2 by stage12_pairs_torch (per pair the window and cutoff of its
    query), the self-hit test through the index tables and the left-most
    filter by left_most_torch on the pairs that pass the rest."""
    dev = q_blk.device
    e_qp, e_sbeg, e_pstart = join_entries(q_start, q_pos, s_start,
                                          group_keep, g0, g1)
    n_e = len(e_qp)
    ns = (e_pstart[1:] - e_pstart[:-1]).long()
    n = int(e_pstart[-1]) if n_e else 0
    if n == 0:
        return torch.empty((0, 4), dtype=torch.int32, device=dev)
    ent = torch.repeat_interleave(torch.arange(n_e, device=dev), ns)
    pair = torch.arange(n, device=dev)
    qp = e_qp[ent].long()
    sp = s_pos[(e_sbeg[ent] + pair - e_pstart[ent]).long()].long()
    qidx = a.q_idx[qp].long()
    keep, best = stage12_pairs_torch(q_blk, s_blk, a.m32, qp.int(), sp.int(),
                                     a.win[qidx], a.cut[qidx], a.hamming_id)
    if a.self_search:
        keep &= a.s_idx[sp].long() != qidx
    qoff = qp - a.q_starts[qidx].long()
    if a.do_leftmost:
        sel = torch.nonzero(keep).flatten()
        if len(sel):
            wl, wr = clip_torch(q_blk, qp[sel], 48)
            keep[sel] = left_most_torch(q_blk, s_blk, q_mask, qp[sel],
                                        sp[sel], qoff[sel], wl, wr, a)
    sel = torch.nonzero(keep).flatten()
    return torch.stack([qidx[sel], sp[sel], qoff[sel], best[sel].long()],
                       dim=1).int()


def clip_torch(blk, pos, w: int):
    """(left, right) of the delimiter clip of [pos - w, pos + w): the k in
    [0, w) of the first raw delimiter at pos - 1 - k (left) and at pos + k
    (right), else w (stages.clip_window; int64 positions)."""
    k = torch.arange(w, device=blk.device)
    big = torch.full((), w, device=blk.device)

    def first(idx):
        return torch.where(blk[idx] == DELIMITER, k, big).min(dim=1).values

    return (first(pos[:, None] - 1 - k[None, :]),
            first(pos[:, None] + k[None, :]))


def _matcher_hit(h, masks):
    """PatternMatcher.hit, bit-parallel (leftmost.cc matcher_hit): bit i of
    the result is set when some pattern matches h at offset i (h >= 0)."""
    out = torch.zeros_like(h)
    for p in masks.tolist():
        m = torch.full_like(h, -1)
        b = 0
        while p:
            if p & 1:
                m &= h >> b
            p >>= 1
            b += 1
        out |= m
    return out


def _verify_torch(q_blk, s_blk, qs, ss, hit_bits, match_masks, left: bool,
                  a: JoinArgs):
    """For each hit, whether any of its set bits verifies (left_most_batch.
    _verify_batch): the seed's partition in or before the chunk's range
    where the whole shape matches (chunked), and the fingerprint identity
    at the bit >= hamming_id."""
    dev = q_blk.device
    bits = torch.arange(64, device=dev)
    rows, col = torch.nonzero((hit_bits[:, None] >> bits[None, :]) & 1,
                              as_tuple=True)
    out = torch.zeros(len(qs), dtype=torch.bool, device=dev)
    if not len(rows):
        return out
    qpos, spos = qs[rows] + col, ss[rows] + col
    ok = torch.ones(len(rows), dtype=torch.bool, device=dev)
    if a.chunked:
        full = ((match_masks[rows] >> col) & a.shape_mask) == a.shape_mask
        if full.any():
            sp_f = spos[full]
            if a.part_tbl is not None:
                part = a.part_tbl[sp_f].long()
                good = torch.ones_like(part, dtype=torch.bool)
            else:
                sl = (s_blk[sp_f[:, None] + a.shape_pos.long()[None, :]]
                      & 31).long()
                good = (sl < 20).all(dim=1)
                key = torch.zeros_like(sp_f)
                for c in range(sl.shape[1]):
                    key = key * a.red_size + a.red_map[sl[:, c]].long()
                part = key & a.seedp_mask
            bound = a.part_hi if left else a.part_lo
            ok[full] = good & (part < bound)
    f = torch.arange(-FP_LEFT, FP_RIGHT, device=dev)
    ident = (((q_blk[qpos[:, None] + f] ^ s_blk[spos[:, None] + f]) & 31)
             == 0).sum(dim=1)
    hits = torch.zeros(len(qs), dtype=torch.int64, device=dev)
    hits.index_add_(0, rows, (ok & (ident >= a.hamming_id)).long())
    return hits > 0


def left_most_torch(q_blk, s_blk, q_mask, qp, sp, seed_offsets, wl0, wr0,
                    a: JoinArgs):
    """The left-most filter's keep flags (int64 tensors in; the numpy body
    of search/left_most_batch.left_most_filter_batch in tensor ops): the
    stage-2 window geometry, the target-side delimiter clip around the
    anchor, the reduced match mask and the query seed-mask bits, the
    matchers' hits left (current shapes) and right (previous shapes, or the
    current ones when chunked), and their verification."""
    dev = q_blk.device
    overhang = (wl0 - seed_offsets % 32).clamp(min=0)
    seed_off = wl0 - overhang
    win_len0 = wl0 + wr0 - overhang
    d = (seed_off - 16).clamp(min=0)
    wl = seed_off.clamp(max=16)
    qs, ss = qp - seed_off + d, sp - seed_off + d
    window = torch.minimum(win_len0 - d, wl + 1 + 32)
    offs = torch.arange(LEFT_MOST_SPAN, device=dev)
    delim = ((s_blk[ss[:, None] + offs] == DELIMITER)
             & (offs[None, :] < window[:, None]))
    rel = offs[None, :] - wl[:, None]
    big = torch.full((), LEFT_MOST_SPAN, device=dev)
    first_after = torch.where(delim & (rel >= 0), offs, big).min(dim=1).values
    first_after = torch.where(first_after == LEFT_MOST_SPAN, window,
                              first_after)
    dd = torch.where(delim & (rel < 0), offs, -1).max(dim=1).values + 1
    qs, ss, wl = qs + dd, ss + dd, wl - dd
    window = first_after - dd
    valid = offs[None, :] < window[:, None]
    ql = (q_blk[qs[:, None] + offs] & 31).long()
    sl = (s_blk[ss[:, None] + offs] & 31).long()

    def is_aa(x):
        return (x != MASK_LETTER) & (x != DELIMITER) & (x != STOP_LETTER)

    red = a.red_map.long()
    okm = valid & is_aa(ql) & is_aa(sl) & (red[ql] == red[sl])
    weights = torch.ones_like(offs) << offs
    match_mask = (okm.long() * weights).sum(dim=1)
    smask = ((q_mask[qs[:, None] + offs] != 0) & valid).long()
    qsm = ~(smask * weights).sum(dim=1)
    bits_left = (torch.ones_like(wl) << (wl + a.shape_len - 1)) - 1
    mm_left = match_mask & bits_left
    left_hit = _matcher_hit(mm_left, a.cur) & qsm & bits_left
    if a.first_shape and not a.chunked:
        keep = left_hit == 0
        need = torch.nonzero(~keep).flatten()
        if len(need):
            keep[need] = ~_verify_torch(q_blk, s_blk, qs[need], ss[need],
                                        left_hit[need], mm_left[need], True,
                                        a)
        return keep
    shift = wl + 1
    mm_right = (match_mask >> shift) & 0xFFFFFFFF
    right_hit = (_matcher_hit(mm_right, a.cur if a.chunked else a.prev)
                 & (qsm >> shift) & 0xFFFFFFFF)
    keep = torch.ones(len(qp), dtype=torch.bool, device=dev)
    need = torch.nonzero(left_hit != 0).flatten()
    if len(need):
        keep[need] = ~_verify_torch(q_blk, s_blk, qs[need], ss[need],
                                    left_hit[need], mm_left[need], True, a)
    need = torch.nonzero(keep & (right_hit != 0)).flatten()
    if len(need):
        keep[need] = ~_verify_torch(q_blk, s_blk, qs[need] + shift[need],
                                    ss[need] + shift[need], right_hit[need],
                                    mm_right[need], False, a)
    return keep


class Stage12Device:
    """Device twin of the fused native stage-1/2 pass
    (native/src/leftmost.cc stage12_pipeline): ``join_rows`` the whole pass
    over a seed join; ``run`` and ``run_join`` its stage 1 and stage 2 pair
    by pair, without the self-hit test and the left-most filter.

    The letter blocks and join_rows' per-position and per-query tables go
    to the device once and stay there, cached by the numpy array they came
    from.  On the card run's
    per-pair inputs of a chunk go over in one copy from a pinned buffer,
    the outputs back in two."""

    def __init__(self, matrix32, device: str | None = None,
                 chunk: int | None = None):
        self.device = torch.device(resolve_device(device))
        m = np.ascontiguousarray(np.asarray(matrix32)[:32, :32],
                                 dtype=np.int32)
        self.m32 = torch.from_numpy(m).to(self.device)
        self.chunk = chunk  # pairs a launch; None: MAX_CHUNK
        # (id(array), dtype) -> (array, device tensor): the letter blocks
        # and join_rows' tables that live as long as a block
        self._tables = {}
        self._staging = None

    def _block(self, letters):
        return self._table(letters, np.int8)

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

    def _table(self, arr, dtype):
        """arr (numpy) on the device as dtype, cached by the array (the
        cache holds it, so its id cannot be reused by another)."""
        key = (id(arr), np.dtype(dtype).str)
        hit = self._tables.get(key)
        if hit is None:
            t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
            hit = self._tables[key] = (arr, t.to(self.device))
        return hit[1]

    def join_rows(self, q_letters, s_letters, q_seed_mask, join, group_keep,
                  q_starts, cut, win, q_idx_tbl, s_idx_tbl, reduction, shape,
                  first_shape: bool, chunked: bool, do_leftmost: bool,
                  current, previous, part_lo: int, part_hi: int,
                  seedp_mask: int, part_tbl, hamming_id: int,
                  self_search: bool, cap: int = JOIN_PAIR_CAP):
        """The hit rows [m, 4] int64 of the fused stage-1/2 pass over a seed
        join (numpy in and out; the arguments of native
        stage12_pipeline_native, current / previous BatchPatternMatchers),
        in chunks of seed groups of at most ``cap`` pairs, each one
        stage12_join call.  The letter blocks and the per-position and
        per-query tables stay on the device (cached by the array they came
        from); the join, group_keep, q_seed_mask and the shape's own tables
        (its positions and partition table, which the pipeline drops after
        the shape) go over each call, so the device keeps nothing a shape
        at a time.
        Spans: seed.s12_upload, seed.s12_card (the calls, their syncs
        included), seed.s12_rows (the rows back)."""
        global dispatch_count, dispatch_pairs, dispatch_wait_s
        from diamond_tpu_torch.utils.log import padd, perf_counter

        t0 = t_start = perf_counter()
        q_counts = np.diff(join.q_start)
        if group_keep is not None:
            q_counts = q_counts * group_keep
        pairs = q_counts * np.diff(join.s_start)
        if not len(pairs) or not pairs.any():
            return np.empty((0, 4), dtype=np.int64)
        check_join(len(q_letters), len(s_letters), join.q_pos, join.s_pos,
                   int(win.max()), shape.length)
        if int(np.asarray(cut).min()) < 0:
            raise ValueError("stage12_join takes no negative cutoff")
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
                dev)

        masks = [torch.from_numpy(np.asarray(
            m.masks if m is not None and not m.empty else [],
            dtype=np.uint64).view(np.int64)).to(dev)
            for m in (current, previous)]
        a = JoinArgs(
            m32=self.m32, q_idx=self._table(q_idx_tbl, np.int32),
            q_starts=self._table(q_starts, np.int32),
            cut=self._table(cut, np.int32), win=self._table(win, np.int32),
            s_idx=(None if s_idx_tbl is None
                   else self._table(s_idx_tbl, np.int32)),
            red_map=self._table(reduction.map, np.int8),
            red_size=int(reduction.size),
            shape_pos=up(shape.positions, np.int32),
            shape_len=int(shape.length), shape_mask=int(shape.mask),
            cur=masks[0], prev=masks[1], part_lo=int(part_lo),
            part_hi=int(part_hi), seedp_mask=int(seedp_mask),
            part_tbl=None if part_tbl is None else up(part_tbl, np.int16),
            hamming_id=int(hamming_id), first_shape=bool(first_shape),
            chunked=bool(chunked), do_leftmost=bool(do_leftmost),
            self_search=bool(self_search))
        ql, sl = self._block(q_letters), self._block(s_letters)
        qm = up(np.asarray(q_seed_mask).view(np.uint8), np.uint8)
        q_start, q_pos = up(join.q_start, np.int64), up(join.q_pos, np.int64)
        s_start, s_pos = up(join.s_start, np.int64), up(join.s_pos, np.int32)
        keep = None if group_keep is None else up(group_keep, np.bool_)
        t0 = padd("seed.s12_upload", t0)
        cum = np.zeros(len(pairs) + 1, dtype=np.int64)
        np.cumsum(pairs, out=cum[1:])
        e_cum = np.zeros(len(pairs) + 1, dtype=np.int64)
        np.cumsum(q_counts, out=e_cum[1:])
        out = []
        g0, n_groups = 0, len(pairs)
        while g0 < n_groups:
            g1 = int(np.searchsorted(cum, cum[g0] + cap, side="right")) - 1
            g1 = max(g1, g0 + 1)
            n = int(cum[g1] - cum[g0])
            if n:
                dispatch_count += 1
                dispatch_pairs += n
                out.append(stage12_join(
                    ql, sl, qm, q_start, q_pos, s_start, s_pos, keep, g0, g1,
                    a, counts=(int(e_cum[g1] - e_cum[g0]), n)))
            g0 = g1
        t0 = padd("seed.s12_card", t0)
        rows = (torch.cat(out).cpu().numpy().astype(np.int64) if out
                else np.empty((0, 4), dtype=np.int64))
        padd("seed.s12_rows", t0)
        dispatch_wait_s += perf_counter() - t_start
        return rows

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
