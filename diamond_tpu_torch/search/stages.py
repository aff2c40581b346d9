"""Seed search stages 0-2: enumeration, join, fingerprint + ungapped filters.

Vectorized re-design of the reference seeding pipeline:
  - stage 0: seed enumeration + radix hash join (reference
    src/search/stage0.cpp:101-217, src/util/algo/hash_join.h) becomes
    sort + run-length grouping over seed keys,
  - complexity masking of joined seed groups (reference
    src/search/seed_complexity.cpp:37-51, mask_seeds),
  - stage 1: 48-byte fingerprint identity filter (reference
    src/search/hamming/kernel.h:29-75, finger_print.h) as a batched gather +
    equality-count over all candidate pairs,
  - stage 2: windowed ungapped Kadane scan vs an e-value cutoff table
    (reference src/search/stage2.h:43-154, dp/ungapped_simd.cpp) and the
    left-most seed dedup filter (reference src/search/left_most.h:31-110).

All stages operate on flat arrays of candidate pairs, the static-shape form
that maps onto TPU kernels; the numpy path is the reference oracle and the
hot filters have jax twins in diamond_tpu.ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import lgamma

import numpy as np

from diamond_tpu_torch.constants.alphabet import LETTER_MASK, MASK_LETTER, TRUE_AA
from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.seed.reduction import Reduction
from diamond_tpu_torch.seed.shapes import Shape

WINDOW_LEFT = 16
WINDOW_RIGHT = 32
FINGERPRINT_LEN = 48


# ---------------------------------------------------------------------------
# Stage 0: seed enumeration and join
# ---------------------------------------------------------------------------

def enumerate_seeds(block: Block, shape: Shape, reduction: Reduction,
                    min_len: int = 0):
    """All (key, global position) seeds of a block for one shape.

    Positions whose sampled letters include MASK/STOP/soft-masked letters are
    skipped (reference enum_seeds.h:131-188, shape.h:114-150).
    """
    reduced_all = reduction(block.letters)
    if reduced_all.dtype == np.int8 and reduced_all.flags.c_contiguous:
        from diamond_tpu_torch import native

        pos64 = getattr(shape, "_pos64", None)
        if pos64 is None:
            pos64 = np.ascontiguousarray(shape.positions, dtype=np.int64)
            shape._pos64 = pos64
        r = native.enumerate_seeds_native(
            reduced_all, block.starts, block.lengths, pos64, shape.weight,
            shape.length, reduction.size, min_len)
        if r is not None:
            return r
    keys, valid = shape.extract_seeds(reduced_all, reduction.size)
    n = len(keys)
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
    # one pass over the whole concatenated block; windows must not cross a
    # sequence end (a spaced shape can straddle the single delimiter byte
    # when the delimiter lands on an unsampled position, so letter validity
    # alone is not enough)
    seq_end, seq_len = block.seq_bounds()
    pos = np.arange(n, dtype=np.int64)
    valid &= pos + shape.length <= seq_end[:n]
    if min_len:
        valid &= seq_len[:n] >= min_len
    idx = np.nonzero(valid)[0]
    return keys[idx], idx


def enumerate_seeds_range(block: Block, shape: Shape, reduction: Reduction,
                          reduced_all, seq_lo: int, seq_hi: int,
                          min_len: int = 0):
    """enumerate_seeds over the sequence range [seq_lo, seq_hi) only,
    with the reduced letters precomputed — the streaming unit of the
    query-indexed route's sliced DB enumeration (positions stay
    global)."""
    if reduced_all.dtype == np.int8 and reduced_all.flags.c_contiguous:
        from diamond_tpu_torch import native

        pos64 = getattr(shape, "_pos64", None)
        if pos64 is None:
            pos64 = np.ascontiguousarray(shape.positions, dtype=np.int64)
            shape._pos64 = pos64
        r = native.enumerate_seeds_native(
            reduced_all, np.ascontiguousarray(block.starts[seq_lo:seq_hi]),
            np.ascontiguousarray(block.lengths[seq_lo:seq_hi]), pos64,
            shape.weight, shape.length, reduction.size, min_len)
        if r is not None:
            return r
    # fallback (no native lib): full extraction, then position-range cut
    keys, pos = enumerate_seeds(block, shape, reduction, min_len)
    lo = int(block.starts[seq_lo])
    hi = (int(block.starts[seq_hi - 1]) + int(block.lengths[seq_hi - 1])
          if seq_hi > seq_lo else lo)
    m = (pos >= lo) & (pos < hi)
    return keys[m], pos[m]


@dataclass
class SeedJoin:
    """Join of query and reference seed arrays on seed key."""

    keys: np.ndarray       # (G,) distinct seed keys present on both sides
    q_start: np.ndarray    # (G+1,) group offsets into q_pos
    q_pos: np.ndarray      # query global positions, grouped by key
    s_start: np.ndarray    # (G+1,) group offsets into s_pos
    s_pos: np.ndarray      # subject global positions, grouped by key


def _csr_gather(first, counts, arr):
    """Gather variable-length runs [first[g], first[g]+counts[g]) into one
    flat array, fully vectorized (CSR expansion)."""
    total = int(counts.sum())
    starts = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    if total == 0:
        return starts, np.empty(0, dtype=arr.dtype)
    grp = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - starts[grp]
    return starts, arr[first[grp] + within]


def _take_runs(first, counts, arr):
    """Like _csr_gather but for DISJOINT ASCENDING runs of arr (the
    seed-join case: groups are contiguous slices of the key-sorted
    array): a +1/-1 boundary scatter and one boolean take replace the
    repeat/arange temporaries (an order of magnitude less allocation
    on multi-million-row joins)."""
    total = int(counts.sum())
    starts = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    if total == 0:
        return starts, np.empty(0, dtype=arr.dtype)
    delta = np.zeros(len(arr) + 1, dtype=np.int8)
    delta[first] += 1            # starts are distinct,
    delta[first + counts] -= 1   # ends are distinct: both accumulate
    keep = np.cumsum(delta[:-1], dtype=np.int8).view(bool)
    return starts, arr[keep]


def _sorted_kv(keys, pos, inplace: bool = False):
    from diamond_tpu_torch import native

    r = native.sort_kv_native(keys, pos, inplace=inplace)
    if r is not None:
        return r
    o = np.argsort(keys, kind="stable")
    return keys[o], pos[o]


def seed_join(q_keys, q_pos, s_keys, s_pos) -> SeedJoin:
    """Sort-merge join (device-friendly replacement of the radix hash join;
    host path sorts with a native stable radix sort)."""
    qk, qp = _sorted_kv(q_keys, q_pos)
    sk, sp = _sorted_kv(s_keys, s_pos)
    return seed_join_sorted(qk, qp, sk, sp)


def seed_join_sorted(qk, qp, sk, sp) -> SeedJoin:
    """seed_join on key-sorted inputs (position order within a key must be
    the enumeration order, i.e. a stable key sort).  The pipeline sorts
    once per shape and slices per index chunk — boolean selection keeps
    the order, so the per-chunk re-sort disappears."""
    from diamond_tpu_torch import native

    if len(qk) and len(sk):
        r = native.sorted_join_merge_native(
            np.ascontiguousarray(qk, dtype=np.uint64),
            np.ascontiguousarray(qp, dtype=np.int64),
            np.ascontiguousarray(sk, dtype=np.uint64),
            np.ascontiguousarray(sp, dtype=np.int64))
        if r is not None:
            keys, q_start, q_pos, s_start, s_pos = r
            return SeedJoin(keys=keys, q_start=q_start, q_pos=q_pos,
                            s_start=s_start, s_pos=s_pos)
    # group boundaries on the sorted key arrays (the arrays are already
    # sorted, so run boundaries beat np.unique, which would sort again)
    def _firsts(k):
        if len(k) == 0:
            return np.zeros(0, dtype=np.int64)
        f = np.empty(len(k), dtype=bool)
        f[0] = True
        np.not_equal(k[1:], k[:-1], out=f[1:])
        return np.nonzero(f)[0]

    q_first = _firsts(qk)
    s_first = _firsts(sk)
    uq = qk[q_first]
    us = sk[s_first]
    # intersect two sorted unique arrays via one searchsorted
    ii = np.searchsorted(us, uq)
    iic = np.minimum(ii, max(len(us) - 1, 0))
    match = ((ii < len(us)) & (us[iic] == uq)) if len(us) else \
        np.zeros(len(uq), dtype=bool)
    qi = np.nonzero(match)[0]
    si = ii[match]
    common = uq[qi]
    q_counts = np.diff(np.append(q_first, len(qk)))[qi]
    s_counts = np.diff(np.append(s_first, len(sk)))[si]

    qs, qv = _take_runs(q_first[qi], q_counts, qp)
    ss, sv = _take_runs(s_first[si], s_counts, sp)
    return SeedJoin(keys=common, q_start=qs, q_pos=qv, s_start=ss, s_pos=sv)


_LNFACT = np.array([lgamma(i + 1) for i in range(64)])


def complexity_mask(join: SeedJoin, shape: Shape, reduction: Reduction,
                    cut: float) -> SeedJoin:
    """Drop seed groups whose reduced-alphabet entropy is below the cut
    (reference seed_complexity.cpp:37-51 via mask_seeds, stage0.cpp:173)."""
    if len(join.keys) == 0:
        return join
    # decode seed keys into reduced bucket digits
    digits = np.zeros((len(join.keys), shape.weight), dtype=np.int64)
    k = join.keys.astype(np.uint64).copy()
    base = np.uint64(reduction.size)
    for i in range(shape.weight - 1, -1, -1):
        digits[:, i] = (k % base).astype(np.int64)
        k //= base
    counts = np.zeros((len(join.keys), reduction.size), dtype=np.int64)
    for i in range(shape.weight):
        np.add.at(counts, (np.arange(len(join.keys)), digits[:, i]), 1)
    entropy = _LNFACT[shape.weight] - _LNFACT[counts].sum(axis=1)
    keep = entropy >= cut
    return _filter_groups(join, keep)


def _filter_groups(join: SeedJoin, keep: np.ndarray) -> SeedJoin:
    idx = np.nonzero(keep)[0]
    q_counts = np.diff(join.q_start)[idx]
    s_counts = np.diff(join.s_start)[idx]
    qs, q_pos = _csr_gather(join.q_start[idx], q_counts, join.q_pos)
    ss, s_pos = _csr_gather(join.s_start[idx], s_counts, join.s_pos)
    return SeedJoin(join.keys[idx], qs, q_pos, ss, s_pos)


# ---------------------------------------------------------------------------
# Stage 1: fingerprint (hamming) filter
# ---------------------------------------------------------------------------

def expand_pairs(join: SeedJoin):
    """Cartesian expansion of each seed group into candidate (qpos, spos),
    fully vectorized (queries outer, subjects inner like the reference
    kernel.h:29-50)."""
    q_counts = np.diff(join.q_start)
    s_counts = np.diff(join.s_start)
    totals = q_counts * s_counts
    n = int(totals.sum())
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    pair_starts = np.zeros(len(totals) + 1, dtype=np.int64)
    np.cumsum(totals, out=pair_starts[1:])
    grp = np.repeat(np.arange(len(totals), dtype=np.int64), totals)
    within = np.arange(n, dtype=np.int64) - pair_starts[grp]
    sc = s_counts[grp]
    qp = join.q_pos[join.q_start[grp] + within // sc]
    sp = join.s_pos[join.s_start[grp] + within % sc]
    return qp, sp


def fingerprints(letters: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """48-byte windows [pos-16, pos+32), soft-mask bits stripped
    (reference finger_print.h:41-49)."""
    offsets = np.arange(-WINDOW_LEFT, -WINDOW_LEFT + FINGERPRINT_LEN, dtype=np.int64)
    win = letters[pos[:, None] + offsets[None, :]]
    return win & LETTER_MASK


def stage1_filter(q_letters, s_letters, qp, sp, hamming_filter_id: int):
    """Keep pairs whose fingerprint identity count >= cutoff.

    Runs through the native C++ twin when available
    (native/src/stages.cc); the numpy body is the fallback and oracle."""
    if len(qp) == 0:
        return np.zeros(0, dtype=bool)
    from diamond_tpu_torch import native

    r = native.stage1_filter_native(
        q_letters, s_letters, np.ascontiguousarray(qp, dtype=np.int64),
        np.ascontiguousarray(sp, dtype=np.int64), int(hamming_filter_id))
    if r is not None:
        return r
    fq = fingerprints(q_letters, qp)
    fs = fingerprints(s_letters, sp)
    matches = (fq == fs).sum(axis=1)
    return matches >= hamming_filter_id


# ---------------------------------------------------------------------------
# Stage 2: ungapped window filter
# ---------------------------------------------------------------------------

def clip_window(letters: np.ndarray, pos: np.ndarray, window: int):
    """Per-position delimiter clipping of [pos-window, pos+window)
    (reference Util::Seq::clip, sequence.h:30-40).

    Returns (left, right) s.t. the window is [pos-left, pos+right) and
    contains no delimiter."""
    from diamond_tpu_torch.constants.alphabet import DELIMITER_LETTER

    if letters.dtype == np.int8 and letters.flags.c_contiguous:
        from diamond_tpu_torch import native

        r = native.clip_window_native(letters, pos, window)
        if r is not None:
            return r
    offs = np.arange(-window, window, dtype=np.int64)
    win = letters[pos[:, None] + offs[None, :]]
    delim = win == DELIMITER_LETTER
    # left clip: distance to nearest delimiter strictly before anchor
    left_region = delim[:, :window][:, ::-1]  # reversed: index 0 = pos-1
    has_l = left_region.any(axis=1)
    first_l = np.argmax(left_region, axis=1)
    left = np.where(has_l, first_l, window)
    right_region = delim[:, window:]
    has_r = right_region.any(axis=1)
    first_r = np.argmax(right_region, axis=1)
    right = np.where(has_r, first_r, window)
    return left.astype(np.int64), right.astype(np.int64)


def stage2_scores(q_letters, s_letters, qp, sp, matrix32: np.ndarray,
                  window: int = 48, clamp: bool = True):
    """Best ungapped segment score on the seed diagonal within the window.

    Query window is delimiter-clipped around the seed start; subject is read
    at the same relative offsets (reference stage2.h:95-100,
    ungapped_align.cpp:244-257).  Kadane with floor 0 and ceiling 255 (the
    int8 SIMD path semantics, dp/ungapped_simd.cpp:32-67)."""
    if len(qp) == 0:
        return np.zeros(0, dtype=np.int32)
    from diamond_tpu_torch import native

    r = native.stage2_scores_native(
        q_letters, s_letters, np.ascontiguousarray(qp, dtype=np.int64),
        np.ascontiguousarray(sp, dtype=np.int64), matrix32, int(window),
        clamp)
    if r is not None:
        return r
    left, right = clip_window(q_letters, qp, window)
    offs = np.arange(-window, window, dtype=np.int64)
    qwin = q_letters[qp[:, None] + offs[None, :]].astype(np.int64) & LETTER_MASK
    swin = s_letters[sp[:, None] + offs[None, :]].astype(np.int64) & LETTER_MASK
    scores = matrix32[qwin, swin]
    inside = (offs[None, :] >= -left[:, None]) & (offs[None, :] < right[:, None])
    scores = np.where(inside, scores, -(10 ** 6))
    # Kadane along axis 1, clamp [0, 255] like saturated int8 biased math
    st = np.zeros(len(qp), dtype=np.int64)
    best = np.zeros(len(qp), dtype=np.int64)
    for j in range(scores.shape[1]):
        st = np.maximum(st + scores[:, j], 0)
        if clamp:
            st = np.minimum(st, 255)
        best = np.maximum(best, st)
    return best.astype(np.int32)


class CutoffTable:
    """query-length-bucketed ungapped score cutoffs
    (reference util/scores/cutoff_table.h:26-46)."""

    def __init__(self, score_matrix, evalue: float):
        self.data = np.zeros(32, dtype=np.int32)
        for b in range(1, 32):
            qlen = 1 << (b - 1)
            bitscore = -np.log(evalue / 1e9 / qlen) / np.log(2.0)
            self.data[b] = score_matrix.rawscore(bitscore)

    def __call__(self, query_len) -> np.ndarray:
        # 32 - clz(len) == bit_length(len), vectorized via log2 on the
        # exact integer (query lengths are < 2^31, exactly representable)
        q = np.asarray(query_len, dtype=np.int64)
        bl = np.where(q > 0,
                      np.floor(np.log2(np.maximum(q, 1))).astype(np.int64) + 1,
                      0)
        return self.data[bl]


def unreduced_complexity_filter(letters, pos, shape, cut: float):
    """Per-position seed complexity on the UNREDUCED 20-letter alphabet
    (reference seed_complexity.cpp:53-75 seed_is_complex_unreduced, applied
    at enumeration): positions sampling any non-AA letter or with entropy
    below the cut are dropped (and seed-masked).  Returns keep bool mask."""
    from diamond_tpu_torch.constants.alphabet import TRUE_AA

    if len(pos) == 0:
        return np.ones(0, dtype=bool)
    win = letters[pos[:, None] + shape.positions[None, :].astype(np.int64)]
    win = win.astype(np.int64) & LETTER_MASK
    ok = (win < TRUE_AA).all(axis=1)
    w = np.where(win < TRUE_AA, win, 0)
    counts = np.zeros((len(pos), TRUE_AA), dtype=np.int64)
    for i in range(shape.weight):
        np.add.at(counts, (np.arange(len(pos)), w[:, i]), 1)
    entropy = _LNFACT[shape.weight] - _LNFACT[counts].sum(axis=1)
    return ok & (entropy >= cut)


def minimizer_select(ekeys, valid, window: int):
    """Window-minimizer seed selection over the VALID seeds (reference
    seed_iterator.h:52-110 MinimizerIterator: windows count valid seeds,
    the first murmur-minimal seed per window is kept, and consecutive
    windows sharing the same minimal seed VALUE collapse to one entry).
    Returns indices into the original position array."""
    from numpy.lib.stride_tricks import sliding_window_view

    from diamond_tpu_torch.cluster.linclust import murmur64

    vpos = np.nonzero(valid)[0]
    if len(vpos) < window:
        return np.zeros(0, dtype=np.int64)
    vk = ekeys[vpos]
    h = murmur64(vk)
    win = sliding_window_view(h, window)
    arg = win.argmin(axis=1) + np.arange(len(win))
    kmin = vk[arg]
    keep = np.ones(len(arg), dtype=bool)
    keep[1:] = kmin[1:] != kmin[:-1]
    return vpos[arg[keep]]
