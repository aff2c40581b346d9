"""Vectorized left-most seed dedup filter.

Batch form of diamond_tpu.search.left_most (reference
src/search/left_most.h:31-110): all per-hit window extractions, reduced
matches, pattern-matcher lookups and fingerprint verifications run as flat
numpy array ops over the whole hit batch — the layout that also maps to a
device kernel.  The scalar module remains as the oracle.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.constants.alphabet import (
    DELIMITER_LETTER,
    LETTER_MASK,
    MASK_LETTER,
    STOP_LETTER,
    TRUE_AA,
)

WINDOW_LEFT = 16
WINDOW_RIGHT = 32
WIN = WINDOW_LEFT + 1 + WINDOW_RIGHT  # 49


class BatchPatternMatcher:
    """Vectorized PatternMatcher.hit over hit batches."""

    def __init__(self, patterns):
        patterns = list(patterns)
        self.empty = len(patterns) == 0
        # raw pattern masks for the native bit-parallel matcher
        self.masks = np.asarray(patterns, dtype=np.uint64)
        self.min_len = 32
        max_len = 0
        for p in patterns:
            ln = p.bit_length()
            max_len = max(max_len, ln)
            self.min_len = min(self.min_len, ln)
        if self.empty:
            return
        self.suffix_mask = (1 << max_len) - 1
        s = np.arange(self.suffix_mask + 1, dtype=np.int64)
        table = np.zeros(self.suffix_mask + 1, dtype=bool)
        for p in patterns:
            table |= (s & p) == p
        self.table = table

    def hit(self, h: np.ndarray, length: np.ndarray, max_len: int) -> np.ndarray:
        """h: [N] uint64 match masks; length: [N] window lengths.
        Returns [N] uint64 hit masks."""
        if self.empty:
            return np.zeros(len(h), dtype=np.uint64)
        out = np.zeros(len(h), dtype=np.uint64)
        hh = h.astype(np.uint64).copy()
        end = length.astype(np.int64) - self.min_len + 1
        for i in range(max(0, max_len - self.min_len + 1)):
            idx = (hh & np.uint64(self.suffix_mask)).astype(np.int64)
            bit = self.table[idx] & (i < end)
            out |= bit.astype(np.uint64) << np.uint64(i)
            hh >>= np.uint64(1)
        return out


def _pack_bits(bools: np.ndarray) -> np.ndarray:
    """[N, W] bool -> [N] uint64 with bit i = column i."""
    W = bools.shape[1]
    weights = (np.uint64(1) << np.arange(W, dtype=np.uint64))
    return (bools.astype(np.uint64) * weights[None, :]).sum(axis=1, dtype=np.uint64)


CHUNK = 16384


def left_most_filter_batch(
    q_letters, s_letters, q_seed_mask, reduction,
    qp, sp, seed_offsets, window_lefts, window_rights,
    shape, sid, chunked, current_matcher: BatchPatternMatcher,
    previous_matcher: BatchPatternMatcher,
    part_lo, part_hi, seedp_mask, hamming_filter_id,
) -> np.ndarray:
    """Vectorized filter; returns [N] bool keep flags.

    qp/sp: [N] global seed positions.  window_lefts/rights: delimiter-clipped
    query window extents around the seed (from stage 2).  seed_offsets: local
    query offsets of the seeds.

    Runs through the native C++ single pass when available
    (native/src/leftmost.cc left_most_filter_many); the numpy body below
    is the bit-identical fallback and test oracle, processed in fixed-size
    chunks so its [N, 49] window temporaries stay a few MB (the host's
    proactive memory reclaim stalls large allocations)."""
    N = len(qp)
    if N:
        from diamond_tpu_torch import native

        r = native.left_most_filter_native(
            q_letters, s_letters, q_seed_mask, reduction, qp, sp,
            seed_offsets, window_lefts, window_rights, shape, sid == 0,
            chunked, current_matcher, previous_matcher, part_lo, part_hi,
            seedp_mask, hamming_filter_id)
        if r is not None:
            return r
    if N > CHUNK:
        out = np.empty(N, dtype=bool)
        for lo in range(0, N, CHUNK):
            hi = min(lo + CHUNK, N)
            out[lo:hi] = left_most_filter_batch(
                q_letters, s_letters, q_seed_mask, reduction,
                qp[lo:hi], sp[lo:hi], seed_offsets[lo:hi],
                window_lefts[lo:hi], window_rights[lo:hi],
                shape, sid, chunked, current_matcher, previous_matcher,
                part_lo, part_hi, seedp_mask, hamming_filter_id)
        return out
    if N == 0:
        return np.zeros(0, dtype=bool)
    qp = qp.astype(np.int64)
    sp = sp.astype(np.int64)

    # stage2 window geometry (reference stage2.h:95-105)
    interval_mod = seed_offsets % 32
    overhang = np.maximum(window_lefts - interval_mod, 0)
    # seed offset within the trimmed window
    seed_off = window_lefts - overhang
    win_len0 = window_lefts + window_rights - overhang

    # left_most_filter entry geometry (left_most.h:74-88)
    d = np.maximum(seed_off - WINDOW_LEFT, 0)
    wl = np.minimum(WINDOW_LEFT, seed_off)
    qs = qp - seed_off + d
    ss = sp - seed_off + d
    window = np.minimum(win_len0 - d, wl + 1 + WINDOW_RIGHT)

    # subject-side clip around anchor wl within [0, window)
    offs = np.arange(WIN, dtype=np.int64)
    s_win = s_letters[ss[:, None] + offs[None, :]]
    in_win = offs[None, :] < window[:, None]
    delim = (s_win == DELIMITER_LETTER) & in_win
    rel = offs[None, :] - wl[:, None]
    # first delimiter at/after anchor
    after = delim & (rel >= 0)
    has_after = after.any(axis=1)
    first_after = np.where(has_after, np.argmax(after, axis=1), window)
    # last delimiter before anchor
    before = delim & (rel < 0)
    has_before = before.any(axis=1)
    last_before = np.where(
        has_before, WIN - 1 - np.argmax(before[:, ::-1], axis=1), -1)
    dd = np.where(has_before, last_before + 1, 0)
    qs = qs + dd
    ss = ss + dd
    wl = wl - dd
    window = first_after - dd

    # reduced match + seed mask bits over the clipped window
    max_w = WIN
    offs2 = np.arange(max_w, dtype=np.int64)
    q_win = q_letters[qs[:, None] + offs2[None, :]]
    s_win = s_letters[ss[:, None] + offs2[None, :]]
    valid = offs2[None, :] < window[:, None]
    ql = q_win & LETTER_MASK
    sl = s_win & LETTER_MASK
    is_aa = lambda x: (x != MASK_LETTER) & (x != DELIMITER_LETTER) & (x != STOP_LETTER)
    okm = valid & is_aa(ql) & is_aa(sl) & (
        reduction.map[ql] == reduction.map[sl])
    match_mask = _pack_bits(okm[:, :49])
    smask = q_seed_mask[qs[:, None] + offs2[None, :]] & valid
    query_seed_mask = ~_pack_bits(smask[:, :49])

    len_left = wl + shape.length - 1
    bits_left = (np.uint64(1) << len_left.astype(np.uint64)) - np.uint64(1)
    mm_left = match_mask & bits_left
    qm_left = query_seed_mask & bits_left
    max_len_left = int(len_left.max(initial=0))
    left_hit = current_matcher.hit(mm_left, len_left, max_len_left) & qm_left

    first_shape = sid == 0
    if first_shape and not chunked:
        keep = left_hit == 0
        need = ~keep
        if need.any():
            ver = _verify_batch(q_letters, s_letters, qs[need], ss[need],
                                left_hit[need], mm_left[need], True, shape,
                                reduction, chunked, part_lo, part_hi,
                                seedp_mask, hamming_filter_id)
            keep_n = ~ver
            keep[need] = keep_n
        return keep

    len_right = window - wl - 1
    shift = (wl + 1).astype(np.uint64)
    mm_right = (match_mask >> shift) & np.uint64(0xFFFFFFFF)
    qm_right = (query_seed_mask >> shift) & np.uint64(0xFFFFFFFF)
    right_matcher = current_matcher if chunked else previous_matcher
    max_len_right = int(len_right.max(initial=0))
    right_hit = right_matcher.hit(mm_right, len_right, max_len_right) & qm_right

    keep = np.ones(N, dtype=bool)
    need_l = left_hit != 0
    if need_l.any():
        ver_l = _verify_batch(q_letters, s_letters, qs[need_l], ss[need_l],
                              left_hit[need_l], mm_left[need_l], True, shape,
                              reduction, chunked, part_lo, part_hi,
                              seedp_mask, hamming_filter_id)
        keep[need_l] &= ~ver_l
    need_r = keep & (right_hit != 0)
    if need_r.any():
        off_r = (wl + 1)[need_r]
        ver_r = _verify_batch(q_letters, s_letters, qs[need_r] + off_r,
                              ss[need_r] + off_r, right_hit[need_r],
                              mm_right[need_r], False, shape, reduction,
                              chunked, part_lo, part_hi, seedp_mask,
                              hamming_filter_id)
        keep[need_r] &= ~ver_r
    return keep


def _verify_batch(q_letters, s_letters, qs, ss, hit_bits, match_masks, left,
                  shape, reduction, chunked, part_lo, part_hi, seedp_mask,
                  hamming_filter_id) -> np.ndarray:
    """For each hit, True iff ANY set bit position verifies
    (reference left_most.h:31-60 verify_hit/verify_hits).

    Runs through the native C++ twin when available (early-exits per hit
    on the first verified bit; native/src/leftmost.cc); the numpy body
    below is the bit-identical fallback and test oracle."""
    from diamond_tpu_torch import native

    r = native.leftmost_verify_native(
        q_letters, s_letters,
        np.ascontiguousarray(qs, dtype=np.int64),
        np.ascontiguousarray(ss, dtype=np.int64),
        np.ascontiguousarray(hit_bits, dtype=np.uint64),
        np.ascontiguousarray(match_masks, dtype=np.uint64),
        left, shape, reduction, chunked, part_lo, part_hi, seedp_mask,
        hamming_filter_id)
    if r is not None:
        return r
    N = len(qs)
    # expand (hit, bit) pairs
    hb = hit_bits.astype(np.uint64)
    bit_ar = np.arange(49, dtype=np.uint64)
    bitmat = ((hb[:, None] >> bit_ar[None, :]) & np.uint64(1)).astype(bool)
    rows, bits = np.nonzero(bitmat)
    if len(rows) == 0:
        return np.zeros(N, dtype=bool)
    rows = rows.astype(np.int64)
    bits = bits.astype(np.int64)
    qpos = qs[rows] + bits
    spos = ss[rows] + bits

    ok = np.ones(len(rows), dtype=bool)
    if chunked:
        # when the full shape pattern matches at the position, recompute the
        # seed from subject letters and check its partition is processed
        # in-or-before (left) / strictly-before (right) the current range
        mm = (match_masks[rows].astype(np.uint64) >> bits.astype(np.uint64))
        full = (mm & np.uint64(shape.mask)) == np.uint64(shape.mask)
        if full.any():
            sl = s_letters[spos[full][:, None]
                           + shape.positions[None, :].astype(np.int64)] & LETTER_MASK
            good = (sl < 20).all(axis=1)
            key = np.zeros(int(full.sum()), dtype=np.int64)
            for c in range(shape.weight):
                key = key * reduction.size + reduction.map[np.clip(sl[:, c], 0, 31)]
            part = key & seedp_mask
            bound_ok = (part < part_hi) if left else (part < part_lo)
            # set_seed failure (letter >= 20 at a sampled position) fails the
            # verification outright (reference left_most.h:36-43)
            res = good & bound_ok
            tmp = ok[full]
            tmp &= res
            ok[full] = tmp

    # fingerprint verification
    f_off = np.arange(-WINDOW_LEFT, 32, dtype=np.int64)
    fq = q_letters[qpos[:, None] + f_off[None, :]] & LETTER_MASK
    fs = s_letters[spos[:, None] + f_off[None, :]] & LETTER_MASK
    ident = (fq == fs).sum(axis=1)
    verified = ok & (ident >= hamming_filter_id)

    out = np.zeros(N, dtype=bool)
    np.logical_or.at(out, rows, verified)
    return out
