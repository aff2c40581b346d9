"""Left-most seed dedup filter.

Drops stage-2 hits that an earlier seed window / earlier shape already found
(reference src/search/left_most.h:31-110, util/algo/pattern_matcher.h).
Operates on one hit at a time (numpy scalar ops); hit survivors are few so
this runs on host after the vectorized stage-2 filter.
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


class PatternMatcher:
    """Bit-parallel spaced-pattern suffix matcher
    (reference util/algo/pattern_matcher.h:23-63)."""

    def __init__(self, patterns):
        patterns = list(patterns)
        self.min_len = 32
        max_len = 0
        for p in patterns:
            ln = p.bit_length()
            max_len = max(max_len, ln)
            self.min_len = min(self.min_len, ln)
        self.suffix_mask = (1 << max_len) - 1
        self.table = np.zeros(self.suffix_mask + 1, dtype=np.uint8)
        s = np.arange(self.suffix_mask + 1)
        for p in patterns:
            self.table[(s & p) == p] = 1
        self.empty = len(patterns) == 0

    def hit(self, h: int, length: int) -> int:
        if self.empty or length < self.min_len:
            return 0
        r = 0
        end = length - self.min_len + 1
        mask = self.suffix_mask
        for i in range(end):
            r |= int(self.table[h & mask]) << i
            h >>= 1
        return r


def _is_aa(l):
    return l != MASK_LETTER and l != DELIMITER_LETTER and l != STOP_LETTER


def reduced_match(q: np.ndarray, s: np.ndarray, length: int, reduction) -> int:
    """Bit i set iff q[i], s[i] are amino acids with equal reduction
    (reference sse_dist.h:105-155)."""
    ql = q[:length] & LETTER_MASK
    sl = s[:length] & LETTER_MASK
    ok = (
        (ql != MASK_LETTER) & (ql != DELIMITER_LETTER) & (ql != STOP_LETTER)
        & (sl != MASK_LETTER) & (sl != DELIMITER_LETTER) & (sl != STOP_LETTER)
        & (reduction.map[ql] == reduction.map[sl])
    )
    bits = 0
    for i in np.nonzero(ok)[0]:
        bits |= 1 << int(i)
    return bits


def seed_mask_bits(mask: np.ndarray, length: int) -> int:
    """Bit i set iff query position i carries the seed-mask flag."""
    bits = 0
    for i in np.nonzero(mask[:length])[0]:
        bits |= 1 << int(i)
    return bits


def _clip(letters: np.ndarray, start: int, length: int, anchor: int):
    """Largest delimiter-free subrange of [start, start+length) containing
    start+anchor (reference util/sequence/sequence.h:30-40).
    Returns (new_start, new_length)."""
    a = start + anchor
    begin = start
    end = start + length
    while True:
        seg = letters[begin:end]
        delim = np.nonzero(seg == DELIMITER_LETTER)[0]
        if len(delim) == 0:
            return begin, end - begin
        p = begin + int(delim[0])
        if p >= a:
            return begin, p - begin
        begin = p + 1


def left_most_filter(
    q_letters: np.ndarray,
    s_letters: np.ndarray,
    q_seed_mask: np.ndarray,  # bool per query global position (SEED_MASK bit)
    q_window_start: int,    # global pos of clipped query window start (+overhang)
    s_window_start: int,    # corresponding global subject pos
    q_window_len: int,
    seed_offset: int,       # seed position relative to q_window_start
    seed_len: int,
    current_matcher: PatternMatcher,
    previous_matcher: PatternMatcher,
    first_shape: bool,
    shape,
    reduction,
    chunked: bool,
    part_begin: int,
    part_end: int,
    seedp_mask: int,
    hamming_filter_id: int,
) -> bool:
    """True = keep the hit; False = an earlier window/shape already covers it."""
    d = max(seed_offset - WINDOW_LEFT, 0)
    window_left = min(WINDOW_LEFT, seed_offset)
    qs = q_window_start + d
    ss = s_window_start + d
    window = q_window_len - d
    window = min(window, window_left + 1 + WINDOW_RIGHT)

    # clip the subject window at delimiters around the anchor
    new_ss, new_window = _clip(s_letters, ss, window, window_left)
    dd = new_ss - ss
    qs += dd
    ss += dd
    window_left -= dd
    window = new_window

    q = q_letters[qs : qs + window]
    s = s_letters[ss : ss + window]
    match_mask = reduced_match(q, s, window, reduction)
    query_seed_mask = ~seed_mask_bits(q_seed_mask[qs : qs + window], window)

    len_left = window_left + seed_len - 1
    bits_left = (1 << len_left) - 1
    match_mask_left = bits_left & match_mask
    query_mask_left = bits_left & query_seed_mask
    left_hit = current_matcher.hit(match_mask_left, len_left) & query_mask_left

    def verify_hits(mask: int, qoff: int, match_mask_v: int, left: bool) -> bool:
        shift = 0
        m = mask
        while m != 0:
            i = (m & -m).bit_length() - 1  # ctz
            p = qoff + i + shift
            if _verify_hit(p, match_mask_v >> (i + shift), left):
                return True
            m >>= i + 1
            shift += i + 1
        return False

    def _verify_hit(p: int, match_mask_v: int, left: bool) -> bool:
        if chunked and (shape.mask & match_mask_v) == shape.mask:
            # recompute the seed at this position from SUBJECT letters
            sl = s_letters[ss + p : ss + p + shape.length] & LETTER_MASK
            ok = True
            key = 0
            for pp in shape.positions:
                l = int(sl[pp])
                if l >= 20:
                    ok = False
                    break
                key = key * reduction.size + int(reduction.map[l])
            if not ok:
                # set_seed failure fails this bit outright
                # (reference left_most.h:36-37)
                return False
            part = key & seedp_mask
            if left and not (part < part_end):
                return False
            if not left and not (part < part_begin):
                return False
        # fingerprint verification
        fq = q_letters[qs + p - WINDOW_LEFT : qs + p + 32] & LETTER_MASK
        fs = s_letters[ss + p - WINDOW_LEFT : ss + p + 32] & LETTER_MASK
        return int((fq == fs).sum()) >= hamming_filter_id

    if first_shape and not chunked:
        return left_hit == 0 or not verify_hits(left_hit, 0, match_mask_left, True)

    len_right = window - window_left - 1
    match_mask_right = (match_mask >> (window_left + 1)) & 0xFFFFFFFF
    query_mask_right = (query_seed_mask >> (window_left + 1)) & 0xFFFFFFFF
    right_matcher = current_matcher if chunked else previous_matcher
    right_hit = right_matcher.hit(match_mask_right, len_right) & query_mask_right

    return (left_hit == 0 or not verify_hits(left_hit, 0, match_mask_left, True)) and (
        right_hit == 0
        or not verify_hits(right_hit, window_left + 1, match_mask_right, False)
    )
