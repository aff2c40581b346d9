"""Motif soft-masking: abundant conserved 8-mers excluded from seeding.

Reference: src/masking/motifs.cpp (table of 1000 8-mers),
src/masking/masking.cpp:112-131 (mask_motifs).  The motif regions are
hard-masked (X) during seed enumeration only, then restored — implemented
here by returning mask ranges which Block applies/removes around seeding.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from diamond_tpu_torch.constants.alphabet import TRUE_AA, encode

MOTIF_LEN = 8
MAX_MOTIF_LEN_DEFAULT = 30  # config.max_motif_len


@lru_cache(maxsize=1)
def motif_keys() -> np.ndarray:
    """The motif 8-mers as packed base-20 keys, sorted for searchsorted."""
    path = os.path.join(os.path.dirname(__file__), "motifs_data.txt")
    keys = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            e = encode(s).astype(np.int64)
            k = 0
            for l in e:
                k = k * TRUE_AA + int(l)
            keys.append(k)
    return np.unique(np.array(keys, dtype=np.int64))


def find_motif_ranges(letters: np.ndarray, max_motif_len: int = MAX_MOTIF_LEN_DEFAULT):
    """Mask ranges for one sequence (reference mask_motifs).

    Returns a list of (begin, end) ranges to hard-mask for seeding. Ranges
    are merged like Mask::Ranges::push_back; a merged range longer than
    max_motif_len is dropped; if total motif cover >= 50% of the sequence,
    nothing is masked."""
    L = len(letters)
    if L < MOTIF_LEN:
        return []
    lets = np.asarray(letters).astype(np.int64)
    if (lets < 0).any() or (lets >= TRUE_AA).any():
        valid_kmer = np.ones(L - MOTIF_LEN + 1, dtype=bool)
        for i in range(MOTIF_LEN):
            w = lets[i : i + L - MOTIF_LEN + 1]
            valid_kmer &= (w >= 0) & (w < TRUE_AA)
    else:
        valid_kmer = np.ones(L - MOTIF_LEN + 1, dtype=bool)
    keys = np.zeros(L - MOTIF_LEN + 1, dtype=np.int64)
    for i in range(MOTIF_LEN):
        w = np.clip(lets[i : i + L - MOTIF_LEN + 1], 0, TRUE_AA - 1)
        keys = keys * TRUE_AA + w
    table = motif_keys()
    idx = np.searchsorted(table, keys)
    hit = valid_kmer & (idx < len(table)) & (table[np.clip(idx, 0, len(table) - 1)] == keys)
    starts = np.nonzero(hit)[0]
    if len(starts) == 0:
        return []
    # merge overlapping [s, s+8) ranges
    ranges = []
    cur_b, cur_e = int(starts[0]), int(starts[0]) + MOTIF_LEN
    for s in starts[1:]:
        s = int(s)
        if s <= cur_e:
            cur_e = s + MOTIF_LEN
        else:
            ranges.append((cur_b, cur_e))
            cur_b, cur_e = s, s + MOTIF_LEN
    ranges.append((cur_b, cur_e))
    total = sum(e - b for b, e in ranges)
    if total / L >= 0.5:
        return []
    return [(b, e) for b, e in ranges if e - b <= max_motif_len]


_MOTIF_SHAPE = None


def find_motif_starts_block(block) -> np.ndarray:
    """Global start positions of motif 8-mer hits over a whole block in one
    pass (same hit set as per-sequence find_motif_ranges before the
    merge/length/50% rules, which remain per sequence)."""
    global _MOTIF_SHAPE
    from diamond_tpu_torch.seed.shapes import Shape

    if _MOTIF_SHAPE is None:
        _MOTIF_SHAPE = Shape("1" * MOTIF_LEN)
    letters = np.asarray(block.letters)
    n = len(letters) - MOTIF_LEN + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    if letters.dtype == np.int8 and letters.flags.c_contiguous:
        from diamond_tpu_torch import native

        r = native.motif_scan_native(letters, block.starts, block.lengths,
                                     motif_keys(), TRUE_AA)
        if r is not None:
            return r
    keys, valid = _MOTIF_SHAPE.extract_seeds(letters, TRUE_AA)
    keys = keys.astype(np.int64)
    table = motif_keys()
    idx = np.searchsorted(table, keys)
    np.minimum(idx, len(table) - 1, out=idx)
    hit = valid & (table[idx] == keys)
    seq_end, _ = block.seq_bounds()
    pos = np.nonzero(hit)[0]
    return pos[pos + MOTIF_LEN <= seq_end[pos]]


def merge_motif_ranges(starts, L: int,
                       max_motif_len: int = MAX_MOTIF_LEN_DEFAULT):
    """Range merge + length/coverage rules for one sequence's LOCAL motif
    start positions (identical to the tail of find_motif_ranges)."""
    if len(starts) == 0:
        return []
    ranges = []
    cur_b, cur_e = int(starts[0]), int(starts[0]) + MOTIF_LEN
    for s in starts[1:]:
        s = int(s)
        if s <= cur_e:
            cur_e = s + MOTIF_LEN
        else:
            ranges.append((cur_b, cur_e))
            cur_b, cur_e = s, s + MOTIF_LEN
    ranges.append((cur_b, cur_e))
    total = sum(e - b for b, e in ranges)
    if total / L >= 0.5:
        return []
    return [(b, e) for b, e in ranges if e - b <= max_motif_len]
