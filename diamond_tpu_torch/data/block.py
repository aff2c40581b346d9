"""In-memory sequence block.

TPU-native equivalent of the reference Block/SequenceSet (reference
src/data/block/block.h:30-132, src/data/string_set.h).  Sequences live in one
concatenated int8 numpy array with the same perimeter/delimiter layout as the
reference (256 delimiter bytes at both ends, one delimiter byte after every
sequence) so window-based kernels (48-byte fingerprints, 96-wide ungapped
scans) read identical bytes across sequence boundaries.

The concatenated array ships to the device once per block; per-kernel views
are gathers into it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.constants.alphabet import DELIMITER_LETTER, encode

PERIMETER_PADDING = 256


def _bulk_copy(letters, starts, seqs, lengths) -> bool:
    """Vectorized fill for sequence lists that are all views into one
    shared int8 base buffer (the read_dmnd strip_mask load): instead of a
    million small slice copies, one chunked fancy-gather/scatter moves
    every letter.  Returns False when the layout doesn't apply (mixed
    sources, strings, non-contiguous views)."""
    n = len(seqs)
    if n < 4096 or not isinstance(seqs[0], np.ndarray):
        return False
    base = seqs[0].base
    if base is None or base.dtype != np.int8 or base.ndim != 1 \
            or not base.flags.c_contiguous:
        return False
    if not all(isinstance(s, np.ndarray) and s.base is base
               and s.ndim == 1 and s.flags.c_contiguous for s in seqs):
        return False
    addr0 = base.__array_interface__["data"][0]
    src0 = np.fromiter(
        (s.__array_interface__["data"][0] for s in seqs),
        dtype=np.int64, count=n) - addr0
    if (src0 < 0).any() or (src0 + lengths > len(base)).any():
        return False
    lengths64 = lengths.astype(np.int64)
    from diamond_tpu_torch import native

    l = native.lib()
    if l is not None:
        src0 = np.ascontiguousarray(src0)
        dst = np.ascontiguousarray(starts, dtype=np.int64)
        l.block_fill(base.ctypes.data, src0.ctypes.data, dst.ctypes.data,
                     lengths64.ctypes.data, n, letters.ctypes.data)
        return True
    # numpy fallback: chunked fancy gather/scatter (~0.5 GB transient)
    CHUNK = 32 << 20
    cum = np.concatenate([[0], np.cumsum(lengths64)])
    k0 = 0
    while k0 < n:
        k1 = int(np.searchsorted(cum, cum[k0] + CHUNK, "left"))
        k1 = min(max(k1, k0 + 1), n)
        L = int(cum[k1] - cum[k0])
        rel = np.arange(L, dtype=np.int64)
        off = np.repeat(np.arange(k0, k1), lengths64[k0:k1])
        rel -= (cum[k0:k1] - cum[k0])[off - k0]
        letters[starts[off] + rel] = base[src0[off] + rel]
        k0 = k1
    return True


@dataclass
class Block:
    letters: np.ndarray          # int8 concatenated, padded
    starts: np.ndarray           # int64 start offset of each sequence in letters
    lengths: np.ndarray          # int32
    ids: list                    # full header strings
    soft_mask_backup: np.ndarray | None = None   # original letters for soft-masked ranges
    unmasked: np.ndarray | None = None           # copy of letters before hard masking
    _mask_ranges: list = field(default_factory=list)

    @classmethod
    def from_sequences(cls, seqs: list, ids: list, nucleotide: bool = False) -> "Block":
        n = len(seqs)
        lengths = np.array([len(s) for s in seqs], dtype=np.int32)
        total = PERIMETER_PADDING * 2 + int(lengths.sum()) + n
        letters = np.full(total, DELIMITER_LETTER, dtype=np.int8)
        starts = np.empty(n, dtype=np.int64)
        if n:
            starts[0] = PERIMETER_PADDING
            np.cumsum(lengths[:-1].astype(np.int64) + 1, out=starts[1:])
            starts[1:] += PERIMETER_PADDING
        if _bulk_copy(letters, starts, seqs, lengths):
            return cls(letters=letters, starts=starts, lengths=lengths,
                       ids=list(ids))
        pos = PERIMETER_PADDING
        for i, s in enumerate(seqs):
            e = s if isinstance(s, np.ndarray) else encode(s, nucleotide)
            letters[pos : pos + len(e)] = e
            pos += len(e) + 1  # delimiter after each sequence
        return cls(letters=letters, starts=starts, lengths=lengths, ids=list(ids))

    def __len__(self) -> int:
        return len(self.starts)

    @property
    def n_letters(self) -> int:
        return int(self.lengths.sum())

    def seq(self, i: int) -> np.ndarray:
        s = self.starts[i]
        return self.letters[s : s + self.lengths[i]]

    _ID_DELIMITERS = " \a\b\f\n\r\t\v\x01"

    def seq_id(self, i: int) -> str:
        """First token of the header, cut at the reference's id delimiter set
        (reference util/sequence/sequence.cpp:37)."""
        title = self.ids[i]
        cut = len(title)
        for d in self._ID_DELIMITERS:
            p = title.find(d)
            if p != -1:
                cut = min(cut, p)
        return title[:cut]

    def global_to_local(self, pos: np.ndarray):
        """Map concatenated offsets -> (seq_index, offset_in_seq).

        Replaces the reference PackedLoc -> local_position binary search
        (reference src/data/sequence_set.h local_position)."""
        pos = np.asarray(pos, dtype=np.int64)
        idx = np.searchsorted(self.starts, pos, side="right") - 1
        return idx.astype(np.int32), (pos - self.starts[idx]).astype(np.int32)

    def save_unmasked(self):
        self.unmasked = self.letters.copy()

    def seq_bounds(self):
        """Per-letter-position (sequence end offset, sequence length) arrays
        over the concatenated layout; 0 at padding/delimiter positions.
        Lets whole-block kernels mask windows that cross sequence bounds in
        one vector op instead of a per-sequence loop.  Cached (the layout
        never changes after construction)."""
        cached = getattr(self, "_seq_bounds", None)
        if cached is not None:
            return cached
        # per-sequence slice fills: no multi-hundred-MB index temporaries
        # (a np.repeat-based expansion thrashes under memory reclaim)
        seq_end = np.zeros(len(self.letters), dtype=np.int64)
        seq_len = np.zeros(len(self.letters), dtype=np.int64)
        starts = self.starts
        lens = self.lengths
        for i in range(len(self)):
            s = starts[i]
            L = lens[i]
            seq_end[s : s + L] = s + L
            seq_len[s : s + L] = L
        self._seq_bounds = (seq_end, seq_len)
        return self._seq_bounds

    def length_sorted(self):
        """Copy with sequences ordered by (length desc, block id desc) —
        used by linearized stage-1 rounds so the kept seed occurrence
        belongs to the longest sequence (reference block.cpp:229-254
        Block::length_sorted, greater<pair<Loc, BlockId>>).

        Returns (sorted_block, order) with order[i_sorted] = original id."""
        order = sorted(range(len(self)),
                       key=lambda i: (-int(self.lengths[i]), -i))
        b = Block.from_sequences([self.seq(i).copy() for i in order],
                                 [self.ids[i] for i in order])
        return b, order
