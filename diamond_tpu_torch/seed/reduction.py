"""Reduced amino-acid alphabets for seeding.

Reference: src/basic/reduction.h, src/basic/basic.cpp:267-296,
src/stats/stats.cpp:48-51.  The reduction is a 256-entry int8 lookup so a
whole block reduces with one numpy/jax gather.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.constants.alphabet import (
    DELIMITER_LETTER,
    MASK_LETTER,
    STOP_LETTER,
    encode,
)


class Reduction:
    def __init__(self, definition: str):
        self.definition = definition
        buckets = definition.split()
        self.size = len(buckets)
        self.bit_size_exact = np.log2(self.size)
        self.bit_size = int(np.ceil(self.bit_size_exact))
        # map_ covers indices 0..255; masked/stop letters map to MASK_LETTER
        # (so seed extraction can reject them), everything unset maps to 0
        # like the reference's memset (reference basic.cpp:269).
        m = np.zeros(256, dtype=np.int8)
        m[MASK_LETTER] = MASK_LETTER
        m[STOP_LETTER] = MASK_LETTER
        for b, token in enumerate(buckets):
            for ch in token:
                m[int(encode(ch)[0])] = b
        self.map = m

    def __call__(self, letters: np.ndarray) -> np.ndarray:
        """Reduce letters; any letter with high bits set (soft/seed mask) or
        X/stop reduces to MASK_LETTER so it can never form a seed."""
        letters = np.asarray(letters)
        out = self.map[letters.astype(np.uint8)]
        # letters with bit 7 (seed mask) or out-of-range map to MASK
        out = np.where(letters >= 0, out, MASK_LETTER)
        out = np.where(letters == DELIMITER_LETTER, MASK_LETTER, out)
        return out

    def __repr__(self):
        return f"Reduction({self.definition!r}, size={self.size})"


MURPHY10 = Reduction("A KR EDNQ C G H ILVM FYW P ST")
STEINEGGER12 = Reduction("AST C DN EQ FY G H IV KR LM P W")
NO_REDUCTION = Reduction("A S T C D N E Q F Y G H I V K R L M P W")
DNA = Reduction("A C G T")
