"""Spaced seed shapes and per-sensitivity shape codes.

Reference: src/basic/shape.h:29-60, src/search/setup.cpp:80-304.
"""
from __future__ import annotations

import numpy as np

MAX_SHAPE_LEN = 19


class Shape:
    def __init__(self, code: str):
        if len(code) > 32:
            raise ValueError("Shape length > 32 not supported")
        self.code = code
        self.length = len(code)
        self.positions = np.array([i for i, c in enumerate(code) if c == "1"],
                                  dtype=np.int32)
        self.weight = len(self.positions)
        # bitmask with bit i set when position i is sampled (LSB = first pos,
        # matching reference shape.h mask_ built from rev_comp ordering used
        # by the pattern matcher: bit 0 = leftmost seed position)
        self.mask = 0
        for i, c in enumerate(code):
            if c == "1":
                self.mask |= 1 << i

    def __len__(self):
        return self.length

    def __repr__(self):
        return f"Shape({self.code})"

    def extract_seeds(self, reduced: np.ndarray, base: int):
        """Seed keys at every start position of a reduced letter array.

        Returns (keys uint64, valid bool) of length len(reduced)-length+1.
        A position is valid when none of the sampled letters is MASK (>=
        base is treated as masked).  Key packing is plain base-`base`
        big-endian over sampled positions — equality-compatible with the
        reference's even/odd packing (reference shape.h:114-150), which only
        permutes the key space.
        """
        L = len(reduced)
        n = L - self.length + 1
        if n <= 0:
            return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
        if reduced.dtype == np.int8 and reduced.flags.c_contiguous:
            from diamond_tpu_torch import native

            pos = getattr(self, "_pos64", None)
            if pos is None:
                pos = np.ascontiguousarray(self.positions, dtype=np.int64)
                self._pos64 = pos
            r = native.extract_seeds_native(reduced, n, pos, self.weight,
                                            base)
            if r is not None:
                return r
        r = reduced.astype(np.int64)
        keys = np.zeros(n, dtype=np.int64)
        valid = np.ones(n, dtype=bool)
        for p in self.positions:
            w = r[p : p + n]
            valid &= (w >= 0) & (w < base)
            keys = keys * base + np.where(w < base, w, 0)
        return keys.astype(np.uint64), valid


class ShapeConfig:
    def __init__(self, codes, count: int = 0):
        codes = list(codes)
        if count and count < len(codes):
            codes = codes[:count]
        self.shapes = [Shape(c) for c in codes]

    def __getitem__(self, i) -> Shape:
        return self.shapes[i]

    def __len__(self):
        return len(self.shapes)

    def patterns(self, begin: int, end: int):
        """Shape masks for the left-most filter PatternMatcher
        (reference shape_config.h patterns())."""
        return [s.mask for s in self.shapes[begin:end]]


# Shape codes per sensitivity (reference search/setup.cpp:80-304).
SHAPE_CODES = {
    "default": ["111101110111", "111011010010111"],
    "fast": ["1101110101101111"],
    "faster": ["1101110101101111"],
    "mid-sensitive": [
        "11110110111", "1101100111101", "1110010101111", "11010101100111",
        "11101110001011", "1110100100010111", "1101000011010111",
        "1110011000011011",
    ],
    "sensitive": [
        "1011110111", "110100100010111", "11001011111", "101110001111",
        "11011101100001", "1111010010101", "111001001001011", "10101001101011",
        "111101010011", "1111000010000111", "1100011011011", "1101010000011011",
        "1110001010101001", "110011000110011", "11011010001101", "1101001100010011",
    ],
    "shapes-6x10": [
        "10111111111", "111110110111", "1101110111011", "111111101011",
        "1111011110011", "111111100100011",
    ],
    "shapes-30x10": [
        "10111111111", "111110110111", "1101110111011", "111111101011",
        "1111011110011", "111111100100011", "110111010011011", "1111100110010011",
        "11101100111101", "111011011010101", "11011010101111", "11111110000010011",
        "11011001100110011", "101011100011111", "111011111101", "111110101100101",
        "1111010101001011", "11100111011001001", "1110110001111001",
        "110111011000010011", "11001100101100111", "11111000000111101",
        "11011110011010001", "110101101010011001", "111010111000010101",
        "1111101000100010011", "11010100100111011", "101001111100111",
        "101110010001010111", "11001101001011011",
    ],
    "very-sensitive": [
        "11101111", "110110111", "111111001", "1010111011", "11110001011",
        "110100101011", "110110001101", "1010101000111", "1100101001011",
        "1101010101001", "1110010010011", "110110000010011", "111001000100011",
        "1101000100010011",
    ],
    "ultra-sensitive": [
        "1111111", "11101111", "110011111", "110110111", "111111001",
        "1010111011", "1011110101", "1111000111", "10011110011", "10101101101",
        "10111010101", "11001010111", "11001100111", "11010101101", "11110001011",
        "100111010011", "101100110101", "101110000111", "110100101011",
        "110110001101", "111000110011", "1010001011011", "1010101000111",
        "1010110100011", "1100100110011", "1100101001011", "1101001100101",
        "1101010101001", "1110001010101", "1110010010011", "10100001101101",
        "11000100010111", "11010000100111", "11010100110001", "11101000011001",
        "11110000001101", "11110100000011", "101001000001111", "110000100101011",
        "110010010000111", "110101100001001", "110110000010011", "111001000100011",
        "111100000100101", "1000110010010101", "1001000100101101", "1001000110011001",
        "1010001001001011", "1010001010010011", "1010010001010101", "1010010100010011",
        "1010010101001001", "1010100000101011", "1010100011000101", "1011000010001011",
        "1100010000111001", "1100010010001011", "1100100001001011", "1100100100100011",
        "1100110000001101", "1101000100010011", "1101000110000101", "1110000001010011",
        "1110100000010101",
    ],
    "linclust-20": [
        "111111111111", "1111111011111", "1111110111111", "11111111010111",
        "11011101111111", "11111011110111", "11110011111111", "11101111101111",
        "11110111111011", "110111110110111", "111101111011011", "111101100111111",
        "111010111110111", "111101011101111", "111110110011111", "111011101011111",
        "111111010011111", "111111001111011", "111110101101111", "111011110101111",
        "1110101110011111", "1111100110110111", "1110111001101111", "1111110010101111",
        "1111001010111111", "1110101101110111", "1110110111001111", "1110110101110111",
        "1111010101101111", "1111011011010111",
    ],
    "linclust-40": [
        "111111111111", "1111111011111", "1111110111111", "11111111010111",
        "11011101111111", "11111011110111", "11110011111111", "11101111101111",
        "11110111111011", "110111110110111", "111101111011011", "111101100111111",
        "111010111110111", "111101011101111", "111110110011111",
    ],
}
SHAPE_CODES["more-sensitive"] = SHAPE_CODES["sensitive"]
