"""Amino-acid / nucleotide alphabets and sequence encoding.

TPU-native re-design of the reference alphabet model (reference
src/basic/value.h:53-136).  Letters are encoded as small integers so whole
blocks of sequences live in int8 device arrays; the soft-mask flag is stored
in bit 5 exactly like the reference so masked letters compare unequal in
seed space but can be stripped with a cheap ``& 31``.
"""
from __future__ import annotations

import numpy as np

AMINO_ACID_ALPHABET = "ARNDCQEGHILKMFPSTWYVBJZX*_"
AMINO_ACID_COUNT = len(AMINO_ACID_ALPHABET)  # 26
NUCLEOTIDE_ALPHABET = "ACGTN"

MASK_LETTER = 23          # 'X'
STOP_LETTER = 24          # '*'
SUPER_HARD_MASK = 25      # '_'
DELIMITER_LETTER = 31
LETTER_MASK = 31          # strip soft-mask bit
SEED_MASK = -128          # int8 sign bit marks seed-masked positions
TRUE_AA = 20

# Row-major char -> letter lookup (uint8 -> int8); invalid = -1.
_INVALID = -1


def _build_char_map(alphabet: str, mask_char: int, extra: dict[str, int]) -> np.ndarray:
    m = np.full(256, _INVALID, dtype=np.int8)
    for i, c in enumerate(alphabet):
        m[ord(c)] = i
        m[ord(c.lower())] = i
    for c, v in extra.items():
        m[ord(c)] = v
        m[ord(c.lower())] = v
    return m


# Reference maps [UO-] and all other IUPAC oddities: value.cpp maps 'U' and
# 'O' to mask, '-' to mask as well ("X" class mask_chars).
AMINO_CHAR_MAP = _build_char_map(
    AMINO_ACID_ALPHABET,
    MASK_LETTER,
    {"U": MASK_LETTER, "O": MASK_LETTER, "-": MASK_LETTER},
)

NUCLEOTIDE_CHAR_MAP = _build_char_map(
    NUCLEOTIDE_ALPHABET,
    4,
    {
        "M": 4, "R": 4, "W": 4, "S": 4, "Y": 4, "K": 4, "V": 4,
        "H": 4, "D": 4, "B": 4, "X": 4,
    },
)


def encode(seq: bytes | str, nucleotide: bool = False) -> np.ndarray:
    """Encode an ASCII sequence into int8 letters."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    table = NUCLEOTIDE_CHAR_MAP if nucleotide else AMINO_CHAR_MAP
    out = table[arr]
    if (out == _INVALID).any():
        bad = chr(int(arr[(out == _INVALID).argmax()]))
        raise ValueError(f"Invalid character in sequence: {bad!r}")
    return out


def decode(letters: np.ndarray, nucleotide: bool = False) -> str:
    alphabet = NUCLEOTIDE_ALPHABET if nucleotide else AMINO_ACID_ALPHABET
    table = np.frombuffer(alphabet.encode(), dtype=np.uint8)
    return table[np.asarray(letters, dtype=np.int64) & LETTER_MASK].tobytes().decode()


def letter_mask(x: np.ndarray) -> np.ndarray:
    """Strip the soft-mask bit (bit 5), like reference letter_mask (value.h:105)."""
    return x & LETTER_MASK


def is_amino_acid(x: np.ndarray) -> np.ndarray:
    return (x != MASK_LETTER) & (x != DELIMITER_LETTER) & (x != STOP_LETTER)
