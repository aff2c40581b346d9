"""Six-frame DNA translation (NCBI genetic codes).

Reference: src/util/sequence/translate.h:25-140, src/basic/basic.cpp:86-140.
Vectorized: one gather per frame over codon index arrays.
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.constants.alphabet import MASK_LETTER, STOP_LETTER, encode

# genetic code tables indexed by NCBI id; codon order TCAG x TCAG x TCAG
CODES = {
    1: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    2: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
    3: "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    4: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    5: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
    6: "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    9: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    10: "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    11: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    12: "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    13: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
    14: "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    16: "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    21: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    22: "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    23: "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    24: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
    25: "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    26: "FFLLSSSSYY**CC*WLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
}

# nucleotide letters: A=0 C=1 G=2 T=3 N=4; reverse complement:
REVERSE = np.array([3, 2, 1, 0, 4], dtype=np.int64)
# mapping nucleotide letter -> index into the TCAG-ordered code string
_IDX = np.array([2, 1, 3, 0], dtype=np.int64)  # A,C,G,T -> 2,1,3,0


class Translator:
    def __init__(self, code_id: int = 1):
        if code_id not in CODES:
            raise ValueError("Invalid genetic code id.")
        code = encode(CODES[code_id])  # amino letters incl. '*'
        lut = np.full((5, 5, 5), MASK_LETTER, dtype=np.int8)
        for i in range(4):
            for j in range(4):
                for k in range(4):
                    lut[i, j, k] = code[_IDX[i] * 16 + _IDX[j] * 4 + _IDX[k]]
        # codons with N resolve when the first two letters determine the AA
        for i in range(4):
            for j in range(4):
                if (lut[i, j, :4] == lut[i, j, 0]).all():
                    lut[i, j, 4] = lut[i, j, 0]
        self.lut = lut

    def translate6(self, dna: np.ndarray):
        """Six frames (reference translate.h:55-103).

        dna: int8 nucleotide letters.  Returns list of 6 int8 arrays:
        frames 0-2 forward with offsets 0,1,2; frames 3-5 on the reverse
        complement with offsets 0,1,2."""
        dna = np.asarray(dna).astype(np.int64)
        L = len(dna)
        if L < 3:
            return [np.zeros(0, dtype=np.int8) for _ in range(6)]
        rev = REVERSE[dna[::-1]]
        out = []
        for strand_seq in (dna, rev):
            for off in range(3):
                n = (L - off) // 3
                c = strand_seq[off : off + n * 3].reshape(n, 3)
                out_f = self.lut[c[:, 0], c[:, 1], c[:, 2]]
                out.append(out_f)
        # reorder: reference order is [fwd0, fwd1, fwd2, rev0, rev1, rev2]
        return out


def min_orf_len(translated_len: int, run_len: int = 0, frame_shift: int = 0) -> int:
    """reference basic/config.h:413-423."""
    if run_len == 0:
        if translated_len < 30 or frame_shift != 0:
            return 1
        return 20 if translated_len < 100 else 40
    return run_len


def find_orfs(seq: np.ndarray, min_len: int) -> np.ndarray:
    """Mask ORFs shorter than min_len between stops
    (reference util/sequence/sequence.cpp:180-197).  In place; returns seq."""
    stops = np.nonzero(seq == STOP_LETTER)[0]
    begin = 0
    for s in stops:
        if s - begin < min_len:
            seq[begin:s] = MASK_LETTER
        begin = s + 1
    if len(seq) - begin < min_len:
        seq[begin:] = MASK_LETTER
    return seq


def oriented_position(pos: int, dna_len: int) -> int:
    return dna_len - 1 - pos


def absolute_interval(q_begin: int, q_end: int, frame: int, dna_len: int):
    """Translated [q_begin, q_end) -> DNA source interval
    (reference translated_position.h:130-136)."""
    offset = frame % 3
    if frame < 3:
        return (q_begin * 3 + offset, q_end * 3 + offset)
    b = oriented_position(q_end * 3 + offset - 1, dna_len)
    e = oriented_position(q_begin * 3 + offset - 1, dna_len)
    return (b, e)
