"""BLAST pairwise (-f 0) and PAF (-f paf) output formats.

Reference: src/output/blast_pairwise_format.cpp, src/output/paf_format.cpp.
"""
from __future__ import annotations

import math

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_ALPHABET
from diamond_tpu_torch.output.format import format_double, print_e

WIDTH = 60


def _pct(x: int, y: int) -> int:
    return x * 100 // y if y else 0


def _expand_transcript(hsp, query, target):
    """(qchars, midline, schars, qpos list, spos list) from the transcript."""
    q, mid, s = [], [], []
    qp, sp = [], []
    i, j = hsp.query_range[0], hsp.subject_range[0]
    from diamond_tpu_torch.stats.score_matrix import get_matrix  # default midline matrix

    for op, val in hsp.transcript:
        if op == "M":
            c = AMINO_ACID_ALPHABET[int(query[i]) & 31]
            q.append(c)
            mid.append(c)
            s.append(AMINO_ACID_ALPHABET[int(target[j]) & 31])
            qp.append(i)
            sp.append(j)
            i += 1
            j += 1
        elif op == "S":
            qc = AMINO_ACID_ALPHABET[int(query[i]) & 31]
            sc = AMINO_ACID_ALPHABET[val & 31]
            q.append(qc)
            s.append(sc)
            mid.append("+" if _midline_positive(query[i], target[j]) else " ")
            qp.append(i)
            sp.append(j)
            i += 1
            j += 1
        elif op == "I":
            for _ in range(val):
                q.append(AMINO_ACID_ALPHABET[int(query[i]) & 31])
                mid.append(" ")
                s.append("-")
                qp.append(i)
                sp.append(j)
                i += 1
        else:  # D
            q.append("-")
            mid.append(" ")
            s.append(AMINO_ACID_ALPHABET[val & 31])
            qp.append(i)
            sp.append(j)
            j += 1
    return q, mid, s, qp, sp


_MIDLINE_MATRIX = None


def _midline_positive(a, b) -> bool:
    global _MIDLINE_MATRIX
    if _MIDLINE_MATRIX is None:
        from diamond_tpu_torch.stats.score_matrix import get_matrix

        _MIDLINE_MATRIX = get_matrix("BLOSUM62").matrix32
    return int(_MIDLINE_MATRIX[int(a) & 31, int(b) & 31]) > 0


def set_midline_matrix(matrix32):
    global _MIDLINE_MATRIX
    _MIDLINE_MATRIX = matrix32


def pairwise_header() -> str:
    return "BLASTP 2.3.0+\n\n\n"


def pairwise_query_intro(query_title: str, query_len: int, unaligned: bool) -> str:
    s = f"Query= {query_title}\n\nLength={query_len}\n\n"
    if unaligned:
        s += "\n***** No hits found *****\n\n\n"
    return s


def pairwise_match(hsp, query, target, target_title: str, target_len: int) -> str:
    out = []
    out.append(">" + target_title)
    out.append(f"Length={target_len}")
    out.append("")
    out.append(f" Score = {format_double(hsp.bit_score)} bits ({hsp.score}),"
               f"  Expect = {print_e(hsp.evalue)}")
    ln = hsp.length
    out.append(
        f" Identities = {hsp.identities}/{ln} ({_pct(hsp.identities, ln)}%), "
        f"Positives = {hsp.positives}/{ln} ({_pct(hsp.positives, ln)}%), "
        f"Gaps = {hsp.gaps}/{ln} ({_pct(hsp.gaps, ln)}%)")
    out.append("")

    q, mid, s, qp, sp = _expand_transcript(hsp, query, target)
    digits = max(int(math.ceil(math.log10(hsp.subject_range[1]))) if hsp.subject_range[1] > 1 else 1,
                 int(math.ceil(math.log10(hsp.query_range[1]))) if hsp.query_range[1] > 1 else 1)
    k = 0
    n = len(q)
    while k < n:
        e = min(k + WIDTH, n)
        q_begin = qp[k] + 1
        # end position: next unconsumed query position (0-based) == 1-based last
        q_end = (qp[e - 1] + (0 if q[e - 1] == "-" else 1))
        s_begin = sp[k] + 1
        s_end = (sp[e - 1] + (0 if s[e - 1] == "-" else 1))
        out.append(f"Query  {q_begin:>{digits}}  " + "".join(q[k:e]) + f" {q_end}")
        out.append(" " * (digits + 9) + "".join(mid[k:e]))
        out.append(f"Sbjct  {s_begin:>{digits}}  " + "".join(s[k:e]) + f" {s_end}")
        out.append("")
        k = e
    return "\n".join(out) + "\n"


def paf_match(query_name: str, target_name: str, hsp, query_source_len: int,
              subject_len: int, bitscore_fn) -> str:
    strand = "+" if hsp.frame < 3 else "-"
    return (f"{query_name}\t{query_source_len}\t{hsp.query_range[0]}\t"
            f"{hsp.query_range[1] - 1}\t{strand}\t{target_name}\t{subject_len}\t"
            f"{hsp.subject_range[0]}\t{hsp.subject_range[1] - 1}\t"
            f"{hsp.identities}\t{hsp.length}\t255\t"
            f"AS:i:{int(bitscore_fn(hsp.score))}\tZR:i:{hsp.score}\t"
            f"ZE:f:{print_e(hsp.evalue)}")
