"""Numeric text formatting matching BLAST/reference conventions.

Reference: src/util/string/string.h:87-92 (format_double),
src/util/text_buffer.h:238-246 (print_e).
"""
from __future__ import annotations

import math


def _llround(f: float) -> int:
    """C llround: round half away from zero."""
    return int(math.floor(f + 0.5)) if f >= 0 else int(math.ceil(f - 0.5))


def format_double(x: float) -> str:
    """BLAST-compatible float: >=100 floors to integer, else one decimal."""
    if x >= 100.0:
        return str(int(math.floor(x)))
    i = _llround(x * 10.0)
    sign = "-" if i < 0 else ""
    i = abs(i)
    return f"{sign}{i // 10}.{i % 10}"


def print_e(x: float) -> str:
    """E-value format: 0.0 or %.2e."""
    if x == 0.0:
        return "0.0"
    return f"{x:.2e}"
