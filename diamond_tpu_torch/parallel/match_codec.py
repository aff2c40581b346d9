"""Compact binary codec for cross-process match exchange.

Role: the reference's IntermediateRecord streams (output/output.h:67-95)
— per-hit binary rows plus packed edit transcripts — instead of pickled
Python object graphs.  The distributed full-pipeline search serializes
each shard's matches as a handful of flat numpy arrays (one fixed-width
row per HSP, one int8/int32 blob pair for all transcripts), so the
allgather payload scales with hit volume at ~100 B/HSP instead of
~3 KB/HSP of pickled dataclasses.

Round-trip is exact: decode() rebuilds Match/Hsp objects whose rendered
output is byte-identical to the originals (pinned by
tests/test_distributed.py at 1,000 queries x a split nr_10k).
"""
from __future__ import annotations

import io

import numpy as np

HSP_DTYPE = np.dtype([
    ("gqid", "<i8"), ("goid", "<i8"), ("score", "<i8"),
    ("evalue", "<f8"), ("bit_score", "<f8"),
    ("filter_evalue", "<f8"), ("filter_score", "<i8"),
    ("d_begin", "<i4"), ("d_end", "<i4"),
    ("qr0", "<i4"), ("qr1", "<i4"), ("sr0", "<i4"), ("sr1", "<i4"),
    ("identities", "<i4"), ("mismatches", "<i4"), ("positives", "<i4"),
    ("gap_openings", "<i4"), ("gaps", "<i4"), ("length", "<i4"),
    ("frame", "<i4"), ("mm_stats", "<i4"), ("go_stats", "<i4"),
    ("n_ops", "<i4"), ("flags", "<u4"),
])

_F_BACKTRACED = 1
_F_TRANSCRIPT = 2
_F_MM_STATS = 4
_F_GO_STATS = 8
_F_FIRST = 16          # first HSP of its Match


def encode(local: dict) -> bytes:
    """local: {gqid: [(goid, Match)]} -> compact bytes."""
    from diamond_tpu_torch.ops.banded_swipe import Transcript

    rows = []
    codes_parts = []
    payload_parts = []
    for gqid, items in local.items():
        for goid, m in items:
            for j, h in enumerate(m.hsp):
                flags = (_F_FIRST if j == 0 else 0)
                if h.backtraced:
                    flags |= _F_BACKTRACED
                n_ops = 0
                if h.transcript is not None:
                    flags |= _F_TRANSCRIPT
                    t = h.transcript
                    if not isinstance(t, Transcript):
                        t = _transcript_from_list(t)
                    codes_parts.append(np.asarray(t.codes, dtype=np.int8))
                    payload_parts.append(np.asarray(t.payloads,
                                                    dtype=np.int32))
                    n_ops = len(t.codes)
                if h.mismatches_stats is not None:
                    flags |= _F_MM_STATS
                if h.gap_openings_stats is not None:
                    flags |= _F_GO_STATS
                rows.append((
                    gqid, goid, h.score, h.evalue, h.bit_score,
                    m.filter_evalue, m.filter_score,
                    h.d_begin, h.d_end,
                    h.query_range[0], h.query_range[1],
                    h.subject_range[0], h.subject_range[1],
                    h.identities, h.mismatches, h.positives,
                    h.gap_openings, h.gaps, h.length, h.frame,
                    h.mismatches_stats or 0, h.gap_openings_stats or 0,
                    n_ops, flags))
    arr = np.array(rows, dtype=HSP_DTYPE)
    codes = (np.concatenate(codes_parts) if codes_parts
             else np.zeros(0, dtype=np.int8))
    payloads = (np.concatenate(payload_parts) if payload_parts
                else np.zeros(0, dtype=np.int32))
    buf = io.BytesIO()
    np.savez(buf, rows=arr, codes=codes, payloads=payloads)
    return buf.getvalue()


def _transcript_from_list(ops):
    """[(op_char, count)] -> Transcript (inverse of Transcript._expand,
    which reverses the stored op order)."""
    from diamond_tpu_torch.ops.banded_swipe import _OP_CHARS, Transcript

    inv = {c: i for i, c in enumerate(_OP_CHARS)}
    codes = np.array([inv[c] for c, _n in ops], dtype=np.int8)[::-1]
    payloads = np.array([n for _c, n in ops], dtype=np.int32)[::-1]
    return Transcript(codes.copy(), payloads.copy())


def decode(blob: bytes) -> dict:
    """bytes -> {gqid: [(goid, Match)]} (same grouping order)."""
    from diamond_tpu_torch.align.extend import Hsp, Match
    from diamond_tpu_torch.ops.banded_swipe import Transcript

    data = np.load(io.BytesIO(blob))
    rows = data["rows"]
    codes = data["codes"]
    payloads = data["payloads"]
    out: dict[int, list] = {}
    op_lo = 0
    cur = None
    for r in rows:
        flags = int(r["flags"])
        t = None
        n_ops = int(r["n_ops"])
        if flags & _F_TRANSCRIPT:
            t = Transcript(codes[op_lo : op_lo + n_ops],
                           payloads[op_lo : op_lo + n_ops])
            op_lo += n_ops
        h = Hsp(score=int(r["score"]), evalue=float(r["evalue"]),
                bit_score=float(r["bit_score"]),
                d_begin=int(r["d_begin"]), d_end=int(r["d_end"]),
                query_range=(int(r["qr0"]), int(r["qr1"])),
                subject_range=(int(r["sr0"]), int(r["sr1"])),
                identities=int(r["identities"]),
                mismatches=int(r["mismatches"]),
                positives=int(r["positives"]),
                gap_openings=int(r["gap_openings"]), gaps=int(r["gaps"]),
                length=int(r["length"]), transcript=t,
                backtraced=bool(flags & _F_BACKTRACED),
                frame=int(r["frame"]),
                mismatches_stats=(int(r["mm_stats"])
                                  if flags & _F_MM_STATS else None),
                gap_openings_stats=(int(r["go_stats"])
                                    if flags & _F_GO_STATS else None))
        if flags & _F_FIRST:
            cur = Match(target_block_id=int(r["goid"]), hsp=[h],
                        filter_evalue=float(r["filter_evalue"]),
                        filter_score=int(r["filter_score"]))
            out.setdefault(int(r["gqid"]), []).append(
                (int(r["goid"]), cur))
        else:
            cur.hsp.append(h)
    return out
