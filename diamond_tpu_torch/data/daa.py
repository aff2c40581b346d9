"""DAA (DIAMOND Alignment Archive) format — reader, writer, view.

Byte-compatible with the reference (reference src/legacy/daa/daa_file.h:28-120,
daa_write.cpp:25-120, daa_record.cpp:53-110, basic/packed_transcript.h,
basic/packed_sequence.h).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_ALPHABET

MAGIC = 0x3C0E53476D3EE36B
VERSION = 1

OP_MATCH, OP_INSERTION, OP_DELETION, OP_SUBSTITUTION = 0, 1, 2, 3

H2_STRUCT = "<QQQQQQ" + "iiiiiiii" + "dddd" + "16s" + "256Q" + "256s"
H2_SIZE = struct.calcsize(H2_STRUCT)


@dataclass
class DaaHeader:
    diamond_build: int = 182
    db_seqs: int = 0
    db_seqs_used: int = 0
    db_letters: int = 0
    flags: int = 0
    query_records: int = 0
    mode: int = 2  # blastp
    gap_open: int = 11
    gap_extend: int = 1
    k: float = 0.041
    lam: float = 0.267
    evalue: float = 0.001
    score_matrix: str = "blosum62"
    block_size: list = field(default_factory=lambda: [0] * 256)
    block_type: list = field(default_factory=lambda: [0] * 256)


def pack_sequence(letters: np.ndarray, bits: int = 5) -> bytes:
    out = bytearray()
    x = 0
    n = 0
    for l in np.asarray(letters).astype(np.uint8):
        x |= int(l) << n
        n += bits
        while n >= 8:
            out.append(x & 0xFF)
            n -= 8
            x >>= 8
    if n > 0:
        out.append(x & 0xFF)
    return bytes(out)


def unpack_sequence(data: bytes, length: int, bits: int = 5) -> np.ndarray:
    out = np.zeros(length, dtype=np.int8)
    x = 0
    n = 0
    pos = 0
    for i in range(length):
        while n < bits:
            x |= data[pos] << n
            pos += 1
            n += 8
        out[i] = x & ((1 << bits) - 1)
        x >>= bits
        n -= bits
    return out


def pack_transcript(transcript) -> bytes:
    """Our op list -> packed bytes (reference packed_transcript.h:160-185)."""
    out = bytearray()
    for op, val in transcript:
        if op == "M":
            n = val
            while n > 0:
                c = min(n, 63)
                if out and (out[-1] >> 6) == OP_MATCH and (out[-1] & 63) not in (0, 63) \
                        and False:
                    pass
                out.append((OP_MATCH << 6) | c)
                n -= c
        elif op == "S":
            out.append((OP_SUBSTITUTION << 6) | (val & 63))
        elif op == "I":
            n = val
            while n > 0:
                c = min(n, 63)
                out.append((OP_INSERTION << 6) | c)
                n -= c
        else:  # D: one letter per op
            out.append((OP_DELETION << 6) | (val & 63))
    out.append(0)  # terminator: op_match count 0
    return bytes(out)


def merge_match_ops(transcript):
    """Merge adjacent M runs like the reference push_back(op, count)."""
    merged = []
    for op, val in transcript:
        if op == "M" and merged and merged[-1][0] == "M":
            merged[-1] = ("M", merged[-1][1] + val)
        else:
            merged.append([op, val] if op == "M" else (op, val))
    return [(o, v) for o, v in merged]


def read_transcript(data: bytes, pos: int):
    """Packed bytes -> op list; returns (ops, new_pos)."""
    ops = []
    while True:
        code = data[pos]
        pos += 1
        op = code >> 6
        arg = code & 63
        if op == OP_MATCH and arg == 0:
            break
        if op == OP_MATCH:
            ops.append(("M", arg))
        elif op == OP_INSERTION:
            ops.append(("I", arg))
        elif op == OP_DELETION:
            ops.append(("D", arg))
        else:
            ops.append(("S", arg))
    return ops, pos


def _get_length_flag(x: int) -> int:
    """Width code for write_packed (reference output/output.h:28-38)."""
    if x <= 0xFF:
        return 0
    if x <= 0xFFFF:
        return 1
    return 2


def _write_packed(out: bytearray, x: int):
    if x <= 0xFF:
        out.append(x)
    elif x <= 0xFFFF:
        out += struct.pack("<H", x)
    else:
        out += struct.pack("<I", x)


def write_daa(path: str, results: dict, query_block, target_block, matrix,
              max_evalue: float, db_seqs: int | None = None,
              db_letters: int | None = None, build_version: int = 0,
              mode: int = 2, query_names=None, query_letters=None):
    """Write a DAA archive byte-compatible with the reference
    (reference legacy/daa/daa_write.cpp:29-115, daa_file.h:41-92).

    results: {query_id: [Match, ...]} with backtraced HSPs.
    query_letters: optional callable qid -> unmasked letters (defaults to
    block.unmasked / block letters)."""
    if db_seqs is None:
        db_seqs = len(target_block)
    if db_letters is None:
        db_letters = target_block.n_letters

    dict_ids: dict[int, int] = {}   # target block id -> dict id
    records = bytearray()
    query_records = 0

    def qletters(qid):
        if query_letters is not None:
            return query_letters(qid)
        src = (query_block.unmasked if query_block.unmasked is not None
               else query_block.letters)
        s = int(query_block.starts[qid])
        return src[s : s + int(query_block.lengths[qid])]

    n = len(query_names) if query_names is not None else len(query_block)
    for qid in range(n):
        matches = results.get(qid)
        if not matches:
            continue
        query_records += 1
        qname = (query_names[qid] if query_names is not None
                 else query_block.seq_id(qid))
        qseq = np.asarray(qletters(qid)) & 31
        rec = bytearray()
        rec += struct.pack("<I", len(qseq))
        rec += qname.encode() + b"\x00"
        rec.append(0)  # flags: no N (protein 5-bit packing)
        rec += pack_sequence(qseq, 5)
        for m in matches:
            tid = m.target_block_id
            if tid not in dict_ids:
                dict_ids[tid] = len(dict_ids)
            for hsp in m.hsp:
                qbegin = hsp.query_range[0]
                sbegin = hsp.subject_range[0]
                rec += struct.pack("<I", dict_ids[tid])
                flag = (_get_length_flag(hsp.score)
                        | (_get_length_flag(qbegin) << 2)
                        | (_get_length_flag(sbegin) << 4)
                        | ((1 if hsp.frame > 2 else 0) << 6))
                rec.append(flag)
                _write_packed(rec, hsp.score)
                _write_packed(rec, qbegin)
                _write_packed(rec, sbegin)
                rec += pack_transcript(merge_match_ops(hsp.transcript or []))
        records += struct.pack("<I", len(rec))
        records += rec

    records += struct.pack("<I", 0)  # terminator

    names_block = bytearray()
    lens_block = bytearray()
    for tid in dict_ids:  # insertion order == dict id order
        names_block += target_block.ids[tid].encode() + b"\x00"
        lens_block += struct.pack("<I", int(target_block.lengths[tid]))

    h2 = struct.pack(
        H2_STRUCT,
        build_version if build_version else 182,
        db_seqs, len(dict_ids), db_letters, 0, query_records,
        mode, matrix.gap_open, matrix.gap_extend, 0, 0, 0, 0, 0,
        float(matrix.k), float(matrix.lam), float(max_evalue), 0.0,
        matrix.name.lower().encode(),
        *( [len(records), len(names_block), len(lens_block)] + [0] * 253 ),
        bytes([1, 2, 3] + [0] * 253),
    )
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", MAGIC, VERSION))
        f.write(h2)
        f.write(records)
        f.write(names_block)
        f.write(lens_block)


def merge_daa(paths: list, out_path: str):
    """Concatenate DAA archives (the reference merge-daa command,
    reference legacy/daa/merge.cpp): records appended, dictionaries remapped."""
    readers = [DaaReader(p) for p in paths]
    h0 = readers[0].h
    name_to_id: dict[str, int] = {}
    names: list[str] = []
    lens: list[int] = []
    records = bytearray()
    query_records = 0
    for r in readers:
        remap = []
        for name, ln in zip(r.ref_names, r.ref_lens):
            if name not in name_to_id:
                name_to_id[name] = len(names)
                names.append(name)
                lens.append(ln)
            remap.append(name_to_id[name])
        query_records += r.h.query_records
        for qname, qseq, matches in r.queries():
            rec = bytearray()
            rec += struct.pack("<I", len(qseq))
            rec += qname.encode() + b"\x00"
            rec.append(0)
            rec += pack_sequence(np.asarray(qseq) & 31, 5)
            for sid, flag, score, qbegin, sbegin, ops in matches:
                rec += struct.pack("<I", remap[sid])
                rec.append(flag)
                _write_packed(rec, score)
                _write_packed(rec, qbegin)
                _write_packed(rec, sbegin)
                rec += pack_transcript(ops)
            records += struct.pack("<I", len(rec))
            records += rec
    records += struct.pack("<I", 0)
    names_block = bytearray()
    lens_block = bytearray()
    for name, ln in zip(names, lens):
        names_block += name.encode() + b"\x00"
        lens_block += struct.pack("<I", ln)
    rv = readers[0].raw_vals
    h2 = struct.pack(
        H2_STRUCT,
        h0.diamond_build, h0.db_seqs, len(names), h0.db_letters, rv[4],
        query_records, *rv[6:18],
        rv[18],
        *( [len(records), len(names_block), len(lens_block)] + [0] * 253 ),
        bytes([1, 2, 3] + [0] * 253),
    )
    with open(out_path, "wb") as f:
        f.write(struct.pack("<QQ", MAGIC, VERSION))
        f.write(h2)
        f.write(records)
        f.write(names_block)
        f.write(lens_block)


class DaaReader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        magic, version = struct.unpack_from("<QQ", self.data, 0)
        if magic != MAGIC:
            raise ValueError("Input file is not a DAA file.")
        if version > VERSION:
            raise ValueError("DAA version requires later version of DIAMOND.")
        vals = struct.unpack_from(H2_STRUCT, self.data, 16)
        self.raw_vals = vals
        h = DaaHeader()
        (h.diamond_build, h.db_seqs, h.db_seqs_used, h.db_letters, h.flags,
         h.query_records) = vals[:6]
        (h.mode, h.gap_open, h.gap_extend, _, _, _, _, _) = vals[6:14]
        (h.k, h.lam, h.evalue, _) = vals[14:18]
        h.score_matrix = vals[18].split(b"\x00")[0].decode()
        h.block_size = list(vals[19 : 19 + 256])
        self.h = h
        self.records_start = 16 + H2_SIZE
        if h.block_size[0] == 0:
            raise ValueError("Invalid DAA file.")
        # ref names and lengths
        pos = self.records_start + h.block_size[0]
        self.ref_names = []
        for _ in range(h.db_seqs_used):
            end = self.data.index(b"\x00", pos)
            self.ref_names.append(self.data[pos:end].decode())
            pos = end + 1
        self.ref_lens = list(struct.unpack_from(f"<{h.db_seqs_used}I", self.data, pos))

    def queries(self):
        """Yield (query_name, query_letters, [(subject_id, flag, score,
        query_begin, subject_begin, ops), ...])."""
        pos = self.records_start
        end = self.records_start + self.h.block_size[0] - 4
        data = self.data
        while pos < end:
            (rec_len,) = struct.unpack_from("<I", data, pos)
            pos += 4
            rec_end = pos + rec_len
            (qlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            zero = data.index(b"\x00", pos)
            qname = data[pos:zero].decode()
            pos = zero + 1
            flags = data[pos]
            pos += 1
            nbytes = (qlen * 5 + 7) // 8 if self.h.mode == 2 else \
                (qlen * (3 if flags & 1 else 2) + 7) // 8
            qseq = unpack_sequence(data[pos : pos + nbytes], qlen,
                                   5 if self.h.mode == 2 else (3 if flags & 1 else 2))
            pos += nbytes
            matches = []
            while pos < rec_end:
                (sid,) = struct.unpack_from("<I", data, pos)
                pos += 4
                flag = data[pos]
                pos += 1
                score, pos = self._read_packed(flag & 3, pos)
                qbegin, pos = self._read_packed((flag >> 2) & 3, pos)
                sbegin, pos = self._read_packed((flag >> 4) & 3, pos)
                ops, pos = read_transcript(data, pos)
                matches.append((sid, flag, score, qbegin, sbegin, ops))
            yield qname, qseq, matches

    def _read_packed(self, width_flag: int, pos: int):
        if width_flag == 0:
            return self.data[pos], pos + 1
        if width_flag == 1:
            return struct.unpack_from("<H", self.data, pos)[0], pos + 2
        return struct.unpack_from("<I", self.data, pos)[0], pos + 4


def view_daa(path: str, matrix=None):
    """Render a DAA file as default tabular lines (the `view` command)."""
    from diamond_tpu_torch.align.extend import Hsp
    from diamond_tpu_torch.output.tabular import format_match_line
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    r = DaaReader(path)
    if matrix is None:
        matrix = ScoreMatrix(r.h.score_matrix.upper(), r.h.gap_open,
                             r.h.gap_extend, db_letters=r.h.db_letters)
    lines = []
    for qname, qseq, matches in r.queries():
        for sid, flag, score, qbegin, sbegin, ops in matches:
            h = Hsp(score=score)
            qlen = len(qseq)
            # replay transcript for stats
            i, j = qbegin, sbegin
            ident = mism = pos_ = gapo = gaps = length = 0
            prev_gap = None
            for op, val in ops:
                if op == "M":
                    ident += val
                    length += val
                    i += val
                    j += val
                    prev_gap = None
                elif op == "S":
                    mism += 1
                    if matrix.matrix32[int(qseq[i]) & 31, val & 31] > 0:
                        pos_ += 1
                    length += 1
                    i += 1
                    j += 1
                    prev_gap = None
                elif op == "I":
                    gaps += val
                    length += val
                    if prev_gap != "I":
                        gapo += 1
                    i += val
                    prev_gap = "I"
                else:
                    gaps += 1
                    length += 1
                    if prev_gap != "D":
                        gapo += 1
                    j += 1
                    prev_gap = "D"
            h.identities = ident
            h.positives = ident + pos_
            h.mismatches = mism
            h.gap_openings = gapo
            h.gaps = gaps
            h.length = length
            h.query_range = (qbegin, i)
            h.subject_range = (sbegin, j)
            h.evalue = float(matrix.evalue(score, qlen, r.ref_lens[sid]))
            h.bit_score = float(matrix.bitscore(score))
            lines.append(format_match_line(qname, r.ref_names[sid].split()[0]
                                           if r.ref_names[sid] else "", h))
    return lines
