"""NCBI BLAST database reader: .pin/.phr/.psq volumes and .pal alias files
with SEQIDLIST filters.

Reference: src/data/blastdb/pin.cpp:31-73 (PIN index), psq.cpp:35-78
(ncbistdaa decode, NCBI_TO_STD at basic/value.cpp:53), phr.cpp (ASN.1 BER
defline parsing), asn1.cpp (BER decoder), pal.cpp (alias files),
blastdb.cpp:362-395 (accession filter).
"""
from __future__ import annotations

import os
import struct

import numpy as np

# ncbistdaa -> DIAMOND letters (reference basic/value.cpp:53)
NCBI_TO_STD = np.array([23, 0, 20, 4, 3, 6, 13, 7, 8, 9, 11, 10, 12, 2, 14,
                        5, 1, 15, 16, 19, 17, 23, 18, 22, 23, 24, 23, 21],
                       dtype=np.int8)


# ---------------------------------------------------------------------------
# ASN.1 BER decoder (reference asn1.cpp)
# ---------------------------------------------------------------------------

class Node:
    __slots__ = ("tag_class", "constructed", "tag", "value", "children")

    def __init__(self):
        self.tag_class = 0
        self.constructed = False
        self.tag = 0
        self.value = b""
        self.children = []


def _parse_tag(data: bytes, off: int):
    first = data[off]
    off += 1
    node = Node()
    node.tag_class = (first & 0xC0) >> 6
    node.constructed = bool(first & 0x20)
    tag = first & 0x1F
    if tag != 0x1F:
        node.tag = tag
        return node, off
    node.tag = 0
    while True:
        b = data[off]
        off += 1
        node.tag = (node.tag << 7) | (b & 0x7F)
        if not (b & 0x80):
            return node, off


def _parse_length(data: bytes, off: int):
    first = data[off]
    off += 1
    if not (first & 0x80):
        return first, False, off
    count = first & 0x7F
    if count == 0:
        return 0, True, off  # indefinite
    value = 0
    for _ in range(count):
        value = (value << 8) | data[off]
        off += 1
    return value, False, off


def ber_decode(data: bytes, off: int = 0, end: int | None = None) -> list:
    """Parse a run of BER nodes in data[off:end]."""
    if end is None:
        end = len(data)
    nodes = []
    while off < end:
        if off + 1 < end and data[off] == 0 and data[off + 1] == 0:
            off += 2
            continue
        node, off = _parse_tag(data, off)
        length, indefinite, off = _parse_length(data, off)
        if node.constructed:
            if indefinite:
                # children run until EOC
                child_end = off
                depth = 1
                while depth and child_end + 1 < end:
                    if data[child_end] == 0 and data[child_end + 1] == 0:
                        depth -= 1
                        child_end += 2
                        continue
                    n2, o2 = _parse_tag(data, child_end)
                    l2, ind2, o2 = _parse_length(data, o2)
                    if ind2:
                        depth += 1
                        child_end = o2
                    else:
                        child_end = o2 + l2
                node.children = ber_decode(data, off, child_end - 2)
                off = child_end
            else:
                node.children = ber_decode(data, off, off + length)
                off += length
        else:
            node.value = bytes(data[off : off + length])
            off += length
        nodes.append(node)
    return nodes


def _decode_int(value: bytes) -> int:
    return int.from_bytes(value, "big", signed=True) if value else 0


# ---------------------------------------------------------------------------
# defline parsing (reference phr.cpp:48-198)
# ---------------------------------------------------------------------------

def _textseq_id(node, seqid):
    for n4 in node.children:
        if n4.tag == 1:  # accession
            for n5 in n4.children:
                if n5.tag == 26:
                    seqid["value"] = n5.value.decode()
        elif n4.tag == 3:  # version
            for n5 in n4.children:
                if n5.tag == 2:
                    seqid["version"] = _decode_int(n5.value)


def _decode_seqid(node):
    seqid = {"value": "", "version": None, "chain": None}
    for n1 in node.children:
        if n1.tag != 16:
            continue
        for n2 in n1.children:
            if n2.tag in (0, 1, 4, 5, 7, 9, 12, 15, 16):
                _textseq_id(n2, seqid)
                for n3 in n2.children:
                    if n3.tag == 16:
                        _textseq_id(n3, seqid)
            elif n2.tag == 14:  # pdb
                for n3 in n2.children:
                    if n3.tag != 16:
                        continue
                    for n4 in n3.children:
                        if n4.tag == 0:
                            for n5 in n4.children:
                                if n5.tag == 26:
                                    seqid["value"] = n5.value.decode()
                        elif n4.tag == 3:
                            for n5 in n4.children:
                                if n5.tag == 26:
                                    seqid["chain"] = n5.value.decode()
    return seqid


def format_seqid(seqid) -> str:
    if not seqid["value"]:
        return "N/A"
    s = seqid["value"]
    if seqid["version"] is not None:
        s += f".{seqid['version']}"
    if seqid["chain"]:
        s += f"_{seqid['chain']}"
    return s


def decode_deflines(data: bytes):
    """[(title, [seqid dict], taxid)] per defline."""
    nodes = ber_decode(data)
    out = []
    if not nodes:
        return out
    for dn in nodes[0].children:
        title = ""
        seqids = []
        taxid = 0
        for n1 in dn.children:
            if n1.tag == 0:
                for n2 in n1.children:
                    if n2.tag == 26:
                        title = n2.value.decode()
            elif n1.tag == 1:
                s = _decode_seqid(n1)
                if s["value"]:
                    seqids.append(s)
            elif n1.tag == 2:
                for n2 in n1.children:
                    if n2.tag == 2:
                        taxid = _decode_int(n2.value)
        out.append((title, seqids, taxid))
    return out


def build_title(deflines) -> str:
    """First-defline title: 'acc.version title' (reference
    phr.cpp:246-263 build_title with all=false)."""
    if not deflines:
        return "N/A"
    title, seqids, _ = deflines[0]
    h = ""
    if seqids:
        h = format_seqid(seqids[0]) + " "
    h += title
    return h or "N/A"


# ---------------------------------------------------------------------------
# volumes and alias files
# ---------------------------------------------------------------------------

class BlastVolume:
    def __init__(self, path: str):
        self.path = path
        with open(path + ".pin", "rb") as f:
            data = f.read()
        off = 0

        def be32():
            nonlocal off
            v = struct.unpack_from(">I", data, off)[0]
            off += 4
            return v

        def pstring():
            nonlocal off
            n = be32()
            s = data[off : off + n].decode()
            off += n
            return s

        self.version = be32()
        if self.version not in (4, 5):
            raise ValueError(f"Unsupported database format version: {self.version}")
        self.is_protein = be32() == 1
        if self.version == 5:
            self.volume_number = be32()
        self.title = pstring()
        if self.version == 5:
            self.lmdb_file = pstring()
        self.date = pstring()
        self.num_oids = be32()
        self.total_length = struct.unpack_from("<Q", data, off)[0]
        off += 8
        self.max_length = be32()
        n = self.num_oids + 1
        self.header_index = np.frombuffer(data, dtype=">u4", count=n,
                                          offset=off).astype(np.int64)
        off += 4 * n
        self.sequence_index = np.frombuffer(data, dtype=">u4", count=n,
                                            offset=off).astype(np.int64)
        with open(path + ".psq", "rb") as f:
            self._psq = f.read()
        with open(path + ".phr", "rb") as f:
            self._phr = f.read()

    def sequence(self, oid: int) -> np.ndarray:
        """DIAMOND-letter sequence (reference psq.cpp:35-60)."""
        b, e = int(self.sequence_index[oid]), int(self.sequence_index[oid + 1])
        raw = self._psq[b:e]
        if raw[:1] == b"\0":
            raw = raw[1:]
        if raw[-1:] == b"\0":
            raw = raw[:-1]
        return NCBI_TO_STD[np.frombuffer(raw, dtype=np.uint8)]

    def deflines(self, oid: int):
        b, e = int(self.header_index[oid]), int(self.header_index[oid + 1])
        return decode_deflines(self._phr[b:e])


class BlastDB:
    """A BLAST protein database: single volume or .pal alias with optional
    SEQIDLIST filter (reference blastdb.cpp, pal.cpp)."""

    def __init__(self, path: str):
        self.volumes: list[BlastVolume] = []
        self.seqidlist: set | None = None
        self.title = None
        if os.path.exists(path + ".pal"):
            self._parse_pal(path + ".pal", os.path.dirname(path) or ".")
        else:
            self.volumes.append(BlastVolume(path))

    def _parse_pal(self, pal_path: str, base_dir: str):
        meta = {}
        with open(pal_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                key, _, val = line.partition(" ")
                meta[key] = val.strip()
        self.title = meta.get("TITLE")
        for vol in meta.get("DBLIST", "").split():
            vol = vol.strip('"')
            vp = vol if os.path.isabs(vol) else os.path.join(base_dir, vol)
            if os.path.exists(vp + ".pal"):
                self._parse_pal(vp + ".pal", os.path.dirname(vp))
            else:
                self.volumes.append(BlastVolume(vp))
        if "SEQIDLIST" in meta:
            sl = meta["SEQIDLIST"]
            sp = sl if os.path.isabs(sl) else os.path.join(base_dir, sl)
            with open(sp) as f:
                self.seqidlist = {l.strip() for l in f if l.strip()}

    def load(self):
        """(ids, seqs) over all volumes, applying the SEQIDLIST filter: a
        sequence is kept when any of its deflines' formatted seqids is
        listed (reference blastdb.cpp:362-387 filter_by_accession)."""
        ids, seqs = [], []
        for vol in self.volumes:
            for oid in range(vol.num_oids):
                dl = vol.deflines(oid)
                if self.seqidlist is not None:
                    keep = any(format_seqid(s) in self.seqidlist
                               for _, sids, _ in dl for s in sids)
                    if not keep:
                        continue
                ids.append(build_title(dl))
                seqs.append(vol.sequence(oid))
        return ids, seqs


def is_blastdb(path: str) -> bool:
    return (os.path.exists(path + ".pin") or os.path.exists(path + ".pal"))
