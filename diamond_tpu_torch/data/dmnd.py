"""DMND database format (byte-compatible with the reference).

Layout (reference src/legacy/dmnd/dmnd.h:28-66, dmnd.cpp:224-345), all
little-endian:

  ReferenceHeader:  magic u64 (0x24af8a415ee186d), build u32, db_version u32,
                    sequences u64, letters u64, pos_array_offset u64
  ReferenceHeader2: size u64 (=48), hash[16], taxon_array_offset u64,
                    taxon_array_size u64, taxon_nodes_offset u64,
                    taxon_names_offset u64
  per sequence:     0xff, letters[len] (int8 codes, tantan soft-mask bit 7),
                    0xff, id bytes, 0x00
  pos array:        (pos u64, seq_len u32, pad u32) per sequence + sentinel
                    (end_offset, 0, 0)
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from diamond_tpu_torch.constants.alphabet import encode

MAGIC = 0x24AF8A415EE186D
DB_VERSION_PROT = 3
BUILD = 182


@dataclass
class DmndHeader:
    magic: int
    build: int
    db_version: int
    sequences: int
    letters: int
    pos_array_offset: int


def read_dmnd(path: str, with_taxonomy: bool = False,
              strip_mask: bool = False):
    """Returns (ids, seqs int8 arrays with soft-mask bit preserved)
    or (ids, seqs, Taxonomy) when with_taxonomy.

    strip_mask=True: seqs are zero-copy views into ONE bulk `letters & 31`
    buffer (bit 7 stripped).  Block.from_sequences detects the shared base
    and bulk-copies, so a 1M-sequence DB loads with a handful of
    vectorized ops instead of millions of small-array copies (the
    reference streams blocks natively, sequence_file.cpp:113-150; this is
    the in-memory equivalent)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, build, dbv, nseq, letters, pos_off = struct.unpack_from("<QIIQQQ", data, 0)
    if magic != MAGIC:
        raise ValueError("Database file is not a DIAMOND database.")
    if dbv > 4:
        raise ValueError("Database was built with a newer version.")
    # header2
    (h2size,) = struct.unpack_from("<Q", data, 40)
    tax = None
    if with_taxonomy:
        from diamond_tpu_torch.data.taxonomy import (Taxonomy, TaxonomyNodes,
                                               deserialize_names,
                                               deserialize_taxon_list)

        tax = Taxonomy()
        (tax_off, tax_size, nodes_off, names_off) = struct.unpack_from(
            "<QQQQ", data, 64)
        if tax_off:
            tax.taxon_lists, _ = deserialize_taxon_list(data, tax_off, nseq)
        if nodes_off:
            tax.nodes, _ = TaxonomyNodes.deserialize(data, nodes_off, build)
        if names_off:
            tax.names, _ = deserialize_names(data, names_off)
    # sequences via pos array
    infos = []
    off = pos_off
    for _ in range(nseq + 1):
        pos, slen, _pad = struct.unpack_from("<QII", data, off)
        infos.append((pos, slen))
        off += 16
    base = None
    if strip_mask:
        base = np.frombuffer(data, dtype=np.int8) & np.int8(31)
    ids, seqs = [], []
    for k in range(nseq):
        pos, slen = infos[k]
        if base is not None:
            seq = base[pos + 1 : pos + 1 + slen]
        else:
            seq = np.frombuffer(data, dtype=np.int8, count=slen,
                                offset=pos + 1)
        id_start = pos + 1 + slen + 1
        id_end = data.index(b"\x00", id_start)
        ids.append(data[id_start:id_end].decode())
        seqs.append(seq)
    if with_taxonomy:
        return ids, seqs, tax
    return ids, seqs


def write_dmnd(path: str, records, mask_bit: bool = True, build: int = BUILD,
               taxonmap: str | None = None, taxonnodes: str | None = None,
               taxonnames: str | None = None):
    """records: iterable of (id, sequence str/bytes/int8 array).

    mask_bit: apply tantan soft masking (bit 7) like the reference makedb
    (reference dmnd.cpp:282-286 via mask_seqs hard_mask=false).
    taxonmap/taxonnodes/taxonnames: taxonomy inputs appended as DMND blocks
    (reference dmnd.cpp:300-340, taxon_list.cpp, taxonomy_nodes.cpp)."""
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    from diamond_tpu_torch.utils.murmur3 import murmur3_x64_128

    from diamond_tpu_torch import native

    masker = Tantan(ScoreMatrix("BLOSUM62").matrix32) if mask_bit else None
    titles = []
    db_hash = b"\x00" * 16
    with open(path, "wb") as f:
        f.write(b"\x00" * (40 + 56))  # headers placeholder
        offset = 96
        pos_array = []
        letters = 0
        n = 0

        # records stream through in ~32M-letter chunks: one batched
        # tantan scan, one chained-hash call, and one buffered write per
        # chunk instead of per record (the reference streams 1 GB blocks
        # through threaded SEG the same way, legacy/dmnd/dmnd.cpp:236-290)
        def flush(chunk):
            nonlocal offset, letters, n, db_hash
            if not chunk:
                return
            m = len(chunk)
            lens = np.fromiter((len(e) for _, e in chunk), np.int64, m)
            starts = np.zeros(m + 1, dtype=np.int64)
            np.cumsum(lens, out=starts[1:])
            cat = np.empty(int(starts[-1]), dtype=np.int8)
            for (_, e), s, ln in zip(chunk, starts, lens):
                cat[s : s + ln] = e
            if masker is not None:
                probs = native.tantan_repeat_prob_many(
                    cat, starts[:-1], lens, masker.ratios,
                    float(masker.p_repeat), float(masker.p_repeat_end),
                    float(masker.repeat_growth))
                if probs is None:
                    probs = np.zeros(len(cat), dtype=np.float32)
                    for (_, e), s, ln in zip(chunk, starts, lens):
                        probs[s : s + ln] = masker.repeat_prob(e)
                cat[probs >= masker.p_mask] |= np.int8(-128)
            ids_b = [sid.encode() for sid, _ in chunk]
            id_offs = np.zeros(m + 1, dtype=np.int64)
            np.cumsum(np.fromiter((len(b) for b in ids_b), np.int64, m),
                      out=id_offs[1:])
            ids_cat = np.frombuffer(b"".join(ids_b), dtype=np.int8) \
                if id_offs[-1] else np.zeros(0, dtype=np.int8)
            h = native.dmnd_hash_records(cat, starts[:-1], lens, ids_cat,
                                         id_offs, db_hash)
            if h is None:
                h = db_hash
                for k in range(m):
                    s, ln = int(starts[k]), int(lens[k])
                    h = murmur3_x64_128(cat[s : s + ln].tobytes(), h)
                    h = murmur3_x64_128(ids_b[k], h)
            db_hash = h
            pieces = []
            for k, (sid, _e) in enumerate(chunk):
                s, ln = int(starts[k]), int(lens[k])
                pos_array.append((offset, ln))
                titles.append(sid)
                pieces.append(b"\xff")
                pieces.append(cat[s : s + ln].tobytes())
                pieces.append(b"\xff")
                pieces.append(ids_b[k])
                pieces.append(b"\x00")
                offset += ln + len(ids_b[k]) + 3
                letters += ln
                n += 1
            f.write(b"".join(pieces))

        chunk = []
        chunk_letters = 0
        for sid, seq in records:
            e = seq if isinstance(seq, np.ndarray) else encode(seq)
            e = np.asarray(e, dtype=np.int8)
            if len(e) == 0:
                raise ValueError("File format error: sequence of length 0")
            chunk.append((sid, e))
            chunk_letters += len(e)
            if chunk_letters >= (32 << 20):
                flush(chunk)
                chunk = []
                chunk_letters = 0
        flush(chunk)
        pos_off = offset
        for pos, slen in pos_array:
            f.write(struct.pack("<QII", pos, slen, 0))
        f.write(struct.pack("<QII", offset, 0, 0))
        # taxonomy blocks (after the pos array, reference dmnd.cpp:300-340)
        tax_off = tax_size = nodes_off = names_off = 0
        if taxonmap:
            from diamond_tpu_torch.data import taxonomy as taxmod

            lists = taxmod.build_taxon_list(titles, taxonmap)
            blob = taxmod.serialize_taxon_list(lists)
            tax_off = f.tell()
            tax_size = len(blob)
            f.write(blob)
            if taxonnodes:
                nodes = taxmod.TaxonomyNodes.from_dmp(taxonnodes)
                nodes_off = f.tell()
                f.write(nodes.serialize())
                if taxonnames:
                    names = taxmod.build_names(taxonnames, len(nodes.parent))
                    names_off = f.tell()
                    f.write(taxmod.serialize_names(names))
        # headers
        f.seek(0)
        f.write(struct.pack("<QIIQQQ", MAGIC, build, DB_VERSION_PROT, n,
                            letters, pos_off))
        f.write(struct.pack("<Q", 48))
        f.write(db_hash)
        f.write(struct.pack("<QQQQ", tax_off, tax_size, nodes_off, names_off))


def is_dmnd(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            (magic,) = struct.unpack("<Q", f.read(8))
        return magic == MAGIC
    except Exception:
        return False


class DmndProvider:
    """Ranged .dmnd access for the out-of-core block swap: only the
    header and pos array stay resident (16 B/sequence); letters and ids
    are read from disk per block (the role of the reference's
    load_seqs streaming, sequence_file.cpp:113-150 — the reference
    never holds the whole DB in RAM and neither does this path)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(96)
            magic, build, dbv, nseq, letters, pos_off = \
                struct.unpack_from("<QIIQQQ", head, 0)
            if magic != MAGIC:
                raise ValueError("Database file is not a DIAMOND database.")
            if dbv > 4:
                raise ValueError("Database was built with a newer version.")
            self.n = nseq
            self.total_letters = letters
            (self._tax_off, self._tax_size, self._nodes_off,
             self._names_off) = struct.unpack_from("<QQQQ", head, 64)
            self._build = build
            f.seek(pos_off)
            arr = np.fromfile(f, dtype=np.dtype(
                [("pos", "<u8"), ("len", "<u4"), ("pad", "<u4")]),
                count=nseq + 1)
        self.pos = arr["pos"].astype(np.int64)
        self.lengths = arr["len"][:nseq].astype(np.int64)

    def load_block(self, lo: int, hi: int):
        """Block of sequences [lo, hi) with ids, soft-mask bit stripped
        (record layout: 0xff, letters, 0xff, id, 0x00)."""
        from diamond_tpu_torch.data.block import Block

        start = int(self.pos[lo])
        end = int(self.pos[hi])
        with open(self.path, "rb") as f:
            f.seek(start)
            slab = np.fromfile(f, dtype=np.int8, count=end - start)
        raw = slab.tobytes()
        base = slab & np.int8(31)
        seqs = []
        ids = []
        for k in range(lo, hi):
            p = int(self.pos[k]) - start
            ln = int(self.lengths[k])
            seqs.append(base[p + 1 : p + 1 + ln])
            id_start = p + 1 + ln + 1
            id_end = raw.index(b"\x00", id_start)
            ids.append(raw[id_start:id_end].decode())
        return Block.from_sequences(seqs, ids)

    def ids_for(self, ks):
        """{k: id} for a set of sequence indices (chunked ranged
        reads — the blocked join only needs names for reported
        targets, reference join_blocks dictionary lookups)."""
        out = {}
        ks = sorted(set(int(k) for k in ks))
        with open(self.path, "rb") as f:
            for k in ks:
                id_start = int(self.pos[k]) + 1 + int(self.lengths[k]) + 1
                f.seek(id_start)
                buf = b""
                while True:
                    chunk = f.read(256)
                    if not chunk:
                        break
                    z = chunk.find(b"\x00")
                    if z != -1:
                        buf += chunk[:z]
                        break
                    buf += chunk
                out[k] = buf.decode()
        return out

    def taxonomy(self):
        """Taxonomy blocks only (no sequence data)."""
        from diamond_tpu_torch.data.taxonomy import (Taxonomy, TaxonomyNodes,
                                               deserialize_names,
                                               deserialize_taxon_list)

        with open(self.path, "rb") as f:
            data = f.read()
        tax = Taxonomy()
        if self._tax_off:
            tax.taxon_lists, _ = deserialize_taxon_list(
                data, self._tax_off, self.n)
        if self._nodes_off:
            tax.nodes, _ = TaxonomyNodes.deserialize(data, self._nodes_off,
                                                     self._build)
        if self._names_off:
            tax.names, _ = deserialize_names(data, self._names_off)
        return tax


class ListProvider:
    """In-memory provider (FASTA inputs / tests): same interface as
    DmndProvider over materialized sequence lists."""

    def __init__(self, seqs, ids):
        self._seqs = seqs
        self._ids = ids
        self.n = len(seqs)
        self.lengths = np.fromiter((len(s) for s in seqs),
                                   dtype=np.int64, count=len(seqs))
        self.total_letters = int(self.lengths.sum())

    def load_block(self, lo: int, hi: int):
        from diamond_tpu_torch.data.block import Block

        return Block.from_sequences(self._seqs[lo:hi], self._ids[lo:hi])

    def ids_for(self, ks):
        return {int(k): self._ids[int(k)] for k in ks}
