"""Taxonomy subsystem: NCBI taxdump parsing, rank model, taxid lists,
DMND-compatible serialization.

Byte-compatible with the reference database blocks (reference
src/data/taxon_list.cpp:105-140 via legacy/dmnd/io.h serialize,
src/data/taxonomy_nodes.cpp:100-128, src/data/taxonomy.cpp:35-55,
src/legacy/dmnd/compact_array.h, src/util/algo/varint.h:26-75).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

MAX_LINEAGE = 255

# Rank enum (reference taxonomy_nodes.h:66-79); names indexed by enum value
# (reference taxonomy.cpp:35-39).
RANK_NAMES = [
    "no rank", "superkingdom", "cellular root", "acellular root", "domain",
    "realm", "kingdom", "subkingdom", "superphylum", "phylum", "subphylum",
    "superclass", "class", "subclass", "infraclass", "cohort", "subcohort",
    "superorder", "order", "suborder", "infraorder", "parvorder",
    "superfamily", "family", "subfamily", "tribe", "subtribe", "genus",
    "subgenus", "section", "subsection", "series", "species group",
    "species subgroup", "species", "subspecies", "varietas", "forma",
    "strain", "biotype", "clade", "forma specialis", "genotype", "isolate",
    "morph", "pathogroup", "serogroup", "serotype", "subvariety",
]
RANK_MAP = {n: i for i, n in enumerate(RANK_NAMES)}
RANK_NONE = 0
RANK_SUPERKINGDOM = 1
RANK_KINGDOM = 6
RANK_PHYLUM = 9
RANK_SPECIES = RANK_MAP["species"]


# ---------------------------------------------------------------------------
# varuint32 (reference util/algo/varint.h:26-75): length tag in low bits
# ---------------------------------------------------------------------------

def write_varuint32(x: int, out: bytearray):
    if x < 1 << 7:
        out.append((x << 1) | 1)
    elif x < 1 << 14:
        out += struct.pack("<H", (x << 2) | 2)
    elif x < 1 << 21:
        out.append(((x & 31) << 3) | 4)
        out += struct.pack("<H", x >> 5)
    elif x < 1 << 28:
        out += struct.pack("<I", (x << 4) | 8)
    else:
        out.append(((x & 7) << 5) | 16)
        out += struct.pack("<I", x >> 3)


def read_varuint32(data: bytes, pos: int):
    b0 = data[pos]
    c = (b0 & -b0).bit_length() - 1 if b0 else 32  # count trailing zeros
    if c == 0:
        return b0 >> 1, pos + 1
    if c == 1:
        b1 = data[pos + 1]
        return (b1 << 6) | (b0 >> 2), pos + 2
    if c == 2:
        (b2,) = struct.unpack_from("<H", data, pos + 1)
        return (b2 << 5) | (b0 >> 3), pos + 3
    if c == 3:
        (w,) = struct.unpack_from("<I", data, pos)
        return w >> 4, pos + 4
    (b3,) = struct.unpack_from("<I", data, pos + 1)
    return (b3 << 3) | (b0 >> 5), pos + 5


# ---------------------------------------------------------------------------
# taxdump parsing
# ---------------------------------------------------------------------------

def _dmp_rows(path: str):
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            yield [t.strip() for t in line.rstrip("\n").rstrip("|").split("|")]


def read_nodes_dmp(path: str):
    """Yield (taxid, parent, rank_string) (reference blastdb/taxdmp.h)."""
    for row in _dmp_rows(path):
        yield int(row[0]), int(row[1]), row[2].strip("\t")


def read_names_dmp(path: str):
    """Yield (taxid, scientific name) rows only."""
    for row in _dmp_rows(path):
        if row[3].strip("\t") == "scientific name":
            yield int(row[0]), row[1].strip("\t")


# ---------------------------------------------------------------------------
# accession parsing (reference util/sequence/sequence.cpp:76-103)
# ---------------------------------------------------------------------------

_ID_DELIMITERS = " \a\b\f\n\r\t\v\x01"
_FASTA_HEADER_SEP = "\x01"


def seqid(title: str) -> str:
    cut = len(title)
    for d in _ID_DELIMITERS:
        p = title.find(d)
        if p != -1:
            cut = min(cut, p)
    return title[:cut]


def get_accession(title: str) -> str:
    t = title
    if t.startswith("UniRef"):
        t = t[t.find("_") + 1:]
    else:
        i = t.find("|")
        if i != -1:
            if t.startswith("gi|"):
                t = t[t.find("|", i + 1) + 1:]
                i = t.find("|")
            t = t[i + 1:]
            i = t.find("|")
            if i != -1:
                t = t[:i]
    i = t.rfind(".")
    if i != -1:
        t = t[:i]
    return t


def accessions_from_title(title: str, parse_seqids: bool = True):
    """All accessions of a (possibly multi-defline) title; deflines are
    separated by '\\x01' or ' >' (reference sequence.cpp:38
    FASTA_HEADER_SEP, :59-71 all_seqids)."""
    out = []
    for p1 in title.split(_FASTA_HEADER_SEP):
        for part in p1.split(" >"):
            if not part:
                continue
            s = seqid(part)
            out.append(get_accession(s) if parse_seqids else s)
    return out


# ---------------------------------------------------------------------------
# TaxonomyNodes
# ---------------------------------------------------------------------------

@dataclass
class TaxonomyNodes:
    """Parent/rank arrays indexed by taxid (reference
    data/taxonomy_nodes.h:82-130)."""
    parent: np.ndarray       # int32 [max_taxid+1]
    rank: np.ndarray         # uint8 [max_taxid+1]

    @classmethod
    def from_dmp(cls, path: str) -> "TaxonomyNodes":
        taxids, parents, ranks = [], [], []
        for taxid, par, rank in read_nodes_dmp(path):
            taxids.append(taxid)
            parents.append(par)
            ranks.append(RANK_MAP.get(rank, RANK_NONE))
        n = max(taxids) + 1
        parent = np.zeros(n, dtype=np.int32)
        rank_a = np.zeros(n, dtype=np.uint8)
        parent[taxids] = parents
        rank_a[taxids] = ranks
        return cls(parent=parent, rank=rank_a)

    def get_parent(self, taxid: int) -> int:
        return int(self.parent[taxid]) if 0 <= taxid < len(self.parent) else 0

    def rank_of(self, taxid: int) -> int:
        return int(self.rank[taxid]) if 0 <= taxid < len(self.rank) else 0

    def rank_taxid(self, taxid: int, rank: int) -> int:
        """Walk to the ancestor with the given rank (reference
        sequence_file.cpp:928-942); 0 when the walk hits the root."""
        n = 0
        while True:
            if self.rank_of(taxid) == rank:
                return taxid
            if taxid <= 1:
                return 0
            n += 1
            if n > 64:
                raise RuntimeError("Path in taxonomy too long (rank_taxid).")
            taxid = self.get_parent(taxid)

    def lineage(self, taxid: int):
        """Root-exclusive lineage, root-first (reference
        sequence_file.cpp:943-958)."""
        out = []
        n = 0
        while True:
            if taxid <= 0:
                return []
            if taxid == 1:
                break
            n += 1
            if n > MAX_LINEAGE:
                raise RuntimeError("Path in taxonomy too long (lineage).")
            out.append(taxid)
            taxid = self.get_parent(taxid)
        out.reverse()
        return out

    def get_lca(self, t1: int, t2: int) -> int:
        """LCA walk (reference sequence_file.cpp:960-995)."""
        if t1 == t2 or t2 <= 0:
            return t1
        if t1 <= 0:
            return t2
        p = t2
        seen = {p}
        n = 0
        while True:
            p = self.get_parent(p)
            if p <= 0:
                return t1
            seen.add(p)
            n += 1
            if n > MAX_LINEAGE:
                raise RuntimeError("Path in taxonomy too long (get_lca).")
            if p == t1 or p == 1:
                break
        if p == t1:
            return p
        p = t1
        n = 0
        while p not in seen:
            p = self.get_parent(p)
            if p <= 0:
                return t2
            n += 1
            if n > MAX_LINEAGE:
                raise RuntimeError("Path in taxonomy too long (get_lca).")
        return p

    def contained(self, query: int, taxon_filter: set, include_invalid=False):
        """Is `query` at/under any taxon in the filter (reference
        sequence_file.cpp:997-1020)."""
        if self.get_parent(query) < 0:
            return include_invalid
        n = 0
        t = query
        while t not in (0, 1):
            if t in taxon_filter:
                return True
            t = self.get_parent(t)
            n += 1
            if n > 64:
                raise RuntimeError("Path in taxonomy too long (contained).")
        return t in taxon_filter

    # --- DMND serialization (reference taxonomy_nodes.cpp:100-128) ---
    def serialize(self) -> bytes:
        out = bytearray()
        out += struct.pack("<I", len(self.parent))
        out += self.parent.astype("<i4").tobytes()
        out += self.rank.tobytes()
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes, pos: int, db_build: int = 182):
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        parent = np.frombuffer(data, dtype="<i4", count=n, offset=pos).copy()
        pos += 4 * n
        if db_build >= 131:
            rank = np.frombuffer(data, dtype=np.uint8, count=n, offset=pos).copy()
            pos += n
        else:
            rank = np.zeros(n, dtype=np.uint8)
        return cls(parent=parent, rank=rank), pos


# ---------------------------------------------------------------------------
# TaxonList (per-OId taxid lists, CompactArray of varint vectors)
# ---------------------------------------------------------------------------

def build_taxon_list(titles, acc2taxid_path: str, parse_seqids: bool = True):
    """Map FASTA titles -> sorted taxid lists via an accession2taxid TSV
    (reference taxon_list.cpp:57-160).  Returns list[list[int]] per OId."""
    import gzip

    acc2oid = {}
    for oid, title in enumerate(titles):
        for acc in accessions_from_title(title, parse_seqids):
            acc2oid.setdefault(acc, []).append(oid)

    out = [set() for _ in range(len(titles))]
    op = gzip.open if acc2taxid_path.endswith(".gz") else open
    with op(acc2taxid_path, "rt") as f:
        header = f.readline().rstrip("\n").split("\t")
        if header[:2] == ["accession", "accession.version"]:
            fmt = 0
        elif header[:2] == ["accession.version", "taxid"]:
            fmt = 1
        else:
            raise RuntimeError(
                "Accession mapping file header has to be in one of these "
                "formats:\naccession\taccession.version\ttaxid\tgi\n"
                "accession.version\ttaxid")
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            if fmt == 0:
                acc, taxid = parts[1], int(parts[2])
            else:
                acc, taxid = parts[0], int(parts[1])
            if parse_seqids:
                i = acc.find(":PDB=")
                if i != -1:
                    acc = acc[:i]
                acc = get_accession(acc)
            oids = acc2oid.get(acc)
            if oids:
                for oid in oids:
                    out[oid].add(taxid)
    for s in out:
        s.discard(0)
    return [sorted(s) for s in out]


def serialize_taxon_list(lists) -> bytes:
    """CompactArray data block: per OId varint count + varint taxids
    (reference io.h serialize(set), taxon_list.cpp:128)."""
    out = bytearray()
    for lst in lists:
        write_varuint32(len(lst), out)
        for t in lst:
            write_varuint32(t, out)
    return bytes(out)


def deserialize_taxon_list(data: bytes, pos: int, count: int):
    out = []
    for _ in range(count):
        n, pos = read_varuint32(data, pos)
        lst = []
        for _ in range(n):
            v, pos = read_varuint32(data, pos)
            lst.append(v)
        out.append(lst)
    return out, pos


def serialize_names(names) -> bytes:
    """vector<string> block (reference io.h:55-59): u32 count + C strings."""
    out = bytearray()
    out += struct.pack("<I", len(names))
    for n in names:
        out += n.encode() + b"\x00"
    return bytes(out)


def deserialize_names(data: bytes, pos: int):
    (n,) = struct.unpack_from("<I", data, pos)
    pos += 4
    out = []
    for _ in range(n):
        end = data.index(b"\x00", pos)
        out.append(data[pos:end].decode())
        pos = end + 1
    return out, pos


def build_names(names_dmp_path: str, size: int):
    """Scientific-name array sized to max taxid (reference
    taxonomy.cpp:57-66 load_names)."""
    names = [""] * size
    for taxid, name in read_names_dmp(names_dmp_path):
        if taxid >= len(names):
            names.extend([""] * (taxid + 1 - len(names)))
        names[taxid] = name
    return names


# ---------------------------------------------------------------------------
# Runtime view used by output fields / filters
# ---------------------------------------------------------------------------

@dataclass
class Taxonomy:
    taxon_lists: list | None = None          # per OId sorted taxids
    nodes: TaxonomyNodes | None = None
    names: list | None = None

    def taxids(self, oid: int):
        if self.taxon_lists is None:
            return []
        return self.taxon_lists[oid]

    def scientific_name(self, taxid: int) -> str:
        """reference dmnd.cpp:621-623."""
        if self.names and 0 <= taxid < len(self.names) and self.names[taxid]:
            return self.names[taxid]
        return str(taxid)

    def rank_taxids(self, taxids, rank: int):
        if self.nodes is None:
            raise RuntimeError(
                "Options require taxonomy nodes information built into the "
                "database (--taxonnodes option of makedb)")
        return sorted({self.nodes.rank_taxid(t, rank) for t in taxids})

    def print_names(self, taxids) -> str:
        """reference sequence_file.h:317-332 print_taxon_names."""
        if not taxids:
            return "N/A"
        return ";".join(self.scientific_name(t) for t in taxids)

    def lca_all(self, taxids) -> int:
        lca = 0
        for t in taxids:
            lca = self.nodes.get_lca(lca, t) if lca else t
        return lca
