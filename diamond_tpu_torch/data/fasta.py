"""FASTA/FASTQ readers (plain, gzip, zstd).

Host-side IO replacing the reference's stream stack (reference
src/util/io/, src/data/fasta/).  Parsing is bytes-based single pass.
"""
from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Tuple


def _open_raw(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(4)[:4] if hasattr(f, "peek") else f.read(4)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, "rb")  # type: ignore[return-value]
    if magic[:4] == b"\x28\xb5\x2f\xfd":
        f.close()
        from diamond_tpu_torch.utils.zstdio import zstd_open

        return zstd_open(path, "rb")  # type: ignore[return-value]
    return f


def read_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (full header line without '>', sequence bytes)."""
    with _open_raw(path) as f:
        name = None
        chunks: list[bytes] = []
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].decode()
                chunks = []
            elif line.startswith(b"@") and name is None:
                # FASTQ file
                f2 = _reopen_as_fastq(path)
                yield from f2
                return
            else:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def _reopen_as_fastq(path: str) -> Iterator[Tuple[str, bytes]]:
    with _open_raw(path) as f:
        while True:
            header = f.readline().rstrip()
            if not header:
                return
            seq = f.readline().rstrip()
            plus = f.readline()
            qual = f.readline()
            if not header.startswith(b"@"):
                raise ValueError("Malformed FASTQ record")
            del plus, qual
            yield header[1:].decode(), seq


def read_fastq(path: str) -> Iterator[Tuple[str, bytes]]:
    yield from _reopen_as_fastq(path)


def read_fastq_full(path: str):
    """Yield (id, sequence bytes, quality str) — quality retained for the
    qqual/full_qqual output fields (reference blast_tab_format.cpp)."""
    with _open_raw(path) as f:
        while True:
            header = f.readline().rstrip()
            if not header:
                return
            seq = f.readline().rstrip()
            f.readline()
            qual = f.readline().rstrip()
            if not header.startswith(b"@"):
                raise ValueError("Malformed FASTQ record")
            yield header[1:].decode(), seq, qual.decode()


def sniff_format(path: str) -> str:
    with _open_raw(path) as f:
        first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"Cannot detect sequence format of {path}")


def read_seqs(path: str):
    if sniff_format(path) == "fastq":
        return read_fastq(path)
    return read_fasta(path)
