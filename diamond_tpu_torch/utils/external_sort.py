"""Bounded-memory external merge sort over numpy record batches.

Role: the reference's ExternalSorter (util/algo/external_sort.h) — sort
streams far larger than RAM by spilling sorted runs to temp files and
k-way merging them back.  Consumers: cluster edge tables (the
greedy-vertex-cover input, reference tools/greedy_vertex_cover.cpp
"external sort by degree") and any record stream above a memory cap.

The merge is vectorized: each pass finds the smallest end-of-chunk
boundary across the run heads, cuts every head at that boundary
(searchsorted on sorted chunks), and merge-sorts the cut — O(n log k)
with numpy-sized steps instead of per-record heap operations.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np


class ExternalSorter:
    """Push numpy structured arrays (or 1-D plain arrays); iterate sorted
    chunks.  Records sort by full lexicographic field order (np.sort on
    a structured dtype).  Spills when buffered bytes exceed mem_cap."""

    def __init__(self, dtype, mem_cap_bytes: int = 256 << 20,
                 tmpdir: str | None = None, chunk_records: int = 1 << 20):
        self.dtype = np.dtype(dtype)
        self.mem_cap = mem_cap_bytes
        self.tmpdir = tmpdir
        self.chunk_records = chunk_records
        self._bufs = []
        self._buffered = 0
        self._runs = []          # file paths of sorted spill runs
        self._run_counts = []
        self.n = 0

    # -- input ----------------------------------------------------------

    def push(self, arr):
        arr = np.asarray(arr, dtype=self.dtype)
        if arr.size == 0:
            return
        self._bufs.append(arr)
        self._buffered += arr.nbytes
        self.n += len(arr)
        if self._buffered >= self.mem_cap:
            self._spill()

    def _spill(self):
        if not self._bufs:
            return
        run = np.sort(np.concatenate(self._bufs), kind="stable")
        self._bufs = []
        self._buffered = 0
        fd, path = tempfile.mkstemp(prefix="dtpu_xsort_",
                                    dir=self.tmpdir)
        with os.fdopen(fd, "wb") as f:
            f.write(run.tobytes())
        self._runs.append(path)
        self._run_counts.append(len(run))

    @property
    def spilled_runs(self) -> int:
        return len(self._runs)

    # -- output ---------------------------------------------------------

    def sorted_chunks(self):
        """Yield sorted record chunks (ascending across the whole
        stream); deletes spill files when exhausted."""
        mem = (np.sort(np.concatenate(self._bufs), kind="stable")
               if self._bufs else np.empty(0, dtype=self.dtype))
        self._bufs = []
        self._buffered = 0
        if not self._runs:
            for lo in range(0, len(mem), self.chunk_records):
                yield mem[lo : lo + self.chunk_records]
            return

        readers = [_RunReader(p, self.dtype, self.chunk_records)
                   for p in self._runs]
        if len(mem):
            readers.append(_MemReader(mem, self.chunk_records))
        heads = [r.next_chunk() for r in readers]
        try:
            while True:
                live = [(h, r) for h, r in zip(heads, readers)
                        if h is not None and len(h)]
                if not live:
                    break
                # cut everything at the smallest head-chunk end: records
                # <= that boundary cannot arrive later from any run.
                # (np.void has no ufunc ordering; .item() tuples compare
                # with the same lexicographic field order np.sort uses)
                boundary = min(h[-1].item() for h, _r in live)
                parts = []
                for i, (h, r) in enumerate(zip(heads, readers)):
                    if h is None or not len(h):
                        continue
                    cut = _cut_le(h, boundary)
                    if cut:
                        parts.append(h[:cut])
                        h = h[cut:]
                    if not len(h):
                        h = r.next_chunk()
                    heads[i] = h
                merged = np.sort(np.concatenate(parts), kind="stable")
                for lo in range(0, len(merged), self.chunk_records):
                    yield merged[lo : lo + self.chunk_records]
        finally:
            for r in readers:
                r.close()
            for p in self._runs:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            self._runs = []

    def __iter__(self):
        for chunk in self.sorted_chunks():
            yield from chunk


def _cut_le(h, boundary) -> int:
    """Index of the first record > boundary in the sorted chunk h."""
    lo, hi = 0, len(h)
    while lo < hi:
        mid = (lo + hi) // 2
        if h[mid].item() <= boundary:
            lo = mid + 1
        else:
            hi = mid
    return lo


class _RunReader:
    def __init__(self, path, dtype, chunk_records):
        self.f = open(path, "rb")
        self.dtype = dtype
        self.chunk_records = chunk_records

    def next_chunk(self):
        buf = self.f.read(self.chunk_records * self.dtype.itemsize)
        if not buf:
            return None
        return np.frombuffer(buf, dtype=self.dtype)

    def close(self):
        self.f.close()


class _MemReader:
    def __init__(self, arr, chunk_records):
        self.arr = arr
        self.lo = 0
        self.chunk_records = chunk_records

    def next_chunk(self):
        if self.lo >= len(self.arr):
            return None
        c = self.arr[self.lo : self.lo + self.chunk_records]
        self.lo += self.chunk_records
        return c

    def close(self):
        pass


EDGE_DTYPE = np.dtype([("n1", "<i8"), ("n2", "<i8"), ("w", "<f8")])


def sort_edges(edges, mem_cap_bytes: int = 256 << 20,
               tmpdir: str | None = None):
    """Sorted (n1, n2, w) edge tuples from a python list or an
    ExternalSorter — the GVC input order (sorted(edges) semantics: floats
    compare identically under tuple sort and structured sort)."""
    if isinstance(edges, ExternalSorter):
        for chunk in edges.sorted_chunks():
            for rec in chunk:
                yield int(rec["n1"]), int(rec["n2"]), float(rec["w"])
        return
    yield from sorted(edges)
