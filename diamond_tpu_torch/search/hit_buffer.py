"""Seed-hit buffer with disk spill (reference src/search/hit_buffer.cpp
:34-235): hit rows are binned by query-id range into temp files once the
in-memory buffer crosses the memory cap, and the extension phase loads
them back bin by bin, so a large query-block x ref-block round has a
bounded memory footprint.

Rows are the pipeline's [N, 4] int64 hit arrays (query_id, subject_gpos,
seed_offset, score).  Bin loads preserve the production order within a
bin (append order), so extension output is byte-identical to the
in-memory path.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

ROW_BYTES = 32


def hit_buffer_cap_rows() -> int:
    mb = int(os.environ.get("DIAMOND_TPU_HIT_BUFFER_MB", "1024"))
    return max(mb, 1) * (1 << 20) // ROW_BYTES


class HitBuffer:
    """Accumulates hit-row arrays; spills to per-bin files over the cap."""

    def __init__(self, n_queries: int, n_bins: int = 16,
                 cap_rows: int | None = None, tmpdir: str | None = None,
                 contexts: int = 1):
        self.n_queries = max(n_queries, 1)
        self.n_bins = n_bins
        self.cap = cap_rows if cap_rows is not None else hit_buffer_cap_rows()
        self.tmpdir = tmpdir
        self.mem: list[np.ndarray] = []
        self.mem_rows = 0
        self.files = None
        self.dir = None
        # bin b covers query ids [b*step, (b+1)*step); a multiple of the
        # context count so a translated source never straddles bins
        step = (self.n_queries + n_bins - 1) // n_bins
        self.step = max((step + contexts - 1) // contexts * contexts,
                        contexts)

    def append(self, rows: np.ndarray):
        if len(rows) == 0:
            return
        self.mem.append(rows)
        self.mem_rows += len(rows)
        if self.mem_rows > self.cap:
            self._flush()

    def _ensure_files(self):
        if self.files is None:
            self.dir = tempfile.mkdtemp(prefix="dtpu_hits_",
                                        dir=self.tmpdir)
            self.files = [open(os.path.join(self.dir, f"bin_{b}.bin"),
                               "ab") for b in range(self.n_bins)]

    def _flush(self):
        self._ensure_files()
        arr = np.concatenate(self.mem) if len(self.mem) > 1 else self.mem[0]
        self.mem = []
        self.mem_rows = 0
        bins = arr[:, 0] // self.step
        # stable split preserves production order within each bin
        order = np.argsort(bins, kind="stable")
        arr = arr[order]
        bins = bins[order]
        bounds = np.searchsorted(bins, np.arange(self.n_bins + 1))
        for b in range(self.n_bins):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            if hi > lo:
                self.files[b].write(
                    np.ascontiguousarray(arr[lo:hi]).tobytes())

    @property
    def spilled(self) -> bool:
        return self.files is not None

    def finish(self):
        """Seal writers; returns self for iteration."""
        if self.files is not None:
            if self.mem:
                self._flush()
            for f in self.files:
                f.close()
        return self

    def bins(self):
        """Yield per-bin row arrays in ascending query-id-range order."""
        if self.files is None:
            arr = (np.concatenate(self.mem) if self.mem
                   else np.empty((0, 4), dtype=np.int64))
            yield arr
            return
        for b in range(self.n_bins):
            path = os.path.join(self.dir, f"bin_{b}.bin")
            data = np.fromfile(path, dtype=np.int64).reshape(-1, 4)
            yield data
            os.remove(path)
        os.rmdir(self.dir)
