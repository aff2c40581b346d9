"""Persisted target seed index (makeidx / --target-indexed).

Reference: src/data/index.cpp (makeidx persists a HashedSeedSet of DB seeds
to <db>.seed_idx, mmap-ed at search time), data/seed_set.h HashedSeedSet.

TPU-native re-design: instead of linear-probing hash tables, the index
stores the per-shape seed arrays (key, position) pre-sorted by key — the
layout the pipeline's sort-merge join consumes directly, so --target-indexed
skips both enumeration and the target-side sort at search time.  Seeds are
enumerated exactly like the search pipeline (tantan-masked block, motif
soft-masking), so indexed and non-indexed searches are byte-identical.
"""
from __future__ import annotations

import numpy as np

FORMAT_VERSION = 1


def build_seed_index(path: str, block, cfg):
    """Enumerate and persist the masked block's seeds for cfg's shapes."""
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.search.pipeline import (Pipeline, apply_ranges,
                                             mask_block, motif_mask_ranges,
                                             restore_ranges)

    mask_block(block, Tantan(cfg.matrix.matrix32))
    motif = motif_mask_ranges(block) if cfg.motif_masking else []
    pipe = Pipeline(cfg, block, block)
    arrays = {"version": np.int64(FORMAT_VERSION),
              "sensitivity": np.bytes_(cfg.sensitivity.encode()),
              "n_shapes": np.int64(len(cfg.shapes)),
              "n_letters": np.int64(block.n_letters)}
    for sid in range(len(cfg.shapes)):
        saved = apply_ranges(block.letters, motif)
        keys, pos = pipe._enumerate(block, cfg.shapes[sid])
        restore_ranges(block.letters, saved)
        order = np.argsort(keys, kind="stable")
        arrays[f"keys_{sid}"] = keys[order]
        arrays[f"pos_{sid}"] = pos[order]
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_seed_index(path: str, cfg):
    """[(keys, pos)] per shape, key-sorted; validates the sensitivity."""
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise RuntimeError("Unsupported seed index version.")
        sens = bytes(z["sensitivity"]).decode()
        if sens != cfg.sensitivity:
            raise RuntimeError(
                f"Seed index was built for sensitivity '{sens}', search uses "
                f"'{cfg.sensitivity}'. Rebuild with makeidx.")
        n = int(z["n_shapes"])
        if n != len(cfg.shapes):
            raise RuntimeError("Seed index shape count mismatch.")
        return [(z[f"keys_{sid}"], z[f"pos_{sid}"]) for sid in range(n)]
