"""Native (C++) host-side runtime components.

The reference implements its host runtime (masking scans, IO, seed
bookkeeping) in C++ (reference src/masking/, src/util/io/); this package
provides the TPU framework's equivalents as a small C++ library compiled
on first use with g++ and loaded via ctypes.  Every entry point has a
bit-identical Python twin used as fallback (and as the test oracle), so
the framework degrades gracefully on systems without a toolchain.

Float32 code is compiled with -ffp-contract=off so results match the
numpy twins exactly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_lib = None
_tried = False
_sort_tmp = None


def _sources():
    return sorted(
        os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
        if f.endswith(".cc"))


def _build(sources, out_path):
    # -ffp-contract=off keeps float results bit-identical to the numpy
    # twins even with -march=native (no FMA contraction)
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared",
           "-ffp-contract=off", "-o", out_path] + sources
    subprocess.run(cmd, check=True, capture_output=True)


def lib():
    """The compiled native library (ctypes.CDLL) or None."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DIAMOND_TPU_NO_NATIVE"):
        return None
    try:
        sources = _sources()
        h = hashlib.sha256()
        for s in sources:
            with open(s, "rb") as f:
                h.update(f.read())
        cache_dir = os.path.join(tempfile.gettempdir(),
                                 f"diamond_tpu_native_{os.getuid()}")
        os.makedirs(cache_dir, exist_ok=True)
        # debug hook: point at a prebuilt .so (e.g. an ASan build)
        so_path = os.environ.get("DIAMOND_TPU_NATIVE_SO") or os.path.join(
            cache_dir, f"libdtpu_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".tmp{os.getpid()}"
            _build(sources, tmp)
            os.replace(tmp, so_path)
        cdll = ctypes.CDLL(so_path)
        cdll.tantan_repeat_prob.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
        cdll.tantan_repeat_prob.restype = None
        cdll.xdrop_ungapped_one.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p]
        cdll.xdrop_ungapped_one.restype = None
        cdll.xdrop_ungapped_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.xdrop_ungapped_chain.restype = ctypes.c_int64
        cdll.leftmost_verify.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int32, ctypes.c_void_p]
        cdll.leftmost_verify.restype = None
        cdll.banded_swipe_many.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        cdll.banded_swipe_many.restype = None
        cdll.stage1_filter_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
        cdll.stage1_filter_many.restype = None
        cdll.stage2_scores_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
        cdll.stage2_scores_many.restype = None
        cdll.tantan_repeat_prob_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        cdll.tantan_repeat_prob_many.restype = None
        cdll.dmnd_hash_records.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        cdll.dmnd_hash_records.restype = None
        cdll.enumerate_seeds_filtered.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.enumerate_seeds_filtered.restype = ctypes.c_int64
        cdll.extract_seeds_many.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        cdll.extract_seeds_many.restype = None
        cdll.clip_window_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        cdll.clip_window_many.restype = None
        cdll.enumerate_seeds_block.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        cdll.enumerate_seeds_block.restype = ctypes.c_int64
        cdll.motif_scan_block.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        cdll.motif_scan_block.restype = ctypes.c_int64
        cdll.left_most_filter_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int32, ctypes.c_void_p]
        cdll.left_most_filter_many.restype = None
        cdll.sort_kv_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        cdll.sort_kv_u64.restype = None
        cdll.sort_kv_u64_d16.argtypes = cdll.sort_kv_u64.argtypes
        cdll.sort_kv_u64_d16.restype = None
        cdll.banded_swipe_tb_many.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.banded_swipe_tb_many.restype = None
        cdll.banded_swipe_tb_multi.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.banded_swipe_tb_multi.restype = None
        cdll.banded_swipe_score_multi.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        cdll.banded_swipe_score_multi.restype = None
        cdll.banded_swipe_score_lanes.argtypes = \
            cdll.banded_swipe_score_multi.argtypes
        cdll.banded_swipe_score_lanes.restype = None
        cdll.backward_stats_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        cdll.backward_stats_many.restype = None
        cdll.sorted_join_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        cdll.sorted_join_merge.restype = ctypes.c_int64
        cdll.hauser_bias_i8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        cdll.hauser_bias_i8.restype = None
        cdll.seed_complexity_keep.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_double,
            ctypes.c_void_p]
        cdll.seed_complexity_keep.restype = None
        cdll.stage12_pipeline.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        cdll.stage12_pipeline.restype = ctypes.c_int64
        cdll.build_seed_part_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_void_p]
        cdll.build_seed_part_table.restype = None
        cdll.ungapped_stage_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        cdll.ungapped_stage_many.restype = ctypes.c_int64
        cdll.ungapped_stage_chunk_sel.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        cdll.ungapped_stage_chunk_sel.restype = ctypes.c_int64
        cdll.ungapped_stage_queries.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.ungapped_stage_queries.restype = ctypes.c_int64
        cdll.hauser_bias_block.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        cdll.hauser_bias_block.restype = None
        cdll.sw_islands.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        cdll.sw_islands.restype = ctypes.c_int64
        cdll.banded_3frame_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        cdll.banded_3frame_forward.restype = None
        cdll.block_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        cdll.block_fill.restype = None
        cdll.filter_keys.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        cdll.filter_keys.restype = ctypes.c_int64
        _lib = cdll
    except Exception:
        _lib = None
    return _lib


def tantan_repeat_prob(letters, ratios, p_repeat, p_repeat_end,
                       repeat_growth):
    """Native tantan scan; returns float32 probs or None if unavailable."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    letters = np.ascontiguousarray(letters, dtype=np.int8)
    ratios = np.ascontiguousarray(ratios, dtype=np.float32)
    out = np.empty(len(letters), dtype=np.float32)
    l.tantan_repeat_prob(
        letters.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(len(letters)),
        ratios.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(p_repeat), ctypes.c_float(p_repeat_end),
        ctypes.c_float(repeat_growth),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


_xdrop_out = None


def xdrop_ungapped_native(query, bias, target, qa: int, sa: int, matrix32,
                          xdrop: int):
    """Native x-drop extension; returns (i, j, len, score) or None.

    query/target must be contiguous int8 views whose memory extends at
    least one delimiter past both sequence boundaries (the padded block
    layout); bias, when given, a contiguous int8 array."""
    import numpy as np

    global _xdrop_out
    l = lib()
    if l is None:
        return None
    if _xdrop_out is None:
        _xdrop_out = np.empty(4, dtype=np.int64)
    out = _xdrop_out
    bias_p = bias.ctypes.data if bias is not None else None
    l.xdrop_ungapped_one(query.ctypes.data, bias_p, target.ctypes.data,
                         qa, sa, matrix32.ctypes.data, xdrop,
                         out.ctypes.data)
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])

_chain_bufs = None


def xdrop_chain_native(query, bias, target, hi, hj, matrix32, xdrop: int):
    """Batched per-target x-drop extension with the chaining skip rule.

    hi/hj: contiguous int64 seed coordinates sorted by (diag, j).  Returns
    (kept, out_i, out_j, out_len, out_score) numpy views valid until the
    next call, or None if the native library is unavailable."""
    import numpy as np

    global _chain_bufs
    l = lib()
    if l is None:
        return None
    n = len(hi)
    if _chain_bufs is None or len(_chain_bufs[0]) < n:
        _chain_bufs = tuple(np.empty(max(n, 64), dtype=np.int64)
                            for _ in range(4))
    oi, oj, ol, os_ = _chain_bufs
    bias_p = bias.ctypes.data if bias is not None else None
    kept = l.xdrop_ungapped_chain(
        query.ctypes.data, bias_p, target.ctypes.data,
        hi.ctypes.data, hj.ctypes.data, n, matrix32.ctypes.data, xdrop,
        oi.ctypes.data, oj.ctypes.data, ol.ctypes.data, os_.ctypes.data)
    return kept, oi, oj, ol, os_


def leftmost_verify_native(q_letters, s_letters, qs, ss, hit_bits,
                           match_masks, left, shape, reduction, chunked,
                           part_lo, part_hi, seedp_mask,
                           hamming_filter_id):
    """Native left-most hit verification; returns [N] bool or None.

    All array arguments must be contiguous (qs/ss int64, hit_bits/
    match_masks uint64); early-exits per hit on the first verified bit."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    n = len(qs)
    out = np.empty(n, dtype=np.uint8)
    pos = getattr(shape, "_pos64", None)
    if pos is None:
        pos = np.ascontiguousarray(shape.positions, dtype=np.int64)
        shape._pos64 = pos
    l.leftmost_verify(
        q_letters.ctypes.data, s_letters.ctypes.data,
        qs.ctypes.data, ss.ctypes.data,
        hit_bits.ctypes.data, match_masks.ctypes.data,
        n, int(bool(left)),
        ctypes.c_uint64(shape.mask), pos.ctypes.data, int(shape.weight),
        reduction.map.ctypes.data, int(reduction.size),
        int(bool(chunked)), int(part_lo), int(part_hi),
        ctypes.c_uint64(seedp_mask), int(hamming_filter_id),
        out.ctypes.data)
    return out.astype(bool)


def banded_swipe_many_native(q_letters, bias32, t_cat, t_off, t_len,
                             d_begins, bands, matrix32, go: int, ge: int,
                             mask_off=None, masks=None):
    """Batched banded-SWIPE score DP; returns [njobs, 3] int64
    (score, max_col, max_row_band) or None.

    All arrays contiguous; t_cat int8 concatenated targets with int64
    offsets/lengths; bias32 int32 per query position or None.  When
    mask_off/masks given (masks = 4 uint8 buffers), the trace-mask planes
    are emitted per job at those offsets."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    njobs = len(t_off)
    out = np.empty((njobs, 3), dtype=np.int64)
    bias_p = bias32.ctypes.data if bias32 is not None else None
    if masks is None:
        mo = gv = gh = ov = oh = None
    else:
        mo = mask_off.ctypes.data
        gv, gh, ov, oh = (m.ctypes.data for m in masks)
    l.banded_swipe_many(
        q_letters.ctypes.data, len(q_letters), bias_p,
        t_cat.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
        d_begins.ctypes.data, bands.ctypes.data, njobs,
        matrix32.ctypes.data, go, ge, out.ctypes.data,
        mo, gv, gh, ov, oh)
    return out


def banded_swipe_tb_native(q_letters, bias32, t_cat, t_off, t_len,
                           d_begins, bands, matrix32, go: int, ge: int):
    """Batched banded SWIPE with in-C++ traceback walk; returns
    (out [njobs,3], stats [njobs,12], op_off, op_codes, op_payload) or
    None.  stats[:,11] == 0 flags a walk failure for that job."""
    import numpy as np

    l = lib()
    if l is None or not hasattr(l, "banded_swipe_tb_many"):
        return None
    njobs = len(t_off)
    qlen = len(q_letters)
    caps = t_len + qlen + 2
    op_off = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(caps, out=op_off[1:])
    total = int(op_off[-1])
    op_codes = np.empty(total, dtype=np.int8)
    op_payload = np.empty(total, dtype=np.int32)
    out = np.empty((njobs, 3), dtype=np.int64)
    stats = np.empty((njobs, 12), dtype=np.int64)
    bias_p = bias32.ctypes.data if bias32 is not None else None
    l.banded_swipe_tb_many(
        q_letters.ctypes.data, qlen, bias_p,
        t_cat.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
        d_begins.ctypes.data, bands.ctypes.data, njobs,
        matrix32.ctypes.data, go, ge, out.ctypes.data,
        op_off.ctypes.data, op_codes.ctypes.data, op_payload.ctypes.data,
        stats.ctypes.data)
    return out, stats, op_off, op_codes, op_payload


def banded_swipe_score_multi_native(q_base, bias_base, q_off, q_len,
                                    use_bias, t_cat, t_off, t_len, d_begins,
                                    bands, matrix32, go: int, ge: int):
    """Cross-query batched score-only banded SWIPE; [njobs, 3] int64
    (score, max_col, max_row) in true per-job coordinates, or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    njobs = len(t_off)
    out = np.empty((njobs, 3), dtype=np.int64)
    bias_p = bias_base.ctypes.data if bias_base is not None else None
    fn = l.banded_swipe_score_lanes  # lane-parallel fast path
    fn(q_base.ctypes.data, bias_p, q_off.ctypes.data, q_len.ctypes.data,
       use_bias.ctypes.data,
       t_cat.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
       d_begins.ctypes.data, bands.ctypes.data, njobs,
       matrix32.ctypes.data, go, ge, out.ctypes.data)
    return out


def banded_swipe_tb_multi_native(q_base, bias_base, q_off, q_len, use_bias,
                                 t_cat, t_off, t_len, d_begins, bands,
                                 matrix32, go: int, ge: int):
    """Cross-query batched banded SWIPE + traceback walk (each job has its
    own query offset into q_base); same outputs as banded_swipe_tb_native
    or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    njobs = len(t_off)
    caps = t_len + q_len + 2
    op_off = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(caps, out=op_off[1:])
    op_codes = np.empty(int(op_off[-1]), dtype=np.int8)
    op_payload = np.empty(int(op_off[-1]), dtype=np.int32)
    out = np.empty((njobs, 3), dtype=np.int64)
    stats = np.empty((njobs, 12), dtype=np.int64)
    bias_p = bias_base.ctypes.data if bias_base is not None else None
    l.banded_swipe_tb_multi(
        q_base.ctypes.data, bias_p, q_off.ctypes.data, q_len.ctypes.data,
        use_bias.ctypes.data,
        t_cat.ctypes.data, t_off.ctypes.data, t_len.ctypes.data,
        d_begins.ctypes.data, bands.ctypes.data, njobs,
        matrix32.ctypes.data, go, ge, out.ctypes.data,
        op_off.ctypes.data, op_codes.ctypes.data, op_payload.ctypes.data,
        stats.ctypes.data)
    return out, stats, op_off, op_codes, op_payload


def sw_islands_native(q8, t8, matrix20, go: int, ge: int):
    """SW island decomposition scores for the Gumbel simulation; int32
    array of per-island best scores or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    cap = len(q8) * len(t8) // 4 + 1024
    out = np.empty(cap, dtype=np.int32)
    m20 = np.ascontiguousarray(matrix20, dtype=np.int32)
    n = l.sw_islands(q8.ctypes.data, len(q8), t8.ctypes.data, len(t8),
                     m20.ctypes.data, go, ge, out.ctypes.data, cap)
    return out[:n].copy()


def banded_3frame_forward_native(q_frames, target, d_begin, d_end, matrix32,
                                 go: int, ge: int, fs: int):
    """Native 3-frame banded-SWIPE forward pass; returns
    (S [(ncols+1), R+2] int32, best, max_col, cols_done) or None.
    Bit-identical to the ops/swipe3.py forward recurrence for scores that
    fit int32 (the C kernel accumulates in int32 while the numpy oracle
    uses int64; alignment scores above 2^31 are unreachable for real
    protein inputs — that would need a ~2×10^8-residue exact match)."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    band = d_end - d_begin
    i1_init = max(d_end - 1, 0)
    j0 = i1_init - (d_end - 1)
    R = band * 3
    ncols = len(target) - j0
    if ncols <= 0:
        return None
    qf = [np.ascontiguousarray(f, dtype=np.int8) for f in q_frames]
    t8 = np.ascontiguousarray(target, dtype=np.int8)
    m32 = np.ascontiguousarray(matrix32, dtype=np.int32)
    S = np.zeros((ncols + 1, R + 2), dtype=np.int32)
    out = np.empty(3, dtype=np.int64)
    l.banded_3frame_forward(
        qf[0].ctypes.data, qf[1].ctypes.data, qf[2].ctypes.data,
        len(qf[0]), len(qf[1]), len(qf[2]),
        t8.ctypes.data, len(t8),
        int(d_begin), int(d_end), m32.ctypes.data,
        int(go), int(ge), int(fs), S.ctypes.data, out.ctypes.data)
    return S, int(out[0]), int(out[1]), int(out[2])


def sorted_join_merge_native(qk, qp, sk, sp):
    """One-pass merge of key-sorted (key,pos) arrays; returns
    (keys, q_start, q_pos, s_start, s_pos) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    nq, ns = len(qk), len(sk)
    gcap = (nq if nq < ns else ns) + 1
    out_keys = np.empty(max(gcap - 1, 1), dtype=np.uint64)
    out_qstart = np.empty(gcap, dtype=np.int64)
    out_sstart = np.empty(gcap, dtype=np.int64)
    out_qpos = np.empty(max(nq, 1), dtype=np.int64)
    out_spos = np.empty(max(ns, 1), dtype=np.int64)
    g = l.sorted_join_merge(
        qk.ctypes.data, qp.ctypes.data, nq,
        sk.ctypes.data, sp.ctypes.data, ns,
        out_keys.ctypes.data, out_qstart.ctypes.data,
        out_sstart.ctypes.data, out_qpos.ctypes.data,
        out_spos.ctypes.data)
    # views, not copies: the buffers are exactly-capacity temporaries
    # that die with the per-chunk join
    return (out_keys[:g], out_qstart[: g + 1],
            out_qpos[: int(out_qstart[g])],
            out_sstart[: g + 1],
            out_spos[: int(out_sstart[g])])


def hauser_bias_native(letters, matrix32, background_scores,
                       window: int = 40):
    """Per-position Hauser bias as int8 (bit-exact twin of
    stats/cbs.py hauser_correction's i8 output) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    letters = np.ascontiguousarray(letters, dtype=np.int8)
    bg = np.ascontiguousarray(background_scores, dtype=np.float64)
    out = np.empty(len(letters), dtype=np.int8)
    l.hauser_bias_i8(letters.ctypes.data, len(letters),
                     matrix32.ctypes.data, bg.ctypes.data, int(window),
                     out.ctypes.data)
    return out


def seed_complexity_keep_native(keys, weight: int, base: int, lnfact,
                                cut: float):
    """Per-group reduced-alphabet entropy keep mask; bool array or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(len(keys), dtype=np.uint8)
    l.seed_complexity_keep(keys.ctypes.data, len(keys), int(weight),
                           int(base), lnfact.ctypes.data, float(cut),
                           out.ctypes.data)
    return out.view(bool)


def stage12_pipeline_native(q_letters, s_letters, q_seed_mask, join,
                            group_keep, group_lo, group_hi, q_block_starts,
                            cutoff_per_query, window_per_query,
                            clamp255, hamming_id, matrix32, self_search,
                            s_block_starts, do_leftmost, reduction, shape,
                            first_shape, chunked, current_matcher,
                            previous_matcher, part_lo, part_hi, seedp_mask,
                            out_rows, part_tbl=None, q_idx_tbl=None,
                            s_idx_tbl=None, stats_out=None):
    """Fused stage1+stage2+left-most over a join-group slice; writes
    [m, 4] hit rows into out_rows and returns m, or None."""
    l = lib()
    if l is None:
        return None
    import numpy as np

    pos64 = getattr(shape, "_pos64", None)
    if pos64 is None:
        pos64 = np.ascontiguousarray(shape.positions, dtype=np.int64)
        shape._pos64 = pos64

    def m_args(m):
        if m is None or m.empty:
            return None, 0
        return m.masks.ctypes.data, len(m.masks)

    ct, cn = m_args(current_matcher)
    pt, pn = m_args(previous_matcher)
    return l.stage12_pipeline(
        q_letters.ctypes.data, s_letters.ctypes.data,
        q_seed_mask.ctypes.data,
        join.q_start.ctypes.data, join.q_pos.ctypes.data,
        join.s_start.ctypes.data, join.s_pos.ctypes.data,
        group_keep.ctypes.data if group_keep is not None else None,
        int(group_lo), int(group_hi),
        q_block_starts.ctypes.data, len(q_block_starts),
        cutoff_per_query.ctypes.data, window_per_query.ctypes.data,
        int(bool(clamp255)),
        int(hamming_id), matrix32.ctypes.data,
        int(bool(self_search)), s_block_starts.ctypes.data,
        len(s_block_starts),
        int(bool(do_leftmost)),
        reduction.map.ctypes.data, int(reduction.size),
        ctypes.c_uint64(shape.mask), pos64.ctypes.data, int(shape.weight),
        int(shape.length),
        int(bool(first_shape)), int(bool(chunked)),
        ct, cn, pt, pn,
        int(part_lo), int(part_hi), ctypes.c_uint64(seedp_mask),
        part_tbl.ctypes.data if part_tbl is not None else None,
        q_idx_tbl.ctypes.data if q_idx_tbl is not None else None,
        s_idx_tbl.ctypes.data if s_idx_tbl is not None else None,
        out_rows.ctypes.data,
        stats_out.ctypes.data if stats_out is not None else None)


def ungapped_stage_many_native(q_view, bias_view, t_letters, t_starts,
                               t_lens, grp_start, hit_i, hit_j, hit_score,
                               matrix32, xdrop, gap_open, gap_extend,
                               query_len):
    """Fused first-round stage for one query over a chunk of targets:
    (diag, j) hit sort + x-drop chain extension + DiagGraph chaining +
    HSP merge per target (native/src/chaining.cc).  Returns
    (ungapped_score[nt], out_start[nt+1], hsp_rows[total, 7]) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    assert (t_starts.dtype == t_lens.dtype == grp_start.dtype == hit_i.dtype
            == hit_j.dtype == hit_score.dtype == np.int64
            and matrix32.dtype == np.int32), "int64/int32 layout contract"
    nt = len(t_starts)
    total_hits = int(grp_start[-1])
    usc = np.empty(nt, dtype=np.int64)
    out_start = np.empty(nt + 1, dtype=np.int64)
    cap = max(total_hits, 1)
    bias_p = bias_view.ctypes.data if bias_view is not None else None
    while True:
        out_hsp = np.empty((cap, 7), dtype=np.int64)
        n = l.ungapped_stage_many(
            q_view.ctypes.data, bias_p, t_letters.ctypes.data,
            t_starts.ctypes.data, t_lens.ctypes.data, grp_start.ctypes.data,
            hit_i.ctypes.data, hit_j.ctypes.data, hit_score.ctypes.data,
            nt, matrix32.ctypes.data, int(xdrop), int(gap_open),
            int(gap_extend), int(query_len), cap,
            usc.ctypes.data, out_start.ctypes.data, out_hsp.ctypes.data)
        if n >= 0:
            return usc, out_start, out_hsp[:n]
        cap *= 4  # backtrace emitted more HSPs than seed hits (rare)


def ungapped_stage_chunk_sel_native(q_view, bias_view, t_letters, chunk,
                                    tids, block_starts, block_lens,
                                    gstart, hit_i, hit_j, hit_score,
                                    matrix32, xdrop, gap_open, gap_extend,
                                    query_len, total_hits):
    """ungapped_stage_many with the chunk gather done in C; returns
    (ungapped_score[nt], out_start[nt+1], hsp_rows) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    nt = len(chunk)
    usc = np.empty(nt, dtype=np.int64)
    out_start = np.empty(nt + 1, dtype=np.int64)
    cap = max(int(total_hits), 1)
    bias_p = bias_view.ctypes.data if bias_view is not None else None
    while True:
        out_hsp = np.empty((cap, 7), dtype=np.int64)
        n = l.ungapped_stage_chunk_sel(
            q_view.ctypes.data, bias_p, t_letters.ctypes.data,
            chunk.ctypes.data, nt, tids.ctypes.data,
            block_starts.ctypes.data, block_lens.ctypes.data,
            gstart.ctypes.data, hit_i.ctypes.data, hit_j.ctypes.data,
            hit_score.ctypes.data, matrix32.ctypes.data, int(xdrop),
            int(gap_open), int(gap_extend), int(query_len), cap,
            usc.ctypes.data, out_start.ctypes.data, out_hsp.ctypes.data)
        if n >= 0:
            return usc, out_start, out_hsp[:n]
        cap *= 4  # backtrace emitted more HSPs than seed hits (rare)


def ungapped_stage_queries_native(q_letters, bias_all, t_letters, q_starts,
                                  qids, q_grp_lo, q_lens, g_tstart, g_tlen,
                                  g_hit_start, hit_i, hit_j, hit_score,
                                  matrix32, xdrop, gap_open, gap_extend,
                                  total_hits):
    """Whole-wave first-round ungapped+chaining stage (one call for every
    eligible query); returns (ungapped_score[G], out_start[G+1], hsp_rows)
    or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    G = len(g_tstart)
    nq = len(qids)
    usc = np.empty(G, dtype=np.int64)
    out_start = np.empty(G + 1, dtype=np.int64)
    cap = max(int(total_hits), 1)
    bias_p = bias_all.ctypes.data if bias_all is not None else None
    while True:
        out_hsp = np.empty((cap, 7), dtype=np.int64)
        n = l.ungapped_stage_queries(
            q_letters.ctypes.data, bias_p, t_letters.ctypes.data,
            q_starts.ctypes.data, qids.ctypes.data, q_grp_lo.ctypes.data,
            q_lens.ctypes.data, nq, g_tstart.ctypes.data,
            g_tlen.ctypes.data, g_hit_start.ctypes.data, hit_i.ctypes.data,
            hit_j.ctypes.data, hit_score.ctypes.data, matrix32.ctypes.data,
            int(xdrop), int(gap_open), int(gap_extend), cap,
            usc.ctypes.data, out_start.ctypes.data, out_hsp.ctypes.data)
        if n >= 0:
            return usc, out_start, out_hsp[:n]
        cap *= 4


def hauser_bias_block_native(letters, starts, lens, matrix32,
                             background_scores, window: int = 40):
    """Block-aligned int8 Hauser bias for every sequence in one call;
    None without the native library."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    bg = np.ascontiguousarray(background_scores, dtype=np.float64)
    starts64 = np.ascontiguousarray(starts, dtype=np.int64)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.zeros(len(letters), dtype=np.int8)
    l.hauser_bias_block(letters.ctypes.data, starts64.ctypes.data,
                        lens64.ctypes.data, len(lens64),
                        matrix32.ctypes.data, bg.ctypes.data, int(window),
                        out.ctypes.data)
    return out


def seed_part_table_native(letters, shape, reduction, seedp_mask):
    """Per-position seed partition table over a letters array (sentinel
    INT32_MAX = no valid seed); None without the native library."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    pos64 = getattr(shape, "_pos64", None)
    if pos64 is None:
        pos64 = np.ascontiguousarray(shape.positions, dtype=np.int64)
        shape._pos64 = pos64
    out = np.empty(len(letters), dtype=np.int16)
    l.build_seed_part_table(
        letters.ctypes.data, len(letters), pos64.ctypes.data,
        int(shape.weight), int(shape.length), reduction.map.ctypes.data,
        int(reduction.size), ctypes.c_uint64(seedp_mask), out.ctypes.data)
    return out


def backward_stats_native(q_base, bias_base, q_off, q_len, use_bias, t_cat,
                          t_off, send, d_begins, d_ends, matrix32,
                          go_pen: int, ge: int):
    """Batched reversed stats pass; returns [njobs, 3] int64
    (best, mismatch, gapopen) or None.  go_pen is the TOTAL cost of a
    length-1 gap (open + extend)."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    njobs = len(t_off)
    out = np.empty((njobs, 3), dtype=np.int64)
    bias_p = bias_base.ctypes.data if bias_base is not None else None
    l.backward_stats_many(
        q_base.ctypes.data, bias_p, q_off.ctypes.data, q_len.ctypes.data,
        use_bias.ctypes.data, t_cat.ctypes.data, t_off.ctypes.data,
        send.ctypes.data, d_begins.ctypes.data, d_ends.ctypes.data, njobs,
        matrix32.ctypes.data, go_pen, ge, out.ctypes.data)
    return out


def stage1_filter_native(q_letters, s_letters, qp, sp, hamming_id: int):
    """Native fingerprint identity filter; returns [N] bool or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    n = len(qp)
    out = np.empty(n, dtype=np.uint8)
    l.stage1_filter_many(q_letters.ctypes.data, s_letters.ctypes.data,
                         qp.ctypes.data, sp.ctypes.data, n, hamming_id,
                         out.ctypes.data)
    return out.astype(bool)


def stage2_scores_native(q_letters, s_letters, qp, sp, matrix32,
                         window: int, clamp: bool):
    """Native diagonal ungapped window scores; returns [N] int32 or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    n = len(qp)
    out = np.empty(n, dtype=np.int32)
    l.stage2_scores_many(q_letters.ctypes.data, s_letters.ctypes.data,
                         qp.ctypes.data, sp.ctypes.data, n,
                         matrix32.ctypes.data, window, int(bool(clamp)),
                         out.ctypes.data)
    return out


def tantan_repeat_prob_many(letters, starts, lens, ratios, p_repeat,
                            p_repeat_end, repeat_growth):
    """Batched native tantan over a concatenated block; returns a float32
    array aligned with letters (zeros outside sequences) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    letters = np.ascontiguousarray(letters, dtype=np.int8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    ratios = np.ascontiguousarray(ratios, dtype=np.float32)
    out = np.zeros(len(letters), dtype=np.float32)
    l.tantan_repeat_prob_many(
        letters.ctypes.data, starts.ctypes.data, lens.ctypes.data,
        len(starts), ratios.ctypes.data,
        ctypes.c_float(p_repeat), ctypes.c_float(p_repeat_end),
        ctypes.c_float(repeat_growth), out.ctypes.data)
    return out


def left_most_filter_native(q_letters, s_letters, q_seed_mask, reduction,
                            qp, sp, seed_offsets, window_lefts,
                            window_rights, shape, first_shape: bool,
                            chunked: bool, current_matcher, previous_matcher,
                            part_lo, part_hi, seedp_mask,
                            hamming_filter_id) -> "np.ndarray | None":
    """Full native left-most filter; returns [N] bool keeps or None.

    current/previous_matcher: BatchPatternMatcher instances (the raw
    pattern masks are read directly)."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    n = len(qp)
    out = np.empty(n, dtype=np.uint8)
    pos64 = getattr(shape, "_pos64", None)
    if pos64 is None:
        pos64 = np.ascontiguousarray(shape.positions, dtype=np.int64)
        shape._pos64 = pos64
    qp = np.ascontiguousarray(qp, dtype=np.int64)
    sp = np.ascontiguousarray(sp, dtype=np.int64)
    seed_offsets = np.ascontiguousarray(seed_offsets, dtype=np.int64)
    window_lefts = np.ascontiguousarray(window_lefts, dtype=np.int64)
    window_rights = np.ascontiguousarray(window_rights, dtype=np.int64)

    def m_args(m):
        if m.empty:
            return None, 0
        return m.masks.ctypes.data, len(m.masks)

    ct, cn = m_args(current_matcher)
    pt, pn = m_args(previous_matcher)
    l.left_most_filter_many(
        q_letters.ctypes.data, s_letters.ctypes.data,
        q_seed_mask.ctypes.data,
        reduction.map.ctypes.data, int(reduction.size),
        qp.ctypes.data, sp.ctypes.data, seed_offsets.ctypes.data,
        window_lefts.ctypes.data, window_rights.ctypes.data, n,
        ctypes.c_uint64(shape.mask), pos64.ctypes.data, int(shape.weight),
        int(shape.length),
        int(bool(first_shape)), int(bool(chunked)),
        ct, cn, pt, pn,
        int(part_lo), int(part_hi), ctypes.c_uint64(seedp_mask),
        int(hamming_filter_id), out.ctypes.data)
    return out.view(bool)


def filter_keys_native(t_keys, q_keys_sorted):
    """Query-indexed seed filter: bool keep mask of target keys present in
    the sorted query key array (hash probe, no DB-side sort), or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    t = np.ascontiguousarray(t_keys, dtype=np.uint64)
    q = np.ascontiguousarray(q_keys_sorted, dtype=np.uint64)
    keep = np.empty(len(t), dtype=np.uint8)
    l.filter_keys(t.ctypes.data, len(t), q.ctypes.data, len(q),
                  keep.ctypes.data)
    return keep.view(np.bool_)


def sort_kv_native(keys, vals, inplace: bool = False):
    """Stable radix sort of (uint64 key, int64 value) pairs; returns the
    sorted (keys, vals) arrays (copies unless inplace and the inputs are
    already contiguous with the right dtypes) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    n = len(keys)
    # ascontiguousarray returns the input unchanged when dtype/layout
    # already match; only then does inplace avoid the defensive copy
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    v = np.ascontiguousarray(vals, dtype=np.int64)
    if not inplace:
        if k is keys:
            k = k.copy()
        if v is vals:
            v = v.copy()
    if n == 0:
        return k, v
    # scratch reused across calls: fresh multi-MB allocations churn this
    # host's proactive memory reclaim
    global _sort_tmp
    if _sort_tmp is None or len(_sort_tmp[0]) < n:
        _sort_tmp = (np.empty(n, dtype=np.uint64),
                     np.empty(n, dtype=np.int64))
    tmp_k, tmp_v = _sort_tmp
    bits = max(int(k.max()).bit_length(), 1)
    if bits > 24:
        # 16-bit digits: 3 passes for 48-bit seed keys instead of 5
        l.sort_kv_u64_d16(k.ctypes.data, v.ctypes.data, n,
                          tmp_k.ctypes.data, tmp_v.ctypes.data, bits)
    else:
        l.sort_kv_u64(k.ctypes.data, v.ctypes.data, n,
                      tmp_k.ctypes.data, tmp_v.ctypes.data,
                      (bits + 7) // 8)
    return k, v


def clip_window_native(letters, pos, window: int):
    """Native per-position delimiter window clip; returns (left, right)
    int64 arrays or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    n = len(pos)
    out_l = np.empty(n, dtype=np.int64)
    out_r = np.empty(n, dtype=np.int64)
    l.clip_window_many(letters.ctypes.data, pos.ctypes.data, n, window,
                       out_l.ctypes.data, out_r.ctypes.data)
    return out_l, out_r


def enumerate_seeds_native(reduced, starts, lengths, positions64, weight,
                           shape_length: int, base: int, min_len: int):
    """Native compacted seed enumeration; returns (keys, positions) or
    None.  Walks sequences directly (no per-window temporaries)."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    # two passes: count, then fill an exact-size buffer (large over-
    # allocation + copy would churn the host's proactive memory reclaim)
    m = l.enumerate_seeds_block(
        reduced.ctypes.data, starts.ctypes.data, lengths.ctypes.data,
        len(starts), positions64.ctypes.data, int(weight),
        int(shape_length), int(base), int(min_len), None, None)
    keys = np.empty(m, dtype=np.uint64)
    pos = np.empty(m, dtype=np.int64)
    l.enumerate_seeds_block(
        reduced.ctypes.data, starts.ctypes.data, lengths.ctypes.data,
        len(starts), positions64.ctypes.data, int(weight),
        int(shape_length), int(base), int(min_len),
        keys.ctypes.data, pos.ctypes.data)
    return keys, pos


def motif_scan_native(letters, starts, lengths, table64, true_aa: int):
    """Native 8-mer motif table scan; returns global hit start positions
    (int64) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(len(letters), dtype=np.int64)
    m = l.motif_scan_block(
        letters.ctypes.data, starts.ctypes.data, lengths.ctypes.data,
        len(starts), table64.ctypes.data, len(table64), int(true_aa),
        out.ctypes.data)
    return out[:m].copy()


def extract_seeds_native(reduced, n_windows: int, positions64, weight,
                         base: int):
    """Native whole-array spaced-seed extraction over the first n_windows
    start positions; returns (keys uint64, valid bool) or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    keys = np.empty(n_windows, dtype=np.uint64)
    valid = np.empty(n_windows, dtype=np.uint8)
    l.extract_seeds_many(reduced.ctypes.data, n_windows,
                         positions64.ctypes.data, int(weight), int(base),
                         keys.ctypes.data, valid.ctypes.data)
    return keys, valid.view(bool)


def dmnd_hash_records(letters_cat, starts, lens, ids_cat, id_offs,
                      hash16: bytes) -> "bytes | None":
    """Chained dmnd header hash over a record chunk (masked letters then
    id bytes per record); returns the updated 16-byte digest or None."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    buf = np.frombuffer(hash16, dtype=np.uint8).copy()
    l.dmnd_hash_records(
        letters_cat.ctypes.data, starts.ctypes.data, lens.ctypes.data,
        ids_cat.ctypes.data, id_offs.ctypes.data, len(starts),
        buf.ctypes.data)
    return buf.tobytes()


def enumerate_seeds_filtered_native(reduced, starts, lengths, positions64,
                                    weight, shape_length: int, base: int,
                                    min_len: int, q_keys_sorted):
    """Fused DB-side enumeration + query-key probe (query-indexed
    route): returns only the (keys, positions) whose key is present in
    q_keys_sorted, or None when the native lib is unavailable.
    Identical survivors/order to enumerate + filter_keys."""
    import numpy as np

    l = lib()
    if l is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    qk = np.ascontiguousarray(q_keys_sorted, dtype=np.uint64)
    cap = int((lengths - shape_length + 1).clip(min=0).sum())
    keys = np.empty(cap, dtype=np.uint64)
    pos = np.empty(cap, dtype=np.int64)
    m = l.enumerate_seeds_filtered(
        reduced.ctypes.data, starts.ctypes.data, lengths.ctypes.data,
        len(starts), positions64.ctypes.data, int(weight),
        int(shape_length), int(base), int(min_len), qk.ctypes.data,
        len(qk), keys.ctypes.data, pos.ctypes.data)
    return keys[:m].copy(), pos[:m].copy()
