"""Score-only uniform-band SWIPE on the card: one query against many targets
(the counterpart of ``diamond_tpu/ops/swipe_pallas.py``).

The kernel, ``banded_swipe_uniform_cuda`` (CUDA C++ in
``csrc/uniform_swipe.cu``, its band-from-a-mask entry point), replaces the
TPU kernel ``diamond_tpu/ops/swipe_pallas.py:banded_swipe_pallas``; its plain
PyTorch version ``banded_swipe_uniform_cuda_plain`` computes the same
function with tensor ops and is what the wrapper runs for tensors on the CPU.

``pack_uniform_batch`` packs a query's jobs as ``prepare_pallas_batch`` does
(the same band, C, shifts and meta; see ``ops/swipe_uniform``) without the
TPU's +8 prefetch columns, tile padding and fp32-exactness check, and with
the profile transposed, [32, T + band].  Bands above ``MAX_UNIFORM_BAND``
are the caller's to send to the host DP.
"""
from __future__ import annotations

import numpy as np
import torch

from diamond_tpu_torch.ops._cuda import check_tensors
from diamond_tpu_torch.ops.swipe_uniform import (MAX_UNIFORM_BAND,
                                                 MAX_WARP_BAND, NEG,
                                                 make_profile, pad_band,
                                                 pad_pow2, profile_rows,
                                                 uniform_shape, uniform_walk)
from diamond_tpu_torch.utils.log import ptimer

# most bytes of strip carries (int2 [B][2][T]) one launch of the wide-band
# walk takes; a larger batch goes in several launches
SCRATCH_BYTES = 256 << 20


def _k4():
    from diamond_tpu_torch.ops import _cuda

    return _cuda.launcher("uniform_swipe", "uniform_swipe_mask_launch",
                          "iipppiiiiiiiiippppp")


def check_uniform(t_idx, rows, prof_t, rows_dtype, rows_name: str):
    """Validate the inputs of the uniform-band kernel (rows: its band mask)
    or of the diagonal-band sweep (rows: its band lengths); returns (B, T,
    band)."""
    check_tensors(t_idx.device, ("t_idx", t_idx, torch.int8),
                  (rows_name, rows, rows_dtype), ("prof_t", prof_t, torch.int32))
    if t_idx.dim() != 2 or prof_t.dim() != 2 or prof_t.shape[0] != 32:
        raise ValueError("t_idx must be [B, T] and prof_t [32, T + band]")
    B, T = t_idx.shape
    band = prof_t.shape[1] - T
    if rows.shape[0] != B:
        raise ValueError(f"{rows_name} must have one row per target")
    if not 1 <= band <= MAX_UNIFORM_BAND:
        raise ValueError(f"band {band} outside 1..{MAX_UNIFORM_BAND}: such "
                         f"jobs take the host DP")
    return B, T, band


def banded_swipe_uniform_cuda(t_idx, band_mask, prof_t, go: int, ge: int,
                              rows=None):
    """Score-only banded SW of one profile against B target rows.

    t_idx int8 [B, T] shifted target letters, band_mask int8 [B, band] (row r
    of target b is in its band iff band_mask[b, r] != 0), prof_t int32
    [32, T + band] (row r of column j scores prof_t[letter][j + r], NEG out of
    the query); go = gap open + extend, ge = gap extend, both >= 0.  Returns
    int32 [B] (best, max_col, max_row) in shifted coordinates: max_col the
    first column where the best rises, max_row the highest band row of that
    column's ties.

    CUDA tensors launch the kernel (counted in
    ``banded_swipe_uniform_cuda.launches``).  Bands above MAX_WARP_BAND need
    the profile's live rows, ``profile_rows(prof_t)``: ``rows`` where the
    caller has them on the host (``pack_uniform_batch`` does), else the
    wrapper reduces prof_t on the card and reads them back (one sync).  A
    batch whose strip carries would pass SCRATCH_BYTES takes several
    launches.  CPU tensors run ``banded_swipe_uniform_cuda_plain``."""
    B, T, band = check_uniform(t_idx, band_mask, prof_t, torch.int8,
                               "band_mask")
    if band_mask.shape[1] != band:
        raise ValueError("band_mask must be [B, band] with band = "
                         "prof_t.shape[1] - T")
    if go < 0 or ge < 0:
        raise ValueError("gap costs must be >= 0")
    dev = t_idx.device
    if dev.type == "cpu":
        return banded_swipe_uniform_cuda_plain(t_idx, band_mask, prof_t, go, ge)
    if dev.type != "cuda":
        raise ValueError(f"banded_swipe_uniform_cuda runs on cuda or cpu, "
                         f"not {dev}")
    out = [torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(3)]
    if B == 0 or T == 0:
        return tuple(out)
    if band <= MAX_WARP_BAND:
        rows = (0, 0, 0, 1)  # the warp path takes no profile rows
    else:
        if rows is None:
            rows = profile_rows(prof_t)
        if rows[1] == rows[0]:
            return tuple(out)  # no row scores: every target (0, 0, 0)
    uniform_launch(t_idx, band_mask, prof_t, go, ge, rows, out)
    return tuple(out)


def uniform_launch(t_idx, band_mask, prof_t, go: int, ge: int, rows, out):
    """The kernel's launches on checked CUDA inputs, writing ``out`` (three
    int32 [B]); rows = profile_rows(prof_t) for bands above MAX_WARP_BAND
    (the wrapper's read-back, given here so that a CUDA graph can hold the
    launches alone)."""
    B, T = t_idx.shape
    band = prof_t.shape[1] - T
    dev = t_idx.device
    p_lo, p_hi, pos, all_valid = rows
    R, strips = uniform_shape(band, p_hi - p_lo)
    chunk = B if strips == 1 else max(1, SCRATCH_BYTES // (16 * T))
    scratch = torch.empty((min(chunk, B) if strips > 1 else 0, 2, T, 2),
                          dtype=torch.int32, device=dev)
    pos = pos - (1 << 32) if pos >= 1 << 31 else pos  # a C int's bits
    with torch.cuda.device(dev):  # the launches go to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, chunk):
            b1 = min(B, b0 + chunk)
            err = _k4()(R, strips, t_idx[b0:b1].data_ptr(),
                        band_mask[b0:b1].data_ptr(), prof_t.data_ptr(),
                        b1 - b0, T, band, int(go), int(ge), p_lo, p_hi, pos,
                        all_valid, scratch.data_ptr(),
                        *[o[b0:b1].data_ptr() for o in out], stream)
            if err != 0:
                raise RuntimeError(f"banded_swipe_uniform_cuda launch "
                                   f"failed: CUDA error {err}")
            banded_swipe_uniform_cuda.launches += 1


banded_swipe_uniform_cuda.launches = 0


def banded_swipe_uniform_cuda_plain(t_idx, band_mask, prof_t, go: int,
                                    ge: int, rows=None):
    """The kernel's function in tensor ops (``swipe_uniform.uniform_walk``);
    exact int32, on whatever device the inputs are on (``rows``, the
    kernel's hint, unused)."""
    return uniform_walk(t_idx, band_mask != 0, prof_t, go, ge)


def pack_uniform_batch(query, bias, matrix32, jobs):
    """The kernel's numpy inputs for one query's jobs [(target, d0, d1)]:
    dict(t_idx int8 [B, T], band_mask int8 [B, band], prof_t int32
    [32, T + band]) and meta {"C", "shifts", "band", "rows"} (target k is
    shifted by shifts[k] = d0_k + C, so band row r of column j is query
    position j - C + r; rows = ``profile_rows(prof_t)``, from the query's
    columns alone, the only ones that can score)."""
    qlen = len(query)
    band = pad_band(max(d1 - d0 for _, d0, d1 in jobs))
    C = max(0, -min(d0 for _, d0, _ in jobs))
    shifts = [d0 + C for _, d0, _ in jobs]
    T = pad_pow2(max(len(t) + s for (t, _, _), s in zip(jobs, shifts)), 16)
    t_idx = np.full((len(jobs), T), 31, dtype=np.int8)
    band_mask = np.zeros((len(jobs), band), dtype=np.int8)
    for k, ((t, d0, d1), s) in enumerate(zip(jobs, shifts)):
        t_idx[k, s: s + len(t)] = np.asarray(t, dtype=np.int8) & 31
        band_mask[k, : d1 - d0] = 1
    prof_t = np.full((32, T + band), NEG, dtype=np.int32)
    i0, i1 = 0, min(qlen, T + band - C)  # profile column C + i: query pos i
    rows = (0, 0, 0, 1)
    if i1 > i0:
        prof_t[:, i0 + C: i1 + C] = make_profile(query, bias, matrix32,
                                                 qlen)[i0:i1].T
        p_lo, p_hi, pos, ok = profile_rows(prof_t[:, i0 + C: i1 + C])
        if p_hi > p_lo:
            rows = (p_lo + i0 + C, p_hi + i0 + C, pos, ok)
    return (dict(t_idx=t_idx, band_mask=band_mask, prof_t=prof_t),
            {"C": C, "shifts": shifts, "band": band, "rows": rows})


def uniform_scores(query, bias, matrix32, jobs, go: int, ge: int, device,
                   kernel=None):
    """One call of ``kernel`` (``banded_swipe_uniform_cuda`` unless given,
    with the profile's live rows from the packing) over a query's jobs on
    ``device``.  Returns numpy int64 (best, max_col,
    max_row) in shifted coordinates and the packing's meta.  Phase timers:
    ``k4.pack``, ``k4.upload`` and ``k4.kernel`` (the call and the read-back
    of its outputs)."""
    with ptimer("k4.pack"):
        packed, meta = pack_uniform_batch(query, bias, matrix32, jobs)
        if meta["band"] > MAX_UNIFORM_BAND:
            raise ValueError(f"band {meta['band']} above {MAX_UNIFORM_BAND}: "
                             f"such jobs take the host DP")
    with ptimer("k4.upload"):
        dev = torch.device(device)
        x = {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
    with ptimer("k4.kernel"):
        out = (kernel or banded_swipe_uniform_cuda)(
            x["t_idx"], x["band_mask"], x["prof_t"], go, ge,
            rows=meta["rows"])
        best, mc, mr = torch.stack(out).cpu().numpy().astype(np.int64)
    return best, mc, mr, meta


def host_as_uniform(ref, jobs):
    """The host DP's (score, subject_pos, query_pos) triples of ``jobs`` in
    the kernel's best-effort output (score, subject_pos, band row), band row
    = query_pos - subject_pos - d0 (0 for score 0, where the host reports
    (0, 0, d0))."""
    return [(s, j, i - j - d0) for (s, j, i), (_, d0, _) in zip(ref, jobs)]


def from_pallas_uniform_batch(t_idx, band_mask, profile_pad, band: int):
    """A ``prepare_pallas_batch`` batch (diamond_tpu's banded_swipe_pallas:
    t_idx [T, B] int32, band_mask [B, band] int32, profile_pad [T + band, 32]
    int32) as this kernel's numpy inputs.  The TPU kernel walks the first
    T - 8 columns (the last 8 are its prefetch margin); so does the carried
    batch, so the outputs equal the TPU kernel's row for row."""
    t_idx = np.asarray(t_idx)
    n_cols = t_idx.shape[0] - 8
    bm = np.asarray(band_mask)
    if bm.shape[1] != band:
        raise ValueError("band_mask must be [B, band]")
    return dict(
        t_idx=np.ascontiguousarray(t_idx[:n_cols].T & 31).astype(np.int8),
        band_mask=(bm != 0).astype(np.int8),
        prof_t=np.ascontiguousarray(
            np.asarray(profile_pad)[: n_cols + band].T).astype(np.int32))
