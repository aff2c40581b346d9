"""Score-only banded 3-frame SWIPE on the card (``blastx -F``, ``--long-reads``).

The kernel, ``banded_swipe3`` (CUDA C++ in ``csrc/swipe3.cu``), replaces the
TPU kernel ``diamond_tpu/ops/swipe3_pallas.py:banded_swipe3_pallas``; its
plain PyTorch version ``banded_swipe3_plain`` computes the same function with
tensor ops and is what the wrapper runs for tensors on the CPU.

The function is ``ops/swipe3._forward_np`` for every job of a ragged batch:
the DP band interleaves the three frame translations of one query strand
(row r = 3 * query offset + frame), moves one query position per target
column, and each cell takes the max of the same-frame diagonal + s, rows
r - 1 / r + 1 of the previous column + s - frameshift, the horizontal gap
from row r + 3 of the previous column, the frame's vertical gap, and 0.
Outputs per job: the best score and max_col, the first DP column where the
best rises strictly (-1 when nothing scores).  ``swipe3_scores`` takes the
jobs of many reads at once: ``align/frameshift`` sends a window of a
block's reads per call, one launch per band class.

Batch layout (flat, ragged, int32 offsets): ``t_cat`` int8 target letters,
``q_cat`` int8 frame letters with ``reqs`` rows (q_off, len0, len1, len2)
(the three frames of one strand stored one after another), ``jobs`` rows
(t_off, t_len, i0, band, req): job column j, band offset o, frame f is query
position i = i0 + j + o of frame f, valid when o < band, 0 <= i < len0 and
3 * i + f < min(3 * len1 + 1, 3 * len2 + 2) (``_forward_np`` stops a
column's row sweep at the first frame past its translation's end).
"""
from __future__ import annotations

import numpy as np
import torch

from diamond_tpu_torch.ops.swipe_device import check_tensors

NEG = -(2 ** 20)
OFFSETS_PER_LANE = (1, 2, 4, 8, 16)  # query offsets (3 rows each) per lane
MAX_BAND = 32 * OFFSETS_PER_LANE[-1]  # query offsets per band on the card
JOB_COLS = 5                          # jobs[k] = (t_off, t_len, i0, band, req)
REQ_COLS = 4                          # reqs[r] = (q_off, len0, len1, len2)

dispatch_count = 0  # launches made by swipe3_scores (either device)


def offsets_per_lane(band: int) -> int:
    """Query offsets each of the warp's 32 lanes holds (the kernel's class)."""
    k = 1
    while 32 * k < band:
        k *= 2
    return k


def _check_inputs(t_cat, q_cat, jobs, reqs, matrix32, K):
    i8, i32 = torch.int8, torch.int32
    check_tensors(t_cat.device, ("t_cat", t_cat, i8), ("q_cat", q_cat, i8),
                  ("jobs", jobs, i32), ("reqs", reqs, i32),
                  ("matrix32", matrix32, i32))
    if t_cat.dim() != 1 or q_cat.dim() != 1:
        raise ValueError("t_cat and q_cat must be 1-D")
    if jobs.dim() != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs must be [n, {JOB_COLS}], got {tuple(jobs.shape)}")
    if reqs.dim() != 2 or reqs.shape[1] != REQ_COLS:
        raise ValueError(f"reqs must be [m, {REQ_COLS}], got {tuple(reqs.shape)}")
    if tuple(matrix32.shape) != (32, 32):
        raise ValueError(f"matrix32 must be [32, 32], got {tuple(matrix32.shape)}")
    if K not in OFFSETS_PER_LANE:
        raise ValueError(f"offsets_per_lane must be one of {OFFSETS_PER_LANE}")


def _k3():
    from diamond_tpu_torch.ops import _cuda

    return _cuda.launcher("swipe3", "banded_swipe3_launch", "ipppppiiiippp")


def banded_swipe3(t_cat, q_cat, jobs, reqs, matrix32, go: int, ge: int,
                  fs: int, offsets_per_lane: int):
    """Score-only banded 3-frame SW for every job of a ragged batch (layout
    in the module docstring); go = gap open + extend, ge = gap extend,
    fs = frameshift penalty; every job's band <= 32 * offsets_per_lane.
    Returns int32 [n] tensors (best, max_col).

    CUDA tensors launch the kernel (counted in ``banded_swipe3.launches``);
    CPU tensors run ``banded_swipe3_plain``.
    """
    _check_inputs(t_cat, q_cat, jobs, reqs, matrix32, offsets_per_lane)
    dev = t_cat.device
    if dev.type == "cpu":
        return banded_swipe3_plain(t_cat, q_cat, jobs, reqs, matrix32, go, ge,
                                   fs, offsets_per_lane)
    if dev.type != "cuda":
        raise ValueError(f"banded_swipe3 runs on cuda or cpu, not {dev}")
    n = jobs.shape[0]
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    if n == 0:
        return tuple(out)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _k3()(offsets_per_lane, t_cat.data_ptr(), q_cat.data_ptr(),
                    jobs.data_ptr(), reqs.data_ptr(), matrix32.data_ptr(), n,
                    int(go), int(ge), int(fs), out[0].data_ptr(),
                    out[1].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_swipe3 launch failed: CUDA error {err}")
    banded_swipe3.launches += 1
    return tuple(out)


banded_swipe3.launches = 0


def banded_swipe3_plain(t_cat, q_cat, jobs, reqs, matrix32, go: int, ge: int,
                        fs: int, offsets_per_lane: int):
    """The kernel's function in tensor ops over [n_jobs, 96 * offsets_per_lane]
    rows, one target column per step (the Pallas kernel's form); exact int32,
    on whatever device the inputs are on."""
    dev = t_cat.device
    i32 = torch.int32
    n = jobs.shape[0]
    best = torch.zeros(n, dtype=i32, device=dev)
    max_col = torch.full((n,), -1, dtype=i32, device=dev)
    if n == 0:
        return best, max_col
    rows = 96 * offsets_per_lane
    t_off, t_len, i0, band, req = jobs.long().unbind(1)
    q_off, l0, l1, l2 = reqs[req].long().unbind(1)
    stop = torch.minimum(3 * l1 + 1, 3 * l2 + 2)
    r = torch.arange(rows, device=dev)
    o, f = r // 3, r % 3
    o_ge = (o * ge).to(i32)
    base = q_off[:, None] + torch.stack([torch.zeros_like(l0), l0, l0 + l1],
                                        1)[:, f]
    in_band = o[None, :] < band[:, None]
    M = matrix32.long()
    S = torch.zeros(n, rows, dtype=i32, device=dev)
    Hg = torch.zeros(n, rows, dtype=i32, device=dev)
    z1 = torch.zeros(n, 1, dtype=i32, device=dev)
    z3 = torch.zeros(n, 3, dtype=i32, device=dev)
    neg3 = torch.full((n, 3), NEG, dtype=i32, device=dev)
    q_last = max(q_cat.numel() - 1, 0)
    t_last = max(t_cat.numel() - 1, 0)
    for j in range(int(t_len.max())):
        active = j < t_len
        tl = t_cat[(t_off + j).clamp(max=t_last)].long() & 31
        i = i0[:, None] + j + o[None, :]
        valid = (in_band & (i >= 0) & (i < l0[:, None])
                 & (3 * i + f[None, :] < stop[:, None]) & active[:, None])
        ql = q_cat[(base + i).clamp(0, q_last)].long() & 31
        s = M[ql, tl[:, None]].to(i32)
        sm4 = torch.cat([z1, S[:, :-1]], dim=1)   # row r - 1
        sm2 = torch.cat([S[:, 1:], z1], dim=1)    # row r + 1
        hg = torch.cat([Hg[:, 3:], z3], dim=1)    # row r + 3
        cur0 = torch.maximum(S + s, torch.maximum(sm4, sm2) + (s - fs))
        cur0 = torch.maximum(cur0, hg).clamp_min(0)
        g = torch.where(valid, cur0 - go + o_ge, NEG)
        gmax = torch.cummax(g.view(n, rows // 3, 3), dim=1).values.view(n, rows)
        F = gmax - o_ge
        Fs = torch.cat([neg3, F[:, :-3]], dim=1)
        Hn = torch.where(valid, torch.maximum(cur0, Fs), 0)
        cb = Hn.max(dim=1).values
        upd = cb > best
        best = torch.where(upd, cb, best)
        max_col = torch.where(upd, j, max_col)
        Hg = torch.where(valid, torch.maximum(hg - ge, Hn - go), 0)
        S = Hn
    return best, max_col


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_swipe3(strands, jobs):
    """The kernel's numpy inputs for 3-frame jobs over query strands (one
    read's two, or the strands of many reads).

    strands: per strand, its three frame translations; jobs: [(strand,
    target_letters, d_begin, d_end)] as ops/swipe3.banded_3frame_swipe_np
    takes them (band = d_end - d_begin, first column at target position
    j0).  Returns a dict of numpy arrays (t_cat, q_cat, jobs, reqs)."""
    q_parts, reqs, off = [], [], 0
    for frames in strands:
        lens = [len(fr) for fr in frames]
        q_parts += [np.asarray(fr, dtype=np.int8) & 31 for fr in frames]
        reqs.append((off, *lens))
        off += sum(lens)
    t_parts, rows, t_off = [], [], 0
    for strand, t, d0, d1 in jobs:
        band = d1 - d0
        i1 = max(d1 - 1, 0)
        j0 = i1 - (d1 - 1)
        tt = np.asarray(t, dtype=np.int8)[j0:] & 31
        t_parts.append(tt)
        rows.append((t_off, len(tt), i1 + 1 - band, band, strand))
        t_off += len(tt)
    if t_off >= 2 ** 31 or off >= 2 ** 31:
        raise ValueError("3-frame batch exceeds int32 letter offsets")
    return dict(
        t_cat=(np.concatenate(t_parts) if t_parts else np.zeros(0, np.int8)),
        q_cat=(np.concatenate(q_parts) if q_parts else np.zeros(0, np.int8)),
        jobs=np.asarray(rows, dtype=np.int32).reshape(-1, JOB_COLS),
        reqs=np.asarray(reqs, dtype=np.int32).reshape(-1, REQ_COLS))


def swipe3_scores(strands, jobs, matrix32, go: int, ge: int, fs: int,
                  device, kernel=None):
    """Score every (strand, target, d_begin, d_end) job with one launch per
    band class (bands <= MAX_BAND) of ``kernel`` (``banded_swipe3`` unless
    given); ``strands`` may hold the strands of many reads.  A launch's jobs
    run longest target first, so long warps start first and short ones fill
    in behind them.  Returns numpy int64 (best, max_col) in job order;
    max_col is the DP column (-1 when nothing scores)."""
    global dispatch_count
    kernel = kernel or banded_swipe3
    packed = pack_swipe3(strands, jobs)
    bands = packed["jobs"][:, 3]
    if len(bands) and bands.max() > MAX_BAND:
        raise ValueError(f"3-frame bands above {MAX_BAND} take the host DP")
    n = len(bands)
    K = np.array([offsets_per_lane(int(b)) for b in bands], np.int64)
    order = np.lexsort((-packed["jobs"][:, 1].astype(np.int64), K))
    packed["jobs"] = np.ascontiguousarray(packed["jobs"][order])
    dev = torch.device(device)
    x = {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
    m32 = torch.from_numpy(np.ascontiguousarray(matrix32, dtype=np.int32)).to(dev)
    classes, los = np.unique(K[order], return_index=True)
    outs = []
    for k, lo, hi in zip(classes, los, np.append(los[1:], n)):
        outs.append(kernel(x["t_cat"], x["q_cat"], x["jobs"][lo:hi], x["reqs"],
                           m32, go, ge, fs, int(k)))
        dispatch_count += 1
    best = np.zeros(n, np.int64)
    max_col = np.full(n, -1, np.int64)
    if outs:
        res = torch.stack([torch.cat([o[k] for o in outs]) for k in range(2)])
        best[order], max_col[order] = res.cpu().numpy()
    return best, max_col


# ---------------------------------------------------------------------------
# Carrying the TPU kernel's packed inputs across
# ---------------------------------------------------------------------------

def from_pallas_swipe3_batch(t_idx, band_mask, profile3_pad, matrix32):
    """A recorded ``prepare_swipe3_batch`` batch (diamond_tpu's
    banded_swipe3_pallas: t_idx [T, B], band_mask [B, 3 * band_q],
    profile3_pad [(T + band_q) * 3, 32]) as this kernel's flat inputs, one
    job per column of t_idx, so the outputs equal the TPU kernel's row for
    row, max_col in its column coordinates.

    The profile's rows are matrix rows of the frame letters at rows
    3 * (C3 + i) + f, NEG elsewhere (before the query, past a frame's end,
    past the stop row); each valid row maps back to the first letter with
    that matrix row, C3 is the first valid row of frame 0.  A job walks all
    T columns (the pad letter 31 included, as the TPU kernel does) with
    i0 = -C3.  Returns a dict of numpy arrays and offsets_per_lane."""
    t_idx = np.asarray(t_idx)
    T, B = t_idx.shape
    prof = np.asarray(profile3_pad).reshape(-1, 3, 32)
    m32 = np.asarray(matrix32)
    row_letter = {}
    for a in range(31, -1, -1):
        row_letter[m32[a].tobytes()] = a
    valid = (prof > NEG // 2).any(axis=2)            # [P, 3]
    frames, starts = [], []
    for f in range(3):
        idx = np.flatnonzero(valid[:, f])
        a, b = (int(idx[0]), int(idx[-1]) + 1) if len(idx) else (0, 0)
        if b - a != len(idx):
            raise ValueError("a frame's profile rows must be contiguous")
        letters = [row_letter.get(prof[p, f].astype(np.int32).tobytes())
                   for p in range(a, b)]
        if any(x is None for x in letters):
            raise ValueError("profile row is not a matrix row")
        frames.append(np.asarray(letters, dtype=np.int8))
        starts.append(a)
    c3 = starts[0]
    if any(len(fr) and s != c3 for fr, s in zip(frames, starts)):
        raise ValueError("frames must start at the same query offset")
    bm = np.asarray(band_mask) != 0
    rows3 = bm.sum(axis=1)
    if (rows3 % 3).any() or not (bm == (np.arange(bm.shape[1])[None, :]
                                        < rows3[:, None])).all():
        raise ValueError("band_mask rows must be prefixes of whole offsets")
    bands = rows3 // 3
    k = np.arange(B)
    jobs = np.stack([k * T, np.full(B, T), np.full(B, -c3), bands,
                     np.zeros(B, np.int64)], axis=1).astype(np.int32)
    packed = dict(
        t_cat=np.ascontiguousarray(t_idx.T.reshape(-1) & 31).astype(np.int8),
        q_cat=np.concatenate(frames).astype(np.int8),
        jobs=jobs,
        reqs=np.asarray([[0, *(len(fr) for fr in frames)]], dtype=np.int32))
    return packed, offsets_per_lane(max(int(bands.max()), 1))
