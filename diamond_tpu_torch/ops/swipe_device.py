"""Score-only SWIPE on the card: the banded extension DP and the full-matrix
``--swipe`` sweep.

``DeviceDP.run_many`` takes the score-only DP jobs of a whole extension round
(many queries, each with its own jobs) and scores them with one kernel launch
per band class.  The kernel, ``banded_swipe_multi`` (CUDA C++ in
``csrc/banded_swipe.cu``), replaces the TPU kernel
``diamond_tpu/ops/swipe_device.py:banded_swipe_pallas_multi``; its plain
PyTorch version ``banded_swipe_multi_plain`` computes the same function with
tensor ops and is what the wrapper runs for tensors on the CPU.

``FullSweep.dispatch_block`` scores every (query, target) pair of a
``--swipe`` search with the full-matrix kernel ``full_swipe`` (CUDA C++ in
``csrc/full_swipe.cu``), which replaces the TPU kernel
``diamond_tpu/ops/swipe_device.py:full_swipe_pallas_sweep``; its plain
version is ``full_swipe_plain``.

``SwipeSweep.run`` scores every (query, target) pair as one diagonal band
per pair over length classes of targets kept on the card, with
``swipe_sweep`` (CUDA C++ in ``csrc/swipe_sweep.cu``, which walks only the
query's rows of the band), which replaces the TPU kernel
``diamond_tpu/ops/swipe_device.py:banded_swipe_pallas_sweep``; its plain
version is ``swipe_sweep_plain``.

The batches are flat and ragged: concatenated int8 target letters with
per-job (or per-target) offset and length, concatenated int8 query letters
and bias with per-request offsets.  Scores are exact int32, so the output
never depends on which jobs were routed here.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from diamond_tpu_torch.ops import swipe_uniform_device
from diamond_tpu_torch.ops._cuda import check_tensors
from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
from diamond_tpu_torch.ops.swipe_uniform import (MAX_UNIFORM_BAND, pad_band,
                                                 uniform_walk)
from diamond_tpu_torch.utils.device import resolve_device
from diamond_tpu_torch.utils.log import kspan, pcount, ptimer

NEG = -(2 ** 20)
MAX_DEVICE_BAND = 512        # 16 rows per lane of one warp
ROWS_PER_LANE = tuple(range(1, 17))  # the kernel's band classes
JOB_COLS = 5                 # jobs[k] = (t_off, t_len, d0, band, req)
MAX_BATCH_LETTERS = 1 << 30  # per launch batch: offsets are int32

# Dispatch telemetry (always on; an int add per launch).
dispatch_count = 0      # kernel launches made by DeviceDP (either device)


def reset_dispatch_stats():
    global dispatch_count
    dispatch_count = 0


def rows_per_lane(band: int) -> int:
    """Band rows each of the warp's 32 lanes holds (the kernel's band class):
    ceil(band / 32), so a class walks at most 31 rows past its bands."""
    return -(-max(band, 1) // 32)


def _min_device_cells() -> int:
    """Per-job routing threshold: DIAMOND_TPU_TORCH_DP_MIN_CELLS, default 0
    (every job within the kernel's band cap goes to DeviceDP)."""
    v = os.environ.get("DIAMOND_TPU_TORCH_DP_MIN_CELLS")
    return int(v) if v else 0


def job_fits_device(tgt_len: int, d0: int, d1: int) -> bool:
    band = d1 - d0
    return (pad_band(band) <= MAX_DEVICE_BAND
            and tgt_len * band >= _min_device_cells())


# ---------------------------------------------------------------------------
# The kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

def _check_inputs(t_cat, q_cat, bias_cat, jobs, reqs, matrix32, R):
    i8, i32 = torch.int8, torch.int32
    check_tensors(t_cat.device, ("t_cat", t_cat, i8), ("q_cat", q_cat, i8),
                  ("bias_cat", bias_cat, i8), ("jobs", jobs, i32),
                  ("reqs", reqs, i32), ("matrix32", matrix32, i32))
    if t_cat.dim() != 1 or q_cat.dim() != 1 or bias_cat.shape != q_cat.shape:
        raise ValueError("t_cat, q_cat and bias_cat must be 1-D, "
                         "bias_cat shaped like q_cat")
    if jobs.dim() != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs must be [n, {JOB_COLS}], got {tuple(jobs.shape)}")
    if reqs.dim() != 2 or reqs.shape[1] != 2:
        raise ValueError(f"reqs must be [m, 2], got {tuple(reqs.shape)}")
    if tuple(matrix32.shape) != (32, 32):
        raise ValueError(f"matrix32 must be [32, 32], got {tuple(matrix32.shape)}")
    if R not in ROWS_PER_LANE:
        raise ValueError(f"rows_per_lane must be in 1..{ROWS_PER_LANE[-1]}")


def _k1():
    from diamond_tpu_torch.ops import _cuda

    return _cuda.launcher("banded_swipe", "banded_swipe_multi_launch",
                          "ippppppiiipppp")


def banded_swipe_multi(t_cat, q_cat, bias_cat, jobs, reqs, matrix32,
                       go: int, ge: int, rows_per_lane: int):
    """Score-only banded SW for every job of a ragged batch.

    t_cat int8 [Lt], q_cat/bias_cat int8 [Lq], jobs int32 [n, 5] rows
    (t_off, t_len, d0, band, req), reqs int32 [m, 2] rows (q_off, q_len),
    matrix32 int32 [32, 32]; go = gap open + extend, ge = gap extend; every
    job's band <= 32 * rows_per_lane.  Band row r of column j is query
    position i = j + d0 + r.  Returns int32 [n] tensors (best, max_col,
    max_row): max_col the first target column where the best rises, max_row
    the highest band row among that column's ties (0, 0, 0 for score 0).

    CUDA tensors launch the kernel (counted in ``banded_swipe_multi.launches``);
    CPU tensors run ``banded_swipe_multi_plain``.
    """
    _check_inputs(t_cat, q_cat, bias_cat, jobs, reqs, matrix32, rows_per_lane)
    dev = t_cat.device
    if dev.type == "cpu":
        return banded_swipe_multi_plain(t_cat, q_cat, bias_cat, jobs, reqs,
                                        matrix32, go, ge, rows_per_lane)
    if dev.type != "cuda":
        raise ValueError(f"banded_swipe_multi runs on cuda or cpu, not {dev}")
    n = jobs.shape[0]
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    if n == 0:
        return tuple(out)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _k1()(rows_per_lane, t_cat.data_ptr(), q_cat.data_ptr(),
                    bias_cat.data_ptr(), jobs.data_ptr(), reqs.data_ptr(),
                    matrix32.data_ptr(), n, int(go), int(ge),
                    out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_swipe_multi launch failed: CUDA error {err}")
    banded_swipe_multi.launches += 1
    return tuple(out)


banded_swipe_multi.launches = 0


def banded_swipe_multi_plain(t_cat, q_cat, bias_cat, jobs, reqs, matrix32,
                             go: int, ge: int, rows_per_lane: int):
    """The kernel's function in tensor ops over [n_jobs, 32 * rows_per_lane],
    one target column per step; exact int32, on whatever device the inputs
    are on."""
    dev = t_cat.device
    i32 = torch.int32
    n = jobs.shape[0]
    band_pad = 32 * rows_per_lane
    best = torch.zeros(n, dtype=i32, device=dev)
    max_col = torch.zeros(n, dtype=i32, device=dev)
    max_row = torch.zeros(n, dtype=i32, device=dev)
    if n == 0:
        return best, max_col, max_row
    t_off, t_len, d0, band, req = jobs.long().unbind(1)
    q_off = reqs[req, 0].long()
    q_len = reqs[req, 1].long()
    r = torch.arange(band_pad, device=dev)
    r_ge = (r * ge).to(i32)
    in_band = r[None, :] < band[:, None]
    M = matrix32.long()
    H = torch.zeros(n, band_pad, dtype=i32, device=dev)
    E = torch.zeros(n, band_pad, dtype=i32, device=dev)
    zcol = torch.zeros(n, 1, dtype=i32, device=dev)
    r32 = r.to(i32)
    q_last = max(q_cat.numel() - 1, 0)
    t_last = max(t_cat.numel() - 1, 0)
    for j in range(int(t_len.max())):
        active = j < t_len
        tl = t_cat[(t_off + j).clamp(max=t_last)].long() & 31
        i = j + d0[:, None] + r[None, :]
        valid = in_band & (i >= 0) & (i < q_len[:, None]) & active[:, None]
        idx = (q_off[:, None] + i).clamp(0, q_last)
        ql = q_cat[idx].long() & 31
        s = (M[ql, tl[:, None]] + bias_cat[idx].long()).to(i32)
        s = torch.where(valid, s, NEG)
        cur0 = torch.maximum(H + s, E).clamp_min(0)
        gmax = torch.cummax(cur0 - go + r_ge, dim=1).values
        F = (gmax - r_ge).clamp_min(0)
        Fs = torch.cat([zcol, F[:, :-1]], dim=1)
        Hn = torch.where(valid, torch.maximum(cur0, Fs), 0)
        cb = Hn.max(dim=1).values
        upd = cb > best
        crow = torch.where(Hn == cb[:, None], r32, -1).max(dim=1).values
        best = torch.where(upd, cb, best)
        max_col = torch.where(upd, j, max_col)
        max_row = torch.where(upd, crow, max_row)
        Eo = torch.maximum(E - ge, Hn - go).clamp_min(0)
        E = torch.cat([Eo[:, 1:], zcol], dim=1)
        H = Hn
    return best, max_col, max_row


# ---------------------------------------------------------------------------
# Packing and the batcher
# ---------------------------------------------------------------------------

class PackedBatch:
    """One run_many batch: the kernel's flat inputs with jobs sorted by band
    class, then by cells, longest first.  ``classes`` lists (rows_per_lane,
    lo, hi) slices of ``jobs``; ``order[k]`` is the (request, job) of sorted
    job k and ``d0[k]`` its diagonal start; ``R[k]`` its band class.
    ``band_cells`` counts band cells as the host DP's telemetry does
    (align/wave._count_cells); ``walk_cells`` the cells the kernel walks.
    The arrays are numpy until ``on(device)`` puts them on a device."""

    __slots__ = ("t_cat", "q_cat", "bias_cat", "jobs", "reqs", "classes",
                 "order", "d0", "R", "n_jobs", "band_cells", "walk_cells")

    def on(self, device, lo: int = 0, hi: int | None = None) -> "PackedBatch":
        """Jobs [lo, hi) of this host batch, their inputs on ``device`` (the
        letters and requests whole)."""
        hi = self.n_jobs if hi is None else hi
        p = PackedBatch()
        dev = torch.device(device)
        for name in ("t_cat", "q_cat", "bias_cat", "reqs"):
            setattr(p, name, torch.from_numpy(getattr(self, name)).to(dev))
        jobs = self.jobs[lo:hi]
        p.jobs = torch.from_numpy(jobs.astype(np.int32)).to(dev)
        p.R = self.R[lo:hi]
        bounds = np.flatnonzero(np.diff(p.R)) + 1
        los = np.concatenate([[0], bounds])
        his = np.concatenate([bounds, [hi - lo]])
        p.classes = [(int(p.R[a]), int(a), int(b)) for a, b in zip(los, his)
                     if b > a]  # an empty slice has no class
        p.order, p.d0 = self.order[lo:hi], self.d0[lo:hi]
        p.n_jobs = hi - lo
        p.walk_cells = int((jobs[:, 1] * 32 * p.R).sum())
        p.band_cells = self.band_cells if (lo, hi) == (0, self.n_jobs) else None
        return p


def pack_requests(requests, device) -> PackedBatch | None:
    """Flatten run_many's requests into the kernel's inputs on ``device``
    (None: numpy arrays, for ``PackedBatch.on``)."""
    n_req = len(requests)
    q_lens = np.fromiter((len(q) for q, _, _ in requests), np.int64, n_req)
    q_offs = np.zeros(n_req, np.int64)
    np.cumsum(q_lens[:-1], out=q_offs[1:])
    q_cat = np.empty(int(q_lens.sum()), np.int8)
    bias_cat = np.zeros(len(q_cat), np.int8)
    targets, rows, order = [], [], []
    for r, (q, bias, jobs) in enumerate(requests):
        a, b = q_offs[r], q_offs[r] + q_lens[r]
        q_cat[a:b] = np.asarray(q, dtype=np.int8) & 31
        if bias is not None:
            bias = np.asarray(bias)
            if len(bias) and (bias.min() < -128 or bias.max() > 127):
                raise ValueError("query bias outside int8")
            bias_cat[a:b] = bias
        for k, (t, d0, d1) in enumerate(jobs):
            targets.append(t)
            rows.append((len(t), d0, d1 - d0, r))
            order.append((r, k))
    n = len(rows)
    if n == 0:
        return None
    info = np.array(rows, dtype=np.int64).reshape(n, 4)
    t_len, d0, band = info[:, 0], info[:, 1], info[:, 2]
    if (band < 1).any() or (band > MAX_DEVICE_BAND).any():
        raise ValueError(f"DeviceDP takes bands 1..{MAX_DEVICE_BAND}")
    if t_len.sum() >= 2 ** 31 or len(q_cat) >= 2 ** 31:
        raise ValueError("DeviceDP batch exceeds int32 letter offsets")
    t_off = np.zeros(n, np.int64)
    np.cumsum(t_len[:-1], out=t_off[1:])
    R = np.array([rows_per_lane(int(b)) for b in band], np.int64)
    perm = np.lexsort((-(t_len * band), R))
    p = PackedBatch()
    p.jobs = np.stack([t_off, t_len, d0, band, info[:, 3]], axis=1)[perm]
    p.t_cat = (np.concatenate([np.asarray(t, dtype=np.int8) for t in targets])
               if t_len.sum() else np.zeros(0, np.int8)) & 31
    p.q_cat, p.bias_cat = q_cat, bias_cat
    p.reqs = np.stack([q_offs, q_lens], axis=1).astype(np.int32)
    p.R = R[perm]
    p.order = [order[k] for k in perm]
    p.d0 = p.jobs[:, 2].copy()
    p.n_jobs = n
    j0 = np.maximum(0, -d0 - band + 1)
    j1 = np.minimum(t_len, q_lens[info[:, 3]] - d0)
    p.band_cells = int((np.maximum(j1 - j0, 0) * band).sum())
    return p if device is None else p.on(device)


class DeviceDP:
    """Cross-query score-only banded DP batcher.

    run_many(requests) with requests = [(query, bias_or_None, jobs)], jobs =
    [(target_letters, d_begin, d_end)], returns per-request lists of
    (score, subject_pos, query_pos), the score-only output of
    ops/banded_swipe.banded_swipe_batch_np.  Bands above MAX_DEVICE_BAND
    are the caller's to route elsewhere (``job_fits_device``).

    With ``mesh`` (``parallel/sharded.Mesh``, the counterpart of the
    reference's ``DeviceDP(mesh=...)``) each batch's jobs are split into one
    contiguous range per shard, of about equal walked cells; each shard runs
    K1 on its device (its plain version on a CPU shard), and the results are
    put back in job order, across ranks by all_gather.  The results are
    those of the unsharded DeviceDP; ``dispatch_count`` counts this
    process's launches on all of its shards.
    """

    def __init__(self, matrix32, gap_open: int, gap_extend: int,
                 device: str | None = None, mesh=None):
        self.mesh = mesh
        self._m32_host = np.ascontiguousarray(matrix32, dtype=np.int32)
        self._m32_on = {}
        self.device = self._m32 = None
        if mesh is None:
            self.device = torch.device(resolve_device(device))
            self._m32 = self.matrix_on(self.device)
        self.go = gap_open + gap_extend
        self.ge = gap_extend

    def matrix_on(self, device):
        """The int32 matrix on ``device``, copied once."""
        dev = torch.device(device)
        if dev not in self._m32_on:
            self._m32_on[dev] = torch.from_numpy(self._m32_host).to(dev)
        return self._m32_on[dev]

    def launch(self, p: PackedBatch, kernel=banded_swipe_multi):
        """One launch of ``kernel`` per band class of a packed batch; returns
        (best, max_col, max_row) int32 tensors in the batch's job order.
        Span ``kernel.k1`` (DIAMOND_TPU_PROF): the batch's jobs and requests,
        the letters of the targets and the queries (``n_t``, ``n_q``), and
        CUDA events."""
        global dispatch_count
        with kspan("kernel.k1", p.t_cat.device) as sp:
            if sp:
                sp.fields = dict(jobs=p.jobs, reqs=p.reqs,
                                 n_t=p.t_cat.numel(), n_q=p.q_cat.numel())
            m32 = self.matrix_on(p.t_cat.device)
            outs = []
            for R, lo, hi in p.classes:
                outs.append(kernel(p.t_cat, p.q_cat, p.bias_cat,
                                   p.jobs[lo:hi], p.reqs, m32, self.go,
                                   self.ge, R))
            dispatch_count += len(p.classes)
            if not outs:
                return tuple(torch.zeros(0, dtype=torch.int32)
                             for _ in range(3))
            return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

    def run_many(self, requests):
        """Consecutive slices of at most MAX_BATCH_LETTERS letters each."""
        out = []
        lo = 0
        while lo < len(requests):
            hi, letters = lo, 0
            while hi < len(requests):
                q, _, jobs = requests[hi]
                n = len(q) + sum(len(t) for t, _, _ in jobs)
                if hi > lo and letters + n > MAX_BATCH_LETTERS:
                    break
                letters += n
                hi += 1
            out += self._run_batch(requests[lo:hi])
            lo = hi
        return out

    def _run_batch(self, requests):
        out = [[None] * len(jobs) for _, _, jobs in requests]
        p = pack_requests(requests, self.device)
        if p is None:
            return out
        pcount("ext.device_jobs", p.n_jobs)
        pcount("ext.device_cells", p.band_cells)
        if self.mesh is None:
            res = torch.stack(self.launch(p)).cpu().numpy()
        else:
            res = self._launch_sharded(p)
        best, col, row = res.astype(np.int64)
        i_true = col + p.d0 + row
        for k, (r, kk) in enumerate(p.order):
            out[r][kk] = (int(best[k]), int(col[k]), int(i_true[k]))
        return out

    def _launch_sharded(self, p: PackedBatch) -> np.ndarray:
        """int32 [3, n_jobs]: the host batch's jobs split over the mesh, each
        shard's range launched on its device, gathered in job order."""
        from diamond_tpu_torch.parallel.sharded import gather_shards

        n_sh = len(self.mesh)
        cells = np.cumsum(p.jobs[:, 1] * p.R)
        cuts = [0] + [int(np.searchsorted(cells, cells[-1] * s / n_sh,
                                          side="right"))
                      for s in range(1, n_sh)] + [p.n_jobs]
        local = {}
        for s in self.mesh.local():
            ps = p.on(self.mesh[s], cuts[s], cuts[s + 1])
            local[s] = torch.stack(self.launch(ps)).cpu().numpy()
        sizes = [cuts[s + 1] - cuts[s] for s in range(n_sh)]
        return np.concatenate(gather_shards(self.mesh, local, sizes, 3),
                              axis=1)


# ---------------------------------------------------------------------------
# Carrying the TPU kernel's packed inputs across
# ---------------------------------------------------------------------------

def from_pallas_batch(t_idx8, band_mask8, q_let8, q_bias8, q_valid8,
                      T: int, band: int, tile_b: int, slots: int = 4):
    """The TPU kernel's packed numpy inputs (diamond_tpu's
    banded_swipe_pallas_multi: tile g, row b = slot b // (tile_b/slots))
    as this kernel's flat inputs, one job per tile row, one request per
    (tile, slot).  A job's target is its row of the first T - 8 columns
    (the TPU kernel's walk; the last 8 are its prefetch margin), its
    query the slot's valid profile rows [a, b) with d0 = -a, so the
    outputs equal the TPU kernel's row for row.  Returns a dict of numpy
    arrays (t_cat, q_cat, bias_cat, jobs, reqs) and rows_per_lane."""
    t_idx8 = np.asarray(t_idx8)
    G = t_idx8.shape[0] // T
    T_pb = T + band
    slot_rows = tile_b // slots
    n_cols = T - 8
    t = t_idx8.reshape(G, T, tile_b)[:, :n_cols, :].transpose(0, 2, 1)
    t_cat = np.ascontiguousarray(t.reshape(-1)) & 31
    bm = np.asarray(band_mask8).reshape(G * tile_b, band) != 0
    bands = bm.sum(axis=1)
    if not (bm == (np.arange(band)[None, :] < bands[:, None])).all():
        raise ValueError("band_mask rows must be prefixes")
    qv = np.asarray(q_valid8).reshape(G * slots, T_pb) != 0
    ql = np.asarray(q_let8).reshape(G * slots, T_pb)
    qb = np.asarray(q_bias8).reshape(G * slots, T_pb)
    q_parts, b_parts, reqs, starts = [], [], [], []
    off = 0
    for s in range(G * slots):
        idx = np.flatnonzero(qv[s])
        a, b = (int(idx[0]), int(idx[-1]) + 1) if len(idx) else (0, 0)
        if b - a != len(idx):
            raise ValueError("q_valid rows must be contiguous")
        q_parts.append(ql[s, a:b] & 31)
        b_parts.append(qb[s, a:b])
        reqs.append((off, b - a))
        starts.append(a)
        off += b - a
    n = G * tile_b
    rows = np.arange(n)
    req = (rows // tile_b) * slots + (rows % tile_b) // slot_rows
    jobs = np.stack([rows * n_cols, np.full(n, n_cols), -np.asarray(starts)[req],
                     bands, req], axis=1).astype(np.int32)
    return dict(
        t_cat=t_cat.astype(np.int8),
        q_cat=np.concatenate(q_parts).astype(np.int8),
        bias_cat=np.concatenate(b_parts).astype(np.int8),
        jobs=np.ascontiguousarray(jobs),
        reqs=np.asarray(reqs, dtype=np.int32).reshape(-1, 2),
    ), rows_per_lane(band)


# ---------------------------------------------------------------------------
# --swipe: the full-matrix sweep (every query against every target)
# ---------------------------------------------------------------------------

STRIP_LANE_ROWS = 16                  # most query rows a lane holds
STRIP_ROWS = 32 * STRIP_LANE_ROWS     # query rows one warp walks per pass
TGT_COLS = 2                          # targets[t] = (t_off, t_len)
SWEEP_REQ_COLS = 3                    # reqs[r] = (q_off, q_len, slot)
PAIR_COLS = 2                         # pairs[k] = (req, tgt)
MAX_SWEEP_PAIRS = 1 << 22             # pairs per launch
SWEEP_BLOCK_PAIRS = 4                 # pairs (warps) of one block of the kernel


def sweep_shape(q_len: int):
    """(rows per lane, strips) of a query: strips of at most STRIP_ROWS rows,
    the rows spread evenly over the strips and the warp's 32 lanes."""
    strips = max(1, -(-q_len // STRIP_ROWS))
    return max(1, -(-q_len // (32 * strips))), strips


def _check_sweep(t_cat, targets, q_cat, bias_cat, reqs, pairs, matrix32, R,
                 scratch, out):
    i8, i32 = torch.int8, torch.int32
    check_tensors(t_cat.device, ("t_cat", t_cat, i8),
                  ("targets", targets, i32), ("q_cat", q_cat, i8),
                  ("bias_cat", bias_cat, i8), ("reqs", reqs, i32),
                  ("pairs", pairs, i32), ("matrix32", matrix32, i32),
                  ("scratch", scratch, i32), ("out", out, i32))
    if t_cat.dim() != 1 or q_cat.dim() != 1 or bias_cat.shape != q_cat.shape:
        raise ValueError("t_cat, q_cat and bias_cat must be 1-D, "
                         "bias_cat shaped like q_cat")
    for name, x, cols in (("targets", targets, TGT_COLS),
                          ("reqs", reqs, SWEEP_REQ_COLS),
                          ("pairs", pairs, PAIR_COLS)):
        if x.dim() != 2 or x.shape[1] != cols:
            raise ValueError(f"{name} must be [n, {cols}], got {tuple(x.shape)}")
    if tuple(matrix32.shape) != (32, 32):
        raise ValueError(f"matrix32 must be [32, 32], got {tuple(matrix32.shape)}")
    if scratch.dim() != 4 or tuple(scratch.shape[1:]) != (2, t_cat.numel(), 2):
        raise ValueError("scratch must be [slots, 2, len(t_cat), 2]")
    if out.dim() != 2 or out.shape[1] != targets.shape[0]:
        raise ValueError("out must be [n_reqs, n_targets]")
    if not 1 <= R <= STRIP_LANE_ROWS:
        raise ValueError(f"rows_per_lane must be in 1..{STRIP_LANE_ROWS}")


def _k2():
    from diamond_tpu_torch.ops import _cuda

    return _cuda.launcher("full_swipe", "full_swipe_launch",
                          "ipppppppiiiipipp")


def full_swipe(t_cat, targets, q_cat, bias_cat, reqs, pairs, matrix32,
               go: int, ge: int, rows_per_lane: int, scratch, out):
    """Best local score of the full matrix for every (query, target) pair.

    t_cat int8 [Lt] with targets int32 [nt, 2] rows (t_off, t_len); q_cat /
    bias_cat int8 [Lq] with reqs int32 [m, 3] rows (q_off, q_len, slot);
    pairs int32 [n, 2] rows (req, tgt); matrix32 int32 [32, 32], entries
    within +-FullSweep.MAX_SCORE; go = gap open + extend, ge = gap extend.
    Each run of SWEEP_BLOCK_PAIRS pairs is one block of the kernel, fastest
    when its pairs share one query (one profile a strip; FullSweep.pack
    orders them so).  Every query of the launch has rows per
    lane ``rows_per_lane`` (``sweep_shape``); a query of more than one strip
    carries each strip's last row to the next through its ``slot`` of
    scratch int32 [slots, 2, Lt, 2] (slot -1: one strip).  Writes each
    pair's score to out int32 [m, nt] at (req, tgt) and returns out.

    CUDA tensors launch the kernel (counted in ``full_swipe.launches``); CPU
    tensors run ``full_swipe_plain``.  Span ``kernel.k2``
    (DIAMOND_TPU_PROF): the targets, requests and pairs, the letters of the
    targets and the queries (``n_t``, ``n_q``), and CUDA events.
    """
    with kspan("kernel.k2", t_cat.device) as sp:
        if sp:
            sp.fields = dict(targets=targets, reqs=reqs, pairs=pairs,
                             n_t=t_cat.numel(), n_q=q_cat.numel())
        _check_sweep(t_cat, targets, q_cat, bias_cat, reqs, pairs, matrix32,
                     rows_per_lane, scratch, out)
        dev = t_cat.device
        if dev.type == "cpu":
            return full_swipe_plain(t_cat, targets, q_cat, bias_cat, reqs,
                                    pairs, matrix32, go, ge, rows_per_lane,
                                    scratch, out)
        if dev.type != "cuda":
            raise ValueError(f"full_swipe runs on cuda or cpu, not {dev}")
        n = pairs.shape[0]
        if n == 0:
            return out
        if t_cat.numel() >= 2 ** 31 or out.numel() >= 2 ** 31:
            raise ValueError("full_swipe batch exceeds int32 offsets")
        with torch.cuda.device(dev):  # the launch goes to the current device
            err = _k2()(rows_per_lane, t_cat.data_ptr(), targets.data_ptr(),
                        q_cat.data_ptr(), bias_cat.data_ptr(),
                        reqs.data_ptr(), pairs.data_ptr(),
                        matrix32.data_ptr(), n, out.shape[1], int(go),
                        int(ge), scratch.data_ptr(), t_cat.numel(),
                        out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"full_swipe launch failed: CUDA error {err}")
        full_swipe.launches += 1
        return out


full_swipe.launches = 0


def full_swipe_plain(t_cat, targets, q_cat, bias_cat, reqs, pairs, matrix32,
                     go: int, ge: int, rows_per_lane: int, scratch, out):
    """The kernel's function in tensor ops over [pairs, longest query] (no
    strips), one target column per step, pairs ordered by target length so
    that finished pairs drop out; exact int32, on whatever device the inputs
    are on."""
    dev = t_cat.device
    i32 = torch.int32
    n = pairs.shape[0]
    if n == 0:
        return out
    req, tgt = pairs.long().unbind(1)
    t_len = targets[tgt, 1].long()
    order = torch.argsort(t_len, descending=True, stable=True)
    req, tgt, t_len = req[order], tgt[order], t_len[order]
    t_off = targets[tgt, 0].long()
    q_off, q_len = reqs[req, 0].long(), reqs[req, 1].long()
    Q = max(int(q_len.max()), 1)
    i = torch.arange(Q, device=dev)
    i_ge = (i * ge).to(i32)
    valid = i[None, :] < q_len[:, None]
    idx = (q_off[:, None] + i).clamp(0, max(q_cat.numel() - 1, 0))
    ql = q_cat[idx].long() & 31
    qb = bias_cat[idx].to(i32)
    M = matrix32.long()
    H = torch.zeros(n, Q, dtype=i32, device=dev)
    E = torch.zeros(n, Q, dtype=i32, device=dev)
    best = torch.zeros(n, dtype=i32, device=dev)
    # active[j]: pairs whose target has a column j (a prefix: sorted by length)
    lens = t_len.cpu().numpy()
    n_cols = int(lens[0]) if len(lens) else 0
    active = np.searchsorted(-lens, -np.arange(n_cols), side="left")
    t_last = max(t_cat.numel() - 1, 0)
    for j in range(n_cols):
        a = int(active[j])
        H, E = H[:a], E[:a]
        tl = t_cat[(t_off[:a] + j).clamp(max=t_last)].long() & 31
        s = M[ql[:a], tl[:, None]].to(i32) + qb[:a]
        diag = torch.cat([torch.zeros(a, 1, dtype=i32, device=dev),
                          H[:, :-1]], dim=1)
        cur0 = torch.maximum(diag + s, E).clamp_min(0)
        gmax = torch.cummax(cur0 - go + i_ge, dim=1).values
        F = (gmax - i_ge).clamp_min(0)
        Fs = torch.cat([torch.zeros(a, 1, dtype=i32, device=dev), F[:, :-1]],
                       dim=1)
        Hn = torch.where(valid[:a], torch.maximum(cur0, Fs), 0)
        best[:a] = torch.maximum(best[:a], Hn.max(dim=1).values)
        E = torch.maximum(E - ge, Hn - go).clamp_min(0)
        H = Hn
    out[req, tgt] = best
    return out


class SweepLaunch:
    """One full_swipe launch of a packed block: numpy inputs (reqs, pairs)
    over the block's shared t_cat / targets / q_cat / bias_cat, the rows per
    lane, scratch slots, and the cells the pairs need (q_len x t_len)."""

    __slots__ = ("R", "reqs", "pairs", "slots", "cells", "walk_cells")


class SweepBlock:
    """A packed dispatch_block: the shared numpy inputs and the launches."""

    __slots__ = ("t_cat", "targets", "q_cat", "bias_cat", "launches",
                 "n_queries", "n_targets")


class FullSweep:
    """--swipe device scheduler: the target letters go to the card once per
    dispatch_block, every query group then sweeps them, and the scores come
    back as one [n_queries, n_targets] int32 matrix (the role of the
    reference's full-DB SWIPE search, src/align/full_db.cpp +
    dp/swipe/full_swipe.h).

    One warp scores one (query, target) pair, walking the target one column
    at a time over a strip of up to STRIP_ROWS query rows held in registers;
    longer queries take several strips, carried through scratch on the card.
    Every pair of a length-capped block fits; the caps bound the cells one
    warp walks alone (8192 x 8192 is tens of ms for one warp), and longer
    sequences take the host striped engine, overlapped with the card's work
    (align/swipe_all).
    """

    MAX_LEN = 8192       # walked targets
    MAX_ROW_LEN = 8192   # query rows (16 strips)
    SCRATCH_BYTES = 1 << 30  # strip carries of one launch
    MAX_SCORE = 16_000   # matrix entries: the kernel's profile is int16

    def __init__(self, matrix32, gap_open: int, gap_extend: int,
                 device: str | None = None):
        if np.abs(np.asarray(matrix32)).max() > self.MAX_SCORE:
            raise ValueError(f"FullSweep takes matrix entries within "
                             f"+-{self.MAX_SCORE}")
        self.device = torch.device(resolve_device(device))
        self._m32 = torch.tensor(np.asarray(matrix32), dtype=torch.int32,
                                 device=self.device)
        self.go = gap_open + gap_extend
        self.ge = gap_extend

    def pack(self, queries, tblock, t_order) -> SweepBlock:
        """queries: [(q_letters, bias_or_None)]; t_order: target block ids.
        One launch per rows-per-lane class and query group; pairs ordered by
        the cells a warp walks, most first."""
        t_order = np.asarray(t_order, dtype=np.int64)
        b = SweepBlock()
        b.n_queries, b.n_targets = len(queries), len(t_order)
        tl = tblock.lengths[t_order].astype(np.int64)
        t_off = np.zeros(len(tl), np.int64)
        np.cumsum(tl[:-1], out=t_off[1:])
        src = np.repeat(tblock.starts[t_order].astype(np.int64) - t_off, tl) \
            + np.arange(int(tl.sum()), dtype=np.int64)
        b.t_cat = (tblock.letters[src] & 31).astype(np.int8)
        b.targets = np.stack([t_off, tl], axis=1).astype(np.int32)
        q_lens = np.fromiter((len(q) for q, _ in queries), np.int64,
                             len(queries))
        q_off = np.zeros(len(queries), np.int64)
        np.cumsum(q_lens[:-1], out=q_off[1:])
        b.q_cat = np.zeros(int(q_lens.sum()), np.int8)
        b.bias_cat = np.zeros(int(q_lens.sum()), np.int8)
        for k, (q, bias) in enumerate(queries):
            a, e = q_off[k], q_off[k] + q_lens[k]
            b.q_cat[a:e] = np.asarray(q, dtype=np.int8) & 31
            if bias is not None:
                bias = np.asarray(bias)
                if len(bias) and (bias.min() < -128 or bias.max() > 127):
                    raise ValueError("query bias outside int8")
                b.bias_cat[a:e] = bias
        if len(b.t_cat) >= 2 ** 31 or len(b.q_cat) >= 2 ** 31:
            raise ValueError("FullSweep block exceeds int32 letter offsets")
        shapes = np.array([sweep_shape(int(x)) for x in q_lens],
                          np.int64).reshape(-1, 2)
        slot_bytes = 16 * max(len(b.t_cat), 1)
        max_slots = max(1, self.SCRATCH_BYTES // slot_bytes)
        per_group = max(1, MAX_SWEEP_PAIRS // max(len(tl), 1))
        b.launches = []
        live = np.flatnonzero(q_lens > 0)
        for R in np.unique(shapes[live, 0]):
            cls = live[shapes[live, 0] == R]
            group, n_slots = [], 0
            for qi in cls:
                long_q = shapes[qi, 1] > 1
                if group and (len(group) == per_group
                              or (long_q and n_slots == max_slots)):
                    b.launches.append(self._launch(b, int(R), group, shapes,
                                                   q_off, q_lens, tl))
                    group, n_slots = [], 0
                group.append(int(qi))
                n_slots += int(long_q)
            if group:
                b.launches.append(self._launch(b, int(R), group, shapes,
                                               q_off, q_lens, tl))
        return b

    @staticmethod
    def _launch(b, R, group, shapes, q_off, q_lens, tl) -> SweepLaunch:
        L = SweepLaunch()
        L.R = R
        g = np.asarray(group, np.int64)
        strips = shapes[g, 1]
        slot = np.where(strips > 1, np.cumsum(strips > 1) - 1, -1)
        L.slots = int((strips > 1).sum())
        L.reqs = np.zeros((b.n_queries, SWEEP_REQ_COLS), np.int32)
        L.reqs[:, 2] = -1
        L.reqs[g, 0], L.reqs[g, 1], L.reqs[g, 2] = q_off[g], q_lens[g], slot
        # the kernel's blocks each take SWEEP_BLOCK_PAIRS pairs of one query:
        # every query's targets, longest first, in runs of that many (the
        # last run repeats its last target, which writes the same score
        # twice), the runs of all queries ordered by the cells a warp
        # walks, most first
        W = SWEEP_BLOCK_PAIRS
        ts = np.argsort(-tl, kind="stable")
        ts = np.concatenate([ts, np.repeat(ts[-1:], -len(ts) % W)])
        runs = ts.reshape(-1, W)
        work = shapes[g, 1][:, None] * tl[runs[:, 0]][None, :]
        order = np.argsort(-work.reshape(-1), kind="stable")
        qq = np.repeat(g[order // len(runs)], W)
        tt = runs[order % len(runs)].reshape(-1)
        L.pairs = np.stack([qq, tt], axis=1).astype(np.int32)
        L.cells = int(q_lens[g].sum() * tl.sum())
        L.walk_cells = int((shapes[qq, 1] * tl[tt]).sum() * 32 * R)
        return L

    def run_block(self, queries, tblock, t_order):
        """Scores [len(queries), len(t_order)] int32 (all target lengths in
        (0, MAX_LEN], query lengths <= MAX_ROW_LEN)."""
        return self.dispatch_block(queries, tblock, t_order).wait()

    def dispatch_block(self, queries, tblock, t_order, kernel=None):
        """Async variant of run_block: every launch of ``kernel``
        (``full_swipe`` unless given) is queued before it returns, so host
        work (the long-sequence tail, result formatting) overlaps the
        card's; .wait() on the returned handle is the only blocking step."""
        global dispatch_count
        kernel = kernel or full_swipe
        with ptimer("swipe.pack"):
            b = self.pack(queries, tblock, t_order)
        dev = self.device
        with ptimer("swipe.h2d_launch"):
            # every copy to the card before the first launch: a pageable
            # copy waits for the stream, so a copy after a launch would
            # wait for it
            x = {k: torch.from_numpy(getattr(b, k)).to(dev)
                 for k in ("t_cat", "targets", "q_cat", "bias_cat")}
            per = [(L, torch.from_numpy(L.reqs).to(dev),
                    torch.from_numpy(L.pairs).to(dev)) for L in b.launches]
            out = torch.zeros((b.n_queries, b.n_targets), dtype=torch.int32,
                              device=dev)
            for L, reqs, pairs in per:
                scratch = torch.empty((L.slots, 2, len(b.t_cat), 2),
                                      dtype=torch.int32, device=dev)
                kernel(x["t_cat"], x["targets"], x["q_cat"], x["bias_cat"],
                       reqs, pairs, self._m32, self.go, self.ge, L.R,
                       scratch, out)
                dispatch_count += 1
        return _SweepPending(out)


class _SweepPending:
    def __init__(self, out):
        self._out = out

    def wait(self):
        # the readback is the only blocking step: it waits for the kernels
        with ptimer("swipe.wait_readback"):
            return self._out.cpu().numpy()


def from_pallas_full_sweep(bounds32, t_idx8, q_let8, q_bias8, q_valid8,
                           Q: int, T: int, tile_b: int):
    """A recorded full_swipe_pallas_sweep call's inputs (diamond_tpu:
    bounds32 [G], t_idx8 [G*T, tile_b], q_let8 / q_bias8 / q_valid8 [NQ*Q])
    as this kernel's inputs: target b of tile g walks the tile's bound
    columns (pad letters included, as the TPU kernel does), query n is its
    valid profile rows (a prefix), every (query, target) a pair.  The
    outputs equal the TPU kernel's [NQ, G*tile_b] matrix.  Returns a dict of
    numpy arrays (t_cat, targets, q_cat, bias_cat, reqs, pairs) and a list
    of (rows per lane, pair rows) launches."""
    bounds = np.asarray(bounds32).astype(np.int64)
    G = len(bounds)
    t = np.asarray(t_idx8).reshape(G, T, tile_b).transpose(0, 2, 1)
    t_len = np.repeat(bounds, tile_b)
    rows = np.arange(T)[None, :] < t_len.reshape(G, tile_b, 1)
    t_cat = (t[rows] & 31).astype(np.int8)       # row-major: tile, lane, col
    t_off = np.zeros(G * tile_b, np.int64)
    np.cumsum(t_len[:-1], out=t_off[1:])
    qv = np.asarray(q_valid8).reshape(-1, Q) != 0
    NQ = qv.shape[0]
    q_lens = qv.sum(axis=1)
    if not (qv == (np.arange(Q)[None, :] < q_lens[:, None])).all():
        raise ValueError("q_valid rows must be prefixes")
    keep = np.arange(Q)[None, :] < q_lens[:, None]
    q_cat = (np.asarray(q_let8).reshape(NQ, Q)[keep] & 31).astype(np.int8)
    bias_cat = np.asarray(q_bias8).reshape(NQ, Q)[keep].astype(np.int8)
    q_off = np.zeros(NQ, np.int64)
    np.cumsum(q_lens[:-1], out=q_off[1:])
    shapes = np.array([sweep_shape(int(x)) for x in q_lens], np.int64)
    reqs = np.stack([q_off, q_lens, np.full(NQ, -1)], axis=1).astype(np.int32)
    launches = []
    for R in np.unique(shapes[:, 0]):
        g = np.flatnonzero(shapes[:, 0] == R)
        pairs = np.stack([np.repeat(g, G * tile_b),
                          np.tile(np.arange(G * tile_b), len(g))], axis=1)
        launches.append((int(R), pairs.astype(np.int32)))
    return dict(t_cat=t_cat, targets=np.stack([t_off, t_len], axis=1).astype(
        np.int32), q_cat=q_cat, bias_cat=bias_cat, reqs=reqs), launches


# ---------------------------------------------------------------------------
# The diagonal-band sweep: every query against length classes of targets
# kept on the card, one uniform band per class, the kernel walking only the
# query's rows of the band
# ---------------------------------------------------------------------------

def _k5():
    from diamond_tpu_torch.ops import _cuda

    return _cuda.launcher("swipe_sweep", "swipe_sweep_launch",
                          "ipppiiiiiiippppp")


def _query_rows(T: int, band: int, q_off, q_len):
    """Check (q_off, q_len) against the kernel's layout: every query row in
    the band at every column."""
    if (q_off is None) != (q_len is None):
        raise ValueError("give both q_off and q_len, or neither")
    if q_off is not None and (q_len < 0 or q_off < T - 1
                              or q_off + q_len > band):
        raise ValueError(f"query rows [{q_off}, {q_off + q_len}) must lie in "
                         f"[T - 1, band) = [{T - 1}, {band})")


def swipe_sweep(t_idx, band_len, prof_t, go: int, ge: int, q_off=None,
                q_len=None):
    """Full-band SW of one query profile against B target rows: band row r
    of target b is valid iff r < band_len[b] (qlen + tlen - 1 covers every
    diagonal, 0 a dead row).

    t_idx int8 [B, T] shifted target letters, band_len int32 [B], prof_t
    int32 [32, T + band] (row r of column j scores prof_t[letter][j + r], NEG
    out of the query); go = gap open + extend, ge = gap extend; q_off,
    q_len: the query's rows of the profile (SwipeSweep's C and qlen), which
    must lie in [T - 1, band); the profile's other rows count as NEG.
    Returns int32 [B] (best, max_col, max_row) in shifted coordinates, with
    the tie rules of ``banded_swipe_uniform_cuda``.

    CUDA tensors launch the kernel (counted in ``swipe_sweep.launches``),
    which walks only the query's rows and needs them given; CPU tensors run
    ``swipe_sweep_plain``."""
    B, T, band = swipe_uniform_device.check_uniform(
        t_idx, band_len, prof_t, torch.int32, "band_len")
    if band_len.dim() != 1:
        raise ValueError("band_len must be [B]")
    _query_rows(T, band, q_off, q_len)
    dev = t_idx.device
    if dev.type == "cpu":
        return swipe_sweep_plain(t_idx, band_len, prof_t, go, ge, q_off, q_len)
    if dev.type != "cuda":
        raise ValueError(f"swipe_sweep runs on cuda or cpu, not {dev}")
    if q_off is None:
        raise ValueError("the swipe_sweep kernel needs the query's rows "
                         "(q_off, q_len)")
    out = [torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(3)]
    if B == 0 or T == 0 or q_len == 0:
        return tuple(out)
    R, strips = sweep_shape(q_len)
    scratch = torch.empty((B if strips > 1 else 0, 2, T, 2),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _k5()(R, t_idx.data_ptr(), band_len.data_ptr(),
                    prof_t.data_ptr(), B, T, band, int(q_off), int(q_len),
                    int(go), int(ge), scratch.data_ptr(), out[0].data_ptr(),
                    out[1].data_ptr(), out[2].data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swipe_sweep launch failed: CUDA error {err}")
    swipe_sweep.launches += 1
    return tuple(out)


swipe_sweep.launches = 0


def swipe_sweep_plain(t_idx, band_len, prof_t, go: int, ge: int, q_off=None,
                      q_len=None):
    """The kernel's function in tensor ops over the whole band
    (``swipe_uniform.uniform_walk``), the profile's rows outside [q_off,
    q_off + q_len) set to NEG when those are given; exact int32, on
    whatever device the inputs are on."""
    band = prof_t.shape[1] - t_idx.shape[1]
    if q_off is not None:
        prof_t = prof_t.clone()
        prof_t[:, :q_off] = NEG
        prof_t[:, q_off + q_len:] = NEG
    r = torch.arange(band, device=t_idx.device)
    return uniform_walk(t_idx, r[None, :] < band_len[:, None], prof_t, go, ge)


def sweep_walk_cells(T: int, q_off: int, q_len: int, band_len) -> int:
    """Cells the swipe_sweep kernel walks: per row and strip, the strip's
    32 * R rows times its columns from max(0, strip start - band_len)."""
    R, strips = sweep_shape(q_len)
    bl = np.asarray(band_len, np.int64)
    p0 = q_off + 32 * R * np.arange(strips)
    cols = T - np.maximum(0, p0[None, :] - bl[:, None])
    return int(32 * R * np.maximum(cols, 0).sum())


def sweep_profile(q_let, q_bias, q_valid, matrix32):
    """The transposed profile [32, T + band] int32 of one query's profile rows
    (int8 [T + band] letters, bias, validity), built outside the kernel as
    diamond_tpu builds it: matrix32[letter] + bias on valid rows, NEG
    elsewhere."""
    prof = matrix32[q_let.long() & 31] + q_bias.to(torch.int32)[:, None]
    prof = torch.where(q_valid[:, None] != 0, prof, NEG)
    return prof.T.contiguous()


class SweepChunk:
    """One length class of a SwipeSweep's targets on the card: ``t_idx``
    int8 [rows, T] with target x right-aligned at column C - (tlen - 1) (C =
    longest length - 1), ``rows`` its target ids, ``tl`` their lengths."""

    __slots__ = ("T", "C", "t_idx", "rows", "tl")


class SwipeSweep:
    """Diagonal-band full-matrix SWIPE: every (query, target) pair's whole
    matrix as one band of qlen + tlen - 1 diagonals (the counterpart of
    diamond_tpu's SwipeSweep).

    The targets are sorted by length and cut into length classes
    (``pad_band`` of the length), each class's letter block goes to the card
    once, and every query then sweeps the resident classes with one launch of
    ``swipe_sweep`` each, the band qlen + C of the class; the kernel walks
    the query's rows [C, C + qlen) of that band.  Classes whose band would
    pass ``MAX_UNIFORM_BAND`` take the host DP for that query (the output
    does not depend on the cap).
    ``run`` returns res[nq][nt] = (score, subject_pos, query_pos) of the best
    cell, with the host DP's (0, 0, 0) for a score of 0.
    """

    def __init__(self, matrix32, gap_open: int, gap_extend: int,
                 device: str | None = None):
        self.device = torch.device(resolve_device(device))
        self.matrix32 = np.ascontiguousarray(matrix32, dtype=np.int32)
        self._m32 = torch.from_numpy(self.matrix32).to(self.device)
        self.gap_open, self.gap_extend = gap_open, gap_extend
        self.go = gap_open + gap_extend
        self.ge = gap_extend

    def chunks(self, targets):
        """The targets' length classes, letter blocks on the card."""
        tl_all = np.fromiter((len(t) for t in targets), np.int64, len(targets))
        order = np.argsort(tl_all, kind="stable")
        cls = np.array([pad_band(max(int(n), 1)) for n in tl_all[order]],
                       np.int64)
        out = []
        for c in np.unique(cls):
            rows = order[cls == c]
            ch = SweepChunk()
            ch.rows, ch.tl = rows, tl_all[rows]
            ch.T = int(ch.tl.max())
            ch.C = ch.T - 1
            t_idx = np.full((len(rows), ch.T), 31, dtype=np.int8)
            for x, t in enumerate(rows):
                s = ch.C - (int(ch.tl[x]) - 1)
                t_idx[x, s: s + int(ch.tl[x])] = \
                    np.asarray(targets[t], dtype=np.int8) & 31
            ch.t_idx = torch.from_numpy(t_idx).to(self.device)
            out.append(ch)
        return out

    def query_launches(self, query, bias, chunks):
        """(chunk, band, band_len, prof_t) of each launch of one query (its
        rows of the profile: [chunk.C, chunk.C + len(query))); a chunk
        whose band would pass MAX_UNIFORM_BAND is left out."""
        qlen = len(query)
        q8 = torch.from_numpy(np.asarray(query, dtype=np.int8) & 31)
        b8 = (torch.from_numpy(np.asarray(bias, dtype=np.int8))
              if bias is not None else torch.zeros(qlen, dtype=torch.int8))
        out = []
        for ch in chunks:
            band = qlen + ch.C
            if not 1 <= band <= MAX_UNIFORM_BAND:
                continue
            T_pb = ch.T + band
            q_let = torch.zeros(T_pb, dtype=torch.int8)
            q_bias = torch.zeros(T_pb, dtype=torch.int8)
            q_valid = torch.zeros(T_pb, dtype=torch.int8)
            q_let[ch.C: ch.C + qlen] = q8
            q_bias[ch.C: ch.C + qlen] = b8
            q_valid[ch.C: ch.C + qlen] = 1
            dev = self.device
            prof_t = sweep_profile(q_let.to(dev), q_bias.to(dev),
                                   q_valid.to(dev), self._m32)
            bl = torch.from_numpy((qlen + ch.tl - 1).astype(np.int32)).to(dev)
            out.append((ch, band, bl, prof_t))
        return out

    def run(self, queries, targets, kernel=None):
        """queries: [(q_letters, bias_or_None)]; targets: [t_letters].
        Every launch of ``kernel`` (``swipe_sweep`` unless given) is queued
        before the first result is read back."""
        global dispatch_count
        kernel = kernel or swipe_sweep
        chunks = self.chunks(targets)
        res = [[None] * len(targets) for _ in queries]
        pending = []
        for qi, (q, bias) in enumerate(queries):
            if bias is not None:
                bias = np.asarray(bias)
                if len(bias) and (bias.min() < -128 or bias.max() > 127):
                    raise ValueError("query bias outside int8")
            done = set()
            for ch, band, bl, prof_t in self.query_launches(q, bias, chunks):
                pending.append((qi, ch, kernel(ch.t_idx, bl, prof_t, self.go,
                                               self.ge, ch.C, len(q))))
                dispatch_count += 1
                pcount("sweep.walk_cells", sweep_walk_cells(
                    ch.T, ch.C, len(q), ch.tl + len(q) - 1))
                done.add(id(ch))
            for ch in chunks:  # bands past the kernel's cap: host DP
                if id(ch) in done:
                    continue
                jobs = [(targets[t], -(len(targets[t]) - 1), len(q))
                        for t in ch.rows]
                for t, r in zip(ch.rows, banded_swipe_batch_np(
                        q, bias, jobs, self.matrix32, self.gap_open,
                        self.gap_extend)):
                    res[qi][t] = r
        for qi, ch, out in pending:
            best, mc, mr = torch.stack(out).cpu().numpy().astype(np.int64)
            for x, t in enumerate(ch.rows):
                tl = int(ch.tl[x])
                if best[x] <= 0:  # the host DP's full-band convention
                    res[qi][t] = (0, 0, 0)
                    continue
                j_true = int(mc[x]) - (ch.C - (tl - 1))
                res[qi][t] = (int(best[x]), j_true, j_true - (tl - 1)
                              + int(mr[x]))
        return res


def from_pallas_sweep_batch(t_idx8, band_len32, q_let8, q_bias8, q_valid8,
                            T: int, band: int, tile_b: int):
    """A banded_swipe_pallas_sweep call's inputs (diamond_tpu: t_idx8
    [G*T, tile_b] int8, band_len32 [G, 8, tile_b] int32 with the lengths in
    plane 0, q_let8 / q_bias8 / q_valid8 [T + band] int8) as this kernel's:
    dict(t_idx int8 [G*tile_b, T], band_len int32 [G*tile_b], q_let, q_bias,
    q_valid int8 [T + band]) (``sweep_profile`` builds prof_t from the last
    three).  Row b of tile g walks all T columns, as the TPU kernel does, so
    the outputs equal its rows."""
    t = np.asarray(t_idx8)
    G = t.shape[0] // T
    if t.shape != (G * T, tile_b):
        raise ValueError("t_idx8 must be [G*T, tile_b]")
    q = [np.asarray(a).astype(np.int8).reshape(-1)
         for a in (q_let8, q_bias8, q_valid8)]
    if any(len(a) != T + band for a in q):
        raise ValueError("query profile rows must be [T + band]")
    return dict(
        t_idx=np.ascontiguousarray(
            t.reshape(G, T, tile_b).transpose(0, 2, 1).reshape(G * tile_b, T)
            & 31).astype(np.int8),
        band_len=np.ascontiguousarray(
            np.asarray(band_len32)[:, 0, :].reshape(-1)).astype(np.int32),
        q_let=q[0], q_bias=q[1], q_valid=q[2])
