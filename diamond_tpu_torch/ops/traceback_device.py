"""The extension's traceback refill on the card (D4): banded local affine-gap
DP with four trace planes, then the walk back from the best cell.

``tb_multi_device`` computes what the host's ``banded_swipe_tb_multi``
(``native/src/banded_swipe.cc``: ``swipe_one`` fills the band and its four
planes, ``walk_one`` walks them) computes for a batch of traceback jobs,
job for job, and returns what ``ops/banded_swipe.tb_multi_results`` returns:
(out [n, 3], stats [n, 12], BandedResults).  It takes
``tb_multi_results``'s numpy arrays and a torch device.

The kernel, ``banded_traceback_multi`` (CUDA C++ in
``csrc/banded_traceback.cu``), takes the place of that host call, which both
packages run from ``align/wave._tb_multi``
(``diamond_tpu/native/src/banded_swipe.cc:369``); it has no Pallas
counterpart.  Its plain PyTorch version ``banded_traceback_multi_plain``
computes the same function with tensor ops and is what the wrapper runs for
tensors on the CPU.

Semantics (``swipe_one``/``walk_one``, which the numpy oracle
``banded_swipe_np(traceback=True)`` shares; for jobs whose band starts
below diagonal -(t_len - 1) the host's striped engine scores cells outside
the band, and D4 follows the oracle, as K1 does):

  - band row r of target column j is query position i = j + d0 + r; only
    rows with 0 <= i < q_len score; columns with no such row are dead;
  - cur0 = max(H + s, E, 0) on live rows, 0 elsewhere; F, the vertical gap
    entering row r, is the prefix max of cur0 - go decayed by ge, floored
    at 0 (so 0 through the first live row: no row above it scores), and
    keeps its value on rows past the query; cur = max(cur0, F) on live
    rows, 0 elsewhere;
  - the column best is the last row reaching the column max; the running
    best moves to a new column only on a strict rise;
  - planes: gapv = cur == F, gaph = cur == E, openv = max(cur - go, 0) >=
    max(F - ge, 0), openh = max(cur - go, 0) >= max(E - ge, 0);
  - the walk prefers gapv, then gaph, then the diagonal; a gap run ends at
    the first set open bit or at i <= 0 / j <= 0; it fails (stats[11] = 0,
    the other stats 0) when the summed score is not the best.

Ops are written in walk order (the alignment reversed), codes int8 (0 = M,
1 = S with the target letter, 2 = D with the target letter, 3 = I with the
run length) and payloads int32, as the native call writes them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from diamond_tpu_torch.ops._cuda import check_tensors
from diamond_tpu_torch.ops.swipe_device import (MAX_DEVICE_BAND,
                                                job_fits_device)

JOB_COLS = 7                   # q_off, q_len, use_bias, t_off, t_len, d0, band
PLANE_BUDGET_BYTES = 1 << 30   # the card's trace planes for one slice of jobs
PLAIN_CELLS = {"cpu": 1 << 22, "cuda": 1 << 27}  # plain fill: cells a chunk
MAX_BIAS = 1 << 25             # |bias| the kernel packs beside a letter
GV, GH, OV, OH = range(4)      # the planes, in the kernel's order

# Dispatch telemetry (always on; a few int adds per call).
dispatch_count = 0      # tb_multi_device calls (either device)
dispatch_wait_s = 0.0   # wall time inside tb_multi_device (copies included)


def reset_dispatch_stats():
    global dispatch_count, dispatch_wait_s
    dispatch_count = 0
    dispatch_wait_s = 0.0


def rows_per_lane(band):
    """ceil(band / 32): the band class of a job (scalars or numpy arrays)."""
    return -(-np.maximum(band, 1) // 32)


def job_table(q_off, q_len, use_bias, t_off, t_len, d_begins, bands):
    """The int64 [n, JOB_COLS] job table of ``banded_traceback_multi`` from
    ``tb_multi_results``'s per-job arrays."""
    return np.stack([np.asarray(a, dtype=np.int64) for a in
                     (q_off, q_len, use_bias, t_off, t_len, d_begins, bands)],
                    axis=1).reshape(-1, JOB_COLS)


@dataclass
class TbPlan:
    """The host side of a kernel call: launch order and buffer offsets.

    ``order`` lists the jobs launch by launch; ``launches`` holds (rows per
    lane, start, count) slices of it, ``slices`` (start, end) of it, one a
    plane scratch's worth of jobs taken in job order; ``plane_off[k]`` is
    job k's first plane word in its slice's scratch, ``slot_off[k]`` its
    first op slot (t_len + q_len + 2 slots a job, as the native call)."""

    order: np.ndarray
    launches: list
    slices: list
    plane_off: np.ndarray
    scratch_words: int
    slot_off: np.ndarray
    n_slots: int


def tb_plan(jobs: np.ndarray, budget_bytes: int = PLANE_BUDGET_BYTES) -> TbPlan:
    """Slices of jobs in order whose planes (t_len x ceil(band/32) x 4 words
    a job) fit ``budget_bytes`` (a larger job alone), each slice's jobs by
    band class, longest first within a class."""
    jobs = np.asarray(jobs, dtype=np.int64).reshape(-1, JOB_COLS)
    n = len(jobs)
    t_len, band = jobs[:, 4], jobs[:, 6]
    R = rows_per_lane(band)
    words = t_len * R * 4
    caps = t_len + jobs[:, 1] + 2
    slot_off = np.zeros(n, np.int64)
    np.cumsum(caps[:-1], out=slot_off[1:])
    plane_off = np.zeros(n, np.int64)
    order, launches, slices = [], [], []
    budget = max(budget_bytes // 4, 1)
    scratch = 0
    lo = 0
    while lo < n:
        hi, used = lo, 0
        while hi < n and (hi == lo or used + words[hi] <= budget):
            used += words[hi]
            hi += 1
        w = words[lo:hi]
        plane_off[lo:hi] = np.cumsum(w) - w
        scratch = max(scratch, int(used))
        start = len(order)
        idx = np.arange(lo, hi)
        for r in np.unique(R[lo:hi]):
            sel = idx[R[lo:hi] == r]
            sel = sel[np.argsort(-(t_len[sel] * band[sel]), kind="stable")]
            launches.append((int(r), len(order), len(sel)))
            order.extend(sel.tolist())
        slices.append((start, len(order)))
        lo = hi
    return TbPlan(np.asarray(order, np.int32), launches, slices, plane_off,
                  scratch, slot_off, int(caps.sum()))


def _check_inputs(q_base, bias_base, t_cat, jobs, matrix32):
    check_tensors(t_cat.device, ("q_base", q_base, torch.int8),
                  ("bias_base", bias_base, torch.int32),
                  ("t_cat", t_cat, torch.int8), ("jobs", jobs, torch.int64),
                  ("matrix32", matrix32, torch.int32))
    if q_base.dim() != 1 or bias_base.dim() != 1 or t_cat.dim() != 1:
        raise ValueError("q_base, bias_base and t_cat must be 1-D")
    if jobs.dim() != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs must be [n, {JOB_COLS}], got "
                         f"{tuple(jobs.shape)}")
    if tuple(matrix32.shape) != (32, 32):
        raise ValueError(f"matrix32 must be [32, 32], got "
                         f"{tuple(matrix32.shape)}")


def check_jobs(jobs: np.ndarray, q_len_all: int, t_len_all: int,
               bias_len: int):
    """Raise on jobs the kernel does not take: bands outside 1..512,
    targets or queries outside their letters, biased queries outside the
    bias array."""
    if not len(jobs):
        return
    q_off, q_len, use_b, t_off, t_len, _d0, band = jobs.T
    if band.min() < 1 or band.max() > MAX_DEVICE_BAND:
        raise ValueError(f"D4 takes bands 1..{MAX_DEVICE_BAND}")
    if (q_len.min() < 1 or q_off.min() < 0
            or (q_off + q_len).max() > q_len_all):
        raise ValueError("a job's query lies outside q_base")
    if t_len.min() < 1 or t_off.min() < 0 or (t_off + t_len).max() > t_len_all:
        raise ValueError("a job's target lies outside t_cat")
    if use_b.any() and (q_off + q_len)[use_b != 0].max() > bias_len:
        raise ValueError("a biased job's query lies outside bias_base")
    if max(q_len.max(), t_len.max()) >= 2 ** 30:
        raise ValueError("D4 takes sequences shorter than 2^30 letters")


def _d4():
    from diamond_tpu_torch.ops import _cuda

    return (_cuda.launcher("banded_traceback", "tb_fill_launch",
                           "ipppppipiipppppppp"),
            _cuda.launcher("banded_traceback", "tb_compact_launch",
                           "ipppppppp"))


def _ptr(x):
    return x.data_ptr()


def banded_traceback_multi(q_base, bias_base, t_cat, jobs, matrix32,
                           go: int, ge: int, plan: TbPlan | None = None):
    """Banded SW with trace planes and the traceback walk for every job.

    q_base int8 [Lq] query letters, bias_base int32 per query letter (read
    only for jobs with use_bias; any length when none has it), t_cat int8
    [Lt], jobs int64 [n, JOB_COLS] rows (q_off, q_len, use_bias, t_off,
    t_len, d0, band), matrix32 int32 [32, 32]; go = gap open + extend,
    ge = gap extend; bands 1..512.  ``plan``: ``tb_plan`` of the jobs on the
    host (computed here from a copy of ``jobs`` when not given).

    Returns (out int64 [n, 3] (score, max_col, max_row), stats int64
    [n, 12], op_off int64 [n], op_codes int8 [m], op_payload int32 [m]):
    job k's ops at op_off[k] .. op_off[k] + stats[k, 10], in walk order.
    CUDA tensors launch the kernels (counted in
    ``banded_traceback_multi.launches``); CPU tensors run
    ``banded_traceback_multi_plain``.
    """
    _check_inputs(q_base, bias_base, t_cat, jobs, matrix32)
    dev = t_cat.device
    if dev.type == "cpu":
        return banded_traceback_multi_plain(q_base, bias_base, t_cat, jobs,
                                            matrix32, go, ge)
    if dev.type != "cuda":
        raise ValueError(f"banded_traceback_multi runs on cuda or cpu, "
                         f"not {dev}")
    if go < 0 or ge < 0:
        raise ValueError("gap costs must be >= 0")
    if plan is None:
        jobs_np = jobs.cpu().numpy()
        check_jobs(jobs_np, q_base.numel(), t_cat.numel(), bias_base.numel())
        plan = tb_plan(jobs_np)
    n = jobs.shape[0]
    i64 = torch.int64
    out = torch.zeros((n, 3), dtype=i64, device=dev)
    stats = torch.zeros((n, 12), dtype=i64, device=dev)
    if n == 0:
        return (out, stats, torch.zeros(0, dtype=i64, device=dev),
                torch.zeros(0, dtype=torch.int8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):  # the launches go to the current device
        bufs = tb_buffers(plan, dev)
        tb_launch(q_base, bias_base, t_cat, jobs, matrix32, go, ge, plan,
                  bufs, out, stats)
        n_ops = stats[:, 10]
        op_off = torch.cumsum(n_ops, 0) - n_ops
        total = int((op_off[-1] + n_ops[-1]).item())
        codes = torch.empty(total, dtype=torch.int8, device=dev)
        payload = torch.empty(total, dtype=torch.int32, device=dev)
        tb_compact(stats, bufs, op_off, codes, payload)
    return out, stats, op_off, codes, payload


banded_traceback_multi.launches = 0


def tb_buffers(plan: TbPlan, dev) -> dict:
    """The card buffers of a call: the plan's order and offsets, the plane
    scratch of one slice, the op slots."""
    return dict(
        order=torch.from_numpy(plan.order).to(dev),
        plane_off=torch.from_numpy(plan.plane_off).to(dev),
        slot_off=torch.from_numpy(plan.slot_off).to(dev),
        planes=torch.empty(max(plan.scratch_words, 1), dtype=torch.int32,
                           device=dev),
        slot_codes=torch.empty(max(plan.n_slots, 1), dtype=torch.int8,
                               device=dev),
        slot_payload=torch.empty(max(plan.n_slots, 1), dtype=torch.int32,
                                 device=dev))


def tb_launch(q_base, bias_base, t_cat, jobs, matrix32, go, ge, plan, bufs,
              out, stats):
    """The fill launches, one a band class of each slice, each warp
    walking its job after its fill; out and stats filled, ops in their
    slots.  No sync."""
    fill, _ = _d4()
    stream = torch.cuda.current_stream(t_cat.device).cuda_stream
    order = bufs["order"]
    common = (_ptr(q_base), _ptr(bias_base), _ptr(t_cat), _ptr(jobs))
    tail = (_ptr(matrix32), int(go), int(ge), _ptr(bufs["planes"]),
            _ptr(bufs["plane_off"]), _ptr(bufs["slot_off"]),
            _ptr(bufs["slot_codes"]), _ptr(bufs["slot_payload"]), _ptr(out),
            _ptr(stats), stream)
    for s_lo, s_hi in plan.slices:
        for R, start, count in plan.launches:
            if not s_lo <= start < s_hi:
                continue
            err = fill(R, *common, _ptr(order) + 4 * start, count, *tail)
            if err:
                raise RuntimeError(f"banded_traceback_multi fill launch "
                                   f"failed: CUDA error {err}")
            banded_traceback_multi.launches += 1


def tb_compact(stats, bufs, op_off, codes, payload):
    """Each job's ops from its slots to op_off, one launch.  No sync."""
    _, compact = _d4()
    n = stats.shape[0]
    err = compact(n, _ptr(stats), _ptr(bufs["slot_off"]), _ptr(op_off),
                  _ptr(bufs["slot_codes"]), _ptr(bufs["slot_payload"]),
                  _ptr(codes), _ptr(payload),
                  torch.cuda.current_stream(stats.device).cuda_stream)
    if err:
        raise RuntimeError(f"banded_traceback_multi compaction launch "
                           f"failed: CUDA error {err}")
    banded_traceback_multi.launches += 1


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _fill_plain(q_base, bias_base, t_cat, J, M, go, ge):
    """Fill of jobs J (int64 [n, JOB_COLS], one chunk): (best, max_col,
    max_row_band) int64 [n] and the planes uint8 [n, T, B] (T the longest
    target, B the widest band), plane p at bit p.  The scores of every
    cell come first, in one pass; the column loop runs the recurrence
    alone and keeps cur, F and E (column-major, so that a column is one
    contiguous block), from which the bits come last."""
    dev = t_cat.device
    n = J.shape[0]
    q_off, q_len, use_b, t_off, t_len, d0, band = J.unbind(1)
    T, B = int(t_len.max()), int(band.max())
    i32 = torch.int32
    r = torch.arange(B, device=dev)
    j = torch.arange(T, device=dev)
    i = d0[None, :, None] + j[:, None, None] + r[None, None, :]  # [T, n, B]
    valid = ((r < band[:, None])[None] & (i >= 0) & (i < q_len[None, :, None])
             & (j[:, None] < t_len[None, :])[:, :, None])
    idx = (q_off[None, :, None] + i).clamp(0, max(q_base.numel() - 1, 0))
    tl = t_cat[(t_off[None, :] + j[:, None]).clamp(
        0, max(t_cat.numel() - 1, 0))].long() & 31
    S = M.view(-1)[(q_base[idx].long() & 31) * 32 + tl[:, :, None]]
    S += torch.where((use_b != 0)[None, :, None],
                     bias_base[idx.clamp(max=max(bias_base.numel() - 1, 0))],
                     0)
    S = S.to(i32)
    del i, idx, tl
    # the live cells as a 0/1 factor (a product is many times quicker
    # than a select here)
    live = valid.to(i32)
    r_ge = (r * ge).to(i32)
    H = torch.zeros(n, B, dtype=i32, device=dev)
    E = torch.zeros(n, B, dtype=i32, device=dev)   # E[:, B - 1] stays 0
    CUR = torch.empty(T, n, B, dtype=i32, device=dev)
    FF = torch.empty_like(CUR)
    EE = torch.empty_like(CUR)
    for c in range(T):
        v = live[c]
        EE[c] = E
        cur0 = torch.maximum(H + S[c], E).clamp_min_(0).mul_(v)
        gm = torch.cummax(cur0 - go + r_ge, dim=1).values
        F = FF[c]
        F[:, 0] = 0
        torch.clamp_min(gm[:, :-1] - r_ge[:-1], 0, out=F[:, 1:])
        H = CUR[c]
        torch.maximum(cur0, F, out=H)
        H.mul_(v)
        En = torch.maximum((E - ge).clamp_min_(0), (H - go).clamp_min_(0))
        E[:, :-1] = En[:, 1:]  # 0 where the row has no query letter
    opn = (CUR - go).clamp_min(0)
    code = (((CUR == FF).to(torch.uint8) << GV)
            | ((CUR == EE).to(torch.uint8) << GH)
            | ((opn >= (FF - ge).clamp_min(0)).to(torch.uint8) << OV)
            | ((opn >= (EE - ge).clamp_min(0)).to(torch.uint8) << OH))
    # the best: the first column reaching the highest column max, its last
    # row reaching it
    colmax = CUR.max(dim=2).values.T                       # [n, T]
    best = colmax.max(dim=1).values
    max_col = torch.where(
        best > 0, (colmax == best[:, None]).to(i32).argmax(dim=1), 0)
    at = CUR[max_col, torch.arange(n, device=dev)]
    rows = torch.where(at == best[:, None], r.to(i32), -1).max(dim=1).values
    max_row = torch.where(best > 0, rows, 0)
    return (best.long(), max_col.long(), max_row.long(),
            code.permute(1, 0, 2))


def _walk_plain(q_base, bias_base, t_cat, J, M, go, ge, planes, base, out,
                slot_off, n_slots):
    """The walk of every job at once, one cell a step: a step of a gap run
    moves first, then every active job reads the plane byte of its cell
    (one gather), then the runs that end close and the jobs between runs
    take a diagonal or open a run.  A job writes at most one op a step
    (jobs that write none write to a spare slot).  Returns stats int64
    [n, 12] and the ops in their slots."""
    dev = t_cat.device
    n = J.shape[0]
    q_off, q_len, use_b, t_off, t_len, d0, band = J.unbind(1)
    i64 = torch.int64
    best = out[:, 0]
    i = out[:, 2].clone()
    j = out[:, 1].clone()
    q_end, s_end = i + 1, j + 1
    z = torch.zeros(n, dtype=i64, device=dev)
    score, n_ops, mode, run = z.clone(), z.clone(), z.clone(), z.clone()
    ident, mism, pos, gapo, gaps, length = (z.clone() for _ in range(6))
    active = best > 0
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    spare = max(n_slots, 1)
    codes = torch.zeros(spare + 1, dtype=torch.int8, device=dev)
    payload = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
    last = planes.numel() - 1
    q_last = max(q_base.numel() - 1, 0)
    t_last = max(t_cat.numel() - 1, 0)
    bias = torch.zeros(q_base.numel(), dtype=i64, device=dev)
    bias[:bias_base.numel()] = bias_base[:q_base.numel()]
    b_on = (use_b != 0).long()
    Mf = M.view(-1)
    cell_at = base - d0          # + i + j * (band - 1): cell (j, i - j - d0)
    step_j = band - 1
    while bool(active.any()):
        m1 = active & (mode == 1)
        m2 = active & (mode == 2)
        m0 = active & (mode == 0)
        tj = t_cat[(t_off + j).clamp(0, t_last)].long()
        # a step of each gap run: I one query letter, D one target letter
        run += m1 | m2
        i -= m1.long()
        j -= m2.long()
        r = i - j - d0
        inb = (r >= 0) & (r < band)
        cell = planes[(cell_at + i + j * step_j).clamp(0, last)].long() * inb
        stop1 = m1 & ((r < 0) | (i <= 0) | (cell & (1 << OV)).bool())
        stop2 = m2 & ((r >= band) | (j <= 0) | (cell & (1 << OH)).bool())
        stop = stop1 | stop2
        gapo += stop
        gaps += run * stop
        length += run * stop
        score -= (go + (run - 1) * ge) * stop
        mode *= ~stop
        # between runs: end, fail, open a run or take the diagonal
        cont = (i >= 0) & (j >= 0) & (score < best)
        done = m0 & ~cont
        bad = m0 & cont & ~inb
        ok = torch.where(done, score == best, ok & ~bad)
        active &= ~(done | bad)
        m0 &= cont & inb
        gv = m0 & (cell & (1 << GV)).bool()
        gh = m0 & ~gv & (cell & (1 << GH)).bool()
        dg = m0 & ~(gv | gh)
        mode += gv + 2 * gh
        run *= ~(gv | gh)
        iq = (q_off + i).clamp(0, q_last)
        qi = q_base[iq].long()
        m = Mf[(qi & 31) * 32 + (tj & 31)]
        eq = qi == tj
        score += (m + bias[iq] * b_on) * dg
        ident += dg & eq
        mism += dg & ~eq
        pos += dg & (eq | (m > 0))
        length += dg
        i -= dg.long()
        j -= dg.long()
        # one op a job at most: D a step of its run, I where its run ends,
        # M or S on the diagonal
        emit = m2 | stop1 | dg
        code = torch.where(m2, 2, torch.where(stop1, 3, (~eq).long()))
        val = torch.where(m2 | (dg & ~eq), tj & 31,
                          torch.where(stop1, run, 1))
        at = torch.where(emit, slot_off + n_ops, spare)
        codes[at] = code.to(torch.int8)
        payload[at] = val.to(torch.int32)
        n_ops += emit
    good = ok & (best > 0)
    stats = torch.zeros((n, 12), dtype=i64, device=dev)
    cols = [i + 1, q_end, j + 1, s_end, ident, mism, pos, gapo, gaps, length,
            n_ops]
    for c, v in enumerate(cols):
        stats[:, c] = v * good
    stats[:, 11] = ok.long()
    return stats, codes[:spare], payload[:spare]


def banded_traceback_multi_plain(q_base, bias_base, t_cat, jobs, matrix32,
                                 go: int, ge: int):
    """The kernel's function in tensor ops: the fill a chunk of jobs at a
    time (jobs sorted by band, then target length; a chunk's jobs x longest
    target x widest band within PLAIN_CELLS), one target column a step,
    the four planes as bits of one byte a cell kept flat, job after job;
    then the walk of every job at
    once, one step a loop; exact int64, on whatever device the inputs are
    on."""
    dev = t_cat.device
    i64 = torch.int64
    n = jobs.shape[0]
    J = jobs.to(i64)
    M = matrix32.to(i64)
    out = torch.zeros((n, 3), dtype=i64, device=dev)
    if n == 0:
        z = torch.zeros(0, dtype=i64, device=dev)
        return (out, torch.zeros((0, 12), dtype=i64, device=dev), z,
                torch.zeros(0, dtype=torch.int8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    t_len, q_len, d0, band = J[:, 4], J[:, 1], J[:, 5], J[:, 6]
    host = J.cpu().numpy()
    perm = np.lexsort((host[:, 4], host[:, 6]))
    sizes = host[perm, 4] * host[perm, 6]
    base_sorted = np.cumsum(sizes) - sizes
    base = np.empty(n, np.int64)
    base[perm] = base_sorted
    planes = torch.zeros(max(int(sizes.sum()), 1), dtype=torch.uint8,
                         device=dev)
    budget = PLAIN_CELLS["cuda" if dev.type == "cuda" else "cpu"]
    lo = 0
    while lo < n:
        hi = lo + 1
        T, B = host[perm[lo], 4], host[perm[lo], 6]
        while hi < n:
            T2, B2 = max(T, host[perm[hi], 4]), max(B, host[perm[hi], 6])
            if (hi + 1 - lo) * T2 * B2 > budget:
                break
            T, B = T2, B2
            hi += 1
        idx = torch.from_numpy(perm[lo:hi]).to(dev)
        Jc = J[idx]
        best, col, row, pl = _fill_plain(q_base, bias_base, t_cat, Jc, M,
                                         go, ge)
        out[idx, 0] = best
        out[idx, 1] = col
        out[idx, 2] = col + Jc[:, 5] + row
        keep = ((torch.arange(pl.shape[1], device=dev)[None, :, None]
                 < Jc[:, 4, None, None])
                & (torch.arange(pl.shape[2], device=dev)[None, None, :]
                   < Jc[:, 6, None, None]))
        a, b = int(base_sorted[lo]), int(base_sorted[hi - 1] + sizes[hi - 1])
        planes[a:b] = pl[keep]
        lo = hi
    caps = t_len + q_len + 2
    slot_off = torch.cumsum(caps, 0) - caps
    stats, codes, payload = _walk_plain(
        q_base, bias_base, t_cat, J, M, go, ge, planes,
        torch.from_numpy(base).to(dev), out, slot_off, int(caps.sum()))
    n_ops = stats[:, 10]
    op_off = torch.cumsum(n_ops, 0) - n_ops
    job = torch.repeat_interleave(torch.arange(n, device=dev), n_ops)
    src = slot_off[job] + torch.arange(job.numel(), device=dev) - op_off[job]
    return out, stats, op_off, codes[src], payload[src]


# ---------------------------------------------------------------------------
# The wave's entry point
# ---------------------------------------------------------------------------

def jobs_fit_device(t_len, bands) -> np.ndarray:
    """Which traceback jobs D4 takes, as a mask: those DeviceDP's K1 would
    take (``swipe_device.job_fits_device``, asked once a distinct (target
    length, band))."""
    pairs = np.stack([np.asarray(t_len, dtype=np.int64).reshape(-1),
                      np.asarray(bands, dtype=np.int64).reshape(-1)], axis=1)
    u, inv = np.unique(pairs, axis=0, return_inverse=True)
    fits = np.array([job_fits_device(int(t), 0, int(b)) for t, b in u], bool)
    return fits[inv.reshape(-1)]


def tb_multi_device(q_base, bias_base, q_off, q_len, use_bias, t_cat, t_off,
                    t_len, d_begins, bands, matrix32, go, ge, device):
    """``tb_multi_results`` on ``device``: the same arrays in (numpy;
    bias_base None when no job has a bias), the same (out, stats, results)
    out.  On a card the letters and the job table go up once, the kernels
    run, the used ops come back in one copy to pinned memory; on the CPU
    the plain version runs.  Phase timers (DIAMOND_TPU_PROF=1):
    ``ext.tb_card_up`` (checks, plan, uploads), ``ext.tb_card_kernel``
    (the call, its one sync included), ``ext.tb_card_back`` (the copies
    back), ``ext.tb_card_results`` (the BandedResults)."""
    global dispatch_count, dispatch_wait_s
    from diamond_tpu_torch.ops.banded_swipe import results_from_tb
    from diamond_tpu_torch.utils.log import padd

    t0 = time.perf_counter()
    dev = torch.device(device)
    jobs = job_table(q_off, q_len, use_bias, t_off, t_len, d_begins, bands)
    if bias_base is None or not jobs[:, 2].any():
        jobs[:, 2] = 0
        bias_base = np.zeros(1, np.int32)
    bias_base = np.ascontiguousarray(bias_base, dtype=np.int32)
    if jobs[:, 2].any():
        used = bias_base[:int((jobs[:, 0] + jobs[:, 1]).max())]
        if len(used) and np.abs(used).max() >= MAX_BIAS:
            raise ValueError(f"D4 takes query biases below {MAX_BIAS}")
    check_jobs(jobs, len(q_base), len(t_cat), len(bias_base))
    plan = tb_plan(jobs) if dev.type == "cuda" else None

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)

    x = (up(q_base, np.int8), up(bias_base, np.int32), up(t_cat, np.int8),
         up(jobs, np.int64), up(matrix32, np.int32))
    t1 = padd("ext.tb_card_up", t0)
    out, stats, op_off, codes, payload = banded_traceback_multi(
        *x, go, ge, plan=plan)
    t1 = padd("ext.tb_card_kernel", t1)
    if dev.type == "cuda":
        pinned = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                  for a in (codes, payload)]
        for h, a in zip(pinned, (codes, payload)):
            h.copy_(a, non_blocking=True)
        out, stats, op_off = (a.cpu() for a in (out, stats, op_off))
        torch.cuda.current_stream(dev).synchronize()
        codes, payload = pinned
    r = tuple(a.numpy() for a in (out, stats, op_off, codes, payload))
    t1 = padd("ext.tb_card_back", t1)
    results = results_from_tb(r)
    padd("ext.tb_card_results", t1)
    dispatch_count += 1
    dispatch_wait_s += time.perf_counter() - t0
    return r[0], r[1], results
