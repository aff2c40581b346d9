"""Uniform-band banded Smith-Waterman in plain PyTorch (the counterpart of
``diamond_tpu/ops/swipe_jax.py``, which is XLA code, not a Pallas kernel).

One query against a batch of targets with per-target bands [d0, d1): each
target k is shifted right by s_k = d0_k + C (C = max(0, -min d0)), so band
row r of shifted column j is query position i = j - C + r for every target,
and the batch shares one profile ``profile_pad`` [T + band, 32] whose rows
[j, j + band) serve column j.  The vertical gap is the lazy-F prefix max: F(r)
= max(0, max_{k<r}(cur0(k) - go - (r-1-k) ge)), exact because go >= ge.

``column_step`` is that recurrence for one column over [B, band]; the
one-hot path here (``banded_swipe_uniform``) and ``uniform_walk``, the plain
version of the uniform-band kernel (``csrc/uniform_swipe.cu``,
``ops/swipe_uniform_device``) and of the diagonal-band sweep
(``csrc/swipe_sweep.cu``, ``ops/swipe_device``), walk their columns with it.
"""
from __future__ import annotations

import numpy as np
import torch

from diamond_tpu_torch.utils.device import resolve_device

NEG = -(2 ** 20)          # large negative, safe from int32 overflow in adds
MAX_UNIFORM_BAND = 8192   # widest band the uniform-band kernel takes
MAX_WARP_BAND = 512       # widest band its warp holds in registers
STRIP_ROWS = 512          # most profile rows a warp walks at once (wider bands)


def pad_pow2(x: int, lo: int = 16) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def pad_band(x: int) -> int:
    """Band padding: pow2 up to 1024, then multiples of 1024."""
    if x <= 1024:
        return pad_pow2(x, 16)
    return (x + 1023) // 1024 * 1024


def uniform_shape(band: int, rows=None):
    """(rows per lane, strips) of the uniform-band kernel for ``band``: up to
    MAX_WARP_BAND rows one warp holds the band, ceil(band / 32) band rows a
    lane, in one strip (``rows`` unused); wider bands one warp walks the
    profile's ``rows`` live rows (``profile_rows``, required there) in
    strips of at most STRIP_ROWS, the rows spread evenly over the strips and
    the warp's 32 lanes."""
    if not 1 <= band <= MAX_UNIFORM_BAND:
        raise ValueError(f"uniform-band kernel takes bands 1..{MAX_UNIFORM_BAND}")
    if band <= MAX_WARP_BAND:
        return -(-band // 32), 1
    if rows is None:
        raise ValueError(f"band {band} takes the wide walk, whose shape needs "
                         f"the profile's live rows")
    strips = max(1, -(-rows // STRIP_ROWS))
    return max(1, -(-rows // (32 * strips))), strips


def profile_rows(prof_t):
    """What the wide-band walk needs to know of a transposed profile
    (int32 [32, T + band], a numpy array or a tensor, whose reduction then
    runs on its device and is read back once) as Python ints: (p_lo, p_hi,
    pos, all_valid).  [p_lo, p_hi) are the first and one past the last
    profile row in which some letter scores (> NEG / 2), (0, 0) when none
    does; bit a of ``pos`` is set where letter a scores > 0 in some row of
    that range (a row outside it scores > 0 nowhere); ``all_valid`` is 1
    where every letter scores > NEG / 2 in every row of it."""
    live = prof_t > NEG // 2
    parts = (live.any(0), live.all(0), (prof_t > 0).any(1))
    if isinstance(prof_t, torch.Tensor):
        back = torch.cat(parts).cpu().numpy()
    else:
        back = np.concatenate(parts)
    n = prof_t.shape[1]
    rows = np.flatnonzero(back[:n])
    if not len(rows):
        return 0, 0, 0, 1
    p_lo, p_hi = int(rows[0]), int(rows[-1]) + 1
    pos = sum(1 << int(a) for a in np.flatnonzero(back[2 * n:]))
    return p_lo, p_hi, pos, int(back[n + p_lo:n + p_hi].all())


def make_profile(query: np.ndarray, bias, matrix32: np.ndarray, qlen_pad: int):
    """[qlen_pad, 32] substitution profile with bias folded in."""
    q = np.asarray(query).astype(np.int64) & 31
    qlen = len(q)
    prof = np.full((qlen_pad, 32), NEG, dtype=np.int32)
    rows = matrix32[q].astype(np.int32)
    if bias is not None:
        rows = rows + np.asarray(bias, dtype=np.int32)[:, None]
    prof[:qlen] = rows
    return prof


def column_step(H, E, scores, best, max_col, max_row, j: int, r, go: int,
                ge: int):
    """One target column of the uniform-band recurrence.

    H, E, scores int32 [B, band] (scores NEG where the cell is out of band or
    query), best / max_col / max_row int32 [B], r int32 [band] row indices.
    Returns the next (H, E, best, max_col, max_row): max_col moves on a strict
    rise of the best only, max_row is the highest band row of that column's
    ties."""
    valid = scores > NEG // 2
    r_ge = r * ge
    cur0 = torch.maximum(H + scores, E).clamp_min(0)
    gmax = torch.cummax(cur0 - go + r_ge, dim=1).values
    F = (gmax - r_ge).clamp_min(0)                       # F at row r + 1
    zcol = torch.zeros_like(H[:, :1])
    # invalid cells are zeroed so gaps cannot tunnel through them
    Hn = torch.where(valid, torch.maximum(cur0, torch.cat([zcol, F[:, :-1]], 1)),
                     0)
    cb = Hn.max(dim=1).values
    crow = torch.where(Hn == cb[:, None], r, -1).max(dim=1).values
    upd = cb > best
    best = torch.where(upd, cb, best)
    max_col = torch.where(upd, j, max_col)
    max_row = torch.where(upd, crow, max_row)
    Eo = torch.maximum(E - ge, Hn - go).clamp_min(0)
    return Hn, torch.cat([Eo[:, 1:], zcol], 1), best, max_col, max_row


def uniform_walk(t_idx, rows_valid, prof_t, go: int, ge: int):
    """The uniform-band kernel's function in tensor ops, one target column
    per step: t_idx int8 [B, T] letters, rows_valid bool [B, band], prof_t
    int32 [32, T + band] (row r of column j scores prof_t[letter][j + r]).
    Returns (best, max_col, max_row) int32 [B]; exact, on whatever device
    the inputs are on."""
    B, T = t_idx.shape
    band = rows_valid.shape[1]
    dev = t_idx.device
    i32 = torch.int32
    r = torch.arange(band, dtype=i32, device=dev)
    rl = r.long()
    letters = t_idx.long() & 31
    H = torch.zeros(B, band, dtype=i32, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros(B, dtype=i32, device=dev)
    max_col, max_row = torch.zeros_like(best), torch.zeros_like(best)
    for j in range(T):
        s = prof_t[letters[:, j, None], j + rl[None, :]]
        s = torch.where(rows_valid, s, NEG)
        H, E, best, max_col, max_row = column_step(
            H, E, s, best, max_col, max_row, j, r, go, ge)
    return best, max_col, max_row


def banded_swipe_uniform(targets_1h, band_mask, profile_pad,
                         gap_open_total: int, gap_extend: int, band: int):
    """Score-only banded SW with the uniform-band formulation.

    targets_1h [T, B, 32] float32 one-hot shifted target letters; band_mask
    [B, band] bool (False rows above a target's band width score nothing);
    profile_pad [T + band, 32] int32, column j reads rows [j, j + band).
    Each column's scores are the one-hot product with its profile window
    (float32, exact for these integers).  Returns (best, max_col,
    max_rowband) int32 [B] in shifted coordinates."""
    T, B, _ = targets_1h.shape
    dev = targets_1h.device
    i32 = torch.int32
    r = torch.arange(band, dtype=i32, device=dev)
    prof_f = profile_pad.to(torch.float32)
    H = torch.zeros(B, band, dtype=i32, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros(B, dtype=i32, device=dev)
    max_col, max_row = torch.zeros_like(best), torch.zeros_like(best)
    for j in range(T):
        s = (targets_1h[j] @ prof_f[j:j + band].T).to(i32)
        s = torch.where(band_mask, s, NEG)
        H, E, best, max_col, max_row = column_step(
            H, E, s, best, max_col, max_row, j, r, gap_open_total, gap_extend)
    return best, max_col, max_row


def prepare_uniform_batch(query, bias, matrix32, jobs, device=None):
    """banded_swipe_uniform's inputs on ``device`` (the card unless the
    caller asks for the CPU) from per-target bands.

    jobs: list of (target_letters, d_begin, d_end).  Returns (targets_1h,
    band_mask, profile_pad, band, meta); meta maps shifted coordinates back:
    true_subject_pos = j - shifts[k], true_query_pos = j - C + rowband."""
    qlen = len(query)
    band = pad_pow2(max(d1 - d0 for _, d0, d1 in jobs), 16)
    C = max(0, -min(d0 for _, d0, _ in jobs))
    shifts = [d0 + C for _, d0, _ in jobs]
    T = pad_pow2(max(len(t) + s for (t, _, _), s in zip(jobs, shifts)), 16)
    B = len(jobs)
    tgt = np.full((B, T), 31, dtype=np.int64)
    band_mask = np.zeros((B, band), dtype=bool)
    for k, ((t, d0, d1), s) in enumerate(zip(jobs, shifts)):
        tgt[k, s: s + len(t)] = np.asarray(t, dtype=np.int64) & 31
        band_mask[k, : d1 - d0] = True
    onehot = np.zeros((T, B, 32), dtype=np.float32)
    onehot[np.arange(T)[:, None], np.arange(B)[None, :], tgt.T] = 1.0
    # column j reads query rows [j - C, j - C + band)
    profile_pad = np.full((T + band, 32), NEG, dtype=np.int32)
    i0, i1 = max(0, -C), min(qlen, T + band - C)
    if i1 > i0:
        profile_pad[i0 + C: i1 + C] = make_profile(query, bias, matrix32,
                                                   qlen)[i0:i1]
    dev = torch.device(resolve_device(device))
    meta = {"C": C, "shifts": shifts, "band": band}
    return (torch.from_numpy(onehot).to(dev),
            torch.from_numpy(band_mask).to(dev),
            torch.from_numpy(profile_pad).to(dev), band, meta)


class SwipeBatcher:
    """Buckets (target, band) work items into one padded batch on the card,
    or on the CPU when the caller asks for it."""

    def __init__(self, matrix32, gap_open: int, gap_extend: int,
                 device=None):
        self.matrix32 = matrix32
        self.go = gap_open + gap_extend
        self.ge = gap_extend
        self.device = resolve_device(device)

    def run(self, query, bias, jobs):
        """jobs: list of (target_letters, d_begin, d_end).
        Returns list of (score, max_col, max_row) in true coordinates."""
        if not jobs:
            return []
        targets_1h, band_mask, profile_pad, band, meta = prepare_uniform_batch(
            query, bias, self.matrix32, jobs, self.device)
        out = banded_swipe_uniform(targets_1h, band_mask, profile_pad,
                                   self.go, self.ge, band)
        best, mc, mr = (o.cpu().numpy().astype(np.int64) for o in out)
        return [(int(best[k]), int(mc[k]) - meta["shifts"][k],
                 int(mc[k]) - meta["C"] + int(mr[k])) for k in range(len(jobs))]
