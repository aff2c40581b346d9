"""The plain reference of a blastp hit: masking, the composition bias, the
alignment DP and the statistics, written from the published methods in
NumPy and PyTorch.  It imports nothing of the program under test and reads
only ``data/blosum62.json`` and the sequences the benchmark made.

- ``repeat_mask``: tantan (Frith 2011) as DIAMOND runs it on proteins:
  50 repeat offsets, repeat start 0.005, end 0.05, offset decay 0.9,
  letters masked to X where P(repeat) >= 0.9; a float64 forward-backward.
- ``hauser_bias``: DIAMOND's default composition-based statistics
  (``--comp-based-stats 1``, Hauser et al. 2016): a per-query-position
  score bias from a 40-letter sliding window, rounded half away from 0.
- ``align``: affine-gap DP (gap of length L costs open + L * extend) in
  int64 keys score * 2^16 +- identities, so one pass gives the best score
  and the most (or fewest) identities among the paths that reach it;
  ``local`` Smith-Waterman or ``box`` (end to end in a given box).
- ``bitscore`` / ``evalue``: Karlin-Altschul with the ALP finite-size
  correction (Sheetlin, Park, Frith, Spouge), scaled to the database.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "data", "blosum62.json")) as _f:
    MATRIX = json.load(_f)
ALPHABET = MATRIX["alphabet"]
SCORES = np.asarray(MATRIX["scores"], np.int64)          # [26, 26]
BG = np.asarray(MATRIX["background_freqs"], np.float64)  # [20]
GAP_OPEN, GAP_EXTEND = MATRIX["gap_open"], MATRIX["gap_extend"]
X = ALPHABET.index("X")
TRUE_AA = 20
CODE = np.full(256, X, np.int64)
for _i, _c in enumerate(ALPHABET):
    CODE[ord(_c)] = _i
U = 1 << 16        # identities live below this in an alignment key
NEG = -(1 << 50)


def encode(seq: str) -> np.ndarray:
    return CODE[np.frombuffer(seq.encode(), np.uint8)]


# ---------------------------------------------------------------------------
# tantan
# ---------------------------------------------------------------------------

TANTAN_OFFSETS = 50
TANTAN_P_REPEAT, TANTAN_P_END, TANTAN_DECAY = 0.005, 0.05, 0.9
TANTAN_P_MASK = 0.9


def tantan_lambda() -> float:
    """The lambda at which inv(exp(lambda S)) over the 20 amino acids sums
    to 1 (the letter probabilities it implies are then valid)."""
    S = SCORES[:TRUE_AA, :TRUE_AA].astype(np.float64)

    def f(lam):
        return np.linalg.inv(np.exp(lam * S)).sum() - 1.0

    lo, hi = 0.05, 1.0
    grid = np.linspace(lo, hi, 200)
    vals = [f(g) for g in grid]
    for a, b, fa, fb in zip(grid, grid[1:], vals, vals[1:]):
        if fa * fb <= 0:
            lo, hi = a, b
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(lo) * f(mid) <= 0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


_TANTAN = {}


def _tantan_tables():
    if not _TANTAN:
        lam = tantan_lambda()
        ratio = np.exp(lam * SCORES.astype(np.float64))
        k = np.arange(TANTAN_OFFSETS)
        # P(enter a repeat of offset k + 1) falls by the decay per offset
        w = TANTAN_DECAY ** k
        _TANTAN.update(lam=lam, ratio=ratio, d=TANTAN_P_REPEAT * w / w.sum())
    return _TANTAN


def repeat_mask(seqs: list[np.ndarray], group: int = 64) -> list[np.ndarray]:
    """Each sequence with its tantan repeats set to X."""
    out = [None] * len(seqs)
    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    for g0 in range(0, len(order), group):
        idx = order[g0:g0 + group]
        for k, m in zip(idx, _mask_group([seqs[k] for k in idx])):
            out[k] = m
    return out


def _mask_group(seqs):
    """tantan over a batch of sequences, padded to the longest."""
    t = _tantan_tables()
    ratio, d = t["ratio"], t["d"]
    n, K = len(seqs), TANTAN_OFFSETS
    L = max(len(s) for s in seqs)
    lens = np.array([len(s) for s in seqs])
    S = np.full((n, L), X, np.int64)
    for i, s in enumerate(seqs):
        S[i, :len(s)] = s
    pr, pe = TANTAN_P_REPEAT, TANTAN_P_END
    # emission of offset state k at position i: ratio(x_i, x_{i-k-1})
    def emis(i):
        j = i - 1 - np.arange(K)
        e = ratio[S[:, i][:, None], S[:, np.maximum(j, 0)]]
        return np.where(j[None, :] >= 0, e, 0.0)

    # forward, each step scaled so the background state reads 1
    fb = np.ones(n)
    fr = np.zeros((n, K))
    fwd_b = np.empty((n, L))
    fwd_r = np.empty((n, L, K))
    for i in range(L):
        nb = fb * (1 - pr) + fr.sum(1) * pe
        nr = (fr * (1 - pe) + fb[:, None] * d[None, :]) * emis(i)
        fb, fr = np.ones(n), nr / nb[:, None]
        fwd_b[:, i], fwd_r[:, i] = fb, fr
    # backward from the end state (entered from background with 1 - pr,
    # from a repeat with pe), each step scaled so the background reads 1
    bb = np.full(n, 1 - pr)
    br = np.full((n, K), pe)
    p_bg = np.empty((n, L))
    for i in range(L - 1, -1, -1):
        end = i >= lens - 1  # at or past a sequence's last letter
        bb = np.where(end, 1 - pr, bb)
        br = np.where(end[:, None], pe, br)
        tot = fwd_b[:, i] * bb + (fwd_r[:, i] * br).sum(1)
        p_bg[:, i] = fwd_b[:, i] * bb / tot
        if i == 0:
            break
        e = emis(i)
        nbb = (1 - pr) * bb + (d[None, :] * e * br).sum(1)
        nbr = pe * bb[:, None] + (1 - pe) * e * br
        bb, br = np.ones(n), nbr / nbb[:, None]
    out = []
    for k, s in enumerate(seqs):
        m = s.copy()
        m[1.0 - p_bg[k, :lens[k]] >= TANTAN_P_MASK] = X
        out.append(m)
    return out


# ---------------------------------------------------------------------------
# composition-based statistics, mode 1 (Hauser 2016)
# ---------------------------------------------------------------------------

HAUSER_WINDOW = 40


def hauser_bias(q: np.ndarray) -> np.ndarray:
    """int64 per-position bias of a (masked) query: at position m, for a
    true amino acid r = q[m], the expected score of r against the
    background minus its mean score against the window's other letters.
    The window is [m - 20, m + 20] kept inside the sequence: it keeps its
    width at the ends (it slides in only once m passes 20 from the start
    and stops 20 from the end); a sequence of 41 letters or fewer uses
    all of it."""
    L = len(q)
    bias = np.zeros(L, np.int64)
    if L == 0:
        return bias
    half = min(HAUSER_WINDOW // 2, L - 1)
    m0 = min(half, L - half - 1) + 1
    expect = SCORES[:TRUE_AA, :TRUE_AA].astype(np.float64) @ BG
    for m in range(L):
        r = int(q[m])
        if r >= TRUE_AA:
            continue
        hi = min(m + half + 1, L)
        lo = 0 if m < m0 else min(m - m0 + 1, L - half - 1)
        win = int(SCORES[r, q[lo:hi]].sum()) - int(SCORES[r, r])
        v = expect[r] - win / max(hi - lo - 1, 1)
        bias[m] = int(v - 0.5) if v < 0 else int(v + 0.5)
    return bias


# ---------------------------------------------------------------------------
# the DP
# ---------------------------------------------------------------------------

def align(pairs, mode: str, device="cpu", int8=False, group: int = 256):
    """Best score and identity range of each pair.

    pairs: [(q, bias, t, q_id, t_id)]: int64 letters (masked), the
    query's per-position bias, and the letters identities are counted
    on.  mode ``box``: the whole of q against the whole of t, end
    to end; ``local``: Smith-Waterman.  Returns int64 arrays (score,
    identities at most, identities at least), the identities over the
    paths that reach the best score.  ``int8``: every cell of H saturates
    at 127, as an 8-bit DP would (the control).
    """
    n = len(pairs)
    score = np.zeros(n, np.int64)
    id_hi = np.zeros(n, np.int64)
    id_lo = np.zeros(n, np.int64)
    order = sorted(range(n), key=lambda k: (len(pairs[k][0]), len(pairs[k][2])))
    M = torch.as_tensor(SCORES, device=device)
    for g0 in range(0, n, group):
        idx = order[g0:g0 + group]
        s, hi, lo = _align_group([pairs[k] for k in idx], mode, M, device,
                                 int8)
        score[idx], id_hi[idx], id_lo[idx] = s, hi, lo
    return score, id_hi, id_lo


def _align_group(pairs, mode, M, device, int8):
    B = len(pairs)
    Lq = max(len(p[0]) for p in pairs)
    Lt = max(len(p[2]) for p in pairs)
    lq = torch.tensor([len(p[0]) for p in pairs], device=device)
    lt = torch.tensor([len(p[2]) for p in pairs], device=device)
    PAD = SCORES.shape[0]
    Mp = torch.full((PAD + 1, PAD + 1), -(1 << 20), dtype=torch.int64,
                    device=device)
    Mp[:PAD, :PAD] = M
    Q = torch.full((B, Lq), PAD, dtype=torch.int64)
    Qp = torch.full((B, Lq), -1, dtype=torch.int64)
    bias = torch.zeros((B, Lq), dtype=torch.int64)
    T = torch.full((B, Lt), PAD, dtype=torch.int64)
    Tp = torch.full((B, Lt), -2, dtype=torch.int64)
    for b, (q, qb, t, qp, tp) in enumerate(pairs):  # qp, tp: identities
        Q[b, :len(q)] = torch.from_numpy(np.asarray(q, np.int64))
        Qp[b, :len(q)] = torch.from_numpy(np.asarray(qp, np.int64))
        bias[b, :len(q)] = torch.from_numpy(np.asarray(qb, np.int64))
        T[b, :len(t)] = torch.from_numpy(np.asarray(t, np.int64))
        Tp[b, :len(t)] = torch.from_numpy(np.asarray(tp, np.int64))
    Q, Qp, bias, T, Tp = (x.to(device) for x in (Q, Qp, bias, T, Tp))
    go, ge = GAP_OPEN + GAP_EXTEND, GAP_EXTEND
    sign = torch.tensor([1, -1], device=device).view(2, 1, 1)  # id max, min
    j = torch.arange(Lt + 1, device=device)
    local = mode == "local"
    neg = torch.full((2, B, Lt + 1), NEG, dtype=torch.int64, device=device)
    if local:
        H = torch.zeros((2, B, Lt + 1), dtype=torch.int64, device=device)
    else:
        H = (-(GAP_OPEN + j * ge) * U).expand(2, B, Lt + 1).clone()
        H[:, :, 0] = 0
    F = neg.clone()
    best = torch.zeros((2, B), dtype=torch.int64, device=device)
    col_ok = (j[None, 1:] <= lt[:, None])                   # [B, Lt]
    for i in range(Lq):
        s = Mp[Q[:, i]].gather(1, T) + bias[:, i:i + 1]      # [B, Lt]
        same = (Tp == Qp[:, i:i + 1]).long()
        diag = H[:, :, :-1] + s * U + sign * same
        F = torch.maximum(F - ge * U, H - go * U)
        h0 = torch.maximum(diag, F[:, :, 1:])
        if local:
            h0 = torch.clamp_min(h0, 0)
            first = torch.zeros((2, B, 1), dtype=torch.int64, device=device)
        else:
            first = (-(GAP_OPEN + (i + 1) * ge) * U) * torch.ones(
                (2, B, 1), dtype=torch.int64, device=device)
        h0 = torch.cat([first, h0], 2)
        # a horizontal gap from column k to j: h0[k] - go - (j - k - 1) ge
        run = torch.cummax(h0 + j * ge * U, 2).values
        e = torch.cat([neg[:, :, :1], run[:, :, :-1] - go * U
                       - (j[1:] - 1) * ge * U], 2)
        Hn = torch.maximum(h0, e)
        if int8:
            Hn = torch.minimum(Hn, torch.full_like(Hn, 127 * U))
        live = (i < lq).view(1, B, 1)
        H = torch.where(live, Hn, H)
        if local:
            cand = torch.where(col_ok, H[:, :, 1:], NEG).amax(2)
            best = torch.where(live[..., 0], torch.maximum(best, cand), best)
    if local:
        key = best
    else:
        key = H[:, torch.arange(B, device=device), lt]
    kmax, kmin = key[0].cpu().numpy(), key[1].cpu().numpy()
    s_hi = np.floor_divide(kmax, U)
    s_lo = -np.floor_divide(-kmin, U)
    return s_hi, kmax - s_hi * U, s_lo * U - kmin


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def _gumbel():
    cols = MATRIX["params_columns"]
    p = dict(zip(cols, MATRIX["gapped_11_1"]))
    u = dict(zip(cols, MATRIX["ungapped"]))
    G = GAP_OPEN + GAP_EXTEND
    b = 2.0 * G * (u["alpha"] - p["alpha"])
    beta = 2.0 * G * (u["alpha_v"] - p["alpha_v"])
    tau = 2.0 * G * (u["alpha_v"] - p["sigma"])
    return dict(lam=p["Lambda"], K=p["K"], a=p["alpha"], b=b,
                alpha=p["alpha_v"], beta=beta, sigma=p["sigma"], tau=tau)


GUMBEL = _gumbel()


def bitscore(raw: float) -> float:
    g = GUMBEL
    return (g["lam"] * raw - math.log(g["K"])) / math.log(2.0)


def evalue(raw: float, qlen: int, slen: int, db_letters: int) -> float:
    """Per-pair e-value with the finite-size corrected area, times the
    database's letters over the subject's length."""
    g = GUMBEL
    y = float(raw)
    cut = 2.0

    def side(length):
        mean = length - (g["a"] * y + g["b"])
        var = max(cut * g["alpha"] / g["lam"], g["alpha"] * y + g["beta"])
        sd = math.sqrt(var)
        z = mean / sd if sd else 1e100
        P = 0.5 * math.erfc(-z / math.sqrt(2.0))
        E = -math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        return mean * P - sd * E, P

    p1, P1 = side(slen)
    p2, P2 = side(qlen)
    c = max(cut * g["sigma"] / g["lam"], g["sigma"] * y + g["tau"])
    area = p1 * p2 + c * P1 * P2
    return area * g["K"] * math.exp(-g["lam"] * y) * db_letters / slen
