"""blastn: nucleotide search (reference contrib/dna/, WITH_DNA build).

The reference's optional DNA module uses a minimizer index, minimap2-style
chaining, and KSW2/WFA extension (reference contrib/dna/dna_index.cpp,
chain.cpp, extension.cpp, setup.cpp: contiguous k=15 seed, minimizer
window 10, reward 2 / penalty -3, repetitive-minimizer cutoff 2e-4).
The reference ships with WITH_DNA off, so there is no golden-output
contract; this is a functional TPU-native implementation sharing the
banded-SWIPE extension machinery (device-dispatchable) with the protein
paths.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.align.extend import Hsp, Match

KMER = 15
WINDOW = 10
REPETITIVE_CUTOFF = 2e-4  # reference config.cpp 'repetition-cutoff'
CHAIN_MAX_DIST = 5000
CHAIN_MIN_SCORE = 40      # reference traits min chain score (DEFAULT: 20*2)
BAND_EXTENSION = 40       # reference 'band-extension'

_NT = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode_dna(s) -> np.ndarray:
    if isinstance(s, bytes):
        s = s.decode()
    return np.array([_NT.get(ord(c.upper()), 4) for c in s], dtype=np.int8)


def revcomp(d: np.ndarray) -> np.ndarray:
    return _COMP[d[::-1]]


def dna_matrix(reward: int = 2, penalty: int = -3) -> np.ndarray:
    m = np.full((32, 32), penalty, dtype=np.int32)
    np.fill_diagonal(m, reward)
    m[4, :] = penalty
    m[:, 4] = penalty
    return m


def _kmers(d: np.ndarray, k: int = KMER):
    """(codes uint64, valid) for every start position."""
    n = len(d) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    x = d.astype(np.uint64)
    codes = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for i in range(k):
        w = x[i : i + n]
        valid &= w < 4
        codes = (codes << np.uint64(2)) | (w & np.uint64(3))
    return codes, valid


def _mm_hash(x: np.ndarray) -> np.ndarray:
    """64-bit mix (murmur finalizer) for minimizer selection."""
    x = x.astype(np.uint64).copy()
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


def minimizers(d: np.ndarray, k: int = KMER, w: int = WINDOW):
    """(positions, codes) of window minimizers (minimap2 scheme:
    smallest hash per w-window of consecutive k-mers)."""
    codes, valid = _kmers(d, k)
    n = len(codes)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    h = np.where(valid, _mm_hash(codes), np.uint64(1 << 63))
    if n <= w:
        p = int(np.argmin(h))
        if not valid[p]:
            return np.zeros(0, np.int64), np.zeros(0, np.uint64)
        return np.array([p]), codes[[p]]
    # sliding window argmin via stride trick
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(h, w)
    arg = win.argmin(axis=1) + np.arange(len(win))
    pos = np.unique(arg)
    pos = pos[valid[pos]]
    return pos.astype(np.int64), codes[pos]


@dataclass
class DnaIndex:
    """Minimizer index over a target block (reference dna_index.cpp)."""
    index: dict = field(default_factory=dict)  # code -> [(tid, pos)]

    @classmethod
    def build(cls, seqs, k: int = KMER, w: int = WINDOW,
              repetitive_cutoff: float = REPETITIVE_CUTOFF):
        idx = cls()
        total = 0
        for tid, d in enumerate(seqs):
            pos, codes = minimizers(d, k, w)
            total += len(pos)
            for p, c in zip(pos, codes):
                idx.index.setdefault(int(c), []).append((tid, int(p)))
        if repetitive_cutoff > 0 and idx.index:
            # drop the top cutoff-fraction most frequent minimizers
            counts = sorted((len(v) for v in idx.index.values()),
                            reverse=True)
            n_drop = int(total * repetitive_cutoff)
            run = 0
            thr = None
            for c in counts:
                run += c
                if run > n_drop:
                    thr = c
                    break
            if thr is not None and thr > 1:
                idx.index = {k2: v for k2, v in idx.index.items()
                             if len(v) < thr}
        return idx


def chain_anchors(anchors, k: int = KMER,
                  max_dist: int = CHAIN_MAX_DIST,
                  min_score: float | None = None):
    """Minimap2-style 1-pass chaining DP (reference contrib/dna/chain.cpp,
    Li 2018 eq. 1-2): anchors sorted by target pos; returns the best
    chains as index lists with scores."""
    if not anchors:
        return []
    anchors = sorted(anchors, key=lambda a: (a[1], a[0]))  # (qpos, tpos)
    n = len(anchors)
    f = np.zeros(n, dtype=np.float64)
    pre = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        qi, ti = anchors[i]
        best = k
        bj = -1
        for j in range(i - 1, max(-1, i - 50) - 1, -1):
            qj, tj = anchors[j]
            dq = qi - qj
            dt = ti - tj
            if dq <= 0 or dt <= 0 or max(dq, dt) > max_dist:
                continue
            gap = abs(dq - dt)
            match = min(min(dq, dt), k)
            # gap cost (minimap2 eq. 2 simplified)
            cost = 0.0 if gap == 0 else 0.01 * k * gap + 0.5 * np.log2(gap)
            sc = f[j] + match - cost
            if sc > best:
                best = sc
                bj = j
        f[i] = best
        pre[i] = bj
    if min_score is None:
        min_score = float(k)  # short queries: any anchor seeds an extension
    used = np.zeros(n, dtype=bool)
    chains = []
    for i in np.argsort(-f):
        if used[i] or f[i] < min_score:
            continue
        idx = []
        j = i
        while j != -1 and not used[j]:
            idx.append(j)
            used[j] = True
            j = pre[j]
        idx.reverse()
        chains.append(([anchors[j] for j in idx], float(f[i])))
    return chains


def blastn_search(query_records, target_records, reward: int = 2,
                  penalty: int = -3, gap_open: int = 5, gap_extend: int = 2,
                  max_evalue: float = 10.0, k: int = KMER, w: int = WINDOW):
    """Returns ({query_idx: [Match]}, query meta, target meta).

    Matches carry Hsps in query-strand coordinates; hsp.frame 0 = plus
    strand, 3 = minus (reusing the translated-frame orientation plumbing
    for output)."""
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_np

    m = dna_matrix(reward, penalty)
    # Karlin-Altschul ungapped params for the reward/penalty pair over
    # uniform base composition (solves sum p_i p_j exp(lambda*s) = 1)
    lam = _ka_lambda(reward, penalty)
    K = 0.46  # BLASTN table value for (2,-3) class scoring
    tnames = [r[0] for r in target_records]
    tseqs = [encode_dna(r[1]) for r in target_records]
    qnames = [r[0] for r in query_records]
    qseqs = [encode_dna(r[1]) for r in query_records]
    db_letters = sum(len(t) for t in tseqs)

    idx = DnaIndex.build(tseqs, k, w)
    results = {}
    for qi, q in enumerate(qseqs):
        matches = []
        for strand, qs in ((0, q), (3, revcomp(q))):
            pos, codes = minimizers(qs, k, w)
            per_target: dict[int, list] = {}
            for p, c in zip(pos, codes):
                for tid, tp in idx.index.get(int(c), ()):
                    per_target.setdefault(tid, []).append((int(p), tp))
            for tid, anchors in per_target.items():
                t = tseqs[tid]
                min_sc = min(CHAIN_MIN_SCORE, max(float(k), 0.5 * len(qs)))
                for chain, _score in chain_anchors(anchors, k,
                                                   min_score=min_sc):
                    c0 = min(a[0] - a[1] for a in chain)
                    c1 = max(a[0] - a[1] for a in chain)
                    # band-doubling on edge contact (the role of ksw2's
                    # band growth in the reference's DNA mode,
                    # contrib/dna/extension.cpp): when the traced
                    # alignment's endpoint diagonals come within 2 of
                    # the band boundary, the optimum may be clipped —
                    # double the margin and re-extend
                    ext = BAND_EXTENSION
                    while True:
                        d0 = max(c0 - ext, -(len(t) - 1))
                        d1 = min(c1 + ext, len(qs))
                        # banded_swipe_np takes the RAW open penalty
                        # (it adds gap_extend internally)
                        r = banded_swipe_np(qs, t, d0, d1, m, None,
                                            gap_open, gap_extend,
                                            traceback=True)
                        full = d0 <= -(len(t) - 1) and d1 >= len(qs)
                        if r.score <= 0 or full or ext >= 1024:
                            break
                        dqb = r.query_range[0] - r.subject_range[0]
                        dqe = r.query_range[1] - r.subject_range[1]
                        if (min(dqb, dqe) - d0 >= 2
                                and (d1 - 1) - max(dqb, dqe) >= 2):
                            break
                        ext *= 2
                    if r.score <= 0:
                        continue
                    bits = (lam * r.score - np.log(K)) / np.log(2.0)
                    ev = db_letters * len(qs) * (2.0 ** -bits)
                    if ev > max_evalue:
                        continue
                    h = Hsp(score=r.score, evalue=float(ev),
                            bit_score=float(bits),
                            d_begin=d0, d_end=d1,
                            query_range=r.query_range,
                            subject_range=r.subject_range,
                            identities=r.identities, mismatches=r.mismatches,
                            positives=r.positives,
                            gap_openings=r.gap_openings, gaps=r.gaps,
                            length=r.length, transcript=r.transcript,
                            backtraced=True)
                    h.frame = strand
                    if strand:
                        # report in plus-strand source coordinates
                        L = len(qs)
                        b, e = h.query_range
                        h.query_source_range = (L - e, L - b)
                    else:
                        h.query_source_range = h.query_range
                    mm = Match(target_block_id=tid, hsp=[h])
                    mm.set_filter()
                    matches.append(mm)
        if matches:
            # one best HSP per (query, target, strand) region set: cull by
            # evalue like the protein paths
            matches.sort(key=lambda mm: (mm.filter_evalue, -mm.filter_score,
                                         mm.target_block_id))
            results[qi] = matches
    return results, (qnames, qseqs), (tnames, tseqs)


def _ka_lambda(reward: int, penalty: int, p: float = 0.25) -> float:
    """Ungapped Karlin-Altschul lambda for uniform base frequencies."""
    lo, hi = 1e-6, 10.0
    def f(lam):
        return (4 * p * p * np.exp(lam * reward)
                + 12 * p * p * np.exp(lam * penalty) - 1.0)
    for _ in range(100):
        mid = (lo + hi) / 2
        if f(mid) > 0:
            hi = mid
        else:
            lo = mid
    return (lo + hi) / 2
