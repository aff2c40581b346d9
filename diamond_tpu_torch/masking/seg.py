"""NCBI SEG low-complexity masking (--masking seg).

Port of the SEG algorithm of Wootton & Federhen (Comput. Chem. 17, 149
(1993)) with the exact numeric behavior of the reference's NCBI toolkit
implementation (reference src/lib/blast/blast_seg.cpp; entry
SeqBufferSeg, parameters SegParametersNewAa: window 10, locut 1.8,
hicut 2.1, maxtrim 50, maxbogus 2, overlaps off): sliding-window K1
entropies trigger low-complexity regions, each region is trimmed to the
subwindow minimizing the Wootton-Federhen P0 probability, and left
remainders recurse.  The rounded ln(n!) table is shared with the
reference so threshold comparisons agree bit-for-bit.

Letters < 20 are the true amino acids; anything else is "bogus" (X,
stops, masked) and excluded from compositions.
"""
from __future__ import annotations

import math

import numpy as np

from diamond_tpu_torch.masking._seg_lnfact import LNFACT

WINDOW = 10
LOCUT = 1.8
HICUT = 2.1
MAXTRIM = 50
MAXBOGUS = 2
ALPHASIZE = 20
LN20 = 2.9957322735539909
LN2 = 0.69314718055994530942


def _lnfact(n: int) -> float:
    if n < len(LNFACT):
        return float(LNFACT[n])
    return (n + 0.5) * math.log(n) - n + 0.9189385332


def _entropy(counts) -> float:
    """K1 entropy of a composition (reference s_Entropy)."""
    total = int(sum(counts))
    if total == 0:
        return 0.0
    ent = 0.0
    for c in counts:
        if c:
            ent += c * math.log(c / total) / LN2
    return abs(ent / total)


def _ln_perm(sv, total: int) -> float:
    """reference s_LnPerm (W-F eq. 3 numerator)."""
    ans = _lnfact(total)
    for c in sv:
        ans -= _lnfact(c)
    return ans


def _ln_ass(sv) -> float:
    """reference s_LnAss (W-F eq. 1): ln of the number of compositions
    in the complexity state."""
    ans = _lnfact(ALPHASIZE)
    if not sv:
        return ans
    total = ALPHASIZE
    cl = 1
    svim1 = sv[0]
    i = 0
    idx = 0
    while True:
        i += 1
        if i == ALPHASIZE:
            ans -= _lnfact(cl)
            break
        idx += 1
        svi = sv[idx] if idx < len(sv) else 0
        if svi == svim1:
            cl += 1
            svim1 = svi
            continue
        total -= cl
        ans -= _lnfact(cl)
        if svi == 0:
            ans -= _lnfact(total)
            break
        cl = 1
        svim1 = svi
    return ans


def _get_prob(sv, total: int) -> float:
    """reference s_GetProb: ln P0."""
    return _ln_ass(sv) + _ln_perm(sv, total) - total * LN20


def _state(counts) -> list:
    """Sorted (desc) non-zero composition counts (reference s_StateOn)."""
    return sorted((c for c in counts if c), reverse=True)


def _seq_entropy(letters: np.ndarray) -> np.ndarray:
    """Per-center window entropies; -1 where the window has > MAXBOGUS
    bogus letters or does not exist (reference s_SeqEntropy)."""
    L = len(letters)
    H = np.full(L, -1.0)
    if WINDOW > L:
        return H
    downset = (WINDOW + 1) // 2 - 1
    counts = [0] * ALPHASIZE
    bogus = 0
    for k in range(WINDOW):
        l = int(letters[k])
        if l < ALPHASIZE:
            counts[l] += 1
        else:
            bogus += 1
    first = downset
    last = L - (WINDOW - downset)
    for i in range(first, last + 1):
        if bogus <= MAXBOGUS:
            H[i] = _entropy(counts)
        w0 = i - downset
        if w0 + WINDOW < L:
            l = int(letters[w0])
            if l < ALPHASIZE:
                counts[l] -= 1
            else:
                bogus -= 1
            l = int(letters[w0 + WINDOW])
            if l < ALPHASIZE:
                counts[l] += 1
            else:
                bogus += 1
    return H


def _trim(letters: np.ndarray, leftend: int, rightend: int):
    """reference s_Trim: shrink [leftend, rightend] to the subwindow
    minimizing P0 (lengths down to max(1, len - MAXTRIM))."""
    seq = letters[leftend : rightend + 1]
    length = len(seq)
    minlen = max(1, length - MAXTRIM)
    lend = 0
    rend = length - 1
    minprob = 1.0
    # prefix composition counts for O(1) window compositions
    for ln in range(length, minlen, -1):
        counts = [0] * ALPHASIZE
        for k in range(ln):
            l = int(seq[k])
            if l < ALPHASIZE:
                counts[l] += 1
        for i in range(0, length - ln + 1):
            prob = _get_prob(_state(counts), ln)
            if prob < minprob:
                minprob = prob
                lend = i
                rend = ln + i - 1
            if i + ln < length:
                l = int(seq[i])
                if l < ALPHASIZE:
                    counts[l] -= 1
                l = int(seq[i + ln])
                if l < ALPHASIZE:
                    counts[l] += 1
    return leftend + lend, rightend - (length - rend - 1)


def _seg_seq(letters: np.ndarray, offset: int, segs: list):
    """reference s_SegSeq (prepends to segs like the reference; order is
    restored by the caller)."""
    L = len(letters)
    downset = (WINDOW + 1) // 2 - 1
    upset = WINDOW - downset
    H = _seq_entropy(letters)
    if WINDOW > L:
        return
    first = downset
    last = L - upset
    lowlim = first
    i = first
    while i <= last:
        if H[i] <= LOCUT and H[i] != -1.0:
            # s_FindLow / s_FindHigh
            j = i
            while j >= lowlim:
                if H[j] == -1.0 or H[j] > HICUT:
                    break
                j -= 1
            loi = j + 1
            j = i
            while j <= last:
                if H[j] == -1.0 or H[j] > HICUT:
                    break
                j += 1
            hii = j - 1
            leftend = loi - downset
            rightend = hii + upset - 1
            leftend, rightend = _trim(letters, leftend, rightend)
            if i + upset - 1 < leftend:   # trigger window in left trim
                lend = loi - downset
                rend = leftend - 1
                leftsegs: list = []
                _seg_seq(letters[lend : rend + 1], offset + lend, leftsegs)
                segs[:0] = leftsegs
            segs.insert(0, (leftend + offset, rightend + offset))
            i = min(hii, rightend + downset)
            lowlim = i + 1
        i += 1


def seg_mask_ranges(letters) -> list:
    """Low-complexity ranges [(begin, end_exclusive)] in ascending order
    (reference SeqBufferSeg; overlaps=false so no merge pass)."""
    seq = np.asarray(letters).astype(np.int64) & 31
    segs: list = []
    _seg_seq(seq, 0, segs)
    return [(b, e + 1) for b, e in segs]


def seg_mask(letters: np.ndarray, mask_letter: int = 23) -> np.ndarray:
    """Hard-mask low-complexity regions (reference masking.cpp:183-187)."""
    out = np.asarray(letters).copy()
    for b, e in seg_mask_ranges(out):
        out[b:e] = mask_letter
    return out
