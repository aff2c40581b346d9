#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diamond_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--queries N] [--long-reads N] [--short-reads N]
                          [--swipe-queries N] [--sweep-queries N] [--seed S]

Phases; each one fails the run on error:
  1. device: the card's name, count, power limit (needs CUDA);
  2. build: the port's CUDA kernels (banded_swipe.cu, swipe3.cu,
     full_swipe.cu, uniform_swipe.cu, swipe_sweep.cu, stage2.cu,
     stage12.cu; one nvcc per source, all at once, for sm_90a; registers
     and spills from ptxas) and the port's native host library;
  3. parity: each kernel against its plain PyTorch version on the card and
     the host DP (exact int32, 0 mismatches required): the banded SWIPE
     (K1) on requests in every band class (rows per lane 1..16), counted
     per class; the 3-frame DP (K3) on jobs over both strands, frames of
     unequal length, d0 < 0, band 1, targets shorter than the band, read
     by read against the native host DP and all reads in one batch
     against the plain version and the reads one by one; the
     full-matrix sweep (K2) against the full-band host DP, with and
     without bias, queries above one strip, and at its own interface
     (against the host DP) on every rows-per-lane class with 1, 31 and
     32R - 1 padding rows, 2-16 strips and low-complexity runs with gaps
     1/1; the
     uniform-band DP (K4) on bands of 16 to 8192 rows, with and without
     bias, d0 < 0, targets shorter than the band, also through the direct
     DP route, and at its own interface on bands of no power of two, masks
     that are no prefix, targets of up to 1,300 letters, and both paths (a
     warp per target for bands up to 512; a CTA per target above); the
     diagonal-band sweep (K5, SwipeSweep) against the full-band host DP,
     with queries above one strip, positive biases, tied bests and score-0
     rows, and on a profile whose pad cells score (and a dead row) against
     its plain version; the stage-2 filter (K6) at the benchmark's shape,
     on pregathered pairs of a padded count and on edge batches (pair
     counts of no multiple of 16, zero-width windows, hamming_id at the
     edge), against a numpy oracle; the fused stage-1/2 filter (D1) on
     200,000 random pairs (also against the native host pass at window
     48) and on edge batches (pair counts of no multiple of a block,
     windows 1-48, delimiters at and around the seed, masked letters with
     high bits, hamming_id 0 to 49);
  4. blastp: a default ``blastp -f 6`` self-search of a seeded synthetic
     protein set the size of nr_10k (10,000 sequences, ~4 M letters), on
     the card, on the host, and a third time with stage 1/2 on the card
     (DIAMOND_TPU_TORCH_STAGE12=1: D1 must launch and the output equal
     the other two); ``seed.stage12`` and its sub-phases printed per route;
  5. blastx --long-reads: seeded 2-8 kb reads back-translated from that set
     (~1 indel per kb) against it; >= 95 % must hit their source protein;
  6. blastx: default six-frame search of 500 seeded 300-1500 nt reads
     (its DP is on the host, as in the reference; run once);
  7. blastp --swipe: the first 32 proteins against the whole set, its
     phase timers printed (masking, dispatch, pack, copies and launches,
     host tail, readback, per-query finish, output);
     paths 4, 5 and 7 run once with the DP on the card and once with
     DIAMOND_TPU_TORCH_DEVICE_DP=0; the outputs must be identical and the
     path's kernel must have launched (counts set to 0 before each run);
     the jobs whose band starts below diagonal -(t_len - 1) are counted
     in the blastp and --swipe runs, K1's and the host DP's; then
     ``makedb`` of the protein set and ``dbinfo`` of the result, timed;
  8. SwipeSweep: the first 4 proteins against the whole set through K5,
     scores held against K2's FullSweep on the same pairs;
  9. benchmark: ``diamond_tpu_torch.cli benchmark`` (its table printed);
     K1, K3, K4 and K6 must have launched;
     paths 4-9 report the card's kernel busy time (CUDA events around every
     launch) and its idle share;
 10. timing: each kernel, its plain version and the bound on the largest
     batch of its path (CUDA events): per call (the wrapper launched from
     Python) and kernel only (the launches replayed from a CUDA graph);
     K1 with its band classes and the cells it walks against the exact
     band cells; K3 also on the largest one-read batch of the long-reads
     run; K4 also on the benchmark's full-matrix row (band 1,024, the CTA
     path); K2 also over the whole --swipe path, against its bound at 7
     int32 ops a cell (DPX counted) and at the 11 before DPX; K6 also cold
     (the L2 flushed before each launch by writing 256 MB, and by reading
     them); D1 on the largest launch of the stage-1/2 blastp run.
The last two lines of standard output are the kernel summary and
{"ok": true, "device": {...}}.  Imports nothing of JAX or diamond_tpu.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

AA = "ARNDCQEGHILKMFPSTWYV"  # order of the BLOSUM62 background frequencies
H100_SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# int32 ops one cell of each recurrence needs (the row-serial form; the
# kernels' lazy-F scans compute the same values with a few more)
K1_OPS = 12
K1_NOTE = ("bias add, H+s, max E, max 0, H-go (shared by E and F), F-ge, "
           "max for F, max F into H, valid select, best max, E-ge, max for E")
# K2 as Hopper issues it: DPX fuses each add-max pair and the profile holds
# the bias.  The count before DPX (K2_PRE_DPX_OPS) is printed beside it.
K2_OPS = 7
K2_NOTE = ("H+s with max E and max 0 (one __viaddmax_s32_relu), cur0-go, "
           "F-ge with max for F (one), max F into H, H-go, E-ge with max for "
           "E (one), best max")
K2_PRE_DPX_OPS = 11
K2_PRE_DPX_NOTE = ("bias add, H+s, max E, max 0, H-go (shared by E and "
                   "F), E-ge, max for E, F-ge, max for F, max F into H, "
                   "best max")
K3_OPS = 15
K3_NOTE = ("s-fs, diagonal+s, row r-1 + (s-fs), row r+1 + (s-fs), 5 max "
           "over those three, the vertical gap, the horizontal state and 0, "
           "H-go (shared), vertical gap-ge, max for it, horizontal state-ge, "
           "max for it, best max")
# K4 and K5 share one recurrence; the bias is folded into their profile
K45_OPS = 11
K45_NOTE = ("H+s, max E, max 0, H-go (shared by E and F), F-ge, max for F, "
            "max F into H, valid select, best max, E-ge, max for E")
K6_OPS = 10
K6_NOTE = ("matrix index, st+M, max 0, min 255, two window compares, window "
           "select, best max, letter compare, identity add")
# D1 per pair, counted from csrc/stage12.cu, the walks as this run's data
# makes them: a fingerprint letter, a letter examined by a clip walk, a
# Kadane step (the function's arithmetic only: the matrix index counts 1 as
# in K6, not the rotated layout's extra add and mask), and the keep test
D1_FP_OPS, D1_WALK_OPS, D1_STEP_OPS, D1_KEEP_OPS = 4, 1, 6, 3
D1_NOTE = ("48 fingerprint letters x 4 (xor, and, compare, add); each "
           "letter a clip walk examines x 1 (its compare); each Kadane step "
           "x 6 (two masks, matrix index, add-max-relu, min 255, best max); "
           "3 for keep")


def make_proteins(n_seqs: int = 10_000, n_families: int = 2_500,
                  seed: int = 0):
    """Seeded synthetic protein set with planted homologs: family roots of
    log-normal length (median ~300, clipped to 30-3000) drawn from the
    BLOSUM62 background frequencies; every other sequence is a member of a
    random family at 40-95 % identity with a few short indels.  Returns
    [(id, sequence)] in shuffled order."""
    from diamond_tpu_torch.constants._matrix_data import MATRICES

    rng = np.random.default_rng(seed)
    bg = np.asarray(MATRICES["BLOSUM62"]["background_freqs"], np.float64)
    bg /= bg.sum()
    letters = np.frombuffer(AA.encode(), np.uint8)

    def draw(n):
        return letters[rng.choice(20, size=n, p=bg)]

    lens = np.clip(np.rint(rng.lognormal(np.log(300), 0.7, n_families)),
                   30, 3000).astype(int)
    roots = [draw(n) for n in lens]
    seqs = []
    for k in range(n_seqs):
        fam = k if k < n_families else int(rng.integers(n_families))
        s = roots[fam]
        if k >= n_families:
            ident = rng.uniform(0.40, 0.95)
            s = s.copy()
            sub = rng.random(len(s)) > ident
            s[sub] = draw(int(sub.sum()))
            for _ in range(int(rng.poisson(2))):
                pos = int(rng.integers(len(s)))
                ln = int(rng.integers(1, 6))
                if rng.random() < 0.5:
                    s = np.concatenate([s[:pos], draw(ln), s[pos:]])
                elif len(s) - ln >= 30:
                    s = np.concatenate([s[:pos], s[pos + ln:]])
        seqs.append((f"syn{k:05d}_fam{fam:04d}", s.tobytes().decode()))
    perm = rng.permutation(n_seqs)
    return [seqs[i] for i in perm]


STANDARD_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
BASES = "TCAG"  # the code's codon order: TCAG x TCAG x TCAG


def make_reads(proteins, n_reads: int, min_len: int, max_len: int,
               indels_per_kb: float = 0.0, subst: float = 0.01,
               seed: int = 0):
    """Seeded synthetic DNA reads from a protein set: each read back-
    translates a random member (or a window of it, when the member is
    longer than the read) with seeded codons of the standard code, adds
    random flanks up to a length drawn from [min_len, max_len], applies
    ~``subst`` substitutions and ``indels_per_kb`` single-nucleotide
    insertions or deletions per kb, and every other read is reverse
    complemented.  Returns [(name, dna)]; a read's name ends with the id of
    its source protein."""
    rng = np.random.default_rng(seed)
    codons: dict[str, list[str]] = {}
    for k, aa in enumerate(STANDARD_CODE):
        codons.setdefault(aa, []).append(
            BASES[k // 16] + BASES[k // 4 % 4] + BASES[k % 4])
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(n_reads):
        pid, prot = proteins[int(rng.integers(len(proteins)))]
        L = int(rng.integers(min_len, max_len + 1))
        n_aa = min(len(prot), (L - 30) // 3)
        a = int(rng.integers(len(prot) - n_aa + 1))
        cds = "".join(codons[c][int(rng.integers(len(codons[c])))]
                      for c in prot[a:a + n_aa])
        left = int(rng.integers(L - len(cds) + 1))
        dna = list("".join(BASES[x] for x in rng.integers(0, 4, left)) + cds
                   + "".join(BASES[x] for x in
                             rng.integers(0, 4, L - len(cds) - left)))
        for p in np.flatnonzero(rng.random(len(dna)) < subst):
            dna[p] = BASES[int(rng.integers(4))]
        for _ in range(int(rng.poisson(indels_per_kb * len(dna) / 1000))):
            p = int(rng.integers(len(dna)))
            if rng.random() < 0.5:
                dna.insert(p, BASES[int(rng.integers(4))])
            else:
                del dna[p]
        dna = "".join(dna)
        if r % 2:
            dna = dna.translate(comp)[::-1]
        reads.append((f"read{r:05d}_{pid}", dna))
    return reads


def write_fasta(path, recs):
    with open(path, "w") as f:
        for name, s in recs:
            f.write(f">{name}\n{s}\n")


def write_fastq(path, recs):
    with open(path, "w") as f:
        for k, (name, s) in enumerate(recs):
            qual = "".join(chr(33 + 20 + (k + i) % 20) for i in range(len(s)))
            f.write(f"@{name}\n{s}\n+\n{qual}\n")


# one band in each of K1's classes (rows per lane 1..16) and at the edges
DP_BANDS = (1, 17, 32, 33, 64, 65, 97, 100, 128, 129, 161, 193, 200, 225,
            256, 257, 289, 300, 321, 353, 385, 417, 449, 481, 500, 512)


def dp_requests(seed: int, n_queries: int):
    """Seeded DeviceDP requests, targets up to ~4000 letters: each query
    takes half of DP_BANDS (and a few more jobs), so every four queries
    cover every band class up to 512 with and without bias (bias on every
    other query); d0 < 0 (down to -(t_len - 1)), band 1, targets shorter
    than the band, and jobs with no cell in the query."""
    rng = np.random.default_rng(seed)
    reqs = []
    half = len(DP_BANDS) // 2
    for r in range(n_queries):
        qlen = int(rng.integers(20, 4000))
        q = rng.integers(0, 20, qlen).astype(np.int8)
        bias = rng.integers(-4, 5, qlen).astype(np.int32) if r % 2 else None
        jobs = []
        for k in range(half + int(rng.integers(0, 4))):
            tl = int(rng.integers(5, 4000))
            t = rng.integers(0, 20, tl).astype(np.int8)
            n = max(min(qlen - 1, tl - 2, 40), 0)
            t[2:2 + n] = q[1:1 + n]
            band = DP_BANDS[(k + half * (r // 2)) % len(DP_BANDS)]
            d0 = int(rng.integers(-tl + 1, qlen))
            jobs.append((t, d0, d0 + band))
        jobs.append((t[:7], -3, 60))       # target shorter than the band
        jobs.append((t[:5], -50, -40))     # no cell in the query
        reqs.append((q, bias, jobs))
    return reqs


def band_cells(t_len, q_len, d0, band):
    """Exact in-query band cells per job (the work the DP needs)."""
    cells = np.zeros(len(t_len), np.int64)
    for r in range(int(band.max()) if len(band) else 0):
        d = d0 + r
        n = np.minimum(t_len, q_len - d) - np.maximum(0, -d)
        cells += np.where(r < band, np.maximum(n, 0), 0)
    return cells


def swipe3_jobs(seed: int, n_queries: int):
    """Seeded 3-frame jobs: per query, both strands' frame translations of
    unequal length (so the stop row bites) and jobs over both strands in
    every band class up to 512, targets up to ~4000 letters with a planted
    stretch of the band's diagonal, d0 < 0, band 1 and targets shorter than
    the band.  Returns [(strands, [(strand, target, d0, d1)])]."""
    rng = np.random.default_rng(seed)
    bands = (1, 20, 32, 33, 64, 100, 128, 200, 256, 300, 512)
    out = []
    for _ in range(n_queries):
        strands = []
        for _s in range(2):
            q0 = int(rng.integers(60, 1500))
            lens = [q0, q0 - int(rng.integers(0, 2)), q0 - int(rng.integers(0, 2))]
            strands.append([rng.integers(0, 20, n).astype(np.int8) for n in lens])
        jobs = []
        for k in range(int(rng.integers(10, 24))):
            s = k % 2
            q = strands[s][0]
            tl = int(rng.integers(5, 4000))
            t = rng.integers(0, 20, tl).astype(np.int8)
            band = bands[k % len(bands)]
            d0 = int(rng.integers(-tl + 1, len(q)))
            d1 = max(min(d0 + band, len(q)), d0 + 1)
            d = (d0 + d1) // 2
            j = np.arange(max(0, -d), min(tl, len(q) - d))[:80]
            t[j] = q[j + d]
            jobs.append((s, t, d0, d1))
        jobs += [(0, t[:7], -3, 60), (1, t[:40], 2, 3)]
        out.append((strands, jobs))
    return out


def swipe3_cells(jobs, reqs):
    """Exact cells of each 3-frame job (rows the recurrence computes, summed
    over its columns), from the kernel's packed jobs and reqs."""
    cells = np.zeros(len(jobs), np.int64)
    for k, (_t_off, t_len, i0, band, req) in enumerate(jobs.astype(np.int64)):
        _q, l0, l1, l2 = reqs[req].astype(np.int64)
        stop = min(3 * l1 + 1, 3 * l2 + 2)
        lo = np.maximum(i0 + np.arange(t_len), 0)
        hi = np.minimum(i0 + np.arange(t_len) + band, l0)
        cells[k] = np.maximum(np.minimum(3 * hi, stop) - 3 * lo, 0).sum()
    return cells


def sweep_inputs(seed: int):
    """Seeded --swipe inputs: queries of 5 to 4,000 letters (several above
    the 512-row strip, bias on every other one) and 150 targets of up to
    ~3,000 letters, most with a planted stretch of a query."""
    rng = np.random.default_rng(seed)
    queries = []
    for k, n in enumerate((5, 31, 33, 100, 300, 512, 513, 1000, 2100, 4000)):
        q = rng.integers(0, 20, n).astype(np.int8)
        queries.append((q, rng.integers(-4, 5, n).astype(np.int8) if k % 2
                        else None))
    targets = []
    for k in range(150):
        t = rng.integers(0, 20, int(rng.integers(1, 3000))).astype(np.int8)
        q = queries[k % len(queries)][0]
        n = min(len(t), len(q), 60)
        a = int(rng.integers(len(t) - n + 1))
        b = int(rng.integers(len(q) - n + 1))
        t[a:a + n] = q[b:b + n]
        targets.append(t)
    return queries, targets


def k2_edge_cases(seed: int):
    """Seeded cases for the full-matrix sweep (K2) at its own interface, one
    query each: (label, query, bias or None, rows per lane R, targets,
    gap_open, gap_extend).  Every R in 1..16 in one strip with 1, 31 and
    32R - 1 rows past the query (the unmasked padding); queries of 2 to 16
    strips; low-complexity runs with gap open 1 and extend 1, so vertical
    gaps cross lanes and strips; bias on every other case.  The targets
    hold stretches of the query, so most pairs score above random."""
    rng = np.random.default_rng(seed)

    def low(n):
        return np.resize(rng.integers(0, 20, 3), n).astype(np.int8)

    def targets_for(q):
        out = [rng.integers(0, 20, int(n)).astype(np.int8)
               for n in rng.integers(1, 300, 6)]
        for k in range(4):
            a = int(rng.integers(len(q)))
            stretch = q[a:a + int(rng.integers(1, 80))]
            out.append(np.concatenate([rng.integers(0, 20, k * 7).astype(
                np.int8), stretch, stretch[::-1]]))
        return out

    cases = []
    for R in range(1, 17):
        for pad in sorted({1, 31, 32 * R - 1}):
            n = 32 * R - pad
            if n < 1:
                continue
            q = rng.integers(0, 20, n).astype(np.int8)
            bias = (rng.integers(-4, 5, n).astype(np.int8)
                    if (R + pad) % 2 else None)
            cases.append((f"R {R}, {pad} padding rows", q, bias, R,
                          targets_for(q), 11, 1))
    for strips, R, last in ((2, 16, 1), (3, 12, 40), (5, 1, 31), (9, 4, 100),
                            (16, 16, 511)):
        n = 32 * R * (strips - 1) + last
        q = rng.integers(0, 20, n).astype(np.int8)
        cases.append((f"{strips} strips of R {R}", q,
                      rng.integers(-4, 5, n).astype(np.int8)
                      if strips % 2 else None, R, targets_for(q), 11, 1))
    for n, R in ((700, 11), (1100, 12), (40, 2), (2049, 4)):
        q = low(n)
        ts = [low(int(x)) for x in rng.integers(5, 600, 5)] + targets_for(q)
        cases.append((f"low complexity {n}, gaps 1/1", q,
                      rng.integers(-4, 5, n).astype(np.int8) if n % 2
                      else None, R, ts, 1, 1))
    return cases


def k2_direct_inputs(q, bias, targets, R):
    """One K2 launch of one query against targets with rows per lane R:
    numpy (t_cat, targets, q_cat, bias_cat, reqs, pairs) and the scratch
    slots it needs."""
    tl = np.array([len(t) for t in targets], np.int64)
    t_off = np.concatenate([[0], np.cumsum(tl)[:-1]])
    slots = int(len(q) > 32 * R)
    return dict(
        t_cat=np.concatenate(targets).astype(np.int8),
        targets=np.stack([t_off, tl], axis=1).astype(np.int32),
        q_cat=np.asarray(q, np.int8),
        bias_cat=(np.zeros(len(q), np.int8) if bias is None
                  else np.asarray(bias, np.int8)),
        reqs=np.array([[0, len(q), slots - 1]], np.int32),
        pairs=np.stack([np.zeros(len(targets)), np.arange(len(targets))],
                       axis=1).astype(np.int32)), slots


def k2_mixed_inputs(seed: int):
    """One K2 launch (rows per lane 4) whose blocks hold pairs of several
    queries: queries of 300 (3 strips, bias), 100, 128 (no padding row) and
    200 letters (2 strips, bias), the two multi-strip ones in scratch slots
    0 and 1; the first block all of the first query, the other pairs
    shuffled, and 39 pairs, so the last block has one idle warp.  Returns
    (queries, biases, targets, R, numpy inputs as k2_direct_inputs gives
    them, scratch slots)."""
    rng = np.random.default_rng(seed)
    R = 4
    lens, slot = (300, 100, 128, 200), (0, -1, -1, 1)
    queries = [rng.integers(0, 20, n).astype(np.int8) for n in lens]
    biases = [rng.integers(-4, 5, n).astype(np.int8) if k in (0, 3) else None
              for k, n in enumerate(lens)]
    targets = []
    for k in range(10):
        q = queries[k % 4]
        a = int(rng.integers(len(q)))
        targets.append(np.concatenate([
            rng.integers(0, 20, int(rng.integers(0, 200))).astype(np.int8),
            q[a:a + int(rng.integers(1, 120))]]))
    rest = [(qi, ti) for qi in range(4) for ti in range(10)
            if (qi, ti) != (2, 9) and not (qi == 0 and ti < 4)]
    order = rng.permutation(len(rest))
    pairs = [(0, t) for t in range(4)] + [rest[k] for k in order]
    tl = np.array([len(t) for t in targets], np.int64)
    ql = np.array(lens, np.int64)
    t_off = np.concatenate([[0], np.cumsum(tl)[:-1]])
    q_off = np.concatenate([[0], np.cumsum(ql)[:-1]])
    arrs = dict(
        t_cat=np.concatenate(targets).astype(np.int8),
        targets=np.stack([t_off, tl], axis=1).astype(np.int32),
        q_cat=np.concatenate(queries).astype(np.int8),
        bias_cat=np.concatenate([np.zeros(len(q), np.int8) if b is None
                                 else b for q, b in zip(queries, biases)]),
        reqs=np.stack([q_off, ql, slot], axis=1).astype(np.int32),
        pairs=np.array(pairs, np.int32))
    return queries, biases, targets, R, arrs, 2


UNIFORM_BANDS = (16, 32, 100, 128, 512, 700, 1024, 3000, 5120, 8192)


def uniform_batches(seed: int, bands=UNIFORM_BANDS):
    """Seeded uniform-band (K4) batches, one query each, whose widest job
    is each of ``bands`` rows: queries of about half the band (bias on every
    other), jobs with d0 < 0, a planted stretch of the query on each job's
    middle diagonal, a target shorter than the band and a job with no cell
    in the query.  Returns [(query, bias, jobs)]."""
    rng = np.random.default_rng(seed)
    out = []
    for k, band in enumerate(bands):
        qlen = int(rng.integers(band // 2 + 20, band // 2 + 200))
        q = rng.integers(0, 20, qlen).astype(np.int8)
        bias = rng.integers(-4, 5, qlen).astype(np.int32) if k % 2 else None
        jobs = []
        for x in range(8):
            width = band if x == 0 else int(rng.integers(1, band + 1))
            tl = int(rng.integers(5, band // 4 + 65))
            t = rng.integers(0, 20, tl).astype(np.int8)
            d0 = int(rng.integers(-tl + 1, qlen // 4 + 1))
            d = d0 + width // 2
            j = np.arange(max(0, -d), min(tl, qlen - d))[:80]
            t[j] = q[j + d]
            jobs.append((t, d0, d0 + width))
        jobs += [(t[:7], -3, band - 3), (t[:5], -50, -40)]
        out.append((q, bias, jobs))
    return out


# (band, longest target, targets, holes in the band mask): K4's warp path
# (bands <= 512, the last two with longer targets) and CTA path (513,
# 1024), bands of no power of two
UNIFORM_DIRECT = ((16, 300, 40, False), (128, 480, 64, True),
                  (200, 300, 16, True), (500, 300, 16, False),
                  (512, 200, 8, True), (513, 200, 8, False),
                  (1024, 200, 4, True), (128, 1200, 16, False),
                  (500, 1300, 8, True))


def uniform_direct_cases(seed: int, cases=UNIFORM_DIRECT):
    """Seeded K4 inputs at the kernel's own interface, band widths as given
    (no padding to a power of two): per case a query, targets of up to the
    given length with a planted stretch on a band diagonal, d0 < 0, packed
    by pack_uniform_batch and cut to the band; ``holes`` clears every
    seventh band row from row 3 (a mask that is no prefix).  Returns
    [(band, t_idx int8 [B, T], band_mask int8 [B, band], prof_t int32
    [32, T + band])] as numpy arrays."""
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m32 = ScoreMatrix("BLOSUM62").matrix32
    rng = np.random.default_rng(seed)
    out = []
    for band, tmax, n, holes in cases:
        qlen = max(band, tmax) // 2 + 60
        q = rng.integers(0, 20, qlen).astype(np.int8)
        jobs = []
        for x in range(n):
            tl = int(rng.integers(tmax // 2, tmax + 1))
            t = rng.integers(0, 20, tl).astype(np.int8)
            d0 = int(rng.integers(-min(tl, band) + 1, qlen // 4 + 1))
            width = band if x == 0 else int(rng.integers(1, band + 1))
            d = d0 + width // 2
            j = np.arange(max(0, -d), min(tl, qlen - d))[:80]
            t[j] = q[j + d]
            jobs.append((t, d0, d0 + width))
        pk, _ = sud.pack_uniform_batch(q, None, m32, jobs)
        T = pk["t_idx"].shape[1]
        bm = np.ascontiguousarray(pk["band_mask"][:, :band])
        if holes:
            bm[:, 3::7] = 0
        out.append((band, pk["t_idx"], bm,
                    np.ascontiguousarray(pk["prof_t"][:, :T + band])))
    return out


def sweep_case(seed: int, n_queries: int = 3, n_targets: int = 40):
    """Seeded full-matrix case for the diagonal-band sweep (K5): queries of
    20-300 letters (bias on every other), targets of 10-400, plus two short
    targets of masked letters with no positive cell."""
    rng = np.random.default_rng(seed)
    queries = []
    for r in range(n_queries):
        qlen = int(rng.integers(20, 300))
        q = rng.integers(0, 20, qlen).astype(np.int8)
        bias = rng.integers(-4, 5, qlen).astype(np.int32) if r % 2 else None
        queries.append((q, bias))
    targets = [rng.integers(0, 20, int(rng.integers(10, 400))).astype(np.int8)
               for _ in range(n_targets)]
    return queries, targets + [np.full(3, 23, np.int8), np.full(1, 23, np.int8)]


def sweep_edges(seed: int):
    """Seeded K5 cases beyond sweep_case: queries above one strip (700 and
    1,100 letters), positive int8 biases, a segment three times (ties
    between query rows) and once; targets holding the segment twice (ties
    between columns) and once, targets of masked letters (score 0 against
    the queries without bias) and random targets of 10-1,200 letters with a
    planted stretch of a query.  Returns (queries, targets)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 20, 60).astype(np.int8)
    queries = [(rng.integers(0, 20, 700).astype(np.int8),
                rng.integers(1, 5, 700).astype(np.int32)),
               (rng.integers(0, 20, 1100).astype(np.int8), None),
               (np.tile(seg, 3), None),
               (seg.copy(), None),
               (rng.integers(0, 20, 40).astype(np.int8),
                np.full(40, 4, np.int32))]
    targets = [np.concatenate([seg, rng.integers(0, 20, 30).astype(np.int8),
                               seg]), seg.copy(), np.full(50, 23, np.int8),
               np.full(700, 23, np.int8)]
    for k in range(20):
        t = rng.integers(0, 20, int(rng.integers(10, 1200))).astype(np.int8)
        q = queries[k % 2][0]
        n = min(len(t), 80)
        a = int(rng.integers(len(t) - n + 1))
        b = int(rng.integers(len(q) - n + 1))
        t[a:a + n] = q[b:b + n]
        targets.append(t)
    return queries, targets


def sweep_pad_case(ss, targets, seed: int):
    """K5 launches on a profile whose pad cells score: per length class of
    ``targets``, a query of 300 letters with an int32 bias of +150 (the pad
    letter then scores 22) and its first row dead (band length 0).  Returns
    [(t_idx, band_len, prof_t, q_off, q_len)] on the card."""
    import torch

    from diamond_tpu_torch.ops.swipe_device import sweep_profile

    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, 300).astype(np.int8)
    out = []
    for ch in ss.chunks(targets):
        band = len(q) + ch.C
        T_pb = ch.T + band
        q_let = torch.zeros(T_pb, dtype=torch.int8)
        q_bias = torch.zeros(T_pb, dtype=torch.int32)
        q_valid = torch.zeros(T_pb, dtype=torch.int8)
        q_let[ch.C:ch.C + len(q)] = torch.from_numpy(q)
        q_bias[ch.C:ch.C + len(q)] = 150
        q_valid[ch.C:ch.C + len(q)] = 1
        dev = ch.t_idx.device
        prof_t = sweep_profile(q_let.to(dev), q_bias.to(dev),
                               q_valid.to(dev), ss._m32)
        bl = (len(q) + ch.tl - 1).astype(np.int32)
        bl[0] = 0
        out.append((ch.t_idx, torch.from_numpy(bl).to(dev), prof_t, ch.C,
                    len(q)))
    return out


def stage2_pairs(seed: int, n: int):
    """Seeded stage-2 candidate pairs: two letter streams with delimiters
    (2 %) and 64-letter delimiter margins, seed positions, every third pair
    locally identical, windows of 10-48 and cutoffs of 10-39.  Returns
    (q_letters, s_letters, qp, sp, windows, cutoffs)."""
    rng = np.random.default_rng(seed)

    def letters(k):
        core = rng.integers(0, 20, k).astype(np.int8)
        core[rng.random(k) < 0.02] = 31
        pad = np.full(64, 31, np.int8)
        return np.concatenate([pad, core, pad])

    q_letters, s_letters = letters(2000), letters(3000)
    qp = rng.integers(64, 64 + 2000, n).astype(np.int64)
    sp = rng.integers(64, 64 + 3000, n).astype(np.int64)
    for k in range(0, n, 3):
        lo, hi = max(0, qp[k] - 20), qp[k] + 36
        s_letters[sp[k] - (qp[k] - lo): sp[k] + (hi - qp[k])] = \
            q_letters[lo:hi]
    windows = rng.integers(10, 49, n).astype(np.int32)
    cutoffs = rng.integers(10, 40, n).astype(np.int32)
    return q_letters, s_letters, qp, sp, windows, cutoffs


def stage2_edge_cases(seed: int):
    """Seeded stage-2 filter (K6) batches at its own interface: (label,
    qw8, sw8 [W, N], meta [3, N], hamming_id, max_window).  Pair counts
    that are no multiple of 16 or of a block (1 to 4,099), windows clipped
    to zero width on either side or both, hamming_id at the edge of a
    pair's identity count (0, the count itself, one above it, 48, 49),
    and max_window 32, 48, 64 and 223 (446 rows, the kernel's most)."""
    rng = np.random.default_rng(seed)
    cases = []
    for n, max_window in ((1, 32), (15, 48), (17, 64), (255, 48),
                          (257, 32), (1003, 48), (4099, 64), (301, 223)):
        W = 2 * max_window
        qw = rng.integers(0, 20, (W, n)).astype(np.int8)
        sw = rng.integers(0, 20, (W, n)).astype(np.int8)
        same = rng.random((W, n)) < rng.uniform(0.2, 1.0, n)
        sw[same] = qw[same]
        wl = rng.integers(0, max_window + 1, n)
        wr = rng.integers(0, max_window + 1, n)
        wl[::3], wr[1::3] = 0, 0
        wl[2::7] = wr[2::7] = 0
        meta = np.stack([wl, wr, rng.integers(0, 80, n)]).astype(np.int32)
        fp = slice(max_window - 16, max_window + 32)
        ident = (qw[fp] == sw[fp]).sum(axis=0)
        k = int(ident[0])
        for hid in sorted({0, k, k + 1, 48, 49}):
            cases.append((f"N {n}, max_window {max_window}, hamming_id "
                          f"{hid}", qw, sw, meta, hid, max_window))
    return cases


def stage2_oracle(qw8, sw8, meta, m2, hamming_id: int, max_window: int):
    """The stage-2 filter in numpy over pregathered windows (qw8, sw8 [W, N]
    letters, meta [3, N] rows wl, wr, cutoff): the fingerprint identity
    count over [-16, +32), the uint8-saturating Kadane walk inside [-wl, wr)
    and keep.  Returns (keep, best, ident)."""
    q = np.asarray(qw8, np.int64)
    s = np.asarray(sw8, np.int64)
    wl, wr, cut = np.asarray(meta, np.int64)
    st = np.zeros(q.shape[1], np.int64)
    best = np.zeros_like(st)
    ident = np.zeros_like(st)
    for w in range(q.shape[0]):
        o = w - max_window
        v = np.asarray(m2, np.int64)[q[w] & 31, s[w] & 31]
        st = np.where((o >= -wl) & (o < wr), np.clip(st + v, 0, 255), 0)
        best = np.maximum(best, st)
        if -16 <= o < 32:
            ident += q[w] == s[w]
    return (ident >= hamming_id) & (best > cut), best, ident


def stage12_case(seed: int, n: int, q_len: int = 20_000,
                 s_len: int | None = None):
    """Seeded stage-1/2 (D1) pairs over two letter blocks laid out like the
    search's: 256 delimiters (31) at each end, 2 % delimiters inside, 10 %
    of the letters (delimiters too) with a high bit set as masked letters
    carry (32, 64 or 128: the clip compares the raw byte with 31, the rest
    reads the low 5 bits); every third pair's target copies the query's
    letters around the seed (it passes stage 1); windows of every width 1 to
    48; delimiters put at qp itself, at qp - 1, at the last offset of the
    window on either side and just past it (in q_len / 100 pairs, a sixth
    of them each; before the letters are read, so every pair sees the
    final blocks); cutoffs 0 to 59.  The target block holds 100 letters a
    pair (30,000 at least), so the copies seldom overwrite each other.
    Returns (q_letters, s_letters, qp, sp, windows, cutoffs)."""
    rng = np.random.default_rng(seed)
    s_len = s_len or max(30_000, 100 * n)

    def block(k):
        core = rng.integers(0, 20, k).astype(np.int8)
        core[rng.random(k) < 0.02] = 31
        pad = np.full(256, 31, np.int8)
        return np.concatenate([pad, core, pad])

    q_letters, s_letters = block(q_len), block(s_len)
    qp = rng.integers(256, 256 + q_len, n).astype(np.int64)
    sp = rng.integers(256, 256 + s_len, n).astype(np.int64)
    windows = rng.integers(1, 49, n).astype(np.int64)
    windows[:48] = np.arange(1, 49)[:n]
    for k in range(0, n, 3):
        lo, hi = max(0, qp[k] - 48), qp[k] + 48
        s_letters[sp[k] - (qp[k] - lo): sp[k] + (hi - qp[k])] = \
            q_letters[lo:hi]
    # anchors next to a delimiter: about one pair in a hundred of the
    # query block's letters, so the block keeps ~3 % delimiters
    kind = np.where(rng.random(n) < q_len / 100 / n, rng.integers(0, 6, n),
                    -1)
    w = windows
    for sel, at in ((kind == 0, qp), (kind == 1, qp - 1),
                    (kind == 2, qp + w - 1), (kind == 3, qp - (w - 1)),
                    (kind == 4, qp + w), (kind == 5, qp - w)):
        q_letters[at[sel]] = 31
    high = rng.random(len(q_letters)) < 0.1
    q_letters[high] |= rng.choice(np.array([32, 64, -128], np.int8),
                                  int(high.sum()))
    high = rng.random(len(s_letters)) < 0.1
    s_letters[high] |= rng.choice(np.array([32, 64, -128], np.int8),
                                  int(high.sum()))
    cutoffs = rng.integers(0, 60, n).astype(np.int32)
    return q_letters, s_letters, qp, sp, windows, cutoffs


STAGE12_EDGES = ((1, 0), (255, 11), (257, 26), (4099, 48), (4099, 49),
                 (20_000, 11))


def stage12_edge_cases(seed: int, edges=STAGE12_EDGES):
    """(label, case, hamming_id) for D1's edge batches: pair counts of no
    multiple of a block (1 to 20,000; stage12_case's pairs) and hamming_id
    0, at the search's 11 and 26, 48 (the whole fingerprint) and 49 (no
    pair passes stage 1)."""
    return [(f"N {n}, hamming_id {hid}", stage12_case(seed + k, n), hid)
            for k, (n, hid) in enumerate(edges)]


STAGE12_JOIN_GROUPS = ((1, 1), (3, 5), (2, 300), (20, 40), (9, 130),
                       (1, 700), (40, 17), (2, 2), (600, 260), (17, 129))


def stage12_join_case(seed: int, sizes=STAGE12_JOIN_GROUPS,
                      L: int = 60_000):
    """A seed join for Stage12Device.run_join over one seeded letter block
    (256 delimiters at each end, 120 inside, 20 copied 96-letter
    stretches): groups of the given (query, target) occurrence counts that
    straddle MATMUL_MIN_PAIRS (512) and split tiles on both sides, two big
    groups with occurrences on a copied stretch so that pairs pass stage 1
    in the one-hot product; windows 1 to 48, cutoffs 0 to 39.
    Returns (letters, join, qp, sp, windows, cutoffs)."""
    from diamond_tpu_torch.search.stages import SeedJoin, expand_pairs

    rng = np.random.default_rng(seed)
    letters = rng.integers(0, 20, L + 512).astype(np.int8)
    letters[:256] = 31
    letters[-256:] = 31
    letters[rng.integers(300, L, 120)] = 31
    src = rng.integers(300, L - 100, 40)
    for a, b in zip(src[::2], src[1::2]):
        letters[b - 48:b + 48] = letters[a - 48:a + 48]
    q_pos, s_pos, q_start, s_start = [], [], [0], [0]
    for nq, ns in sizes:
        q_pos.extend(rng.integers(300, L, nq))
        s_pos.extend(rng.integers(300, L, ns))
        q_start.append(len(q_pos))
        s_start.append(len(s_pos))
    join = SeedJoin(keys=np.arange(len(sizes), dtype=np.uint64),
                    q_start=np.array(q_start, dtype=np.int64),
                    q_pos=np.array(q_pos, dtype=np.int64),
                    s_start=np.array(s_start, dtype=np.int64),
                    s_pos=np.array(s_pos, dtype=np.int64))
    for g in (5, 8):  # big groups: some occurrences on the copied stretch
        join.q_pos[join.q_start[g]:join.q_start[g + 1]:2] = src[0]
        join.s_pos[join.s_start[g]:join.s_start[g + 1]:3] = src[1]
    qp, sp = expand_pairs(join)
    windows = rng.integers(1, 49, len(qp)).astype(np.int64)
    cutoffs = rng.integers(0, 40, len(qp)).astype(np.int32)
    return letters, join, qp, sp, windows, cutoffs


def d1_ops(q_blk, s_blk, qp, sp, windows) -> int:
    """D1's int32 operations on these pairs (the D1_*_OPS counts), the clip
    walks and the Kadane walk as long as this data makes them."""
    import torch

    from diamond_tpu_torch.ops.stage12_device import PLAIN_CHUNK, _gather_clip

    w = windows.long()
    wl, wr = torch.empty_like(w), torch.empty_like(w)
    for lo in range(0, len(qp), PLAIN_CHUNK):
        hi = lo + PLAIN_CHUNK
        _, _, _, wl[lo:hi], wr[lo:hi] = _gather_clip(
            q_blk, s_blk, qp[lo:hi].long(), sp[lo:hi].long(), w[lo:hi])
    left = torch.where(wl < w, wl + 1, (w - 1).clamp(min=0))
    right = torch.where(wr < w, wr + 1, w)
    return int(len(qp) * (48 * D1_FP_OPS + D1_KEEP_OPS)
               + D1_WALK_OPS * int((left + right).sum())
               + D1_STEP_OPS * int((wl + wr).sum()))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """The kernels' own time: ``reps`` calls of fn captured in one CUDA
    graph, its replay timed between two events, so no host cadence (Python,
    ctypes, allocation) lies between the launches.  Memsets that fn itself
    enqueues are in the graph too."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm the allocator outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


COLD_BYTES = 256 << 20  # flushed between cold launches: five times the L2


def cold_ms(fn, reps: int, write: bool) -> float:
    """Median time of one call of fn that finds the L2 cold: before each
    call the card writes COLD_BYTES (the L2 is then full of dirty lines,
    which the call's reads must first write back) or reads them (clean
    lines), then spins ~0.1 ms so that the call is queued before the card
    reaches it; all outside the call's own events."""
    import torch

    flush = torch.empty(COLD_BYTES // 4, dtype=torch.int32, device="cuda")
    times = []
    for k in range(reps):
        if write:
            flush.fill_(k)
        else:
            flush.max()
        torch.cuda._sleep(200_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


T0 = time.perf_counter()


def phase(name):
    """Print a phase header with the seconds since the module loaded."""
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


class Patched:
    """Set attributes for the length of a with-block, then restore them."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(o, n, getattr(o, n)) for o, n, _ in self.triples]
        for o, n, v in self.triples:
            setattr(o, n, v)

    def __exit__(self, *exc):
        for o, n, v in self.saved:
            setattr(o, n, v)


def source_hits(lines):
    """Reads (query ids ending with their source protein's id) that hit
    their source protein."""
    out = set()
    for ln in lines:
        q, s = ln.split("\t")[:2]
        if q.split("_", 1)[1] == s:
            out.add(q)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=10_000,
                    help="queries of the blastp self-search (the DB stays "
                         "whole)")
    ap.add_argument("--long-reads", type=int, default=300,
                    help="reads of the blastx --long-reads run")
    ap.add_argument("--short-reads", type=int, default=500,
                    help="reads of the default blastx run")
    ap.add_argument("--swipe-queries", type=int, default=32,
                    help="queries of the blastp --swipe run")
    ap.add_argument("--sweep-queries", type=int, default=4,
                    help="queries of the SwipeSweep (K5) run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    # -- 1. device ----------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    name_power = smi("name,power.limit")
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"device: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; max SM clock {sm_clock_mhz:.0f} MHz")
    print(name_power)
    int32_ops_per_s = H100_SMS * INT32_LANES_PER_SM * sm_clock_mhz * 1e6

    def bound(cells, ops, n_bytes):
        ops_s = cells * ops / int32_ops_per_s
        bytes_s = n_bytes / HBM_BYTES_PER_S
        return (max(ops_s, bytes_s) * 1e3,
                "operations" if ops_s >= bytes_s else "bytes")

    # profiler counters (jobs and cells per DP route) must be on before
    # the port's log module is imported
    os.environ["DIAMOND_TPU_PROF"] = "1"
    from diamond_tpu_torch import native
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.align import extend as pext
    from diamond_tpu_torch.align import swipe_all as pswipe
    from diamond_tpu_torch.align import wave as pwave
    from diamond_tpu_torch.search import pipeline as ppipe
    from diamond_tpu_torch.search import stages as pstages
    from diamond_tpu_torch.benchmark import FULL as BENCH
    from diamond_tpu_torch.constants.alphabet import encode
    from diamond_tpu_torch.ops import _cuda
    from diamond_tpu_torch.ops import stage12_device as d1m
    from diamond_tpu_torch.ops import stage2_device as s2
    from diamond_tpu_torch.ops import swipe3_device as s3
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix
    from diamond_tpu_torch.utils import log as plog

    # -- 2. build -----------------------------------------------------------
    phase("build")
    kernels = ("banded_swipe", "swipe3", "full_swipe", "uniform_swipe",
               "swipe_sweep", "stage2", "stage12")
    t0 = time.perf_counter()
    _cuda.build(kernels)  # one nvcc per source, all at once
    print(f"nvcc {', '.join(k + '.cu' for k in kernels)} in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in _cuda.build_log.get(k, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {k}:", line.strip())
    sd._k1(), s3._k3(), sd._k2(), sud._k4(), sd._k5(), s2._k6(), d1m._k_d1()
    t0 = time.perf_counter()
    if native.lib() is None:
        raise RuntimeError("the port's native host library did not build/load")
    print(f"native host library: {time.perf_counter() - t0:.2f} s")

    # -- 3. parity ----------------------------------------------------------
    phase("kernel parity: K1")
    m = ScoreMatrix("BLOSUM62")
    go, ge, fs = m.gap_open + m.gap_extend, m.gap_extend, 15
    m32 = torch.tensor(m.matrix32, dtype=torch.int32, device="cuda")
    max_err = {}

    def diff(name, got, want):
        torch.cuda.synchronize()
        mis = int(sum((g != w).sum().item() for g, w in zip(got, want)))
        err = max(int((g.long() - w.long()).abs().max().item())
                  for g, w in zip(got, want) if g.numel())
        max_err[name] = max(max_err.get(name, 0), err)
        return mis

    # K1: the banded extension DP
    dp = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    reqs = dp_requests(args.seed + 1, 24)
    p = sd.pack_requests(reqs, "cuda")
    got = dp.launch(p)
    want = dp.launch(p, kernel=sd.banded_swipe_multi_plain)
    torch.cuda.synchronize()
    res = dp.run_many(reqs)
    refs = [banded_swipe_batch_np(q, bias, jobs, m.matrix32, m.gap_open,
                                  m.gap_extend) for q, bias, jobs in reqs]
    mis_by_class = []
    for R, lo, hi in p.classes:  # per band class: kernel vs plain, vs host
        raw = diff("k1", [g[lo:hi] for g in got], [w[lo:hi] for w in want])
        hm = sum(res[r][k] != refs[r][k] for r, k in p.order[lo:hi])
        mis_by_class.append((32 * R, hi - lo, raw, hm))
    print(f"K1 parity: {p.n_jobs} jobs; per band class (rows, jobs, kernel "
          f"vs plain mismatches, kernel vs host DP mismatches): "
          f"{mis_by_class}")
    if [R for R, _, _ in p.classes] != list(sd.ROWS_PER_LANE):
        raise RuntimeError("K1 parity did not cover every band class")
    if any(raw or hm for _, _, raw, hm in mis_by_class):
        raise RuntimeError("K1 disagrees with its references")

    # K3: the 3-frame DP of blastx -F
    phase("kernel parity: K3")
    k3_jobs = k3_host_mis = 0
    k3_classes = set()
    k3_reads = swipe3_jobs(args.seed + 2, 8)
    per_read = []
    for strands, jobs in k3_reads:
        kb, kc = s3.swipe3_scores(strands, jobs, m.matrix32, go, ge, fs, "cuda")
        per_read.append((kb, kc))
        for k, (s, t, d0, d1) in enumerate(jobs):
            k3_classes.add(32 * s3.offsets_per_lane(d1 - d0))
            fwd = native.banded_3frame_forward_native(
                strands[s], t, d0, d1, m.matrix32, go, ge, fs)
            want = (0, -1) if fwd is None else (fwd[1], fwd[2])
            if want[0] <= 0:
                want = (0, -1)
            k3_host_mis += (int(kb[k]), int(kc[k])) != want
        k3_jobs += len(jobs)
    # every read's jobs in one batch, as the -F pipeline sends a window; the
    # plain version runs once, on the batch, which must equal the reads
    # scored one by one
    all_strands, all_jobs = [], []
    for strands, jobs in k3_reads:
        all_jobs += [(len(all_strands) + s, t, d0, d1) for s, t, d0, d1 in jobs]
        all_strands += strands
    launches = s3.banded_swipe3.launches
    bb, bc = s3.swipe3_scores(all_strands, all_jobs, m.matrix32, go, ge, fs,
                              "cuda")
    k3_batch_launches = s3.banded_swipe3.launches - launches
    pb, pc = s3.swipe3_scores(all_strands, all_jobs, m.matrix32, go, ge, fs,
                              "cuda", kernel=s3.banded_swipe3_plain)
    k3_mis = int((bb != pb).sum() + (bc != pc).sum())
    max_err["k3"] = max(int(np.abs(bb - pb).max()), int(np.abs(bc - pc).max()))
    k3_batch_mis = int(
        (bb != np.concatenate([b for b, _ in per_read])).sum()
        + (bc != np.concatenate([c for _, c in per_read])).sum())
    print(f"K3 parity: {k3_jobs} jobs over both strands, band classes "
          f"{sorted(k3_classes)}, kernel read by read vs native host DP "
          f"mismatches {k3_host_mis}; all {len(k3_reads)} reads in one batch "
          f"({k3_batch_launches} launches): kernel vs plain mismatches "
          f"{k3_mis}, vs read by read {k3_batch_mis}")
    if k3_mis or k3_host_mis or k3_batch_mis:
        raise RuntimeError("K3 disagrees with its references")

    # K2: the full-matrix sweep of --swipe
    phase("kernel parity: K2")
    queries, targets = sweep_inputs(args.seed + 3)
    tb = Block.from_sequences(targets, [f"t{i}" for i in range(len(targets))])
    t_order = np.arange(len(targets))
    sweep = sd.FullSweep(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    blk = sweep.pack(queries, tb, t_order)
    x = {k: torch.from_numpy(getattr(blk, k)).cuda()
         for k in ("t_cat", "targets", "q_cat", "bias_cat")}
    k2_mis = 0
    for L in blk.launches:
        r_, p_ = (torch.from_numpy(a).cuda() for a in (L.reqs, L.pairs))
        scratch = torch.empty((L.slots, 2, len(blk.t_cat), 2),
                              dtype=torch.int32, device="cuda")
        outs = []
        for fn in (sd.full_swipe, sd.full_swipe_plain):
            o = torch.zeros((blk.n_queries, blk.n_targets), dtype=torch.int32,
                            device="cuda")
            outs.append(fn(x["t_cat"], x["targets"], x["q_cat"],
                           x["bias_cat"], r_, p_, m32, go, ge, L.R, scratch, o))
        k2_mis += diff("k2", [outs[0]], [outs[1]])
    S = sweep.run_block(queries, tb, t_order)
    k2_host_mis = 0
    for r, (q, bias) in enumerate(queries):
        ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                              for t in targets],
                                    m.matrix32, m.gap_open, m.gap_extend)
        k2_host_mis += int((S[r] != np.array([x_[0] for x_ in ref])).sum())
    print(f"K2 parity: {len(queries)} queries (lengths "
          f"{[len(q) for q, _ in queries]}, up to "
          f"{max(L_.slots for L_ in blk.launches)} multi-strip per launch) x "
          f"{len(targets)} targets, rows-per-lane classes "
          f"{sorted(L_.R for L_ in blk.launches)}, kernel vs plain mismatches "
          f"{k2_mis}, kernel vs host DP (full band) mismatches {k2_host_mis}")
    # at the kernel's interface: every R with 1, 31 and 32R - 1 padding
    # rows, 2-16 strips, low-complexity runs with gaps 1/1, against the host
    # DP (tests/test_torch_gpu.py holds them against the plain version too)
    edges = k2_edge_cases(args.seed + 21)
    e_host_mis = 0
    for label, q, bias, R, targets2, g_open, g_ext in edges:
        arrs, slots = k2_direct_inputs(q, bias, targets2, R)
        x2 = {k: torch.from_numpy(v).cuda() for k, v in arrs.items()}
        scratch = torch.empty((slots, 2, len(arrs["t_cat"]), 2),
                              dtype=torch.int32, device="cuda")
        o = sd.full_swipe(x2["t_cat"], x2["targets"], x2["q_cat"],
                          x2["bias_cat"], x2["reqs"], x2["pairs"], m32,
                          g_open + g_ext, g_ext, R, scratch,
                          torch.zeros((1, len(targets2)), dtype=torch.int32,
                                      device="cuda"))
        ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                              for t in targets2],
                                    m.matrix32, g_open, g_ext)
        e_host_mis += int((o[0].cpu().numpy()
                           != np.array([r[0] for r in ref])).sum())
    print(f"K2 parity at the kernel's interface: {len(edges)} queries (R "
          f"1..16 with 1, 31 and 32R - 1 padding rows, 2-16 strips, "
          f"low-complexity runs with gaps 1/1), kernel vs host DP "
          f"mismatches {e_host_mis}")
    # blocks whose warps hold pairs of several queries (one profile round
    # per query; FullSweep.pack never makes them, the kernel takes them)
    qs, bs, ts, R, arrs, slots = k2_mixed_inputs(args.seed + 22)
    x2 = {k: torch.from_numpy(v).cuda() for k, v in arrs.items()}
    scratch = torch.empty((slots, 2, len(arrs["t_cat"]), 2),
                          dtype=torch.int32, device="cuda")
    outs = [fn(x2["t_cat"], x2["targets"], x2["q_cat"], x2["bias_cat"],
               x2["reqs"], x2["pairs"], m32, go, ge, R, scratch,
               torch.zeros((len(qs), len(ts)), dtype=torch.int32,
                           device="cuda"))
            for fn in (sd.full_swipe, sd.full_swipe_plain)]
    mix_mis = diff("k2", [outs[0]], [outs[1]])
    got = outs[0].cpu().numpy()
    for qi, ti in arrs["pairs"]:
        q, t = qs[qi], ts[ti]
        ref = banded_swipe_batch_np(q, bs[qi], [(t, -(len(t) - 1), len(q))],
                                    m.matrix32, m.gap_open, m.gap_extend)
        mix_mis += int(got[qi, ti] != ref[0][0])
    print(f"K2 parity, blocks of mixed queries: {len(arrs['pairs'])} pairs "
          f"of {len(qs)} queries (lengths {[len(q) for q in qs]}, R {R}), "
          f"kernel vs plain and host DP mismatches {mix_mis}")
    if k2_mis or k2_host_mis or e_host_mis or mix_mis:
        raise RuntimeError("K2 disagrees with its references")

    def np_diff(name, got, want):
        mis = int(sum((np.asarray(g) != np.asarray(w)).sum()
                      for g, w in zip(got, want)))
        err = max(int(np.abs(np.asarray(g, np.int64)
                             - np.asarray(w, np.int64)).max())
                  for g, w in zip(got, want))
        max_err[name] = max(max_err.get(name, 0), err)
        return mis

    def uniform_best_effort(out, n):
        best, mc, mr, meta = out
        return [(int(best[k]), max(int(mc[k]) - meta["shifts"][k], 0),
                 int(mr[k])) for k in range(n)]

    # K4: the uniform-band DP of the benchmark and the direct DP route
    phase("kernel parity: K4")
    k4_jobs = k4_mis = k4_host_mis = 0
    k4_bands = []
    for q, bias, jobs in uniform_batches(args.seed + 4):
        kb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda")
        pb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda",
                                kernel=sud.banded_swipe_uniform_cuda_plain)
        k4_mis += np_diff("k4", kb[:3], pb[:3])
        ref = sud.host_as_uniform(banded_swipe_batch_np(
            q, bias, jobs, m.matrix32, m.gap_open, m.gap_extend), jobs)
        k4_host_mis += sum(a != b for a, b in zip(
            uniform_best_effort(kb, len(jobs)), ref))
        k4_host_mis += sum(a != b for a, b in zip(  # the direct DP route
            pext._device_dp_scores(q, bias, jobs, m), ref))
        k4_bands.append(kb[3]["band"])
        k4_jobs += len(jobs)
    # at the kernel's interface: bands of no power of two, masks that are
    # no prefix, both paths
    k4_direct = []
    for band, *arrs in uniform_direct_cases(args.seed + 12):
        t_idx, bm, prof = (torch.from_numpy(a).cuda() for a in arrs)
        R, threads = sud.uniform_shape(band)
        k4_direct.append((band, tuple(t_idx.shape), 4 * prof.numel(),
                          "warp" if threads == 32 else "cta"))
        k4_mis += diff("k4", sud.banded_swipe_uniform_cuda(t_idx, bm, prof,
                                                           go, ge),
                       sud.banded_swipe_uniform_cuda_plain(t_idx, bm, prof,
                                                           go, ge))
    print(f"K4 parity: {k4_jobs} jobs, bands {k4_bands}, and at the "
          f"kernel's interface (band, [B, T], profile bytes, path) "
          f"{k4_direct}; kernel vs plain mismatches {k4_mis}, kernel vs "
          f"host DP mismatches {k4_host_mis}")
    if k4_mis or k4_host_mis:
        raise RuntimeError("K4 disagrees with its references")

    # K5: the diagonal-band full-matrix sweep (SwipeSweep)
    phase("kernel parity: K5")
    ss = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    k5_mis = k5_launches = k5_host_mis = 0
    k5_cases = []
    for cq5, ct5 in (sweep_case(args.seed + 5), sweep_edges(args.seed + 8)):
        chunks5 = ss.chunks(ct5)
        for q, bias in cq5:
            for ch, _band, bl, prof_t in ss.query_launches(q, bias, chunks5):
                k5_mis += diff("k5", sd.swipe_sweep(ch.t_idx, bl, prof_t, go,
                                                    ge, ch.C, len(q)),
                               sd.swipe_sweep_plain(ch.t_idx, bl, prof_t, go,
                                                    ge))
                k5_launches += 1
        cres5 = ss.run(cq5, ct5)
        for (q, bias), row in zip(cq5, cres5):
            ref = banded_swipe_batch_np(q, bias, [(t, -(len(t) - 1), len(q))
                                                  for t in ct5],
                                        m.matrix32, m.gap_open, m.gap_extend)
            k5_host_mis += sum(a != tuple(b) for a, b in zip(row, ref))
        k5_cases.append(f"{len(cq5)} queries (lengths "
                        f"{[len(q) for q, _ in cq5]}) x {len(ct5)} targets in "
                        f"{len(chunks5)} length classes, "
                        f"{sum(r[0] == 0 for row in cres5 for r in row)} "
                        f"score-0 pairs")
    pads = sweep_pad_case(ss, sweep_edges(args.seed + 8)[1], args.seed + 9)
    for t_idx, bl, prof_t, q_off, q_len in pads:
        k5_mis += diff("k5", sd.swipe_sweep(t_idx, bl, prof_t, go, ge, q_off,
                                            q_len),
                       sd.swipe_sweep_plain(t_idx, bl, prof_t, go, ge))
        k5_launches += 1
    print(f"K5 parity: {'; '.join(k5_cases)}; a profile whose pad cells "
          f"score (+150 bias) in {len(pads)} launches with a dead row each; "
          f"{k5_launches} launches, kernel vs plain mismatches {k5_mis}, "
          f"SwipeSweep vs host DP (full band) mismatches {k5_host_mis}")
    if k5_mis or k5_host_mis:
        raise RuntimeError("K5 disagrees with its references")

    phase("kernel parity: K6")
    # K6: the stage-2 filter, at the benchmark's shape and on pregathered
    # pairs whose count is no multiple of a block
    m2 = m32[:32, :32].contiguous()
    m2_np = m2.cpu().numpy()
    rng6 = np.random.default_rng(args.seed + 6)
    n6, w6 = BENCH["N2"], 96
    qw6 = rng6.integers(0, 20, (w6, n6)).astype(np.int8)
    sw6 = rng6.integers(0, 20, (w6, n6)).astype(np.int8)
    sw6[:, ::5] = qw6[:, ::5]  # some pairs pass the identity test
    meta6 = np.stack([rng6.integers(0, 49, n6), rng6.integers(0, 49, n6),
                      rng6.integers(0, 60, n6)]).astype(np.int32)
    x6 = [torch.from_numpy(a).cuda() for a in (qw6, sw6, meta6)]
    got6 = s2.stage2_filter(*x6, m2, 26, w6 // 2)
    k6_mis = diff("k6", got6, s2.stage2_filter_plain(*x6, m2, 26, w6 // 2))
    k6_host_mis = np_diff("k6", [g.cpu().numpy() for g in got6],
                          stage2_oracle(qw6, sw6, meta6, m2_np, 26, w6 // 2))
    pairs6 = stage2_pairs(args.seed + 7, 700)
    max_window = int(pairs6[4].max())
    keep_k, best_k = s2.stage2_pregathered(*pairs6, m.matrix32, 26, max_window,
                                           device="cuda")
    keep_p, best_p = s2.stage2_pregathered(
        *pairs6, m.matrix32, 26, max_window, device="cuda",
        kernel=s2.stage2_filter_plain)
    k6_mis += np_diff("k6", [keep_k, best_k], [keep_p, best_p])
    qw, sw, wl, wr = s2.pregather_windows(*pairs6[:5], max_window)
    keep_o, best_o, _ = stage2_oracle(qw, sw, np.stack([wl, wr, pairs6[5]]),
                                      m2_np, 26, max_window)
    k6_host_mis += np_diff("k6", [keep_k, best_k], [keep_o, best_o])
    edges6 = stage2_edge_cases(args.seed + 22)
    for _label, qw, sw, meta, hid, mw in edges6:
        xe = [torch.from_numpy(a).cuda() for a in (qw, sw, meta)]
        got = s2.stage2_filter(*xe, m2, hid, mw)
        k6_mis += diff("k6", got, s2.stage2_filter_plain(*xe, m2, hid, mw))
        k6_host_mis += np_diff("k6", [g.cpu().numpy() for g in got],
                               stage2_oracle(qw, sw, meta, m2_np, hid, mw))
    print(f"K6 parity: {n6} pairs x {w6} window letters ({int(got6[0].sum())} "
          f"kept), {len(pairs6[2])} pregathered pairs (max_window "
          f"{max_window}, {int(keep_k.sum())} kept) and {len(edges6)} edge "
          f"batches (N 1 to 4,099, zero-width windows, hamming_id at the "
          f"edge), kernel vs plain mismatches {k6_mis}, kernel vs numpy "
          f"oracle mismatches {k6_host_mis}")
    if k6_mis or k6_host_mis:
        raise RuntimeError("K6 disagrees with its references")

    phase("kernel parity: D1")
    # D1: the fused stage-1/2 filter over letter blocks on the card, on
    # random pairs (also against the native host pass at window 48) and on
    # edge batches
    def d1_tensors(case):
        q, s, qp, sp, win, cut = case
        return ([torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in (q, s)] + [m2]
                + [torch.from_numpy(a.astype(np.int32)).cuda()
                   for a in (qp, sp, win, cut)])

    d1_case = stage12_case(args.seed + 40, 200_000)
    xd = d1_tensors(d1_case)
    got = d1m.stage12_pairs(*xd, 11)
    d1_mis = diff("d1", got, d1m.stage12_pairs_torch(*xd, 11))
    d1_kept = int(got[0].sum())
    q, s, qp, sp, _, _ = d1_case
    w48 = np.full(len(qp), 48, np.int64)
    cut48 = np.full(len(qp), 19, np.int32)
    keep48, best48 = d1m.Stage12Device(m.matrix32, device="cuda").run(
        q, s, qp, sp, w48, cut48, 11)
    nat1 = native.stage1_filter_native(q, s, qp, sp, 11)
    nat2 = native.stage2_scores_native(q, s, qp, sp, m.matrix32, 48, True)
    d1_host_mis = int((keep48 != (nat1 & (nat2 > cut48))).sum()
                      + (best48[keep48] != np.minimum(nat2, 255)[keep48]).sum())
    edges_d1 = stage12_edge_cases(args.seed + 41)
    for _label, case, hid in edges_d1:
        xe = d1_tensors(case)
        d1_mis += diff("d1", d1m.stage12_pairs(*xe, hid),
                       d1m.stage12_pairs_torch(*xe, hid))
    # run_join on the card: groups over 512 pairs through the one-hot
    # product, its tiles split over three products, against the CPU's
    jl, join, jqp, jsp, jwin, jcut = stage12_join_case(args.seed + 42)
    tiles_per_product = d1m.GROUP_TILES
    d1m.GROUP_TILES = 100
    try:
        want_j = d1m.Stage12Device(m.matrix32, device="cpu").run_join(
            jl, jl, join, jqp, jsp, jwin, jcut, 11)
        d1m.reset_dispatch_stats()
        got_j = d1m.Stage12Device(m.matrix32, device="cuda").run_join(
            jl, jl, join, jqp, jsp, jwin, jcut, 11)
        products = d1m.dispatch_count - 1
    finally:
        d1m.GROUP_TILES = tiles_per_product
    d1_join_mis = int((got_j[0] != want_j[0]).sum()
                      + (got_j[1] != want_j[1]).sum())
    print(f"D1 parity: {len(qp)} random pairs ({d1_kept} kept), kernel vs "
          f"plain mismatches and {len(edges_d1)} edge batches (N 1 to "
          f"20,000, windows 1-48, delimiters at and around the seed, masked "
          f"letters, hamming_id 0 to 49): {d1_mis}; at window 48 against "
          f"the native host pass (keep, and best where kept; "
          f"{int(keep48.sum())} kept): {d1_host_mis}; run_join on the card "
          f"against the CPU's ({len(jqp)} pairs, {products} one-hot "
          f"products, {int(got_j[0].sum())} kept): {d1_join_mis}")
    if products != 3 or not got_j[0].any():
        raise RuntimeError("D1 run_join case missed its split products")
    if d1_mis or d1_host_mis or d1_join_mis:
        raise RuntimeError("D1 disagrees with its references")

    # -- 4-9. the paths, each with every launch count set to 0 just before --
    wrappers = dict(k1=sd.banded_swipe_multi, k3=s3.banded_swipe3,
                    k2=sd.full_swipe, k4=sud.banded_swipe_uniform_cuda,
                    k5=sd.swipe_sweep, k6=s2.stage2_filter,
                    d1=d1m.stage12_pairs)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
        spy_d1.launches = 0

    def launch_counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    events = []           # CUDA events around every kernel launch of a run
    captured = {}         # the largest batch of each kernel, for timing

    def timed(fn):
        def wrapper(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            events.append(ev)
            return out
        return wrapper

    run_many, launch = sd.DeviceDP.run_many, sd.DeviceDP.launch
    scores3, dispatch_block = s3.swipe3_scores, sd.FullSweep.dispatch_block
    stage12_pairs = d1m.stage12_pairs
    k1_low = [0]  # K1 jobs of a run whose band starts below -(t_len - 1)
    host_dp = [0, 0]  # host DP jobs of a run: such jobs, all jobs

    def count_host(jobs):
        jobs = list(jobs)
        host_dp[0] += sum(d0 < -(len(t) - 1) for t, d0, _ in jobs)
        host_dp[1] += len(jobs)

    def spy_host_dp(q, bias, jobs, *a, **kw):
        """The host DP of one query (banded_swipe_batch_np: the native
        scorer of native/src/banded_swipe.cc), its jobs counted."""
        count_host(jobs)
        return banded_swipe_batch_np(q, bias, jobs, *a, **kw)

    pack_jobs = pwave._pack_jobs

    def spy_pack_jobs(items, state):
        """The host DP of an extension round (the same native scorer's
        multi-query score-only and traceback calls), its jobs counted."""
        count_host(req.jobs[k] for _, req, ks, _ in items for k in ks)
        return pack_jobs(items, state)

    def spy_k1(self, requests):
        n = sum(len(j) for _, _, j in requests)
        k1_low[0] += sum(d0 < -(len(t) - 1)
                         for _, _, jobs in requests for t, d0, _ in jobs)
        if n > captured.get("k1", (-1,))[0]:
            captured["k1"] = (n, requests)
        return run_many(self, requests)

    def spy_d1(*a, **kw):
        """D1 as Stage12Device launches it, timed; the largest launch's
        per-pair inputs copied (they are views of reused buffers).  The
        wrapper counts its launches on the name its module binds, so they
        land here and drive() hands them back."""
        if a[3].shape[0] > captured.get("d1", (-1,))[0]:
            captured["d1"] = (a[3].shape[0],
                              list(a[:3]) + [x.clone() for x in a[3:7]], a[7])
        return timed(stage12_pairs)(*a, **kw)

    def spy_k3(strands, jobs, *a):
        n = sum(len(t) * (d1 - d0) for _, t, d0, d1 in jobs)
        if n > captured.get("k3", (-1,))[0]:
            captured["k3"] = (n, (strands, jobs))
        return scores3(strands, jobs, *a, kernel=timed(s3.banded_swipe3))

    def spy_k2(self, queries, tblock, t_order):
        captured["k2"] = (0, (queries, tblock, t_order))
        return dispatch_block(self, queries, tblock, t_order,
                              kernel=timed(sd.full_swipe))

    def drive(route, argv, out, host, stage12=False, patches=()):
        """One CLI run with every count and counter set to 0 just before;
        stage12 puts stage 1/2 on the card (DIAMOND_TPU_TORCH_STAGE12=1);
        patches, (object, name, value) triples, hold for the run."""
        if host:
            os.environ["DIAMOND_TPU_TORCH_DEVICE_DP"] = "0"
        else:  # the default route
            os.environ.pop("DIAMOND_TPU_TORCH_DEVICE_DP", None)
        if stage12:
            os.environ["DIAMOND_TPU_TORCH_STAGE12"] = "1"
        sd.reset_dispatch_stats()
        d1m.reset_dispatch_stats()
        s3.dispatch_count = 0
        k1_low[0] = 0
        host_dp[:] = [0, 0]
        zero_counts()
        plog.prof_calls.clear()
        plog.prof.clear()
        events.clear()
        torch.cuda.reset_peak_memory_stats()
        try:
            with Patched((sd.DeviceDP, "run_many", spy_k1),
                         (sd.DeviceDP, "launch", timed(launch)),
                         (s3, "swipe3_scores", spy_k3),
                         (sd.FullSweep, "dispatch_block", spy_k2),
                         (d1m, "stage12_pairs", spy_d1),
                         *[(mod, "banded_swipe_batch_np", spy_host_dp)
                           for mod in (pext, pwave, pswipe)],
                         (pwave, "_pack_jobs", spy_pack_jobs), *patches):
                t0 = time.perf_counter()
                rc = cli_main(argv + ["-o", out])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            os.environ.pop("DIAMOND_TPU_TORCH_DEVICE_DP", None)
            os.environ.pop("DIAMOND_TPU_TORCH_STAGE12", None)
        stage12_pairs.launches += spy_d1.launches
        spy_d1.launches = 0
        if rc:
            raise RuntimeError(f"{' '.join(argv[:1])} exited {rc}")
        data = open(out, "rb").read()
        busy = sum(a.elapsed_time(b) for a, b in events) / 1e3
        res = dict(
            wall_s=wall, lines=len(data.decode().splitlines()),
            sha=hashlib.sha256(data).hexdigest()[:16],
            launches=launch_counts(),
            device_busy_s=busy, idle_share=1 - busy / wall,
            device_jobs=plog.prof_calls.get("ext.device_jobs", 0),
            device_cells=plog.prof_calls.get("ext.device_cells", 0),
            host_score_cells=plog.prof_calls.get("ext.score_cells", 0),
            host_tb_cells=plog.prof_calls.get("ext.tb_cells", 0),
            k1_low_start_jobs=k1_low[0],
            host_dp_low_start_jobs=host_dp[0], host_dp_jobs=host_dp[1],
            s12_pairs=plog.prof_calls.get("seed.s12_pairs", 0),
            s12_dispatches=d1m.dispatch_count,
            s12_kernel_pairs=d1m.dispatch_pairs,
            s12_wait_s=d1m.dispatch_wait_s,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        phases = sorted(plog.prof.items(), key=lambda kv: -kv[1])[:10]
        print(f"{route}: " + json.dumps(res))
        print(f"{route} host phases (s): "
              + json.dumps({k: round(v, 3) for k, v in phases}))
        res["phases"] = dict(plog.prof)
        return res, data


    def report(route, res, n, what):
        print(f"{route}: {res['lines']} lines, sha {res['sha']}, "
              f"{res['wall_s']:.2f} s, {n / res['wall_s']:.1f} {what}/s on "
              f"{kind} ({name_power}); device busy {res['device_busy_s']:.4f}"
              f" s, idle share {res['idle_share']:.4f}")

    def both(name, argv, n, what, kernel):
        out = {}
        for route in ("card", "host"):
            res, data = drive(f"{name} {route}", argv,
                              os.path.join(tmp, f"{name}_{route}.out"),
                              host=route == "host")
            report(f"{name} {route}", res, n, what)
            out[route] = (res, data)
        card, host = out["card"][0], out["host"][0]
        if out["card"][1] != out["host"][1]:
            raise RuntimeError(f"{name}: card-DP and host-DP outputs differ")
        if card["launches"][kernel] == 0:
            raise RuntimeError(f"{name}: the path never launched {kernel}")
        if any(host["launches"].values()):
            raise RuntimeError(f"{name}: the host route launched a kernel")
        if card["launches"]["d1"]:
            raise RuntimeError(f"{name}: stage 1/2 went to the card unasked")
        print(f"{name}: outputs identical ({card['lines']} lines, sha "
              f"{card['sha']}); {kernel} launches {card['launches'][kernel]}")
        return out

    inside_s12 = [False]

    def s12_span(label, fn):
        """fn, its time added to plog.prof[label] while the stage-1/2
        device route (Pipeline._stage12_device) runs."""
        def wrapper(*a, **kw):
            if not inside_s12[0]:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                plog.prof[label] += time.perf_counter() - t0
        return wrapper

    s12_route = ppipe.Pipeline._stage12_device

    def s12_inside(self, *a, **kw):
        inside_s12[0] = True
        try:
            return s12_route(self, *a, **kw)
        finally:
            inside_s12[0] = False

    # the host steps of the stage-1/2 device route, each timed on its own
    s12_spans = [(ppipe.Pipeline, "_stage12_device", s12_inside)] + [
        (obj, name, s12_span(f"s12.{name}", getattr(obj, name)))
        for obj, name in ((pstages, "expand_pairs"),
                          (Block, "global_to_local"),
                          (pstages, "clip_window"),
                          (ppipe, "left_most_filter_batch"),
                          (ppipe, "_hit_rows"))]

    def low_starts(name, out):
        """The jobs whose band starts below diagonal -(t_len - 1), which
        the native host scorer gets wrong from ~107 band rows up (ROADMAP
        section 3): K1's on the card route, the host DP's on both."""
        c, h = out["card"][0], out["host"][0]
        print(f"{name}: jobs whose band starts below -(t_len - 1): K1 "
              f"{c['k1_low_start_jobs']} of {c['device_jobs']}; host DP "
              f"{c['host_dp_low_start_jobs']} of {c['host_dp_jobs']} (card "
              f"route), {h['host_dp_low_start_jobs']} of {h['host_dp_jobs']}"
              f" (host route)")

    recs = make_proteins(seed=args.seed)
    n_letters = sum(len(s) for _, s in recs)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "db.faa")
        write_fasta(db, recs)
        print(f"synthetic protein set: {len(recs)} sequences, {n_letters} "
              f"letters, seed {args.seed}")

        phase("main path: blastp self-search")
        n_q = min(args.queries, len(recs))
        qf = os.path.join(tmp, "q.faa")
        write_fasta(qf, recs[:n_q])
        if n_q < len(recs):
            print(f"query count cut to {n_q} of {len(recs)} (DB kept whole)")
        out = both("blastp", ["blastp", "-q", qf, "-d", db, "-f", "6"],
                   n_q, "queries", "k1")
        lines = out["card"][1].decode().splitlines()
        selfs = {ln.split("\t")[0] for ln in lines
                 if ln.split("\t")[0] == ln.split("\t")[1]}
        print(f"blastp: self hits {len(selfs)}/{n_q}")
        if len(selfs) != n_q:
            raise RuntimeError("a query did not find itself")
        paths["k1"] = out["card"][0]
        # the third route: stage 1/2 on the card too (D1)
        res, data = drive("blastp card-stage12",
                          ["blastp", "-q", qf, "-d", db, "-f", "6"],
                          os.path.join(tmp, "blastp_s12.out"), host=False,
                          stage12=True, patches=s12_spans)
        report("blastp card-stage12", res, n_q, "queries")
        if data != out["card"][1]:
            raise RuntimeError("blastp: stage 1/2 on the card changed the "
                               "output")
        if res["launches"]["d1"] == 0 or res["launches"]["k1"] == 0:
            raise RuntimeError("blastp card-stage12: D1 or K1 never launched")
        print(f"blastp card-stage12: output identical (sha {res['sha']}); "
              f"D1 launches {res['launches']['d1']}, Stage12Device "
              f"dispatches {res['s12_dispatches']} (one-hot products and "
              f"kernel chunks), pairs through D1 {res['s12_kernel_pairs']}, "
              f"wait {res['s12_wait_s']:.4f} s")
        paths["d1"] = res
        for route, r in (("card", out["card"][0]), ("host", out["host"][0]),
                         ("card-stage12", res)):
            ph = {k: round(r["phases"].get(k, 0.0), 4) for k in (
                "seed.stage12", "seed.s12_native", "seed.s12_expand",
                "seed.s12_card", "seed.s12_leftmost")}
            print(f"blastp {route} stage 1/2 (s, of {r['wall_s']:.2f} s "
                  f"wall): {json.dumps(ph)}; seed.s12_pairs {r['s12_pairs']}")
        print("blastp card-stage12, the device route's host steps (s): "
              + json.dumps({k: round(v, 4) for k, v in res["phases"].items()
                            if k.startswith("s12.")}))
        low_starts("blastp", out)

        phase("blastx --long-reads (3-frame DP, K3)")
        reads = make_reads(recs, args.long_reads, 2000, 8000,
                           indels_per_kb=1.0, seed=args.seed + 10)
        rf = os.path.join(tmp, "long.fna")
        write_fasta(rf, reads)
        print(f"long reads: {len(reads)}, {sum(len(s) for _, s in reads)} nt, "
              f"2-8 kb, ~1 indel/kb, 1% substitutions, half reverse "
              f"complemented")
        out = both("blastx-long-reads", ["blastx", "-q", rf, "-d", db,
                                         "--long-reads", "-f", "6"],
                   len(reads), "reads", "k3")
        hit = source_hits(out["card"][1].decode().splitlines())
        print(f"blastx-long-reads: {len(hit)}/{len(reads)} reads hit their "
              f"source protein")
        if len(hit) < 0.95 * len(reads):
            raise RuntimeError("fewer than 95% of the long reads hit their "
                               "source protein")
        paths["k3"] = out["card"][0]

        phase("blastx six-frame (host DP, as in the reference)")
        reads = make_reads(recs, args.short_reads, 300, 1500,
                           seed=args.seed + 11)
        rf = os.path.join(tmp, "short.fna")
        write_fasta(rf, reads)
        res, data = drive("blastx card", ["blastx", "-q", rf, "-d", db,
                                          "-f", "6"],
                          os.path.join(tmp, "short.out"), host=False)
        report("blastx", res, len(reads), "reads")
        hit = source_hits(data.decode().splitlines())
        print(f"blastx: {len(reads)} reads of 300-1500 nt, {len(hit)} hit "
              f"their source protein; kernel launches {res['launches']}")
        if len(hit) < 0.95 * len(reads):
            raise RuntimeError("fewer than 95% of the reads hit their "
                               "source protein")

        phase("blastp --swipe (full-matrix sweep, K2)")
        n_sw = min(args.swipe_queries, len(recs))
        qf = os.path.join(tmp, "q_swipe.faa")
        write_fasta(qf, recs[:n_sw])
        cells = sum(len(s) for _, s in recs[:n_sw]) * n_letters
        print(f"--swipe: {n_sw} queries x {len(recs)} targets, {cells} cells")
        out = both("blastp-swipe", ["blastp", "-q", qf, "-d", db, "--swipe",
                                    "-f", "6"], n_sw, "queries", "k2")
        paths["k2"] = out["card"][0]
        low_starts("--swipe", out)
        for route in ("card", "host"):  # where the wall goes
            res = out[route][0]
            ph = {k: v for k, v in res["phases"].items()
                  if k.startswith(("swipe.", "cli."))}
            print(f"--swipe {route} route phases (s, of {res['wall_s']:.3f} "
                  f"s wall; swipe.dispatch holds swipe.pack and "
                  f"swipe.h2d_launch): " + json.dumps(ph))

        phase("database commands (makedb, dbinfo; host code)")
        import contextlib
        import io

        dbp = os.path.join(tmp, "db")
        t0 = time.perf_counter()
        rc = cli_main(["makedb", "--in", db, "-d", dbp])
        t_makedb = time.perf_counter() - t0
        info = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(info):
            rc = rc or cli_main(["dbinfo", "-d", dbp + ".dmnd"])
        t_dbinfo = time.perf_counter() - t0
        info = info.getvalue().splitlines()
        print(f"makedb: {len(recs)} sequences, {os.path.getsize(dbp + '.dmnd')}"
              f" bytes in {t_makedb:.2f} s; dbinfo {t_dbinfo:.2f} s: {info}")
        if rc or info[1:] != [f"Sequences = {len(recs)}",
                              f"Letters = {n_letters}"]:
            raise RuntimeError("makedb/dbinfo failed or miscounted")

    phase("SwipeSweep (diagonal-band full-matrix sweep, K5)")
    letters = [encode(s) for _, s in recs]
    queries5 = [(q, None) for q in letters[:args.sweep_queries]]
    cells = sum(len(q) for q, _ in queries5) * n_letters
    ss = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    sd.reset_dispatch_stats()
    zero_counts()
    events.clear()
    t0 = time.perf_counter()
    res5 = ss.run(queries5, letters, kernel=timed(sd.swipe_sweep))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    busy = sum(a.elapsed_time(b) for a, b in events) / 1e3
    paths["k5"] = dict(launches=counts, device_busy_s=busy)
    if counts["k5"] == 0 or counts["k5"] != sd.dispatch_count:
        raise RuntimeError(f"SwipeSweep launched K5 {counts['k5']} times "
                           f"for {sd.dispatch_count} dispatches")
    tb = Block.from_sequences(letters, [i for i, _ in recs])
    S = sd.FullSweep(m.matrix32, m.gap_open, m.gap_extend,
                     device="cuda").run_block(queries5, tb,
                                              np.arange(len(letters)))
    k5_full_mis = int((np.array([[r[0] for r in row] for row in res5])
                       != S).sum())
    chunks5 = ss.chunks(letters)
    print(f"SwipeSweep: {len(queries5)} queries x {len(letters)} targets, "
          f"{cells} cells (q_len x t_len), {sd.dispatch_cells} cells walked, "
          f"{counts['k5']} K5 launches over {len(chunks5)} length classes, "
          f"{wall:.2f} s on {kind} ({name_power}); kernel busy {busy:.4f} s, "
          f"idle share {1 - busy / wall:.4f}; scores vs FullSweep (K2) "
          f"mismatches {k5_full_mis}; launches {counts}")
    if k5_full_mis:
        raise RuntimeError("SwipeSweep (K5) and FullSweep (K2) disagree")

    phase("benchmark (diamond_tpu_torch.cli benchmark)")
    zero_counts()
    events.clear()
    # each wrapper counts its launches on the name its module binds, so the
    # timed stand-ins carry the counts, handed back after the run
    stand_ins = [(mod, name, getattr(mod, name), timed(getattr(mod, name)))
                 for mod, name in ((s3, "banded_swipe3"),
                                   (sud, "banded_swipe_uniform_cuda"),
                                   (s2, "stage2_filter"))]
    for _mod, _name, _fn, w in stand_ins:
        w.launches = 0
    t0 = time.perf_counter()
    with Patched((sd.DeviceDP, "launch", timed(launch)),
                 *[(mod, name, w) for mod, name, _fn, w in stand_ins]):
        rc = cli_main(["benchmark"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for _mod, _name, fn, w in stand_ins:
        fn.launches += w.launches
    counts = launch_counts()
    busy = sum(a.elapsed_time(b) for a, b in events) / 1e3
    paths["bench"] = dict(launches=counts, device_busy_s=busy)
    print(f"benchmark: {wall:.2f} s on {kind} ({name_power}); kernel "
          f"launches {counts}; kernel busy {busy:.4f} s, idle share "
          f"{1 - busy / wall:.4f} (the torch rows' own card work is not in "
          f"the busy time)")
    if rc:
        raise RuntimeError(f"benchmark exited {rc}")
    missing = [k for k in ("k1", "k3", "k4", "k6") if counts[k] == 0]
    if missing:
        raise RuntimeError(f"the benchmark never launched {missing}")

    # -- 8. timing ----------------------------------------------------------
    phase("kernel timing at main-path shapes")
    rows = []

    def time_kernel(name, kern, plain, cells, ops, note, n_bytes, reps,
                    alone=None, unit="cell"):
        """Per call: reps calls of the wrapper launched from Python (the
        column of PRs 1-5); kernel only: reps calls of ``alone`` (the
        wrapper on preallocated outputs, where it takes them) replayed
        from one CUDA graph.  ``cells`` units of work (cells, or D1's
        pairs) at ``ops`` int32 operations each."""
        got, want = kern(), plain()
        if diff(name, got, want):
            raise RuntimeError(f"{name} disagrees with its plain version on "
                               f"the main-path batch")
        kern()
        ms = cuda_ms(kern, reps)
        only_ms = graph_ms(alone or kern, reps)
        plain_ms = cuda_ms(plain, 1)
        bound_ms, bound_by = bound(cells, ops, n_bytes)
        print(f"{name}: {cells} {unit}s, {n_bytes} bytes; {ops:g} int32 ops/"
              f"{unit} ({note}); kernel {ms:.4f} ms per call, {only_ms:.4f} ms "
              f"kernel only (CUDA graph), plain {plain_ms:.2f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library_ms null; {kind}, "
              f"{name_power}")
        return ms, plain_ms, bound_ms, bound_by, only_ms

    # K1 on the largest DeviceDP batch of the blastp run
    p = sd.pack_requests(captured["k1"][1], "cuda")

    def per_class(fn):  # one call per band class, as DeviceDP.launch makes
        return [o for R, lo, hi in p.classes
                for o in fn(p.t_cat, p.q_cat, p.bias_cat, p.jobs[lo:hi],
                            p.reqs, dp._m32, dp.go, dp.ge, R)]

    jobs = p.jobs.cpu().numpy().astype(np.int64)
    reqs_np = p.reqs.cpu().numpy().astype(np.int64)
    cells = int(band_cells(jobs[:, 1], reqs_np[jobs[:, 4], 1], jobs[:, 2],
                           jobs[:, 3]).sum())
    n_bytes = (p.t_cat.numel() + p.q_cat.numel() + p.bias_cat.numel()
               + 4 * (p.jobs.numel() + p.reqs.numel() + 32 * 32)
               + 3 * 4 * p.n_jobs)
    t_len1 = jobs[:, 1]
    pow2 = int((t_len1 * 32 * np.array(
        [1 << (sd.rows_per_lane(int(b)) - 1).bit_length()
         for b in jobs[:, 3]])).sum())
    print(f"K1 batch: {p.n_jobs} jobs in {len(captured['k1'][1])} requests; "
          f"(band class rows, jobs): "
          f"{[(R * 32, hi - lo) for R, lo, hi in p.classes]}; cells walked "
          f"{p.walk_cells} (power-of-two classes would walk {pow2}) for "
          f"{cells} exact band cells")
    rows.append(("k1", time_kernel(
        "k1", lambda: per_class(sd.banded_swipe_multi),
        lambda: per_class(sd.banded_swipe_multi_plain), cells, K1_OPS,
        K1_NOTE, n_bytes, 10)))

    # K3 on the largest 3-frame batch of the --long-reads run (a window of
    # reads), and on that window's largest one-read batch (the shape one
    # launch set had when every read launched on its own)
    strands, jobs3 = captured["k3"][1]

    def k3_batch(strands, jobs3):
        pk = s3.pack_swipe3(strands, jobs3)
        K = np.array([s3.offsets_per_lane(int(b)) for b in pk["jobs"][:, 3]])
        order = np.lexsort((-pk["jobs"][:, 1].astype(np.int64), K))
        x3 = {k: torch.from_numpy(v).cuda() for k, v in pk.items()}
        sel = [(int(k), torch.from_numpy(np.ascontiguousarray(
            pk["jobs"][order][K[order] == k])).cuda()) for k in np.unique(K)]

        def call(fn):
            return [o for k, jb in sel
                    for o in fn(x3["t_cat"], x3["q_cat"], jb, x3["reqs"], m32,
                                go, ge, fs, k)]

        cells = int(swipe3_cells(pk["jobs"], pk["reqs"]).sum())
        n_bytes = (len(pk["t_cat"]) + len(pk["q_cat"]) + 4 * pk["jobs"].size
                   + 4 * pk["reqs"].size + 4 * 32 * 32
                   + 2 * 4 * len(pk["jobs"]))
        return call, cells, n_bytes, [(32 * k, int((K == k).sum()))
                                      for k, _ in sel]

    read_of = np.array([s // 2 for s, _, _, _ in jobs3])
    work = np.array([len(t) * (d1 - d0) for _, t, d0, d1 in jobs3])
    r1 = int(np.argmax(np.bincount(read_of, weights=work)))
    one = [(s - 2 * r1, t, d0, d1) for s, t, d0, d1 in jobs3
           if s // 2 == r1]
    call1, cells1, bytes1, cls1 = k3_batch(strands[2 * r1: 2 * r1 + 2], one)
    print(f"K3 one-read batch: {len(one)} jobs over both strands of one "
          f"read, band classes {cls1}")
    ms1, plain1, bound1, by1, only1 = time_kernel(
        "k3", lambda: call1(s3.banded_swipe3),
        lambda: call1(s3.banded_swipe3_plain), cells1, K3_OPS, K3_NOTE,
        bytes1, 20)
    print(f"K3 one-read batch: kernel {ms1:.4f} ms per call, {only1:.4f} ms "
          f"kernel only, bound {bound1:.5f} ms ({by1}), {ms1 / bound1:.1f}x; "
          f"{kind}, {name_power}")
    call3, cells3, bytes3, cls3 = k3_batch(strands, jobs3)
    print(f"K3 batch: {len(jobs3)} jobs of {len(strands) // 2} reads (the "
          f"largest window), band classes {cls3}; the long-reads run: "
          f"{paths['k3']['launches']['k3']} K3 launches, "
          f"{paths['k3']['device_busy_s']:.4f} s of card time")
    rows.append(("k3", time_kernel(
        "k3", lambda: call3(s3.banded_swipe3),
        lambda: call3(s3.banded_swipe3_plain), cells3, K3_OPS, K3_NOTE,
        bytes3, 10)))

    # K2 on the largest launch of the --swipe run
    queries, tblock, t_order = captured["k2"][1]
    blk = sweep.pack(queries, tblock, t_order)
    L = max(blk.launches, key=lambda L_: L_.cells)
    x2 = {k: torch.from_numpy(getattr(blk, k)).cuda()
          for k in ("t_cat", "targets", "q_cat", "bias_cat")}
    r2, p2 = (torch.from_numpy(a).cuda() for a in (L.reqs, L.pairs))
    scratch = torch.empty((L.slots, 2, len(blk.t_cat), 2), dtype=torch.int32,
                          device="cuda")

    o2 = torch.zeros((blk.n_queries, blk.n_targets), dtype=torch.int32,
                     device="cuda")

    def k2_call(fn, o=None):
        if o is None:
            o = torch.zeros((blk.n_queries, blk.n_targets),
                            dtype=torch.int32, device="cuda")
        return [fn(x2["t_cat"], x2["targets"], x2["q_cat"], x2["bias_cat"],
                   r2, p2, m32, go, ge, L.R, scratch, o)]

    n_bytes = (len(blk.t_cat) + 4 * blk.targets.size + len(blk.q_cat)
               + len(blk.bias_cat) + 4 * (L.reqs.size + L.pairs.size + 32 * 32)
               + 4 * len(L.pairs))
    print(f"K2 batch: {len(L.pairs)} pairs, {L.R} rows per lane, "
          f"{L.slots} multi-strip queries, of {len(blk.launches)} launches")
    rows.append(("k2", time_kernel(
        "k2", lambda: k2_call(sd.full_swipe),
        lambda: k2_call(sd.full_swipe_plain), L.cells, K2_OPS, K2_NOTE,
        n_bytes, 3, alone=lambda: k2_call(sd.full_swipe, o2))))
    # K2 over the whole --swipe path: busy time of its launches in the run
    # (CUDA events around each), and all of them replayed from one graph
    per2 = [(L_, *(torch.from_numpy(a).cuda() for a in (L_.reqs, L_.pairs)),
             torch.empty((L_.slots, 2, len(blk.t_cat), 2), dtype=torch.int32,
                         device="cuda")) for L_ in blk.launches]

    def k2_path():
        for L_, r_, p_, sc_ in per2:
            sd.full_swipe(x2["t_cat"], x2["targets"], x2["q_cat"],
                          x2["bias_cat"], r_, p_, m32, go, ge, L_.R, sc_, o2)

    path_cells = sum(L_.cells for L_ in blk.launches)
    path_bound, _ = bound(path_cells, K2_OPS, 0)
    path_pre, _ = bound(path_cells, K2_PRE_DPX_OPS, 0)
    busy_ms = paths["k2"]["device_busy_s"] * 1e3
    path_only = graph_ms(k2_path, 2)
    big_only = rows[-1][1][4]
    big_pre, _ = bound(L.cells, K2_PRE_DPX_OPS, 0)
    print(f"K2 before DPX ({K2_PRE_DPX_OPS} int32 ops/cell: "
          f"{K2_PRE_DPX_NOTE}): largest launch bound {big_pre:.4f} ms, "
          f"kernel only {big_only / big_pre:.2f}x")
    print(f"K2 over the --swipe path: {len(blk.launches)} launches, "
          f"{path_cells} cells, bound {path_bound:.4f} ms at {K2_OPS} "
          f"ops/cell, {path_pre:.4f} ms at {K2_PRE_DPX_OPS} (before "
          f"DPX); "
          f"busy in the run {busy_ms:.4f} ms ({busy_ms / path_bound:.2f}x, "
          f"{busy_ms / path_pre:.2f}x), kernel only {path_only:.4f} ms "
          f"({path_only / path_bound:.2f}x, {path_only / path_pre:.2f}x); "
          f"{kind}, {name_power}")

    # K4 on the benchmark's first row (benchmark.py's seed and sizes)
    rng4 = np.random.default_rng(0)
    q4 = rng4.integers(0, 20, BENCH["qlen"]).astype(np.int8)
    band4 = BENCH["band"]
    jobs4 = [(rng4.integers(0, 20, BENCH["T"]).astype(np.int8), -band4 // 2,
              band4 // 2) for _ in range(BENCH["B"])]
    pk4, _ = sud.pack_uniform_batch(q4, None, m.matrix32, jobs4)
    x4 = {k: torch.from_numpy(v).cuda() for k, v in pk4.items()}
    cells = int(band_cells(np.array([len(t) for t, _, _ in jobs4]),
                           np.full(len(jobs4), len(q4)),
                           np.array([d0 for _, d0, _ in jobs4]),
                           np.array([d1 - d0 for _, d0, d1 in jobs4])).sum())
    n_bytes = sum(v.nbytes for v in pk4.values()) + 3 * 4 * len(jobs4)
    print(f"K4 batch: {len(jobs4)} targets of {BENCH['T']} x query of "
          f"{len(q4)}, band {band4}, shape {sud.uniform_shape(band4)} (the "
          f"benchmark's first row)")
    rows.append(("k4", time_kernel(
        "k4", lambda: sud.banded_swipe_uniform_cuda(
            x4["t_idx"], x4["band_mask"], x4["prof_t"], go, ge),
        lambda: sud.banded_swipe_uniform_cuda_plain(
            x4["t_idx"], x4["band_mask"], x4["prof_t"], go, ge),
        cells, K45_OPS, K45_NOTE, n_bytes, 20)))

    # K4 on the benchmark's full-matrix row (64 targets of 256 x the query,
    # band 1,024: the CTA path)
    t4 = BENCH["T_full"]
    jobs4f = [(rng4.integers(0, 20, t4).astype(np.int8), -(t4 - 1), len(q4))
              for _ in range(BENCH["n_full"])]
    pk4f, meta4f = sud.pack_uniform_batch(q4, None, m.matrix32, jobs4f)
    x4f = {k: torch.from_numpy(v).cuda() for k, v in pk4f.items()}
    print(f"K4 batch: {len(jobs4f)} targets of {t4} x query of {len(q4)}, "
          f"band {meta4f['band']}, shape {sud.uniform_shape(meta4f['band'])} "
          f"(the benchmark's full-matrix row)")
    k4_full = time_kernel(
        "k4", lambda: sud.banded_swipe_uniform_cuda(
            x4f["t_idx"], x4f["band_mask"], x4f["prof_t"], go, ge),
        lambda: sud.banded_swipe_uniform_cuda_plain(
            x4f["t_idx"], x4f["band_mask"], x4f["prof_t"], go, ge),
        len(q4) * t4 * len(jobs4f), K45_OPS, K45_NOTE,
        sum(v.nbytes for v in pk4f.values()) + 3 * 4 * len(jobs4f), 20)
    print(f"K4 full-matrix row: kernel {k4_full[0]:.4f} ms per call, "
          f"{k4_full[4]:.4f} ms kernel only, bound "
          f"{k4_full[2]:.5f} ms ({k4_full[3]}), {k4_full[0] / k4_full[2]:.1f}x; "
          f"{kind}, {name_power}")

    # K5 on the largest launch of the SwipeSweep run
    launches5 = [(len(q), L) for q, _ in queries5
                 for L in ss.query_launches(q, None, chunks5)]
    qlen5, (ch, band5, bl5, prof5) = max(
        launches5, key=lambda x: len(x[1][0].rows) * x[1][0].T * x[0])
    cells = qlen5 * int(ch.tl.sum())
    walked = sd.sweep_walk_cells(ch.T, ch.C, qlen5, ch.tl + qlen5 - 1)
    n_bytes = (ch.t_idx.numel() + 4 * bl5.numel() + 4 * 32 * qlen5
               + 3 * 4 * len(ch.rows))
    print(f"K5 batch: {len(ch.rows)} targets of up to {ch.T} letters x query "
          f"of {qlen5}, band {band5}: {walked} cells walked (query rows x "
          f"columns; the diagonal band would walk "
          f"{len(ch.rows) * ch.T * band5}) for {cells} matrix cells, of "
          f"{len(launches5)} launches")
    rows.append(("k5", time_kernel(
        "k5", lambda: sd.swipe_sweep(ch.t_idx, bl5, prof5, go, ge, ch.C,
                                     qlen5),
        lambda: sd.swipe_sweep_plain(ch.t_idx, bl5, prof5, go, ge),
        cells, K45_OPS, K45_NOTE, n_bytes, 10)))

    # K6 at the benchmark's stage-2 row: 131,072 pairs x 96 window letters
    meta6 = np.zeros((3, n6), np.int32)
    meta6[0], meta6[1], meta6[2] = 40, 40, 20
    x6[2] = torch.from_numpy(meta6).cuda()
    n_bytes = 2 * w6 * n6 + 4 * meta6.size + 4 * 32 * 32 + (1 + 4 + 4) * n6
    print(f"K6 batch: {n6} pairs x {w6} window letters (the benchmark's row)")
    rows.append(("k6", time_kernel(
        "k6", lambda: s2.stage2_filter(*x6, m2, 26, w6 // 2),
        lambda: s2.stage2_filter_plain(*x6, m2, 26, w6 // 2),
        n6 * w6, K6_OPS, K6_NOTE, n_bytes, 20)))
    for write in (True, False):
        k6_cold = cold_ms(lambda: s2.stage2_filter(*x6, m2, 26, w6 // 2), 20,
                          write)
        print(f"K6 cold (the L2 flushed before each launch by "
              f"{'writing' if write else 'reading'} {COLD_BYTES >> 20} MB, "
              f"median of 20): {k6_cold:.4f} ms, "
              f"{k6_cold / rows[-1][1][2]:.2f}x the bytes bound; warm kernel "
              f"only {rows[-1][1][4]:.4f} ms; {kind}, {name_power}")

    # D1 on the largest launch of the stage-1/2 blastp run
    n_d1, xd, hid = captured["d1"]
    ops_d1 = d1_ops(xd[0], xd[1], xd[3], xd[4], xd[5])
    blocks = xd[0].numel() + (0 if xd[1] is xd[0] else xd[1].numel())
    n_bytes = 16 * n_d1 + blocks + 4 * 32 * 32 + (1 + 4) * n_d1
    out_d1 = (torch.empty(n_d1, dtype=torch.uint8, device="cuda"),
              torch.empty(n_d1, dtype=torch.int32, device="cuda"))
    print(f"D1 batch: {n_d1} pairs (the largest of the stage-1/2 blastp run's "
          f"{paths['d1']['launches']['d1']} launches), {ops_d1} int32 ops "
          f"({ops_d1 / n_d1:.1f} a pair: {D1_NOTE}), {n_bytes} bytes (16 in "
          f"and 5 out a pair, the letter blocks once)")
    rows.append(("d1", time_kernel(
        "d1", lambda: d1m.stage12_pairs(*xd, hid, checked=True),
        lambda: d1m.stage12_pairs_torch(*xd, hid), n_d1, ops_d1 / n_d1,
        "the mean of this batch's walks", n_bytes, 20,
        alone=lambda: d1m.stage12_pairs(*xd, hid, checked=True, out=out_d1),
        unit="pair")))

    meta = {
        "k1": ("banded_swipe_multi", "diamond_tpu_torch/csrc/banded_swipe.cu",
               "diamond_tpu/ops/swipe_device.py:231 (banded_swipe_pallas_multi)",
               "k1"),
        "k3": ("banded_swipe3", "diamond_tpu_torch/csrc/swipe3.cu",
               "diamond_tpu/ops/swipe3_pallas.py:123 (banded_swipe3_pallas)",
               "k3"),
        "k2": ("full_swipe", "diamond_tpu_torch/csrc/full_swipe.cu",
               "diamond_tpu/ops/swipe_device.py:789 (full_swipe_pallas_sweep)",
               "k2"),
        "k4": ("banded_swipe_uniform_cuda",
               "diamond_tpu_torch/csrc/uniform_swipe.cu",
               "diamond_tpu/ops/swipe_pallas.py:114 (banded_swipe_pallas)",
               "bench"),
        "k5": ("swipe_sweep", "diamond_tpu_torch/csrc/swipe_sweep.cu",
               "diamond_tpu/ops/swipe_device.py:582 (banded_swipe_pallas_sweep)",
               "k5"),
        "k6": ("stage2_filter", "diamond_tpu_torch/csrc/stage2.cu",
               "diamond_tpu/ops/stage2_pallas.py:85 (stage2_pallas)", "bench"),
        "d1": ("stage12_pairs", "diamond_tpu_torch/csrc/stage12.cu",
               "diamond_tpu/ops/stage12_jax.py:35 (_stage12_kernel)", "d1"),
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": meta[k][0],
        "route": "cuda",
        "source": meta[k][1],
        "replaces": meta[k][2],
        "launches": paths[meta[k][3]]["launches"][k],
        "max_abs_err": max_err[k],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "kernel_only_ms": only_ms,
    } for k, (ms, plain_ms, bound_ms, bound_by, only_ms) in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
