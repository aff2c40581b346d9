#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diamond_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--queries N] [--long-reads N] [--short-reads N]
                          [--swipe-queries N] [--sweep-queries N]
                          [--blocked-queries N] [--dmnd-queries N]
                          [--mp-queries N] [--iterate-queries N]
                          [--global-queries N] [--cluster-seqs N]
                          [--linclust-seqs N] [--deepclust-seqs N]
                          [--mcl-small N] [--blastn-reads N]
                          [--coord-queries N] [--seed S] [--mask-only]
                          [--enum-only]

Phases; each one fails the run on error:
  1. device: the card's name, count, power limit (needs CUDA);
  2. build: the port's CUDA kernels (banded_swipe.cu, swipe3.cu,
     full_swipe.cu, uniform_swipe.cu, swipe_sweep.cu, stage2.cu,
     stage12.cu, stage12_join.cu, banded_traceback.cu, tantan.cu,
     seed_enum.cu; one
     nvcc per source, all at once, for sm_90a; registers
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
     warp per target for bands up to 512; the wide-band walk above, also on
     its edges, UNIFORM_EDGES: dead rows, rows leaving and entering the
     band, several strips, pad columns that score, ties, best 0, B = 1,
     bands 513-8192), and on 3,000 full-matrix jobs in one call against
     the host DP; the
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
     high bits, hamming_id 0 to 49); D1's whole fused pass
     (stage12_join: stage 1, self-hit, left-most, stage 2, the rows) on
     seeded joins (STAGE12_FUSED_EDGES: self-search on and off, a chunked
     index with and without the part table, group_keep, the first shape
     and later ones, translated short-query windows, skip_lm, seeds beside
     delimiters), whole and in chunks of 3,000 pairs, against its plain
     version and the native host pass, row for row; the traceback
     refill (D4) on seeded jobs (tb_jobs: every band class edge, bias on
     and off, gap runs, one beside the first target column and one beside
     the first query row, d0 < 0, targets cut short, score-0 jobs, jobs
     starting below diagonal -(t_len - 1)), whole and in 64 KB plane
     slices, against its plain version, its planes read
     from its scratch against the plain fill's, and through
     tb_multi_device against the native host call and, for the jobs
     starting low, the numpy oracle;
  4. blastp: a default ``blastp -f 6`` self-search of a seeded synthetic
     protein set the size of nr_10k (10,000 sequences, ~4 M letters), on
     the card, on the host, and a third time with stage 1/2 on the card
     (DIAMOND_TPU_TORCH_STAGE12=1: the fused pass stage12_join must
     launch, the pair kernel not, and the output equal the other two);
     ``seed.stage12`` and its spans (upload, card, rows back) printed per
     route; the traceback round: D4 must launch on the card route and
     refill every job within its band cap there (ext.tb_multi,
     ext.tb_card and its jobs and cells, K1's ext.device_dp, the host
     route's ext.score_multi, failed walks on both routes, D4's jobs
     starting below -(t_len - 1), peak card memory); tantan_mask must
     launch twice on both routes (the DB block and the query block: the
     masking runs on the card whatever the DP route);
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
  8. the search drivers and the clustering commands, each on the card
     route and on the host route (equal outputs; K1 launched on the card
     route, no DP kernel on the host route), each Pipeline's sensitivity, queries,
     K1 jobs and seconds printed: ``blastp -b`` of the whole set against
     itself at 1/4.5 of its letters a block (5 x 5 blocks; the card's peak
     memory; whether it equals the unblocked output), the same from a
     .dmnd at 2,000 queries (DmndProvider streaming); ``--multiprocessing``
     at 2,000 queries: ``--mp-init``, then two worker processes at once
     (``chip_smoke.py --cli-worker``) on each route, equal to one process;
     ``--iterate --no-self-hits`` at 1,000 queries against the whole set;
     ``-g 10`` at 1,000 (no K1: its extension is host DP, as in the
     reference; the query-indexed route: the seed kernel must launch once
     a shape on both routes); ``cluster`` of 800, ``realign`` of its output and
     ``linclust`` of 40 (host code, once); ``deepclust`` of 400 (these
     sizes keep the run within half its time limit: at 10,000 the
     cascades' linearised rounds take minutes of host code a route);
     ``cluster --cluster-algo
     mcl`` of a seeded set with families of 130-220 members (MCL_FAMILIES),
     whose dense step (D3, torch ops) must run on the card on both routes;
  9. SwipeSweep: the first 4 proteins against the whole set through K5,
     scores held against K2's FullSweep on the same pairs;
 10. benchmark: ``diamond_tpu_torch.cli benchmark`` (its table printed);
     K1, K3, K4 and K6 must have launched;
     paths 4-10 report the card's kernel busy time (CUDA events around every
     launch) and its idle share;
 11. timing: each kernel, its plain version and the bound on the largest
     batch of its path (CUDA events): per call (the wrapper launched from
     Python) and kernel only (the launches replayed from a CUDA graph);
     K1 with its band classes and the cells it walks against the exact
     band cells; K3 also on the largest one-read batch of the long-reads
     run; K4 on the benchmark's first row (band 128, its warp path), its
     wide-band walk on the largest launch of the --swipe --mesh 1 run
     (``k4w``) and on the benchmark's full-matrix row (band 1,024), both
     against their bound at 8 int32 ops a cell (DPX counted) and at 11; K2
     also over the whole --swipe path, against its bound at 7
     int32 ops a cell (DPX counted) and at the 11 before DPX; K6 also cold
     (the L2 flushed before each launch by writing 256 MB, and by reading
     them); D1's fused pass on the largest call of the stage-1/2 blastp
     run (kernel only: its two kernels and the scan between them; the
     bound from the operations the function needs, D1J_OPS), the pair
     kernel, which no search path launches, on that call's pairs; D4 on
     blastp's largest traceback call (per call, kernel only: its
     launches, the scan and the compaction; against its plain version
     and the native host call; the bound from D4_OPS a cell and
     D4_WALK_OPS a walk op, the planes written and read); tantan's scan
     at the benchmark's block (mask_entry: against the native host scan
     and its plain version, bit for bit; per call, kernel only, the card
     route of _mask_block and the native scan, against the larger of
     MASK_OPS a letter and state over the fp32 rate and the longest
     sequence's chain of MASK_CHAIN_OPS dependent ops a letter); the
     DB-side seed enumeration at the benchmark's block (enum_entry: both
     default shapes, the keys of 20 and of 1,000 proteins, against the
     native fused pass and its plain version, key for key and position
     for position; per call, kernel only, the card route and the native
     pass, against the larger of SEED_ENUM_OPS int32 ops a window over
     the int32 rate and the bytes; its launches the -g run's); D3 on
     the MCL run's matrices against the same torch ops on the CPU and the
     numpy loop (equal cluster assignments), timed on the largest against
     2 m^3 (expansion - 1) flops an iteration over the fp32 rate.
 12. the last modules (after path 8's, before 9): ``blastp --masking
     seg`` and ``blastp --custom-matrix`` (the 20 x 20 golden file, gap
     penalties 11/1; the ALP run timed, in an empty TMPDIR of its own) as
     self-searches on both routes (equal shas, K1 on the card route);
     ``makeidx`` (timed) then ``--target-indexed`` on both routes (the
     self-search's sha); the tool commands on the protein set (wall and
     sha each; ``test`` must launch K1, ``info`` name the card); ``blastn``
     of seeded reads of 500-3000 nt from both strands of 10 random 100 kb
     sequences (host DP; >= 95 % on their source and strand);
     ``blastp --mesh 1`` (the self-search's sha through the sharded
     DeviceDP) and ``blastp --swipe --mesh 1`` with the device DP off (the
     --swipe path's sha, K4 launched; its launches by path, warp and wide,
     its time a launch, each launch alone by class (band, columns, rows a
     lane, strips), and the wall split into packing, upload, K4 with the
     sync on its outputs, the host DP of bands above 8,192 and the rest);
     ``--coordinator``
     runs of ``blastp --mesh N`` at 2,000 queries, one rank (NCCL) and two
     ranks sharing the card (Gloo), each rank's output equal to one
     process's, and ``parallel.dist_worker`` with two ranks on the card;
``--mask-only`` runs phase 1, builds tantan.cu and runs mask_entry alone;
``--enum-only`` runs phase 1, builds seed_enum.cu and runs enum_entry alone.
The last two lines of standard output are the kernel summary and
{"ok": true, "device": {...}}.  Imports nothing of JAX or diamond_tpu.
"""
from __future__ import annotations

import argparse
import collections
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
# K4's wide-band walk as Hopper issues it: K2's DPX count plus the valid
# select; K45_OPS, the count before DPX, is printed beside it
K4W_OPS = 8
K4W_NOTE = ("H+s with max E and max 0 (one __viaddmax_s32_relu), cur0-go, "
            "F-ge with max for F (one), max F into H, valid select, H-go, "
            "E-ge with max for E (one), best max")
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
# D1's fused pass, the bound's count: the arithmetic the function needs, as
# this call's data makes the work, whatever the kernel's layout (no entry
# search, no realignment of words, no address arithmetic; a table lookup is
# a load, not an operation; 4 letters compared in one int32 op): a pair, an
# entry (one query occurrence of a group: its query side, once), a pair
# past stage 1, a pair at the left-most filter (its window of <= 49
# letters), a Kadane step, a row
D1J_OPS = dict(pairs=50, entries=151, s1=1, at_leftmost=185, kadane_steps=6,
               rows=0)
D1J_NOTE = ("a pair 50: stage 1's 12 target words x 4 (mask, __vcmpeq4 "
            "against the query's masked word, __popc, add), the threshold, "
            "the rows' prefix; an entry 151: its offset, its 12 query words "
            "masked, the two clips (24 words x 1 packed delimiter compare, "
            "the nearest delimiter each side 4), the left-most geometry 12, "
            "49 window letters x 2 (the is-aa select of the reduced letter, "
            "the seed-mask bit); a pair past stage 1 1 (self-hit); a pair at "
            "the left-most filter 185: 49 window letters x 2 (the reduced "
            "compare, its match bit), its delimiters 15 (13 words, the "
            "nearest each side), the matchers and the rest 72; a Kadane step "
            "6 (as D1's); a row 0 (its writes are bytes)")
# the same work as csrc/stage12_join.cu issues it (printed beside the
# bound, not used for it)
D1J_ISSUED_OPS = dict(pairs=81, entries=933, s1=2, at_leftmost=566,
                      kadane_steps=6, rows=64)
D1J_ISSUED_NOTE = (
    "a pair 81: its entry's binary search over <= 256 in shared memory (8 "
    "steps x 2), its target index 2, the target's 12 fingerprint words x 2 "
    "(funnel shift, mask), 12 x 3 (__vcmpeq4, __popc, add), shift and "
    "compare, the score byte; an entry 933: 5 for its tables, 12 query "
    "words x 2, two clips of 13 words (funnel shift, and 8 a word for the "
    "delimiter bits: __vcmpeq4, 5 to take the bits, shift, or) and 3, the "
    "left-most query side 664 (geometry 12, 26 words realigned, the "
    "seed-mask bits 106, 52 reduced letters x 10); a pair past stage 1 2 "
    "(self-hit); a pair at the left-most filter 566 (13 target words "
    "realigned, their delimiter bits 104, the match bits 13 x 29, the "
    "matchers and the rest 72); a Kadane step 6; a row 64")


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
            s = _member(rng, s, rng.uniform(0.40, 0.95), draw)
        seqs.append((f"syn{k:05d}_fam{fam:04d}", s.tobytes().decode()))
    perm = rng.permutation(n_seqs)
    return [seqs[i] for i in perm]


def _member(rng, root, ident, draw):
    """A family member: the root at identity ``ident`` with a few short
    indels."""
    s = root.copy()
    sub = rng.random(len(s)) > ident
    s[sub] = draw(int(sub.sum()))
    for _ in range(int(rng.poisson(2))):
        pos = int(rng.integers(len(s)))
        ln = int(rng.integers(1, 6))
        if rng.random() < 0.5:
            s = np.concatenate([s[:pos], draw(ln), s[pos:]])
        elif len(s) - ln >= 30:
            s = np.concatenate([s[:pos], s[pos + ln:]])
    return s


def make_families(sizes, n_small: int, seed: int = 0):
    """Seeded protein families of the given member counts plus ``n_small``
    sequences in families of 1-6: roots of 120-260 letters from the
    BLOSUM62 background frequencies, every member at 80-97 % identity to its
    root with a few short indels, so that a family of 128 members or more
    forms one MCL component of that size.  Returns [(id, sequence)] in
    shuffled order."""
    from diamond_tpu_torch.constants._matrix_data import MATRICES

    rng = np.random.default_rng(seed)
    bg = np.asarray(MATRICES["BLOSUM62"]["background_freqs"], np.float64)
    bg /= bg.sum()
    letters = np.frombuffer(AA.encode(), np.uint8)

    def draw(n):
        return letters[rng.choice(20, size=n, p=bg)]

    sizes = list(sizes)
    small = 0
    while small < n_small:
        sizes.append(min(int(rng.integers(1, 7)), n_small - small))
        small += sizes[-1]
    seqs = []
    for fam, size in enumerate(sizes):
        root = draw(int(rng.integers(120, 261)))
        for k in range(size):
            s = _member(rng, root, rng.uniform(0.80, 0.97), draw)
            seqs.append((f"mcl{len(seqs):05d}_fam{fam:04d}",
                         s.tobytes().decode()))
    perm = rng.permutation(len(seqs))
    return [seqs[i] for i in perm]


def mcl_graph(seed: int, sizes):
    """Seeded MCL input: edges (i, j, similarity) of components of the
    given node counts, each made of families of 8-40 nodes joined strongly
    inside (55-99, self loops 100) and by one weak edge (1-19) to the next
    family.  Returns (node count, edges)."""
    rng = np.random.default_rng(seed)
    edges, base = [], 0
    for size in sizes:
        fam, k = [], 0
        while k < size:
            f = min(int(rng.integers(8, 41)), size - k)
            fam.append(range(base + k, base + k + f))
            k += f
        for f in fam:
            for i in f:
                edges.append((i, i, 100.0))
                for j in f:
                    if i < j and rng.random() < 0.6:
                        w = float(rng.integers(55, 100))
                        edges += [(i, j, w), (j, i, w)]
        for a, b in zip(fam, fam[1:]):
            i, j = int(rng.choice(a)), int(rng.choice(b))
            w = float(rng.integers(1, 20))
            edges += [(i, j, w), (j, i, w)]
        base += size
    return base, edges


def mcl_matrix(n: int, edges):
    """The column-stochastic matrix mcl_cluster builds for one component
    (symmetric edges, self loops of at least 1)."""
    M = np.zeros((n, n), dtype=np.float32)
    for i, j, w in edges:
        M[j, i] = max(M[j, i], w)
        M[i, j] = max(M[i, j], w)
    np.fill_diagonal(M, np.maximum(M.diagonal(), 1.0))
    M /= np.maximum(M.sum(axis=0, keepdims=True), 1e-30)
    return M


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


def make_dna(n_refs: int, ref_len: int, n_reads: int, min_len: int,
             max_len: int, subst: tuple = (0.03, 0.03),
             indels_per_kb: float = 0.0, seed: int = 0):
    """A seeded nucleotide set for blastn: n_refs random sequences of
    ref_len nt and n_reads reads, each a window of [min_len, max_len] nt of
    a random reference with a substitution rate drawn from ``subst`` (low,
    high) and ``indels_per_kb`` single-nucleotide insertions or deletions
    per kb, every other read reverse complemented.  Returns (refs, reads)
    as [(name, dna)]; a read's name is ``read<k>_<plus|minus>_<ref name>``."""
    rng = np.random.default_rng(seed)
    refs = [(f"ref{k}", "".join(np.array(list("ACGT"))[
        rng.integers(0, 4, ref_len)])) for k in range(n_refs)]
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(n_reads):
        name, ref = refs[int(rng.integers(n_refs))]
        L = int(rng.integers(min_len, max_len + 1))
        a = int(rng.integers(len(ref) - L + 1))
        dna = list(ref[a:a + L])
        rate = float(rng.uniform(*subst))
        for p in np.flatnonzero(rng.random(len(dna)) < rate):
            dna[p] = "ACGT"[int(rng.integers(4))]
        for _ in range(int(rng.poisson(indels_per_kb * len(dna) / 1000))):
            p = int(rng.integers(len(dna)))
            if rng.random() < 0.5:
                dna.insert(p, "ACGT"[int(rng.integers(4))])
            else:
                del dna[p]
        dna = "".join(dna)
        strand = "minus" if r % 2 else "plus"
        if r % 2:
            dna = dna.translate(comp)[::-1]
        reads.append((f"read{r:04d}_{strand}_{name}", dna))
    return refs, reads


def dna_source_hits(lines):
    """Reads whose hit lines include their source reference on the right
    strand (blastn -f 6: a minus-strand hit prints sstart > send)."""
    out = set()
    for ln in lines:
        f = ln.split("\t")
        _, strand, src = f[0].split("_", 2)
        minus = int(f[8]) > int(f[9])
        if f[1] == src and minus == (strand == "minus"):
            out.add(f[0])
    return out


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


TB_BANDS = (1, 31, 32, 33, 64, 97, 128, 129, 200, 257, 300, 385, 449, 512)


def _mutate(rng, seg, sub: float, indel: float):
    """seg with substitutions and short insertions and deletions."""
    out = []
    for a in seg:
        x = rng.random()
        if x < indel / 2:
            continue                                   # a deletion
        out.append(a if rng.random() >= sub else rng.integers(0, 20))
        if x > 1 - indel / 2:
            out.extend(rng.integers(0, 20, int(rng.integers(1, 6))))
    return np.array(out, dtype=np.int8)


def tb_jobs(seed: int, n_queries: int = 6, bands=TB_BANDS,
            max_len: int = 400, low_start: bool = True):
    """Seeded traceback jobs as ``tb_multi_results`` takes them (a dict of
    its flat arrays: q_base, bias_base, q_off, q_len, use_bias, t_cat,
    t_off, t_len, d_begins, bands).  Each query's targets hold mutated
    copies of a query segment (substitutions and indels, so the walk takes
    gap runs), on a diagonal of the band; bias on every other query; every
    band of ``bands`` over the queries; d0 < 0; a band that covers the
    whole target; targets cut short (1-5 letters); jobs with no cell in the
    query (score 0); letters with the seed-mask bit (-128) set; two jobs
    whose best alignment starts with a gap run beside the first target
    column and the first query row (a strong match there, its bias +10);
    with ``low_start`` also jobs whose band starts below diagonal
    -(t_len - 1), marked in ``low``."""
    rng = np.random.default_rng(seed)
    qs, jobs = [], []
    for qi in range(n_queries):
        ql = int(rng.integers(20, max_len))
        q = rng.integers(0, 20, ql).astype(np.int8)
        q[rng.random(ql) < 0.03] |= -128
        qs.append(q)
        for k in range(len(bands) // 2 + 2):
            band = int(bands[(k + qi * (len(bands) // 2)) % len(bands)])
            a = int(rng.integers(0, ql))
            seg = _mutate(rng, q[a:a + int(rng.integers(5, 200))],
                          0.25, 0.08 if k % 2 else 0.0)
            pre = rng.integers(0, 20, int(rng.integers(0, 60))).astype(np.int8)
            post = rng.integers(0, 20, int(rng.integers(0, 60))).astype(np.int8)
            t = np.concatenate([pre, seg, post]).astype(np.int8)
            if not len(t):
                t = rng.integers(0, 20, 3).astype(np.int8)
            t[rng.random(len(t)) < 0.02] |= -128
            diag = a - len(pre)
            d0 = diag - int(rng.integers(0, band))
            if not low_start or k % 4:
                d0 = max(d0, -(len(t) - 1))
            jobs.append((qi, t, d0, band))
        t = q[:int(rng.integers(1, 6))].copy()
        jobs.append((qi, t, -2, 33))                     # a target cut short
        t = rng.integers(0, 20, 80).astype(np.int8)
        t[10:30] = q[:20]
        if ql + 79 <= 512:
            jobs.append((qi, t, -79, ql + 79))           # the whole target
        jobs.append((qi, t[:9], ql + 3, 32))             # no query cell
        jobs.append((qi, t[:9], -40, 20))                # no query cell
    # W (17) against W, then two P (14) in the target (a D run) or three
    # G (7) in the query (an I run), then 20 matching letters
    w, g3 = np.array([17], np.int8), np.full(3, 7, np.int8)
    tail = rng.integers(0, 20, 20).astype(np.int8)
    edge = len(qs)
    qs += [np.concatenate([w, tail]), np.concatenate([w, g3, tail])]
    jobs.append((edge, np.concatenate([w, np.full(2, 14, np.int8), tail]),
                 -5, 9))
    jobs.append((edge + 1, np.concatenate([w, tail]), -2, 9))
    q_len = np.array([len(q) for q in qs], np.int64)
    q_start = np.concatenate([[0], np.cumsum(q_len)[:-1]])
    q_base = np.concatenate(qs)
    bias = rng.integers(-4, 5, len(q_base)).astype(np.int32)
    bias[q_start[edge:]] = 10
    t_len = np.array([len(t) for _, t, _, _ in jobs], np.int64)
    qid = np.array([j[0] for j in jobs])
    d0 = np.array([j[2] for j in jobs], np.int64)
    return dict(q_base=q_base, bias_base=bias, q_off=q_start[qid],
                q_len=q_len[qid],
                use_bias=((qid % 2 == 1) | (qid >= edge)).astype(np.uint8),
                t_cat=np.concatenate([t for _, t, _, _ in jobs]),
                t_off=np.concatenate([[0], np.cumsum(t_len)[:-1]]),
                t_len=t_len, d_begins=d0,
                bands=np.array([j[3] for j in jobs], np.int64),
                low=d0 < -(t_len - 1))


TB_KEYS = ("q_base", "bias_base", "q_off", "q_len", "use_bias", "t_cat",
           "t_off", "t_len", "d_begins", "bands")


def tb_select(c: dict, sel) -> dict:
    """The jobs ``sel`` (a mask or indices) of a tb_jobs dict, letters
    shared."""
    out = {k: c[k] for k in ("q_base", "bias_base", "t_cat")}
    for k in set(c) - set(out):
        out[k] = c[k][sel]
    return out


D4_OPS = 16
D4_NOTE = ("K1's 12 a cell (" + K1_NOTE + ") and the 4 plane compares "
           "(cur == F, cur == E, the two open compares)")
D4_WALK_OPS = 10
D4_WALK_NOTE = ("a walk step: the band row (2), the plane bit (2), the "
                "matrix index and the score with its bias (3), the letter "
                "compare (1), the two decrements (2)")


def tb_tensors(c: dict, device):
    """(q_base, bias_base, t_cat, jobs) of a tb_jobs dict as tensors on
    ``device``, and the job table in numpy."""
    import torch

    from diamond_tpu_torch.ops import traceback_device as tbd

    jobs = tbd.job_table(*[c[k] for k in ("q_off", "q_len", "use_bias",
                                          "t_off", "t_len", "d_begins",
                                          "bands")])
    x = [torch.from_numpy(np.ascontiguousarray(c[k])).to(device)
         for k in ("q_base", "bias_base", "t_cat")]
    return (*x, torch.from_numpy(jobs).to(device)), jobs


def tb_check(c: dict, got, matrix32, gap_open: int, gap_extend: int,
             refs=None):
    """D4's (out, stats, results) of a tb_jobs dict against the native
    tb_multi_results on the jobs whose band starts at diagonal -(t_len - 1)
    or above (every field: out, the ok flag, and stats and ops where the
    walk succeeded) and against banded_swipe_np(traceback=True) on the
    others (every field, the ok flag included).  ``refs``: the pair
    (tb_multi_results, banded_swipe_np) to hold it against, by default the
    port's own.  Returns (native mismatches, oracle mismatches, jobs held
    against the oracle, of those the native call got wrong)."""
    if refs is None:
        from diamond_tpu_torch.ops.banded_swipe import (banded_swipe_np,
                                                        tb_multi_results)
    else:
        tb_multi_results, banded_swipe_np = refs

    go, ge = gap_open + gap_extend, gap_extend
    args = [c[k] for k in TB_KEYS]
    out, stats, res = got
    w_out, w_stats, w_res = tb_multi_results(*args, matrix32, go, ge)
    low = c["d_begins"] < -(c["t_len"] - 1)
    nat_mis = oracle_mis = native_wrong = 0
    for k in range(len(out)):
        if low[k]:
            qo, ql = int(c["q_off"][k]), int(c["q_len"][k])
            to, tl = int(c["t_off"][k]), int(c["t_len"][k])
            d0 = int(c["d_begins"][k])
            bias = c["bias_base"][qo:qo + ql] if c["use_bias"][k] else None
            try:
                o = banded_swipe_np(c["q_base"][qo:qo + ql],
                                    c["t_cat"][to:to + tl], d0,
                                    d0 + int(c["bands"][k]), matrix32, bias,
                                    gap_open, gap_extend, traceback=True)
            except (RuntimeError, AssertionError):
                oracle_mis += int(stats[k, 11] != 0)
                continue
            r = res[k]
            same = ((r.score, r.max_col, r.max_row)
                    == (o.score, o.max_col, o.max_row) and stats[k, 11] == 1)
            if same and o.score > 0:
                same = (list(r.transcript) == o.transcript
                        and (r.query_range, r.subject_range, r.identities,
                             r.mismatches, r.positives, r.gap_openings,
                             r.gaps, r.length)
                        == (o.query_range, o.subject_range, o.identities,
                            o.mismatches, o.positives, o.gap_openings,
                            o.gaps, o.length))
            oracle_mis += int(not same)
            native_wrong += int(tuple(w_out[k]) != (o.score, o.max_col,
                                                    o.max_row))
            continue
        same = (tuple(out[k]) == tuple(w_out[k])
                and stats[k, 11] == w_stats[k, 11])
        if same and w_stats[k, 11] and w_out[k, 0] > 0:
            a, b = res[k].transcript, w_res[k].transcript
            same = (tuple(stats[k]) == tuple(w_stats[k])
                    and np.array_equal(a.codes, b.codes)
                    and np.array_equal(a.payloads, b.payloads))
        nat_mis += int(not same)
    return nat_mis, oracle_mis, int(low.sum()), native_wrong


def tb_plane_mismatches(scratch: np.ndarray, plan, jobs: np.ndarray,
                        code) -> int:
    """Cells of the live columns whose four plane bits differ between the
    kernel's scratch (one slice: word (j, p, k) of a job holds band row
    l R + k at bit l) and ``code`` (uint8 [n, T, B], plane p at bit p, as
    traceback_device._fill_plain gives them)."""
    words = scratch.view(np.uint32)
    bad = 0
    for k, (_qo, ql, _ub, _to, tl, d0, band) in enumerate(jobs.tolist()):
        R = -(-band // 32)
        w = words[plan.plane_off[k]:plan.plane_off[k] + tl * 4 * R]
        bits = (w.reshape(tl, 4, R)[..., None] >> np.arange(32, dtype=np.uint32)
                ) & 1                                    # [t, p, k, l]
        rows = bits.transpose(0, 1, 3, 2).reshape(tl, 4, 32 * R)[..., :band]
        got = (rows << np.arange(4, dtype=np.uint32)[None, :, None]).sum(1)
        j0, j1 = max(0, -d0 - band + 1), min(tl, ql - d0)
        if j1 > j0:
            bad += int((got[j0:j1] != code[k, j0:j1, :band]).sum())
    return bad


def tb_work(t_len, q_len, d0, band, n_ops) -> tuple[int, int]:
    """(exact in-query band cells, walk steps) of a D4 call: the fill's
    work and the walk's, as the function needs them."""
    return (int(band_cells(t_len, q_len, d0, band).sum()),
            int(np.sum(n_ops)))


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


# K4's wide-band walk (bands 513-8192) at its own interface: (label, band,
# columns T, targets B, profile row C of the query's first letter, query
# length, options); the walk takes profile rows [p_lo, p_hi) in strips of
# 512, so a query of over 512 live rows takes several
UNIFORM_EDGES = (
    ("holes in the mask, 2 strips", 700, 256, 5, 150, 600,
     {"holes": True}),
    ("dead rows at both ends and inside, rows valid for some letters", 1024,
     256, 4, 300, 700, {"dead": True}),
    ("p_lo below T - 1: rows leave the band at the top", 513, 512, 4, 0, 300,
     {"holes": True}),
    ("p_lo above T - 1, rows enter the band late, 3 strips", 3000, 512, 3,
     2000, 1200, {}),
    ("pad columns scoring under a positive bias", 1024, 256, 4, 200, 400,
     {"pad_bias": True}),
    ("tied bests across lanes and strips", 700, 128, 3, 100, 600,
     {"ties": True}),
    ("targets that cannot score (best 0), T of no multiple of 16", 513, 70,
     3, 10, 200, {"zero": True}),
    ("band 8192, 2 strips", 8192, 512, 2, 4000, 900, {"holes": True}),
    ("band 8192, B = 1", 8192, 256, 1, 7000, 300, {}),
    ("B = 1, one live row", 600, 64, 1, 30, 1, {}),
    ("rows leave the band at the top in every strip, 3 strips", 1024, 1024,
     3, 0, 1100, {"long": True}),
    ("a match on a diagonal above the band (band row -40)", 600, 512, 3, 16,
     400, {"above": True}),
    ("a high cell at band row 0 as its row leaves the band", 513, 16, 1, 0,
     20, {"exit": True}),
    ("band of 16 mod 32, a match on a diagonal below the band (band row "
     "band + 4)", 1040, 256, 3, 0, 1296, {"below": True}),
)


def uniform_edge_cases(seed: int, cases=UNIFORM_EDGES):
    """Seeded K4 inputs for the wide-band walk at the kernel's own interface
    (see UNIFORM_EDGES): per case a query profile at profile rows [C, C +
    qlen) (NEG elsewhere), targets of up to T letters at a random shift in
    their row (pad letter 31 around them) with a planted stretch of the
    query, and masks covering each target's rows [0, w) of the band.
    Options: ``holes`` clears every seventh band row from row 3 and a run
    of 40; ``dead`` sets 40 query rows in the middle to NEG for every letter
    and 30 rows to NEG for half the letters; ``pad_bias`` gives letter 31 a
    score of +2 on the query's rows (pad columns then score); ``ties`` makes
    a query of P with W at rows 100 and 420 (with 600 rows from profile row
    100, one lane's rows in each of the walk's two strips), no bias, and
    targets of W, or of C with W at two columns: equal bests in several
    columns, rows and strips; ``zero`` makes
    targets of pad letters and of X, which score nothing; ``long`` makes
    targets of 0.8-1 T letters; ``above`` copies the query onto band row
    -40, a diagonal above the band (which the function never scores), and
    ``below`` onto band row band + 4, a diagonal below it;
    ``exit`` is a crafted 16-column case (letter j in column j): a score of
    100 at band row 0 in column 5, whose row leaves the band at column 6,
    an invalid cell below it, and a score of 60 two rows below on the next
    diagonal, so that an E kept past the band's top row would raise the
    best.  Returns [(label,
    band, t_idx int8 [B, T], band_mask int8 [B, band], prof_t int32 [32, T +
    band])] as numpy arrays."""
    from diamond_tpu_torch.ops.swipe_uniform import NEG
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m32 = ScoreMatrix("BLOSUM62").matrix32
    rng = np.random.default_rng(seed)
    out = []
    for label, band, T, B, C, qlen, opt in cases:
        q = rng.integers(0, 20, qlen).astype(np.int64)
        bias = rng.integers(-2, 3, qlen)
        if opt.get("ties"):
            q[:] = 14  # P
            q[[100, 420]] = 17  # W
            bias[:] = 0
        prof_t = np.full((32, T + band), NEG, np.int64)
        prof_t[:, C:C + qlen] = (m32[q].astype(np.int64) + bias[:, None]).T
        if opt.get("pad_bias"):
            prof_t[31, C:C + qlen] = 2
        if opt.get("dead"):
            mid = C + qlen // 2
            prof_t[:, mid:mid + 40] = NEG
            prof_t[::2, mid + 100:mid + 130] = NEG
        if opt.get("exit"):
            prof_t[:, C:C + qlen] = -50
            prof_t[5, C + 5] = 100
            prof_t[5, C + 6] = NEG
            prof_t[7, C + 7] = 60
            out.append((label, band, np.arange(T, dtype=np.int8)[None, :],
                        np.ones((1, band), np.int8), prof_t.astype(np.int32)))
            continue
        t_idx = np.full((B, T), 31, np.int8)
        band_mask = np.zeros((B, band), np.int8)
        for b in range(B):
            tl = int(rng.integers(max(1, T // 3), T + 1))
            if opt.get("long"):
                tl = int(rng.integers(T * 4 // 5, T + 1))
            if opt.get("pad_bias"):
                tl = min(tl, T - 40)
            t = rng.integers(0, 20, tl).astype(np.int8)
            sh = int(rng.integers(0, T - tl + 1))
            if opt.get("ties"):  # W, or C with W at two columns
                t[:] = 17 if b == 0 else 4
                t[[min(10, tl - 1), min(50, tl - 1)]] = 17
            elif opt.get("zero") and b < 2:
                t[:] = 31 if b == 0 else 23  # pad letters; X
            elif opt.get("above") or opt.get("below"):
                # the query on band row -40, or band + 4, at column j
                j = np.arange(tl)
                i = j + sh + (-40 if opt.get("above") else band + 4) - C
                ok = (i >= 0) & (i < qlen)
                t[j[ok]] = q[i[ok]]
            else:  # a stretch of the query on a diagonal in the band
                j = np.arange(min(tl, 60))
                i = np.clip(j + sh + int(rng.integers(0, band // 2)) - C, 0,
                            qlen - 1)
                t[j] = q[i]
            t_idx[b, sh:sh + tl] = t
            w = band if b == 0 else int(rng.integers(band // 2, band + 1))
            band_mask[b, :w] = 1
            if opt.get("holes"):
                band_mask[b, 3::7] = 0
                h = int(rng.integers(0, band - 40))
                band_mask[b, h:h + 40] = 0
        out.append((label, band, t_idx, band_mask,
                    prof_t.astype(np.int32)))
    return out


def uniform_many(seed: int, n: int = 3000):
    """K4 at a batch of thousands: one query of 700 letters against ``n``
    seeded targets of 100-500 letters, full-matrix jobs as
    sharded_full_scores makes them (band [-(len - 1), qlen): the wide-band
    walk, band 2048 or less).  Returns (query, bias, jobs)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, 700).astype(np.int8)
    bias = rng.integers(-3, 4, 700).astype(np.int32)
    jobs = []
    for _ in range(n):
        t = rng.integers(0, 20, int(rng.integers(100, 501))).astype(np.int8)
        k = int(rng.integers(0, 640))
        t[20:60] = q[k:k + 40]
        jobs.append((t, -(len(t) - 1), len(q)))
    return q, bias, jobs


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


# the fused stage-1/2 pass (stage12_join) on seeded joins: the cases of
# chip_smoke's D1 phase and tests/test_torch_stage12.py, (label, options of
# stage12_fused_case)
STAGE12_FUSED_EDGES = (
    ("self-search, first shape", dict(self_search=True, sid=0)),
    ("self-search, a later shape, group_keep",
     dict(self_search=True, sid=3, keep=True)),
    ("two blocks, chunked index, part table",
     dict(self_search=False, sid=1, chunked=True)),
    ("self-search, chunked, first shape, no part table, group_keep",
     dict(self_search=True, sid=0, chunked=True, table=False, keep=True)),
    ("translated short-query windows (qlen <= 85)",
     dict(self_search=False, sid=2, win85=True)),
    ("skip_lm", dict(self_search=True, sid=1, skip_lm=True)),
    ("the query's letters as target, delimiters put into them",
     dict(self_search=False, sid=2, same_letters=True)),
)
# the keyword arguments of Stage12Device.join_rows in a case
JOIN_KEYS = ("q_letters", "s_letters", "q_seed_mask", "join", "group_keep",
             "q_starts", "cut", "win", "q_idx_tbl", "s_idx_tbl", "reduction",
             "shape", "first_shape", "chunked", "do_leftmost", "current",
             "previous", "part_lo", "part_hi", "seedp_mask", "part_tbl",
             "hamming_id", "self_search")


def _pos_index(letters, starts):
    """Position -> sequence index (Pipeline._pos_index)."""
    mark = np.zeros(len(letters), dtype=np.int32)
    st = starts[1:]
    np.add.at(mark, st[st < len(mark)], 1)
    return np.cumsum(mark, dtype=np.int32)


def stage12_fused_case(seed: int, n_fam: int = 80, members: int = 6,
                       self_search: bool = True, sid: int = 0,
                       chunked: bool = False, table: bool = True,
                       keep: bool = False, win85: bool = False,
                       skip_lm: bool = False, big: bool = True,
                       same_letters: bool = False):
    """A seeded seed join for the fused stage-1/2 pass, as the keyword
    arguments of Stage12Device.join_rows (JOIN_KEYS) plus "matrix32" and
    "s_starts" for native stage12_pipeline_native.

    Families of protein-like sequences (roots of 12-400 letters, a quarter
    of them at most 85, drawn from the 20 amino acids; members at 5-35 %
    substitutions, no indels, three in ten without their first 1-6 letters,
    so that a delimiter lies before the anchor on one side only); 1 % of
    the letters the mask letter 23, 10 %
    with a high bit set (32, 64 or 128) as masked letters carry.  Seed
    groups pair the same offset in members of one family (stage 1 passes
    often, the left-most filter rejects often), at the first offset every
    member holds (a delimiter beside the seed there) and at len - 1, plus
    groups of random positions; most
    groups hold 1-4 occurrences a side, ``big`` adds a 60 x 45 and a 2 x 700
    group.  The query block holds every member; with ``self_search`` the
    target block is the query block, else members drawn anew.  The shapes,
    reduction and seed partitions are the sensitive mode's (16 shapes; sid
    picks the shape, the matchers those before it); ``chunked`` takes one of
    4 index chunks, with the native part table unless ``table`` is False;
    ``keep`` drops a fifth of the groups (group_keep); ``win85`` gives
    queries of at most 85 letters their length as stage-2 window (blastx's
    short-query rule); ``skip_lm`` turns the left-most filter off;
    ``same_letters`` (not a self-search) makes the target block the query
    block's letters with 3 % of them turned into delimiters, so that
    target delimiters cut windows where the letters match; 3 % of
    the query positions are seed-masked; cutoffs 5 to 40."""
    from diamond_tpu_torch import native
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.search.left_most_batch import BatchPatternMatcher
    from diamond_tpu_torch.search.stages import SeedJoin
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    rng = np.random.default_rng(seed)
    cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"),
                       sensitivity="sensitive",
                       index_chunks=4 if chunked else 1)
    lens = np.where(rng.random(n_fam) < 0.25, rng.integers(12, 86, n_fam),
                    rng.integers(86, 401, n_fam))
    roots = [rng.integers(0, 20, n) for n in lens]

    def family_members():
        seqs, fam, cut = [], [], []
        for f, r in enumerate(roots):
            for _ in range(members):
                k = int(rng.integers(1, 7)) if rng.random() < 0.3 else 0
                x = r[k:].copy()
                sub = rng.random(len(x)) < rng.uniform(0.05, 0.35)
                x[sub] = rng.integers(0, 20, int(sub.sum()))
                seqs.append(x)
                fam.append(f)
                cut.append(k)
        order = rng.permutation(len(seqs))
        return ([seqs[i] for i in order], np.asarray(fam)[order],
                np.asarray(cut)[order])

    def block(seqs):
        blk = Block.from_sequences(["".join(AA[c] for c in x) for x in seqs],
                                   [f"s{i}" for i in range(len(seqs))])
        letters = blk.letters.copy()
        inside = letters != 31
        letters[inside & (rng.random(len(letters)) < 0.01)] = 23
        high = inside & (rng.random(len(letters)) < 0.1)
        letters[high] |= rng.choice(np.array([32, 64, -128], np.int8),
                                    int(high.sum()))
        return blk, letters

    q_seqs, q_fam, q_cut = family_members()
    qb, q_letters = block(q_seqs)
    if self_search:
        tb, s_letters, t_fam, t_cut = qb, q_letters, q_fam, q_cut
    elif same_letters:
        tb, t_fam, t_cut = qb, q_fam, q_cut
        s_letters = q_letters.copy()
        s_letters[rng.random(len(s_letters)) < 0.03] = 31
    else:
        t_seqs, t_fam, t_cut = family_members()
        tb, s_letters = block(t_seqs)
    q_by = [np.nonzero(q_fam == f)[0] for f in range(n_fam)]
    t_by = [np.nonzero(t_fam == f)[0] for f in range(n_fam)]
    q_pos, s_pos, q_start, s_start = [], [], [0], [0]
    for f in range(n_fam):
        for o in {6, int(lens[f]) - 1, *rng.integers(6, lens[f], 6)}:
            # the root's offset o in members of family f (a member that
            # dropped k leading letters holds it at o - k)
            qm = rng.choice(q_by[f], int(rng.integers(1, 5)))
            sm = rng.choice(t_by[f], int(rng.integers(1, 5)))
            q_pos.extend(qb.starts[qm] + o - q_cut[qm])
            s_pos.extend(tb.starts[sm] + o - t_cut[sm])
            q_start.append(len(q_pos))
            s_start.append(len(s_pos))

    def anywhere(blk, n):
        i = rng.integers(0, len(blk.lengths), n)
        return blk.starts[i] + rng.integers(0, blk.lengths[i])

    sizes = [(int(rng.integers(1, 4)), int(rng.integers(1, 4)))
             for _ in range(200)]
    if big:
        sizes += [(60, 45), (2, 700)]
    for nq, ns in sizes:
        q_pos.extend(anywhere(qb, nq))
        s_pos.extend(anywhere(tb, ns))
        q_start.append(len(q_pos))
        s_start.append(len(s_pos))
    n_groups = len(q_start) - 1
    perm = rng.permutation(n_groups)  # groups of both kinds interleaved
    qs, ss = np.asarray(q_start), np.asarray(s_start)
    qv, sv = np.asarray(q_pos, np.int64), np.asarray(s_pos, np.int64)
    q_parts = [qv[qs[g]:qs[g + 1]] for g in perm]
    s_parts = [sv[ss[g]:ss[g + 1]] for g in perm]
    join = SeedJoin(
        keys=np.arange(n_groups, dtype=np.uint64),
        q_start=np.concatenate([[0], np.cumsum([len(x) for x in q_parts])]
                               ).astype(np.int64),
        q_pos=np.concatenate(q_parts).astype(np.int64),
        s_start=np.concatenate([[0], np.cumsum([len(x) for x in s_parts])]
                               ).astype(np.int64),
        s_pos=np.concatenate(s_parts).astype(np.int64))
    qlens = qb.lengths.astype(np.int64)
    win = np.where(win85 & (qlens <= 85), qlens, 48).astype(np.int64)
    shape = cfg.shapes[sid]
    n_chunk = int(rng.integers(0, 4)) if chunked else 0
    seedp = cfg.seedp_mask + 1
    part_lo, part_hi = ((n_chunk * seedp // 4, (n_chunk + 1) * seedp // 4)
                        if chunked else (0, seedp))
    return dict(
        q_letters=q_letters, s_letters=s_letters,
        q_seed_mask=rng.random(len(q_letters)) < 0.03, join=join,
        group_keep=(rng.random(n_groups) < 0.8 if keep else None),
        q_starts=qb.starts, cut=rng.integers(5, 41, len(qlens)).astype(
            np.int32), win=win,
        q_idx_tbl=_pos_index(q_letters, qb.starts),
        s_idx_tbl=(_pos_index(s_letters, tb.starts) if self_search
                   else None),
        reduction=cfg.reduction, shape=shape, first_shape=sid == 0,
        chunked=chunked, do_leftmost=not skip_lm,
        current=BatchPatternMatcher(cfg.shapes.patterns(0, sid + 1)),
        previous=BatchPatternMatcher(cfg.shapes.patterns(0, sid)),
        part_lo=part_lo, part_hi=part_hi, seedp_mask=cfg.seedp_mask,
        part_tbl=(native.seed_part_table_native(
            s_letters, shape, cfg.reduction, cfg.seedp_mask)
            if chunked and table else None),
        hamming_id=cfg.hamming_filter_id, self_search=self_search,
        matrix32=cfg.matrix.matrix32, s_starts=tb.starts)


def stage12_native_rows(nat, c):
    """The rows of the fused host pass (nat: a package's native module,
    its stage12_pipeline_native) on case c, over all its groups."""
    join = c["join"]
    n = int((np.diff(join.q_start) * np.diff(join.s_start)).sum())
    out = np.empty((max(n, 1), 4), dtype=np.int64)
    keep = c["group_keep"]
    m = nat.stage12_pipeline_native(
        c["q_letters"], c["s_letters"], c["q_seed_mask"], join,
        None if keep is None else keep.astype(np.uint8), 0, len(join.keys),
        c["q_starts"], c["cut"], c["win"], True, c["hamming_id"],
        c["matrix32"], c["self_search"], c["s_starts"], c["do_leftmost"],
        c["reduction"], c["shape"], c["first_shape"], c["chunked"],
        c["current"], c["previous"], c["part_lo"], c["part_hi"],
        c["seedp_mask"], out, c["part_tbl"], q_idx_tbl=c["q_idx_tbl"],
        s_idx_tbl=c["s_idx_tbl"])
    if m is None:
        raise RuntimeError("the native library is unavailable")
    return out[:m]


def stage12_fused_rows(dev, c, **kw):
    """Stage12Device.join_rows on case c."""
    return dev.join_rows(**{k: c[k] for k in JOIN_KEYS}, **kw)


def stage12_route_memory(device: str, seed: int = 9) -> list[dict]:
    """A --sensitive search (16 shapes, a chunked index) of 60 of
    make_proteins' sequences against 160, stage 1/2 on the fused pass
    (DIAMOND_TPU_TORCH_STAGE12=1) on ``device``, the extension skipped.
    Per Stage12Device.join_rows call: whether it had a partition table,
    the bytes its Stage12Device keeps cached after it, and on a card the
    memory allocated before and after it."""
    import inspect

    import torch

    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.ops.stage12_device import Stage12Device
    from diamond_tpu_torch.search import pipeline as pp
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    cuda = torch.device(device).type == "cuda"
    real = Stage12Device.join_rows
    calls = []

    def spy(self, *a, **kw):
        rec = dict(part_tbl=inspect.signature(real).bind(
            self, *a, **kw).arguments["part_tbl"] is not None)
        if cuda:
            torch.cuda.synchronize()
            rec["before"] = torch.cuda.memory_allocated()
        rows = real(self, *a, **kw)
        if cuda:
            torch.cuda.synchronize()
            rec["after"] = torch.cuda.memory_allocated()
        rec["cached"] = sum(t.numel() * t.element_size()
                            for _, t in self._tables.values())
        calls.append(rec)
        return rows

    recs = make_proteins(n_seqs=160, n_families=40, seed=seed)
    seqs, ids = [x for _, x in recs], [i for i, _ in recs]
    cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"), sensitivity="sensitive")
    env = os.environ.get("DIAMOND_TPU_TORCH_STAGE12")
    os.environ["DIAMOND_TPU_TORCH_STAGE12"] = "1"
    try:
        with Patched((Stage12Device, "join_rows", spy),
                     (pp.Pipeline, "_extend_all", lambda self, h: {})):
            pp.Pipeline(cfg, Block.from_sequences(seqs[:60], ids[:60]),
                        Block.from_sequences(seqs, ids),
                        device=device).search()
    finally:
        if env is None:
            os.environ.pop("DIAMOND_TPU_TORCH_STAGE12")
        else:
            os.environ["DIAMOND_TPU_TORCH_STAGE12"] = env
    return calls


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


def d1j_work(call, n_rows: int) -> tuple[dict, tuple]:
    """The work of one stage12_join call (its positional arguments, tensors
    on one device), as this data makes it: pairs, entries, pairs past stage
    1, pairs at the left-most filter, Kadane pairs and steps, rows; and the
    call's pairs expanded (qp, sp, their query index), in its order."""
    import torch

    from diamond_tpu_torch.ops import stage12_device as d1m

    q_blk, s_blk, q_mask, q_start, q_pos, s_start, s_pos, keep, g0, g1, a = call
    dev = q_blk.device
    e_qp, e_sbeg, e_pstart = d1m.join_entries(q_start, q_pos, s_start, keep,
                                              g0, g1)
    n_e = len(e_qp)
    ent = torch.repeat_interleave(torch.arange(n_e, device=dev),
                                  (e_pstart[1:] - e_pstart[:-1]).long())
    n = len(ent)
    qp = e_qp[ent].long()
    sp = s_pos[(e_sbeg[ent] + torch.arange(n, device=dev)
                - e_pstart[ent]).long()].long()
    f = torch.arange(-d1m.FP_LEFT, d1m.FP_RIGHT, device=dev)
    s1 = torch.zeros(n, dtype=torch.bool, device=dev)
    for lo in range(0, n, d1m.PLAIN_CHUNK):
        hi = min(lo + d1m.PLAIN_CHUNK, n)
        s1[lo:hi] = (((q_blk[qp[lo:hi, None] + f] ^ s_blk[sp[lo:hi, None] + f])
                      & 31) == 0).sum(dim=1) >= a.hamming_id
    qidx = a.q_idx[qp].long()
    at_lm = s1 & (a.s_idx[sp].long() != qidx) if a.self_search else s1
    sel = torch.nonzero(at_lm).flatten()
    if a.do_leftmost and len(sel):
        wl, wr = d1m.clip_torch(q_blk, qp[sel], 48)
        sel = sel[d1m.left_most_torch(q_blk, s_blk, q_mask, qp[sel], sp[sel],
                                      qp[sel] - a.q_starts[qidx[sel]].long(),
                                      wl, wr, a)]
    steps = 0
    for lo in range(0, len(sel), d1m.PLAIN_CHUNK):
        k = sel[lo:lo + d1m.PLAIN_CHUNK]
        _, _, _, wl, wr = d1m._gather_clip(q_blk, s_blk, qp[k], sp[k],
                                           a.win[qidx[k]].long())
        steps += int((wl + wr).sum())
    work = dict(pairs=n, entries=n_e, s1=int(s1.sum()),
                at_leftmost=int(at_lm.sum()) if a.do_leftmost else 0,
                kadane_pairs=len(sel), kadane_steps=steps, rows=n_rows)
    return work, (qp, sp, qidx)


def d1j_ops(work: dict, per: dict) -> int:
    """The int32 operations of a stage12_join call's work at the counts
    per (D1J_OPS or D1J_ISSUED_OPS)."""
    return sum(work[k] * v for k, v in per.items())


def d1j_bytes(call, n_rows: int) -> int:
    """The bytes the fused pass must move on one call, each input read once
    and each output written once: the letter blocks, the seed mask, the
    position and per-query tables (and the partition table), the join's
    CSR of the call's groups, the rows (16 bytes each)."""
    q_blk, s_blk, q_mask, q_start, q_pos, s_start, s_pos, keep, g0, g1, a = call
    tables = [q_blk, q_mask, a.q_idx, a.q_starts, a.cut, a.win, a.m32]
    if s_blk.data_ptr() != q_blk.data_ptr():
        tables.append(s_blk)
    tables += [t for t in (a.s_idx, a.part_tbl) if t is not None]
    n = sum(t.numel() * t.element_size() for t in tables)
    qa, qb = (int(x) for x in q_start[[g0, g1]].tolist())
    sa, sb = (int(x) for x in s_start[[g0, g1]].tolist())
    n += 2 * 8 * (g1 - g0 + 1) + 8 * (qb - qa) + 4 * (sb - sa)
    if keep is not None:
        n += g1 - g0
    return n + 16 * n_rows


# the MCL run's large families: four components of 128-1,024 nodes, so that
# MCL's dense step (D3) runs on the card through the CLI
MCL_FAMILIES = (130, 150, 180, 220)
# D3's bound: 2 m^3 (expansion - 1) flops an iteration over the fp32 rate
# outside the tensor cores (132 SMs x 128 lanes x 2 flops x the SM clock)
FP32_LANES_PER_SM = 128


# tantan's scan on the card (csrc/tantan.cu): fp32 operations a letter and
# state over both passes, and the dependent ones a letter of the longest
# sequence (its serial chain), each FP32_LATENCY_CYCLES long
MASK_OPS = 10
MASK_NOTE = ("forward f * f2f, b * d, their sum, times e, the state's add "
             "into the 50-state sum; backward f * e, times d, the add into "
             "the sum, fe * f2f, plus p_repeat_end * b; no FMA")
MASK_CHAIN_OPS = 15
MASK_CHAIN_NOTE = ("each pass 15 dependent ops every two positions: the "
                   "50-state sum's depth 10 (5 accumulator adds, 3 tree "
                   "levels, a[48], a[49]), b's 2, f's 2-3")
FP32_LATENCY_CYCLES = 4


def mask_entry(seed: int, sm_clock_mhz: float, kind: str, name_power: str):
    """tantan on the card at the benchmark's block (perfbench/gen.py's
    frozen generator: 15,000 proteins, 3,750 families, size_seed 2500, the
    letters from ``seed``): the kernel against the native host scan (bit-
    equal probabilities, byte-equal letters, padding untouched) and its
    plain version on the card; timed per call (the wrapper on letters
    already on the card, a fresh copy of them each call), kernel only (a
    CUDA graph of the same), the whole card route of _mask_block
    (tantan_device.mask_letters: staging, upload, kernel, the masked
    positions back) on the block and on 8 of its proteins, the plain
    version once and the native host scan; bound the larger of the
    operations over the fp32 rate, the longest chain's latency and the
    bytes.  Returns ((ms, plain_ms, bound_ms, bound_by, kernel_only_ms),
    the largest difference from the native scan: of the probabilities' int32
    bits, of the letters, of the plain version's bits)."""
    import torch

    from diamond_tpu_torch import native
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.ops import tantan_device as td
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "perfbench"))
    try:
        import gen
    finally:
        sys.path.remove(os.path.join(here, "perfbench"))
    recs = gen.make_proteins(15_000, 3_750, seed=seed, size_seed=2500)
    blk = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
    masker = Tantan(ScoreMatrix("BLOSUM62").matrix32)
    params = td.scan_params(masker)
    lens = blk.lengths.astype(np.int64)
    n_let, longest = int(lens.sum()), int(lens.max())
    args = (blk.letters, blk.starts, lens, masker.ratios,
            float(masker.p_repeat), float(masker.p_repeat_end),
            float(masker.repeat_growth))
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        want = native.tantan_repeat_prob_many(*args)
        host_s.append(time.perf_counter() - t0)
    ref = blk.letters.copy()
    np.copyto(ref, 23, where=want >= masker.p_mask)
    orig = torch.from_numpy(blk.letters).cuda()
    st, ln = torch.from_numpy(blk.starts).cuda(), torch.from_numpy(lens).cuda()
    x = orig.clone()
    probs = torch.full(x.shape, -1.0, device="cuda")
    td.tantan_mask(x, st, ln, params, probs=probs)
    torch.cuda.synchronize()
    got = probs.cpu().numpy()
    inside = np.zeros(len(blk.letters), bool)
    for s0, n in zip(blk.starts, lens):
        inside[s0:s0 + n] = True
    bits = np.abs(got.view(np.int32)[inside].astype(np.int64)
                  - want.view(np.int32)[inside])
    p_mis = int((bits != 0).sum())
    pad_written = int((got[~inside] != -1.0).sum())
    l_diff = np.abs(x.cpu().numpy().astype(np.int64) - ref)
    l_mis = int((l_diff != 0).sum())
    t0 = time.perf_counter()
    plain = td.tantan_prob_torch(orig, st, ln, params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_bits = np.abs(plain.cpu().numpy().view(np.int32).astype(np.int64)
                        - want.view(np.int32))
    plain_mis = int((plain_bits != 0).sum())
    max_err = int(max(bits.max(initial=0), l_diff.max(initial=0),
                      plain_bits.max(initial=0)))
    n_masked = int((ref != blk.letters).sum())
    print(f"mask block: {len(blk)} sequences, {n_let} letters in "
          f"{len(blk.letters)} (longest {longest}); {n_masked} "
          f"masked; kernel against the native scan: {p_mis} probabilities "
          f"and {l_mis} letters differ, {pad_written} padding positions "
          f"written; plain version on the card: {plain_mis} differ")
    if p_mis or l_mis or pad_written or plain_mis:
        raise RuntimeError("tantan's kernel disagrees with the native scan")

    o, so = td.launch_plan(lens)[:2]
    plan = (torch.from_numpy(o).cuda(), torch.from_numpy(so).cuda(), longest,
            n_let)

    def call():
        x.copy_(orig)
        td.tantan_mask(x, st, ln, params, plan=plan)

    call()
    ms = cuda_ms(call, 10)
    only_ms = graph_ms(call, 10)
    route_s = []
    for _ in range(5):
        host = blk.letters.copy()
        t0 = time.perf_counter()
        td.mask_letters(host, blk.starts, blk.lengths, masker, "cuda")
        route_s.append(time.perf_counter() - t0)
        if not np.array_equal(host, ref):
            raise RuntimeError("mask_letters disagrees with the native scan")
    small = Block.from_sequences([s for _, s in recs[:8]],
                                 [i for i, _ in recs[:8]])
    small_s = []
    for _ in range(5):
        host = small.letters.copy()
        t0 = time.perf_counter()
        td.mask_letters(host, small.starts, small.lengths, masker, "cuda")
        small_s.append(time.perf_counter() - t0)
    print(f"mask: a block of 8 of them ({int(small.lengths.sum())} letters, "
          f"longest {int(small.lengths.max())}) through mask_letters: "
          f"{' '.join(f'{t * 1e3:.3f}' for t in small_s)} ms")
    clock = sm_clock_mhz * 1e6
    ops_s = n_let * td.WINDOW * MASK_OPS / (H100_SMS * FP32_LANES_PER_SM
                                             * clock)
    chain_s = longest * MASK_CHAIN_OPS * FP32_LATENCY_CYCLES / clock
    n_bytes = 2 * len(blk.letters) + 16 * len(blk) + 4 * (32 * 32 + 50)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    bound_s = max(ops_s, chain_s, bytes_s)
    bound_by = ("operations" if bound_s == ops_s else
                "the longest chain" if bound_s == chain_s else "bytes")
    print(f"mask: {n_let} letters x {td.WINDOW} states x {MASK_OPS} fp32 "
          f"ops ({MASK_NOTE}): {ops_s * 1e3:.5f} ms; longest chain {longest} "
          f"letters x {MASK_CHAIN_OPS} dependent ops ({MASK_CHAIN_NOTE}) x "
          f"{FP32_LATENCY_CYCLES} cycles: {chain_s * 1e3:.5f} ms; {n_bytes} "
          f"bytes: {bytes_s * 1e3:.5f} ms; bound {bound_s * 1e3:.5f} ms "
          f"({bound_by})")
    print(f"mask: kernel {ms:.4f} ms per call (a 5.8 MB device copy of the "
          f"letters in each), {only_ms:.4f} ms kernel only (CUDA graph), "
          f"{ms / (bound_s * 1e3):.1f}x the bound; plain {plain_ms:.1f} ms; "
          f"the card route of _mask_block (mask_letters) "
          f"{' '.join(f'{t * 1e3:.2f}' for t in route_s)} ms; the native "
          f"host scan {' '.join(f'{t * 1e3:.1f}' for t in host_s)} ms; "
          f"{kind}, {name_power}")
    return (ms, plain_ms, bound_s * 1e3, bound_by, only_ms), max_err


# the query-indexed route's DB-side seed enumeration on the card
# (csrc/seed_enum.cu): int32 operations a window that the function needs
SEED_ENUM_OPS = 45
SEED_ENUM_NOTE = ("at weight 10, 4 a sampled letter (its load, the table "
                  "lookup, the range test, the multiply-add into the key), "
                  "and 5 for the window's sequence and the key's probe")


def seed_block(seed: int, n_seqs: int = 15_000, n_queries=(20, 1000)):
    """The DB-side seed enumeration's block and cases on the card:
    ``n_seqs`` proteins of perfbench/gen.py's frozen generator (a quarter
    as many families, size_seed 2500, the letters from ``seed``),
    tantan-masked by the native scan as the pipeline masks them, and
    uploaded once (upload_block, timed to its sync); a case for the keys of
    the block's first ``n_q`` proteins (each of ``n_queries``, at most the
    block) and each default shape.  Returns (the block, its int64 lengths,
    the SeedBlock, the upload's ms, [(n_q, shape, query keys), ...])."""
    import torch

    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.ops import seed_enum_device as sed
    from diamond_tpu_torch.search import pipeline, stages
    from diamond_tpu_torch.seed.reduction import MURPHY10 as red
    from diamond_tpu_torch.seed.shapes import SHAPE_CODES, Shape
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "perfbench"))
    try:
        import gen
    finally:
        sys.path.remove(os.path.join(here, "perfbench"))
    recs = gen.make_proteins(n_seqs, max(n_seqs // 4, 1), seed=seed,
                             size_seed=2500)
    blk = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
    pipeline._mask_block(blk, Tantan(ScoreMatrix("BLOSUM62").matrix32),
                         device="cpu")
    lens = blk.lengths.astype(np.int64)
    t0 = time.perf_counter()
    card = sed.upload_block(blk.letters, blk.starts, lens,
                            sed.reduce_table(red), red.size, "cuda")
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) * 1e3
    cases = []
    for n_q in sorted({min(n, n_seqs) for n in n_queries}):
        qb = Block.from_sequences([s for _, s in recs[:n_q]],
                                  [i for i, _ in recs[:n_q]])
        for code in SHAPE_CODES["default"]:
            shape = Shape(code)
            cases.append((n_q, shape, stages.enumerate_seeds(qb, shape,
                                                             red)[0]))
    return blk, lens, card, up_ms, cases


def seed_native(blk, lens, shape, qs):
    """The native fused pass that the card route replaces, with the
    reduction of the block it needs: (keys, positions)."""
    from diamond_tpu_torch import native
    from diamond_tpu_torch.seed.reduction import MURPHY10 as red

    return native.enumerate_seeds_filtered_native(
        red(blk.letters), blk.starts, lens,
        np.ascontiguousarray(shape.positions, np.int64), shape.weight,
        shape.length, red.size, 0, np.sort(qs))


def enum_entry(seed: int, sm_clock_mhz: float, kind: str, name_power: str):
    """The DB-side seed enumeration on the card at the benchmark's block
    (seed_block: 15,000 proteins, both default shapes, the keys of the
    block's first 20 and first 1,000 proteins): the kernel against the
    native fused pass (the same keys and positions in the same order) and
    its plain version on the card; timed per call (the wrapper on tensors
    on the card: its launches, the sync on the total, the write), kernel
    only (a CUDA graph of the two launches on fixed buffers), the card
    route (enumerate_block: the keys' upload, the launches, the survivors
    back; upload_block once) and the native pass (seed_native); bound the
    larger of SEED_ENUM_OPS int32 ops a window over the int32 rate and the
    bytes.  Returns ((ms, plain_ms, bound_ms, bound_by, kernel_only_ms) of
    the 1,000 proteins' first shape, the mismatches against the native
    pass)."""
    import torch

    from diamond_tpu_torch.ops import seed_enum_device as sed
    from diamond_tpu_torch.seed.reduction import MURPHY10 as red

    blk, lens, card, up_ms, cases = seed_block(seed)
    clock = sm_clock_mhz * 1e6
    mis, row = 0, None
    print(f"seed_enum block: {len(blk)} sequences, {int(lens.sum())} "
          f"letters in {len(blk.letters)}; upload_block {up_ms:.3f} ms "
          f"(first call: pinned staging allocated)")
    for n_q, shape, qs in cases:
        code = shape.code
        host_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            want = seed_native(blk, lens, shape, qs)
            host_s.append(time.perf_counter() - t0)
        route_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            got = sed.enumerate_block(card, shape.positions,
                                      shape.length, qs)
            route_s.append(time.perf_counter() - t0)
            mis += int(len(got[0]) != len(want[0])
                       or not np.array_equal(got[0], want[0])
                       or not np.array_equal(got[1], want[1]))
        off = sed.window_offsets(lens, shape.length)
        n_win = int(off[-1])
        x = dict(letters=card.letters, table=card.table,
                 starts=card.starts, lens=card.lens,
                 shape_pos=torch.from_numpy(
                     shape.positions.astype(np.int32)).cuda(),
                 span=shape.length, base=red.size,
                 q_keys=torch.from_numpy(qs.view(np.int64)).cuda())
        plan = (torch.from_numpy(off).cuda(), n_win)
        t0 = time.perf_counter()
        pk, pp = sed.enumerate_filtered_torch(**x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        mis += int(not np.array_equal(
            pk.cpu().numpy().view(np.uint64), want[0])
            or not np.array_equal(pp.cpu().numpy(), want[1]))
        ms = cuda_ms(lambda: sed.enumerate_filtered(**x, plan=plan), 10)
        # the two launches on fixed buffers, as the wrapper makes them
        nq, cap = len(qs), sed.hash_capacity(len(qs))
        n_tiles = -(-n_win // sed.TILE)
        hs = torch.empty(cap, dtype=torch.int64, device="cuda")
        cnt = torch.empty(n_tiles, dtype=torch.int32, device="cuda")
        offs = torch.empty(n_tiles + 1, dtype=torch.int64, device="cuda")
        out = torch.empty(2 * max(len(want[0]), 1), dtype=torch.int64,
                          device="cuda")
        k = sed._kernel()

        def launches():
            for phase_, ko, po in ((0, 0, 0), (1, out.data_ptr(),
                                               out[len(want[0]):]
                                               .data_ptr())):
                k(phase_, x["letters"].data_ptr(), x["table"].data_ptr(),
                  x["starts"].data_ptr(), plan[0].data_ptr(), len(lens),
                  n_win, x["shape_pos"].data_ptr(), shape.weight,
                  red.size, x["q_keys"].data_ptr(), nq, hs.data_ptr(),
                  cap, cnt.data_ptr(), offs.data_ptr(), ko, po,
                  torch.cuda.current_stream().cuda_stream)

        only_ms = graph_ms(launches, 10)
        ops_s = n_win * SEED_ENUM_OPS / (H100_SMS * INT32_LANES_PER_SM
                                         * clock)
        n_bytes = (len(blk.letters) + 24 * len(lens) + 8 * nq
                   + 16 * len(want[0]))
        bytes_s = n_bytes / HBM_BYTES_PER_S
        bound_s = max(ops_s, bytes_s)
        bound_by = "operations" if ops_s >= bytes_s else "bytes"
        print(f"seed_enum {n_q} proteins, shape {code}: {n_win} windows, "
              f"{nq} query keys, {len(want[0])} survivors; {n_win} x "
              f"{SEED_ENUM_OPS} int32 ops ({SEED_ENUM_NOTE}): "
              f"{ops_s * 1e3:.5f} ms; {n_bytes} bytes: "
              f"{bytes_s * 1e3:.5f} ms; bound {bound_s * 1e3:.5f} ms "
              f"({bound_by}); kernel {ms:.4f} ms per call (its sync "
              f"on the total), {only_ms:.4f} ms kernel only (CUDA "
              f"graph), {only_ms / (bound_s * 1e3):.1f}x the bound; "
              f"plain {plain_ms:.1f} ms; the card route (enumerate_block) "
              f"{' '.join(f'{t * 1e3:.3f}' for t in route_s)} ms; the "
              f"native pass {' '.join(f'{t * 1e3:.1f}' for t in host_s)}"
              f" ms; {kind}, {name_power}")
        if n_q == 1000 and row is None:
            row = (ms, plain_ms, bound_s * 1e3, bound_by, only_ms)
    print(f"seed_enum: {mis} mismatches against the native pass and the "
          f"plain version; launches {sed.enumerate_filtered.launches}")
    if mis:
        raise RuntimeError("the seed kernel disagrees with the native pass")
    return row, mis


def cli_worker(argv) -> int:
    """One CLI run in a process of its own (a --multiprocessing worker),
    DeviceDP's launches timed with CUDA events; its last line of standard
    output is ``WORKER_STATS=`` and a JSON object."""
    import torch

    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import swipe_device as sd

    events = []
    launch = sd.DeviceDP.launch

    def timed_launch(self, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = launch(self, *a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    sd.DeviceDP.launch = timed_launch
    t0 = time.perf_counter()
    rc = cli_main(argv) or 0
    torch.cuda.synchronize()
    import torch.distributed as dist

    print("WORKER_STATS=" + json.dumps(dict(
        rc=rc, wall_s=round(time.perf_counter() - t0, 3),
        backend=dist.get_backend() if dist.is_initialized() else None,
        k1=sd.banded_swipe_multi.launches,
        busy_s=sum(a.elapsed_time(b) for a, b in events) / 1e3,
        max_memory_allocated=torch.cuda.max_memory_allocated())))
    return rc


def run_workers(argvs, env, timeout=900):
    """cli_worker processes, one per argv, all at once; their stats.  Every
    process is waited for (and killed on a failure or the timeout)."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--cli-worker", *a], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    stats = []
    for p, (o, e) in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"a worker exited {p.returncode}: {e[-2000:]}")
        stats.append(json.loads(o.splitlines()[-1].split("=", 1)[1]))
    return stats


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
    ap.add_argument("--blocked-queries", type=int, default=10_000,
                    help="queries of the blastp -b run (FASTA)")
    ap.add_argument("--dmnd-queries", type=int, default=2_000,
                    help="queries of the blastp -b run from a .dmnd")
    ap.add_argument("--mp-queries", type=int, default=2_000,
                    help="queries of the --multiprocessing run")
    ap.add_argument("--iterate-queries", type=int, default=1_000,
                    help="queries of the blastp --iterate run")
    ap.add_argument("--global-queries", type=int, default=1_000,
                    help="queries of the blastp -g 10 run")
    ap.add_argument("--cluster-seqs", type=int, default=800,
                    help="sequences of the cluster run (realign takes its "
                         "output)")
    ap.add_argument("--linclust-seqs", type=int, default=40,
                    help="sequences of the linclust run")
    ap.add_argument("--deepclust-seqs", type=int, default=400,
                    help="sequences of the deepclust run")
    ap.add_argument("--mcl-small", type=int, default=200,
                    help="sequences in small families beside MCL_FAMILIES")
    ap.add_argument("--blastn-reads", type=int, default=200,
                    help="reads of the blastn run")
    ap.add_argument("--coord-queries", type=int, default=2_000,
                    help="queries of the --coordinator runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mask-only", action="store_true",
                    help="only tantan's scan on the card (build, parity "
                         "against the native scan, timing) at the "
                         "benchmark's block")
    ap.add_argument("--enum-only", action="store_true",
                    help="only the DB-side seed enumeration on the card "
                         "(build, parity against the native pass, timing) "
                         "at the benchmark's block")
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

    if args.mask_only:
        from diamond_tpu_torch.ops import _cuda
        from diamond_tpu_torch.ops import tantan_device as td

        phase("build")
        t0 = time.perf_counter()
        td._kernel()
        print(f"nvcc tantan.cu: {time.perf_counter() - t0:.2f} s")
        for line in _cuda.build_log.get("tantan", "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas tantan:", line.strip())
        phase("tantan's scan on the card")
        row, err = mask_entry(args.seed, sm_clock_mhz, kind, name_power)
        print(json.dumps({"kernels": [dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "kernel_only_ms"),
            row), name="tantan_mask", launches=td.tantan_mask.launches,
            max_abs_err=err)]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
        return 0
    if args.enum_only:
        from diamond_tpu_torch.ops import _cuda
        from diamond_tpu_torch.ops import seed_enum_device as sed

        phase("build")
        t0 = time.perf_counter()
        sed._kernel()
        print(f"nvcc seed_enum.cu: {time.perf_counter() - t0:.2f} s")
        for line in _cuda.build_log.get("seed_enum", "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas seed_enum:", line.strip())
        phase("the DB-side seed enumeration on the card")
        row, err = enum_entry(args.seed, sm_clock_mhz, kind, name_power)
        print(json.dumps({"kernels": [dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "kernel_only_ms"),
            row), name="seed_enum", launches=sed.enumerate_filtered.launches,
            max_abs_err=err)]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
        return 0
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
    from diamond_tpu_torch.benchmark import FULL as BENCH
    from diamond_tpu_torch.cluster import mcl as pmcl
    from diamond_tpu_torch.constants.alphabet import encode
    from diamond_tpu_torch.ops import _cuda
    from diamond_tpu_torch.ops import stage12_device as d1m
    from diamond_tpu_torch.ops import stage2_device as s2
    from diamond_tpu_torch.ops import swipe3_device as s3
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops import seed_enum_device as sed
    from diamond_tpu_torch.ops import tantan_device as tmd
    from diamond_tpu_torch.ops import traceback_device as tbd
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix
    from diamond_tpu_torch.utils import log as plog

    # -- 2. build -----------------------------------------------------------
    phase("build")
    kernels = ("banded_swipe", "swipe3", "full_swipe", "uniform_swipe",
               "swipe_sweep", "stage2", "stage12", "stage12_join",
               "banded_traceback", "tantan", "seed_enum")
    t0 = time.perf_counter()
    _cuda.build(kernels)  # one nvcc per source, all at once
    print(f"nvcc {', '.join(k + '.cu' for k in kernels)} in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in _cuda.build_log.get(k, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {k}:", line.strip())
    sd._k1(), s3._k3(), sd._k2(), sud._k4(), sd._k5(), s2._k6(), d1m._k_d1()
    d1m._k_join(), tbd._d4(), sed._kernel()
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

    def k4_name(band):  # the warp path's errors, and the wide walk's
        return "k4" if band <= sud.MAX_WARP_BAND else "k4w"

    for q, bias, jobs in uniform_batches(args.seed + 4):
        kb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda")
        pb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda",
                                kernel=sud.banded_swipe_uniform_cuda_plain)
        k4_mis += np_diff(k4_name(kb[3]["band"]), kb[:3], pb[:3])
        ref = sud.host_as_uniform(banded_swipe_batch_np(
            q, bias, jobs, m.matrix32, m.gap_open, m.gap_extend), jobs)
        k4_host_mis += sum(a != b for a, b in zip(
            uniform_best_effort(kb, len(jobs)), ref))
        k4_host_mis += sum(a != b for a, b in zip(  # the direct DP route
            pext._device_dp_scores(q, bias, jobs, m), ref))
        k4_bands.append(kb[3]["band"])
        k4_jobs += len(jobs)
    # thousands of targets in one call (full-matrix jobs: the wide walk)
    q, bias, jobs = uniform_many(args.seed + 16)
    kb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda")
    pb = sud.uniform_scores(q, bias, m.matrix32, jobs, go, ge, "cuda",
                            kernel=sud.banded_swipe_uniform_cuda_plain)
    k4_mis += np_diff(k4_name(kb[3]["band"]), kb[:3], pb[:3])
    k4_host_mis += sum(a != b for a, b in zip(
        uniform_best_effort(kb, len(jobs)),
        sud.host_as_uniform(banded_swipe_batch_np(
            q, bias, jobs, m.matrix32, m.gap_open, m.gap_extend), jobs)))
    k4_bands.append(kb[3]["band"])
    k4_jobs += len(jobs)
    # at the kernel's interface: bands of no power of two, masks that are
    # no prefix, both paths, and the wide walk's edges
    k4_direct = []
    cases = [(str(c[0]), *c) for c in uniform_direct_cases(args.seed + 12)]
    for label, band, *arrs in cases + uniform_edge_cases(args.seed + 30):
        t_idx, bm, prof = (torch.from_numpy(a).cuda() for a in arrs)
        rows = sud.profile_rows(prof) if band > sud.MAX_WARP_BAND else None
        k4_direct.append((label, band, tuple(t_idx.shape),
                          sud.uniform_shape(band, rows[1] - rows[0])
                          if rows else sud.uniform_shape(band),
                          "warp" if rows is None else "wide"))
        plain = sud.banded_swipe_uniform_cuda_plain(t_idx, bm, prof, go, ge)
        k4_mis += diff(k4_name(band),
                       sud.banded_swipe_uniform_cuda(t_idx, bm, prof, go, ge),
                       plain)
        # the live rows from the host, as the packing hands them over
        k4_mis += diff(k4_name(band), sud.banded_swipe_uniform_cuda(
            t_idx, bm, prof, go, ge, rows=sud.profile_rows(arrs[2])), plain)
    print(f"K4 parity: {k4_jobs} jobs, bands {k4_bands}, and at the "
          f"kernel's interface (case, band, [B, T], (rows a lane, strips), "
          f"path) {k4_direct}; kernel vs plain mismatches {k4_mis}, kernel "
          f"vs host DP mismatches {k4_host_mis}")
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
    # D1's whole fused pass on seeded joins: the card against the plain
    # version (on the CPU) and the native host pass, whole and in chunks
    d1j_mis = d1j_rows = d1j_calls = 0
    max_err["d1j"] = 0
    for k, (label, kw) in enumerate(STAGE12_FUSED_EDGES):
        c = stage12_fused_case(args.seed + 43 + k, **kw)
        want = stage12_native_rows(native, c)
        plain = stage12_fused_rows(
            d1m.Stage12Device(c["matrix32"], device="cpu"), c)
        for cap in (d1m.JOIN_PAIR_CAP, 3000):
            d1m.reset_dispatch_stats()
            got = stage12_fused_rows(
                d1m.Stage12Device(c["matrix32"], device="cuda"), c, cap=cap)
            d1j_calls += d1m.dispatch_count
            for ref in (want, plain):
                if got.shape != ref.shape:
                    d1j_mis += max(len(got), len(ref))
                else:
                    d1j_mis += int((got != ref).any(axis=1).sum())
                    if len(got):
                        max_err["d1j"] = max(max_err["d1j"], int(
                            np.abs(got - ref).max()))
        d1j_rows += len(want)
    print(f"D1 fused pass parity: {len(STAGE12_FUSED_EDGES)} seeded joins "
          f"({', '.join(label for label, _ in STAGE12_FUSED_EDGES)}), whole "
          f"and in chunks of 3,000 pairs ({d1j_calls} calls), {d1j_rows} "
          f"rows; rows differing from the plain version's or the native "
          f"pass's: {d1j_mis}")
    if d1j_mis or not d1j_rows:
        raise RuntimeError("D1's fused pass disagrees with its references")

    # D4: the traceback refill, on seeded jobs (every band class edge, bias
    # on and off, gaps, d0 < 0, targets cut short, score-0 jobs, jobs that
    # start below diagonal -(t_len - 1)), whole and with the planes sliced
    # small, against its plain version on the card, the native host call
    # and the numpy oracle
    phase("kernel parity: D4")
    d4_mis = d4_nat = d4_orc = d4_low = d4_nat_wrong = d4_jobs = 0
    d4_planes = d4_cells = 0
    d4_calls = []
    for k, kw in enumerate((dict(), dict(bands=(1, 31, 32, 33, 512)),
                            dict(n_queries=8, max_len=1500))):
        c = tb_jobs(args.seed + 50 + k, **kw)
        x, jobs_np = tb_tensors(c, "cuda")
        want = tbd.banded_traceback_multi_plain(*x, m32, go, ge)
        for budget in (tbd.PLANE_BUDGET_BYTES, 1 << 16):
            plan = tbd.tb_plan(jobs_np, budget)
            got = tbd.banded_traceback_multi(*x, m32, go, ge, plan=plan)
            torch.cuda.synchronize()
            if [g.shape for g in got] != [w.shape for w in want]:
                d4_mis += len(jobs_np)
            else:
                d4_mis += diff("d4", got, want)
            d4_calls.append((len(plan.slices), len(plan.launches)))
        # the planes themselves, from the kernel's scratch
        plan = tbd.tb_plan(jobs_np)
        bufs = tbd.tb_buffers(plan, "cuda")
        o3 = torch.zeros((len(jobs_np), 3), dtype=torch.int64, device="cuda")
        o12 = torch.zeros((len(jobs_np), 12), dtype=torch.int64,
                          device="cuda")
        tbd.tb_launch(*x, m32, go, ge, plan, bufs, o3, o12)
        code = tbd._fill_plain(*x, m32.long(), go, ge)[3].cpu().numpy()
        d4_planes += tb_plane_mismatches(bufs["planes"].cpu().numpy(), plan,
                                         jobs_np, code)
        d4_cells += int(band_cells(jobs_np[:, 4], jobs_np[:, 1],
                                   jobs_np[:, 5], jobs_np[:, 6]).sum())
        r = tbd.tb_multi_device(*[c[k] for k in TB_KEYS], m.matrix32, go, ge,
                                "cuda")
        nat, orc, low, wrong = tb_check(c, r, m.matrix32, m.gap_open,
                                        m.gap_extend)
        d4_nat, d4_orc, d4_low = d4_nat + nat, d4_orc + orc, d4_low + low
        d4_nat_wrong += wrong
        d4_jobs += len(jobs_np)
    print(f"D4 parity: {d4_jobs} jobs in 3 sets, each with plane slices of "
          f"1 GB and 64 KB ((slices, launches): {d4_calls}); kernel vs "
          f"plain mismatches {d4_mis}; "
          f"plane cells of the live columns differing from the plain "
          f"fill's ({d4_cells} in-query band cells) {d4_planes}; "
          f"against the native host call {d4_nat}; {d4_low} jobs starting "
          f"below diagonal -(t_len - 1) against the numpy oracle {d4_orc} "
          f"(the native call differs from the oracle on {d4_nat_wrong})")
    if d4_mis or d4_nat or d4_orc or d4_planes:
        raise RuntimeError("D4 disagrees with its references")

    # -- 4-9. the paths, each with every launch count set to 0 just before --
    wrappers = dict(k1=sd.banded_swipe_multi, k3=s3.banded_swipe3,
                    k2=sd.full_swipe, k4=sud.banded_swipe_uniform_cuda,
                    k5=sd.swipe_sweep, k6=s2.stage2_filter,
                    d1=d1m.stage12_pairs, d1j=d1m.stage12_join,
                    d4=tbd.banded_traceback_multi, mask=tmd.tantan_mask,
                    seed=sed.enumerate_filtered)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
        spy_d1.launches = spy_d1j.launches = 0

    def launch_counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    def dp_launched(counts):
        """Whether a run launched a DP kernel: the masking and the seed
        kernels launch wherever the device is a card, on the host DP route
        too."""
        return any(v for k, v in counts.items() if k not in ("mask", "seed"))

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
    stage12_join = d1m.stage12_join
    k1_low = [0]  # K1 jobs of a run whose band starts below -(t_len - 1)
    # D4's jobs of a run: those starting below -(t_len - 1), failed walks;
    # the native traceback calls' failed walks, and the jobs within D4's
    # band cap that the traceback round still refilled on the host
    tb_count = dict(d4_low=0, d4_failed=0, native_failed=0, native_in_cap=0)
    in_tb_round = [False]
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

    tb_multi_device = tbd.tb_multi_device
    tb_multi_results = pwave.tb_multi_results
    tb_multi = pwave._tb_multi

    def spy_d4(*a):
        """D4 as the wave's traceback round calls it: low-start jobs and
        failed walks counted, the largest call's arguments kept."""
        t_len, d0 = a[7], a[8]
        tb_count["d4_low"] += int((d0 < -(t_len - 1)).sum())
        if len(t_len) > captured.get("d4", (-1,))[0]:
            captured["d4"] = (len(t_len), a)
        r = tb_multi_device(*a)
        tb_count["d4_failed"] += int((r[1][:, 11] == 0).sum())
        return r

    def spy_native_tb(*a):
        """The native fill+walk (round 1's fused call on the host route,
        the traceback round's refill): failed walks counted, and in the
        traceback round the jobs D4 would take."""
        if in_tb_round[0]:
            tb_count["native_in_cap"] += int(tbd.jobs_fit_device(
                a[7], a[9]).sum())
        r = tb_multi_results(*a)
        if r is not None:
            tb_count["native_failed"] += int((r[1][:, 11] == 0).sum())
        return r

    def spy_tb_multi(items, mat, state, device=None):
        in_tb_round[0] = device is not None and device.device is not None
        try:
            return tb_multi(items, mat, state, device)
        finally:
            in_tb_round[0] = False

    def spy_d1(*a, **kw):
        """D1's pair kernel as Stage12Device would launch it, timed; no
        search path does.  The wrapper counts its launches on the name its
        module binds, so they land here and drive() hands them back."""
        return timed(stage12_pairs)(*a, **kw)

    def spy_d1j(*a, **kw):
        """D1's fused pass as Stage12Device.join_rows calls it, timed; the
        largest call's arguments and rows kept.  Its launches land here as
        spy_d1's do."""
        out = timed(stage12_join)(*a, **kw)
        if kw["counts"][1] > captured.get("d1j", (-1,))[0]:
            captured["d1j"] = (kw["counts"][1], a, kw["counts"], out)
        return out

    def spy_k3(strands, jobs, *a):
        n = sum(len(t) * (d1 - d0) for _, t, d0, d1 in jobs)
        if n > captured.get("k3", (-1,))[0]:
            captured["k3"] = (n, (strands, jobs))
        return scores3(strands, jobs, *a, kernel=timed(s3.banded_swipe3))

    def spy_k2(self, queries, tblock, t_order):
        captured["k2"] = (0, (queries, tblock, t_order))
        return dispatch_block(self, queries, tblock, t_order,
                              kernel=timed(sd.full_swipe))

    rounds_log = []  # the Pipelines of a run (combos, rounds)
    pipe_search = ppipe.Pipeline.search

    def spy_search(self):
        """One Pipeline (a block combo, an --iterate or cluster round): its
        sensitivity, queries searched, targets, K1 jobs and seconds."""
        t0 = time.perf_counter()
        jobs0 = plog.prof_calls.get("ext.device_jobs", 0)
        try:
            return pipe_search(self)
        finally:
            skip = self.query_skip
            rounds_log.append(dict(
                sens=self.cfg.sensitivity
                + ("_lin" if self.cfg.lin_stage1_target else ""),
                queries=len(self.q) - (0 if skip is None
                                       else int(np.count_nonzero(skip))),
                targets=len(self.t),
                k1_jobs=plog.prof_calls.get("ext.device_jobs", 0) - jobs0,
                s=round(time.perf_counter() - t0, 3)))

    round_patch = [(ppipe.Pipeline, "search", spy_search)]

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
        tb_count.update(d4_low=0, d4_failed=0, native_failed=0,
                        native_in_cap=0)
        tbd.reset_dispatch_stats()
        zero_counts()
        plog.prof_calls.clear()
        plog.prof.clear()
        events.clear()
        rounds_log.clear()
        torch.cuda.reset_peak_memory_stats()
        try:
            with Patched((sd.DeviceDP, "run_many", spy_k1),
                         (sd.DeviceDP, "launch", timed(launch)),
                         (s3, "swipe3_scores", spy_k3),
                         (sd.FullSweep, "dispatch_block", spy_k2),
                         (d1m, "stage12_pairs", spy_d1),
                         (d1m, "stage12_join", spy_d1j),
                         (tbd, "tb_multi_device", spy_d4),
                         (tbd, "tb_launch", timed(tbd.tb_launch)),
                         (tbd, "tb_compact", timed(tbd.tb_compact)),
                         (pwave, "tb_multi_results", spy_native_tb),
                         (pwave, "_tb_multi", spy_tb_multi),
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
        stage12_join.launches += spy_d1j.launches
        spy_d1.launches = spy_d1j.launches = 0
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
            host_tb_jobs=plog.prof_calls.get("ext.tb_jobs", 0),
            tb_card_jobs=plog.prof_calls.get("ext.tb_card_jobs", 0),
            tb_card_cells=plog.prof_calls.get("ext.tb_card_cells", 0),
            d4_calls=tbd.dispatch_count,
            d4_wait_s=sum(plog.prof.get("ext.tb_card_" + k, 0.0) for k in
                          ("up", "kernel", "back", "results")),
            d4_low_start_jobs=tb_count["d4_low"],
            d4_failed_walks=tb_count["d4_failed"],
            native_failed_walks=tb_count["native_failed"],
            native_refill_in_cap=tb_count["native_in_cap"],
            k1_low_start_jobs=k1_low[0],
            host_dp_low_start_jobs=host_dp[0], host_dp_jobs=host_dp[1],
            s12_pairs=plog.prof_calls.get("seed.s12_pairs", 0),
            s12_dispatches=d1m.dispatch_count,
            s12_kernel_pairs=d1m.dispatch_pairs,
            s12_wait_s=sum(plog.prof.get("seed.s12_" + k, 0.0)
                           for k in ("upload", "card", "rows")),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        phases = sorted(plog.prof.items(), key=lambda kv: -kv[1])[:10]
        print(f"{route}: " + json.dumps(res))
        print(f"{route} host phases (s): "
              + json.dumps({k: round(v, 3) for k, v in phases}))
        res["phases"] = dict(plog.prof)
        res["rounds"] = list(rounds_log)
        return res, data


    def report(route, res, n, what):
        print(f"{route}: {res['lines']} lines, sha {res['sha']}, "
              f"{res['wall_s']:.2f} s, {n / res['wall_s']:.1f} {what}/s on "
              f"{kind} ({name_power}); K1 launches {res['launches']['k1']}; "
              f"device busy {res['device_busy_s']:.4f}"
              f" s, idle share {res['idle_share']:.4f}")

    def both(name, argv, n, what, kernel, patches=()):
        """The path on the card route and on the host route (DIAMOND_TPU_
        TORCH_DEVICE_DP=0): equal outputs, ``kernel`` launched on the card
        route (None: a path that launches no kernel, as -g)."""
        out = {}
        for route in ("card", "host"):
            res, data = drive(f"{name} {route}", argv,
                              os.path.join(tmp, f"{name}_{route}.out"),
                              host=route == "host", patches=patches)
            report(f"{name} {route}", res, n, what)
            out[route] = (res, data)
        card, host = out["card"][0], out["host"][0]
        if out["card"][1] != out["host"][1]:
            raise RuntimeError(f"{name}: card-DP and host-DP outputs differ")
        if kernel and card["launches"][kernel] == 0:
            raise RuntimeError(f"{name}: the path never launched {kernel}")
        if dp_launched(host["launches"]):
            raise RuntimeError(f"{name}: the host route launched a kernel")
        if card["launches"]["d1"] or card["launches"]["d1j"]:
            raise RuntimeError(f"{name}: stage 1/2 went to the card unasked")
        print(f"{name}: outputs identical ({card['lines']} lines, sha "
              f"{card['sha']}); launches {card['launches']}")
        return out

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
        paths["k1"] = paths["d4"] = paths["mask"] = out["card"][0]
        masks = [out[r][0]["launches"]["mask"] for r in ("card", "host")]
        print(f"blastp: tantan_mask launches (card route, host route) "
              f"{masks}")
        if masks != [2, 2]:  # the DB block and the query block
            raise RuntimeError("blastp did not mask its two blocks on the "
                               "card")
        k1_batch = captured["k1"]  # K1 is timed on blastp's largest batch
        d4_call = captured["d4"]   # and D4 on its largest traceback call
        card, host = out["card"][0], out["host"][0]
        cph, hph = card["phases"], host["phases"]
        print(f"blastp traceback round: card route ext.tb_multi "
              f"{cph.get('ext.tb_multi', 0):.4f} s, of it ext.tb_card "
              f"{cph.get('ext.tb_card', 0):.4f} s (up "
              f"{cph.get('ext.tb_card_up', 0):.4f}, kernels with the sync "
              f"{cph.get('ext.tb_card_kernel', 0):.4f}, ops back "
              f"{cph.get('ext.tb_card_back', 0):.4f}, results "
              f"{cph.get('ext.tb_card_results', 0):.4f}; D4: {card['d4_calls']} "
              f"calls, {card['tb_card_jobs']} jobs, {card['tb_card_cells']} "
              f"cells, {card['launches']['d4']} launches; host refill "
              f"{card['host_tb_jobs']} jobs of bands above the cap, "
              f"{card['native_refill_in_cap']} within it); K1 ext.device_dp "
              f"{cph.get('ext.device_dp', 0):.4f} s; host route "
              f"ext.score_multi {hph.get('ext.score_multi', 0):.4f} s "
              f"(round 1's fused fill and walk), ext.tb_multi "
              f"{hph.get('ext.tb_multi', 0):.4f} s; D4 jobs starting below "
              f"-(t_len - 1) {card['d4_low_start_jobs']}; failed walks: D4 "
              f"{card['d4_failed_walks']}, native {card['native_failed_walks']}"
              f" (card route), native {host['native_failed_walks']} (host "
              f"route); peak card memory {card['max_memory_allocated']} "
              f"bytes (card route), {host['max_memory_allocated']} (host "
              f"route); {kind}, {name_power}")
        if card["launches"]["d4"] == 0 or card["native_refill_in_cap"]:
            raise RuntimeError("blastp: the traceback round did not refill "
                               "every job within the band cap through D4")
        # the third route: stage 1/2 on the card too (D1's fused pass)
        res, data = drive("blastp card-stage12",
                          ["blastp", "-q", qf, "-d", db, "-f", "6"],
                          os.path.join(tmp, "blastp_s12.out"), host=False,
                          stage12=True)
        report("blastp card-stage12", res, n_q, "queries")
        if data != out["card"][1]:
            raise RuntimeError("blastp: stage 1/2 on the card changed the "
                               "output")
        if res["launches"]["d1j"] == 0 or res["launches"]["k1"] == 0:
            raise RuntimeError("blastp card-stage12: D1's fused pass or K1 "
                               "never launched")
        if res["launches"]["d1"]:
            raise RuntimeError("blastp card-stage12: the pair kernel "
                               "launched on the fused route")
        print(f"blastp card-stage12: output identical (sha {res['sha']}); "
              f"D1 fused pass launches {res['launches']['d1j']} "
              f"(Stage12Device.join_rows chunks {res['s12_dispatches']}), "
              f"pairs {res['s12_kernel_pairs']}, join_rows wall "
              f"{res['s12_wait_s']:.4f} s")
        paths["d1j"] = res
        for route, r in (("card", out["card"][0]), ("host", out["host"][0]),
                         ("card-stage12", res)):
            ph = {k: round(r["phases"].get(k, 0.0), 4) for k in (
                "seed.stage12", "seed.s12_native", "seed.s12_upload",
                "seed.s12_card", "seed.s12_rows")}
            print(f"blastp {route} stage 1/2 (s, of {r['wall_s']:.2f} s "
                  f"wall): {json.dumps(ph)}; seed.s12_pairs {r['s12_pairs']}")
        ph_c, ph_h = res["phases"], out["card"][0]["phases"]
        print(f"seed.stage12 split on {kind} ({name_power}): card route "
              f"{ph_c.get('seed.stage12', 0.0):.4f} s (upload "
              f"{ph_c.get('seed.s12_upload', 0.0):.4f}, card "
              f"{ph_c.get('seed.s12_card', 0.0):.4f}, rows back "
              f"{ph_c.get('seed.s12_rows', 0.0):.4f}) against the host pass "
              f"{ph_h.get('seed.stage12', 0.0):.4f} s (native "
              f"{ph_h.get('seed.s12_native', 0.0):.4f}); blastp wall "
              f"{res['wall_s']:.2f} s against {out['card'][0]['wall_s']:.2f} s")
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

        # -- 10-15. the search drivers and the clustering commands ----------
        def print_rounds(name, res):
            print(f"{name} Pipelines (sensitivity, queries searched, targets,"
                  f" K1 jobs, s): " + json.dumps(
                      [[r["sens"], r["queries"], r["targets"], r["k1_jobs"],
                        r["s"]] for r in res["rounds"]]))

        def fasta_of(name, sub):
            if len(sub) == len(recs):
                return db
            path = os.path.join(tmp, f"{name}.faa")
            write_fasta(path, sub)
            return path

        phase("blastp -b (blocked search, K1)")
        from diamond_tpu_torch.search.blocked import split_bounds

        lens = np.array([len(x) for _, x in recs])
        bsz = f"{n_letters / 4.5 / 1e9:.9f}"
        cap = int(float(bsz) * 1e9)
        n_b = min(args.blocked_queries, len(recs))
        n_tb, n_qb = (len(split_bounds(lens, cap)),
                      len(split_bounds(lens[:n_b], cap)))
        print(f"-b {bsz} ({cap} letters a block): {n_qb} query blocks of "
              f"{n_b} queries x {n_tb} target blocks")
        if n_tb < 4 or n_qb < 2:
            raise RuntimeError("the block size gives too few blocks")
        qb_f = fasta_of("q_blocked", recs[:n_b])
        out = both("blastp-b", ["blastp", "-q", qb_f, "-d", db, "-b", bsz],
                   n_b, "queries", "k1", patches=round_patch)
        blocked = out["card"][0]
        print_rounds("blastp-b card", blocked)
        print(f"blastp-b: card peak memory {blocked['max_memory_allocated']}"
              f" bytes (torch.cuda.max_memory_allocated)")
        if n_b == n_q:
            print(f"blastp-b: output {'equals' if blocked['sha'] == paths['k1']['sha'] else 'differs from'}"
                  f" the unblocked self-search's (sha {paths['k1']['sha']})")

        phase("blastp -b from a .dmnd (DmndProvider streaming, K1)")
        n_dm = min(args.dmnd_queries, len(recs))
        qdm = fasta_of("q_dmnd", recs[:n_dm])
        out = both("blastp-b-dmnd", ["blastp", "-q", qdm, "-d",
                                     dbp + ".dmnd", "-b", bsz],
                   n_dm, "queries", "k1", patches=round_patch)
        print_rounds("blastp-b-dmnd card", out["card"][0])
        print(f"blastp-b-dmnd: card peak memory "
              f"{out['card'][0]['max_memory_allocated']} bytes")

        phase("blastp --multiprocessing (two worker processes, one card)")
        n_mp = min(args.mp_queries, len(recs))
        qmp = fasta_of("q_mp", recs[:n_mp])
        mp_argv = ["blastp", "-q", qmp, "-d", db, "-b", bsz]
        res_one, one = drive("blastp-mp one process card", mp_argv,
                             os.path.join(tmp, "mp_one.out"), host=False)
        report("blastp-mp one process card", res_one, n_mp, "queries")
        for route in ("card", "host"):
            work = os.path.join(tmp, f"mp_{route}")
            if cli_main(mp_argv + ["--mp-init", "--parallel-tmpdir", work]):
                raise RuntimeError("--mp-init failed")
            env = dict(os.environ)
            env.pop("DIAMOND_TPU_PROF", None)
            if route == "host":
                env["DIAMOND_TPU_TORCH_DEVICE_DP"] = "0"
            t0 = time.perf_counter()
            stats = run_workers(
                [mp_argv + ["--multiprocessing", "--parallel-tmpdir", work,
                            "-o", os.path.join(work, f"out{k}")]
                 for k in range(2)], env)
            wall = time.perf_counter() - t0
            outs = [open(os.path.join(work, f"out{k}"), "rb").read()
                    for k in range(2)
                    if os.path.exists(os.path.join(work, f"out{k}"))]
            k1 = [st["k1"] for st in stats]
            busy = sum(st["busy_s"] for st in stats)
            sha = hashlib.sha256(outs[0]).hexdigest()[:16] if outs else None
            print(f"blastp-mp {route}: 2 workers, {n_mp} queries x "
                  f"{len(recs)} targets, {n_tb} combos; {wall:.2f} s from "
                  f"launch to the last exit, {n_mp / wall:.1f} queries/s on "
                  f"{kind} ({name_power}); per worker: " + json.dumps(stats)
                  + f"; K1 launches {k1}, device busy {busy:.4f} s, idle "
                  f"share {1 - busy / wall:.4f}; {len(outs)} printed the "
                  f"join, sha {sha}")
            if not outs or any(o != one for o in outs):
                raise RuntimeError(f"blastp-mp {route}: the workers' output "
                                   f"differs from one process's")
            if route == "card" and not sum(k1):
                raise RuntimeError("blastp-mp: the workers never launched K1")
            if route == "host" and sum(k1):
                raise RuntimeError("blastp-mp: the host route launched K1")
        print(f"blastp-mp: two workers equal one process on both routes "
              f"(sha {res_one['sha']})")

        phase("blastp --iterate (default cascade, K1)")
        # without self hits, a query moves on to the next round until it
        # finds a homolog (a self-search would end after the first round)
        n_it = min(args.iterate_queries, len(recs))
        out = both("blastp-iterate", ["blastp", "-q",
                                      fasta_of("q_iterate", recs[:n_it]),
                                      "-d", db, "--iterate",
                                      "--no-self-hits"],
                   n_it, "queries", "k1", patches=round_patch)
        for route in ("card", "host"):
            print_rounds(f"blastp-iterate {route}", out[route][0])

        phase("blastp -g 10 (global ranking; its extension on the host DP)")
        n_g = min(args.global_queries, len(recs))
        out = both("blastp-g", ["blastp", "-q", fasta_of("q_g", recs[:n_g]),
                                "-d", db, "-g", "10"], n_g, "queries", None)
        if out["card"][0]["launches"]["k1"]:
            raise RuntimeError("-g launched K1: its ranking pass stops "
                               "before the extension")
        # 1,000 queries against the whole set take the query-indexed route
        paths["seed"] = out["card"][0]
        seeds = [out[r][0]["launches"]["seed"] for r in ("card", "host")]
        print(f"blastp-g: seed_enum launches (card route, host route) "
              f"{seeds}")
        if seeds != [2, 2]:  # one a shape, whatever the DP route
            raise RuntimeError("blastp -g did not enumerate the DB's seeds "
                               "on the card")

        phase("cluster (default cascade, greedy vertex cover, K1)")
        n_cl = min(args.cluster_seqs, len(recs))
        cdb = fasta_of("cluster", recs[:n_cl])
        out = both("cluster", ["cluster", "-d", cdb], n_cl, "sequences",
                   "k1", patches=round_patch)
        for route in ("card", "host"):
            print_rounds(f"cluster {route}", out[route][0])
        reps = {ln.split("\t")[0] for ln in out["card"][1].decode().splitlines()}
        print(f"cluster: {len(reps)} clusters of {n_cl} sequences")
        cl_out = os.path.join(tmp, "cluster_card.out")

        phase("realign of the cluster output, linclust (host code)")
        res, data = drive("realign", ["realign", "-d", cdb, "--clusters",
                                      cl_out],
                          os.path.join(tmp, "realign.out"), host=False)
        report("realign", res, n_cl, "sequences")
        if res["lines"] != n_cl or dp_launched(res["launches"]):
            raise RuntimeError("realign: a line per member, host code only")
        n_lc = min(args.linclust_seqs, len(recs))
        res, data = drive("linclust", ["linclust", "-d",
                                       fasta_of("linclust", recs[:n_lc])],
                          os.path.join(tmp, "linclust.out"), host=False)
        report("linclust", res, n_lc, "sequences")
        print(f"linclust: {len({ln.split(chr(9))[0] for ln in data.decode().splitlines()})}"
              f" clusters of {n_lc} sequences")
        if res["lines"] != n_lc or dp_launched(res["launches"]):
            raise RuntimeError("linclust: a line per sequence, host code "
                               "only")

        phase("deepclust (the cascade at approx-id 0, K1)")
        n_dc = min(args.deepclust_seqs, len(recs))
        out = both("deepclust", ["deepclust", "-d",
                                 fasta_of("deepclust", recs[:n_dc])],
                   n_dc, "sequences", "k1", patches=round_patch)
        print_rounds("deepclust card", out["card"][0])

        phase("cluster --cluster-algo mcl (MCL; its dense step D3 on the card)")
        fams = make_families(MCL_FAMILIES, args.mcl_small, seed=args.seed + 20)
        mdb = os.path.join(tmp, "mcl.faa")
        write_fasta(mdb, fams)
        print(f"MCL set: {len(fams)} sequences, families of "
              f"{list(MCL_FAMILIES)} members and {args.mcl_small} sequences "
              f"in families of 1-6, 80-97 % identity to their roots")
        mcl_step = pmcl.mcl_dense_torch
        d3_in, d3_calls = [], []

        def spy_d3(M, *a):
            """D3 as mcl_cluster calls it: each input kept, each call timed
            to its result on the host; the step counts its launches on the
            name its module binds, so they land here."""
            d3_in.append((M.copy(), a))
            t0 = time.perf_counter()
            r = mcl_step(M, *a)
            d3_calls.append((len(M), time.perf_counter() - t0))
            return r

        mcl_out = {}
        for route in ("card", "host"):
            d3_in.clear(), d3_calls.clear()
            spy_d3.launches = 0
            res, data = drive(f"cluster-mcl {route}",
                              ["cluster", "-d", mdb, "--cluster-algo", "mcl"],
                              os.path.join(tmp, f"mcl_{route}.out"),
                              host=route == "host", patches=round_patch + [
                                  (pmcl, "mcl_dense_torch", spy_d3)])
            report(f"cluster-mcl {route}", res, len(fams), "sequences")
            res["d3"] = (spy_d3.launches, list(d3_calls), list(d3_in))
            print(f"cluster-mcl {route}: D3 launches {spy_d3.launches}, "
                  f"calls (m, s) " + json.dumps([(n, round(t, 4))
                                                 for n, t in d3_calls]))
            mcl_out[route] = (res, data)
        card, host = mcl_out["card"][0], mcl_out["host"][0]
        if mcl_out["card"][1] != mcl_out["host"][1]:
            raise RuntimeError("cluster-mcl: card-DP and host-DP outputs "
                               "differ")
        n_big = sum(s >= pmcl.JAX_MIN_COMPONENT for s in MCL_FAMILIES)
        if not card["launches"]["k1"] or dp_launched(host["launches"]):
            raise RuntimeError("cluster-mcl: K1 on the card route only")
        if card["d3"][0] < n_big or host["d3"][0] < n_big:
            raise RuntimeError(f"cluster-mcl: D3 launched fewer than "
                               f"{n_big} times")
        sizes_out = sorted(collections.Counter(
            ln.split("\t")[0] for ln in
            mcl_out["card"][1].decode().splitlines()).values())[::-1]
        print(f"cluster-mcl: outputs identical (sha {card['sha']}); "
              f"largest clusters {sizes_out[:8]}")
        paths["d3"] = dict(launches={"d3": card["d3"][0]})
        d3_mats = card["d3"][2]

        # -- 16-22. the last modules ported: seg, custom matrices, the seed
        # index, the tool commands, blastn, --mesh and several processes --
        phase("blastp --masking seg (K1)")
        qf = os.path.join(tmp, "q.faa")  # the main path's queries
        out = both("blastp-seg", ["blastp", "-q", qf, "-d", db, "--masking",
                                  "seg"], n_q, "queries", "k1")
        paths["seg"] = out["card"][0]

        phase("blastp --custom-matrix (ALP on the host, K1)")
        custom = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "goldens", "custom_blosum62_20x20.txt")
        from diamond_tpu_torch.stats import alp_exact

        alp_fn, alp_s = alp_exact.gapped_params_exact, []

        def timed_alp(*a, **kw):
            t0 = time.perf_counter()
            try:
                return alp_fn(*a, **kw)
            finally:
                alp_s.append(time.perf_counter() - t0)

        # the ALP cache lives under $TMPDIR (diamond_tpu_alp_<uid>, a name
        # diamond_tpu uses too): an empty directory of this run's own, so
        # the port computes its own parameters
        alp_tmp = os.path.join(tmp, "alp_tmpdir")
        os.makedirs(alp_tmp)
        saved_tmp = (os.environ.get("TMPDIR"), tempfile.tempdir)
        os.environ["TMPDIR"], tempfile.tempdir = alp_tmp, alp_tmp
        try:
            out = both("blastp-custom", ["blastp", "-q", qf, "-d", db,
                                         "--custom-matrix", custom,
                                         "--gapopen", "11", "--gapextend",
                                         "1"], n_q, "queries", "k1",
                       patches=[(alp_exact, "gapped_params_exact",
                                 timed_alp)])
        finally:
            if saved_tmp[0] is None:
                os.environ.pop("TMPDIR", None)
            else:
                os.environ["TMPDIR"] = saved_tmp[0]
            tempfile.tempdir = saved_tmp[1]
        print(f"custom-matrix ALP: {len(alp_s)} run(s) of "
              f"gapped_params_exact, {sum(alp_s):.2f} s (host), cache in an "
              f"empty TMPDIR of this run")
        if len(alp_s) != 1:
            raise RuntimeError("--custom-matrix: the ALP must run once, on "
                               "the first route, and be read from the cache "
                               "on the second")
        paths["custom"] = out["card"][0]

        phase("makeidx, then blastp --target-indexed (K1)")
        idx_db = os.path.join(tmp, "idx.faa")
        write_fasta(idx_db, recs)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["makeidx", "-d", idx_db])
        t_idx = time.perf_counter() - t0
        print(f"makeidx: {len(recs)} sequences in {t_idx:.2f} s, "
              f"{os.path.getsize(idx_db + '.seed_idx')} bytes")
        if rc:
            raise RuntimeError("makeidx failed")
        out = both("blastp-target-indexed", ["blastp", "-q", qf, "-d", idx_db,
                                             "--target-indexed"],
                   n_q, "queries", "k1")
        if out["card"][0]["sha"] != paths["k1"]["sha"]:
            raise RuntimeError("--target-indexed changed blastp's output")
        print(f"blastp-target-indexed: sha {out['card'][0]['sha']} equals "
              f"the unindexed self-search's")

        phase("tool commands (host code; test launches K1)")
        fq = os.path.join(tmp, "set.fq")
        write_fastq(fq, recs[:2000])
        dna_refs, dna_reads = make_dna(10, 1_000, 20, 400, 600,
                                       seed=args.seed + 30)
        pairs_f = os.path.join(tmp, "pairs.fna")
        write_fasta(pairs_f, [x for k in range(10)
                              for x in (dna_refs[k], dna_reads[k])])
        tool_runs = (
            ("getseq", ["getseq", "-d", db, "-o", "FILE"]),
            ("random-seqs", ["random-seqs", "-d", db, "-n", "100", "-o",
                             "FILE"]),
            ("mask", ["mask", "-q", db, "-o", "FILE"]),
            ("fastq2fasta", ["fastq2fasta", "-q", fq, "-o", "FILE"]),
            ("reverse", ["reverse", "-q", db, "-o", "FILE"]),
            ("hashseqs", ["hashseqs", "-q", db]),
            ("split", ["split", "-q", db, "--chunk-size",
                       f"{n_letters / 3.5 / 1e9:.9f}", "--prefix",
                       os.path.join(tmp, "vol")]),
            ("listseeds", ["listseeds", "-d", db, "-n", "20"]),
            ("smith-waterman", ["smith-waterman", "-q", pairs_f]),
            ("info", ["info"]),
            ("test", ["test"]),
        )
        import gzip

        for name, argv in tool_runs:
            zero_counts()
            target = os.path.join(tmp, f"tool_{name}.out")
            argv = [target if a == "FILE" else a for a in argv]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            wall = time.perf_counter() - t0
            data = (open(target, "rb").read() if target in argv
                    else buf.getvalue().encode())
            if name == "split":
                vols = sorted(f for f in os.listdir(tmp)
                              if f.startswith("vol"))
                data = b"".join(gzip.open(os.path.join(tmp, f)).read()
                                for f in vols)
                if len(vols) < 3:
                    raise RuntimeError("split wrote too few volumes")
            counts = launch_counts()
            print(f"tool {name}: {wall:.2f} s, {len(data)} bytes, sha "
                  f"{hashlib.sha256(data).hexdigest()[:16]}; launches "
                  f"{counts}")
            if rc or not data:
                raise RuntimeError(f"{name} exited {rc} or wrote nothing")
            if name == "info" and kind not in data.decode():
                raise RuntimeError("info does not name the card")
            if name == "test":
                if data != b"Self test OK.\n" or counts["k1"] == 0:
                    raise RuntimeError("test failed or never launched K1")
                paths["test"] = dict(launches=counts)
            elif dp_launched(counts):
                raise RuntimeError(f"{name} launched a kernel")

        phase("blastn (host DP with traceback, as in the reference)")
        dna_refs, dna_reads = make_dna(10, 100_000, args.blastn_reads, 500,
                                       3000, subst=(0.01, 0.05),
                                       indels_per_kb=1.0,
                                       seed=args.seed + 31)
        refs_f = os.path.join(tmp, "dna_refs.fna")
        reads_f = os.path.join(tmp, "dna_reads.fna")
        write_fasta(refs_f, dna_refs)
        write_fasta(reads_f, dna_reads)
        print(f"blastn set: {len(dna_reads)} reads of 500-3000 nt "
              f"({sum(len(x) for _, x in dna_reads)} nt), both strands, of "
              f"10 random 100 kb sequences, 1-5 % substitutions, ~1 indel "
              f"per kb")
        res, data = drive("blastn", ["blastn", "-q", reads_f, "-d", refs_f],
                          os.path.join(tmp, "blastn.out"), host=False)
        report("blastn", res, len(dna_reads), "reads")
        hit = dna_source_hits(data.decode().splitlines())
        print(f"blastn: {len(hit)}/{len(dna_reads)} reads hit their source "
              f"on the right strand; launches {res['launches']}")
        if len(hit) < 0.95 * len(dna_reads):
            raise RuntimeError("fewer than 95% of the DNA reads hit their "
                               "source on the right strand")
        if dp_launched(res["launches"]):
            raise RuntimeError("blastn launched a kernel: its DP is host code")

        phase("blastp --mesh 1 (the sharded DeviceDP, K1)")
        sharded_calls = [0]
        launch_sharded = sd.DeviceDP._launch_sharded

        def spy_sharded(self, p):
            sharded_calls[0] += 1
            return launch_sharded(self, p)

        res, data = drive("blastp-mesh1", ["blastp", "-q", qf, "-d", db,
                                           "--mesh", "1"],
                          os.path.join(tmp, "mesh1.out"), host=False,
                          patches=[(sd.DeviceDP, "_launch_sharded",
                                    spy_sharded)])
        report("blastp-mesh1", res, n_q, "queries")
        if res["sha"] != paths["k1"]["sha"] or not sharded_calls[0] \
                or not res["launches"]["k1"]:
            raise RuntimeError("blastp --mesh 1: output changed, or K1 did "
                               "not run through the sharded DeviceDP")
        print(f"blastp-mesh1: sha {res['sha']} equals the self-search's; "
              f"{sharded_calls[0]} sharded batches, K1 launches "
              f"{res['launches']['k1']}")
        paths["mesh1"] = res

        phase("blastp --swipe --mesh 1 (K4 on the mesh's shard)")
        qsw = os.path.join(tmp, "q_swipe.faa")
        k4_fn = sud.banded_swipe_uniform_cuda
        k4_timed = timed(k4_fn)
        k4_split = {"warp": 0, "wide": 0}
        k4_big = {"cells": 0}
        pack_uniform = sud.pack_uniform_batch
        k4_letters = [0]  # the targets' letters of the call being packed

        def k4_pack(query, bias, matrix32, jobs):
            k4_letters[0] = sum(len(t) for t, _, _ in jobs)
            return pack_uniform(query, bias, matrix32, jobs)

        def k4_in(t_idx, band_mask, prof_t, go_, ge_, rows=None):
            # the real wrapper adds its launches to this stand-in's count
            n0 = k4_in.launches
            out = k4_timed(t_idx, band_mask, prof_t, go_, ge_, rows=rows)
            wide = prof_t.shape[1] - t_idx.shape[1] > sud.MAX_WARP_BAND
            k4_split["wide" if wide else "warp"] += k4_in.launches - n0
            # the largest launch by matrix cells: the query's live rows
            # (given by the packing) times the targets' letters; its inputs
            # kept by reference, with no reduction or sync in the run
            cells = (rows[1] - rows[0]) * k4_letters[0] if rows else 0
            if wide and cells > k4_big["cells"]:
                k4_big.update(cells=cells, t_idx=t_idx, band_mask=band_mask,
                              prof_t=prof_t)
            return out

        k4_in.launches = 0
        k4_c = sud._k4()
        k4_each = []  # (band, B, T, rows a lane, strips, events) a launch

        def k4_launch(R, strips, t_ptr, bm_ptr, prof_ptr, B, T, band, *rest):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            err = k4_c(R, strips, t_ptr, bm_ptr, prof_ptr, B, T, band, *rest)
            ev[1].record()
            k4_each.append((band, B, T, R, strips, ev))
            return err

        res, data = drive("blastp-swipe-mesh1", ["blastp", "-q", qsw, "-d", db,
                                                 "--swipe", "--mesh", "1"],
                          os.path.join(tmp, "swipe_mesh1.out"), host=True,
                          patches=[(sud, "banded_swipe_uniform_cuda", k4_in),
                                   (sud, "pack_uniform_batch", k4_pack),
                                   (sud, "_k4", lambda: k4_launch)])
        # the launches alone (events around each C launch), by path and by
        # class (band, columns, rows a lane, strips)
        k4_cls = collections.defaultdict(lambda: [0, 0, 0.0])
        for band, B, T, R, strips, ev in k4_each:
            c = k4_cls[(band, T, R, strips)]
            c[0] += 1
            c[1] += B
            c[2] += ev[0].elapsed_time(ev[1])
        k4_only = {p: sum(v[2] for k, v in k4_cls.items()
                          if (k[0] > sud.MAX_WARP_BAND) == (p == "wide"))
                   for p in ("warp", "wide")}
        top = sorted(k4_cls.items(), key=lambda kv: -kv[1][2])[:8]
        print(f"blastp-swipe-mesh1: K4 launches alone (ms, events around each "
              f"C launch): {json.dumps({k: round(v, 4) for k, v in k4_only.items()})}"
              f"; the 8 classes (band, columns, rows a lane, strips) that "
              f"take most: " + "; ".join(
                  f"{k}: {n} launches, {b} targets, {ms:.4f} ms"
                  for k, (n, b, ms) in top))
        k4_fn.launches += k4_in.launches
        res["launches"]["k4"] = k4_in.launches
        res["launches"]["k4w"] = k4_split["wide"]
        report("blastp-swipe-mesh1", res, n_sw, "queries")
        k4_busy = res["device_busy_s"]
        sw_cells = sum(len(x) for _, x in recs[:n_sw]) * n_letters
        sw_bound, sw_by = bound(sw_cells, K4W_OPS, 0)
        sw_pre, _ = bound(sw_cells, K45_OPS, 0)
        ph = res["phases"]
        split = {k: ph.get(k, 0.0) for k in ("k4.pack", "k4.upload",
                                             "k4.kernel", "mesh.host_dp")}
        split["rest"] = res["wall_s"] - sum(split.values())
        print(f"blastp-swipe-mesh1: K4 launches {k4_in.launches} (one per "
              f"band and target-length class per query; by path {k4_split}),"
              f" {k4_busy:.4f} s of card time, "
              f"{k4_busy * 1e3 / max(k4_in.launches, 1):.4f} ms a "
              f"launch on {kind} ({name_power}); the path's {sw_cells} "
              f"matrix cells at {K4W_OPS} int32 ops a cell bound it at "
              f"{sw_bound:.4f} ms ({sw_by}; {sw_pre:.4f} ms at {K45_OPS}, "
              f"before DPX; the padded classes walk more); "
              f"wall {res['wall_s']:.4f} s split (s): "
              f"{json.dumps({k: round(v, 4) for k, v in split.items()})} "
              f"(packing, upload, K4 with the sync on its outputs, the host "
              f"DP of bands above {sud.MAX_UNIFORM_BAND}, the rest); its "
              f"largest launch: {k4_big['cells']} matrix cells; sha "
              f"{res['sha']}")
        if res["sha"] != paths["k2"]["sha"] or not k4_split["wide"]:
            raise RuntimeError("blastp --swipe --mesh 1: output differs from "
                               "--swipe's, or K4's wide-band walk never "
                               "launched")
        paths["swipe-mesh1"] = res

        phase("several processes on the one card (torch.distributed)")
        n_co = min(args.coord_queries, len(recs))
        qco = fasta_of("q_coord", recs[:n_co])
        co_argv = ["blastp", "-q", qco, "-d", db]
        res_one, one = drive("blastp-coord one process", co_argv,
                             os.path.join(tmp, "coord_one.out"), host=False)
        report("blastp-coord one process", res_one, n_co, "queries")
        env = dict(os.environ)
        env.pop("DIAMOND_TPU_PROF", None)
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
        from diamond_tpu_torch.parallel.dist_worker import (free_port,
                                                            spawn_workers)

        for n_ranks, want_backend in ((1, "nccl"), (2, "gloo")):
            port = free_port()
            outs = [os.path.join(tmp, f"coord{n_ranks}_{i}.out")
                    for i in range(n_ranks)]
            t0 = time.perf_counter()
            stats = run_workers(
                [co_argv + ["--coordinator", f"127.0.0.1:{port}",
                            "--num-procs", str(n_ranks), "--proc-id", str(i),
                            "--mesh", str(n_ranks), "-o", outs[i]]
                 for i in range(n_ranks)], env,
                timeout=300)
            wall = time.perf_counter() - t0
            same = [open(o, "rb").read() == one for o in outs]
            print(f"blastp-coord {n_ranks} rank(s), --mesh {n_ranks} (each "
                  f"rank K1 on its shard of every batch, the scores "
                  f"all-gathered): {wall:.2f} s from launch "
                  f"to the last exit; backends "
                  f"{[st['backend'] for st in stats]}; per rank "
                  + json.dumps(stats) + f"; equal to one process: {same}; "
                  f"{kind} ({name_power})")
            if not all(same) or any(st["backend"] != want_backend
                                    for st in stats) \
                    or not all(st["k1"] for st in stats):
                raise RuntimeError(f"blastp-coord {n_ranks}: a rank's output "
                                   f"differs, its backend is not "
                                   f"{want_backend}, or it launched no K1")
        t0 = time.perf_counter()
        outs = spawn_workers(2, n_seqs=1001, env=env, timeout_s=300)
        print(f"dist_worker, 2 ranks on the card: "
              f"{time.perf_counter() - t0:.2f} s; "
              + " | ".join(o.strip().splitlines()[-1] for o in outs))
        if not all("OK" in o and "gloo" in o and "K4 launches 0" not in o
                   for o in outs):
            raise RuntimeError("dist_worker: a rank failed or ran no K4")

    phase("SwipeSweep (diagonal-band full-matrix sweep, K5)")
    letters = [encode(s) for _, s in recs]
    queries5 = [(q, None) for q in letters[:args.sweep_queries]]
    cells = sum(len(q) for q, _ in queries5) * n_letters
    ss = sd.SwipeSweep(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    sd.reset_dispatch_stats()
    plog.prof_calls.pop("sweep.walk_cells", None)
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
          f"{cells} cells (q_len x t_len), "
          f"{plog.prof_calls.get('sweep.walk_cells', 0)} cells walked, "
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
                    alone=None, unit="cell", plain_once=False):
        """Per call: reps calls of the wrapper launched from Python (the
        column of PRs 1-5); kernel only: reps calls of ``alone`` (the
        wrapper on preallocated outputs, where it takes them) replayed
        from one CUDA graph.  ``cells`` units of work (cells, or D1's
        pairs) at ``ops`` int32 operations each.  plain_once: the plain
        version's time is that of the call the kernel is held against (a
        plain version of many seconds runs once)."""
        got = kern()
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        t_plain = (time.perf_counter() - t_plain) * 1e3
        if diff(name, got, want):
            raise RuntimeError(f"{name} disagrees with its plain version on "
                               f"the main-path batch")
        kern()
        ms = cuda_ms(kern, reps)
        only_ms = graph_ms(alone or kern, reps)
        plain_ms = t_plain if plain_once else cuda_ms(plain, 1)
        bound_ms, bound_by = bound(cells, ops, n_bytes)
        print(f"{name}: {cells} {unit}s, {n_bytes} bytes; {ops:g} int32 ops/"
              f"{unit} ({note}); kernel {ms:.4f} ms per call, {only_ms:.4f} ms "
              f"kernel only (CUDA graph), plain {plain_ms:.2f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library_ms null; {kind}, "
              f"{name_power}")
        return ms, plain_ms, bound_ms, bound_by, only_ms

    # K1 on the largest DeviceDP batch of the blastp run
    p = sd.pack_requests(k1_batch[1], "cuda")

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
    print(f"K1 batch: {p.n_jobs} jobs in {len(k1_batch[1])} requests; "
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
          f"{len(q4)}, band {band4}, (rows a lane, strips) "
          f"{sud.uniform_shape(band4)} (the benchmark's first row: the warp "
          f"path)")
    rows.append(("k4", time_kernel(
        "k4", lambda: sud.banded_swipe_uniform_cuda(
            x4["t_idx"], x4["band_mask"], x4["prof_t"], go, ge),
        lambda: sud.banded_swipe_uniform_cuda_plain(
            x4["t_idx"], x4["band_mask"], x4["prof_t"], go, ge),
        cells, K45_OPS, K45_NOTE, n_bytes, 20)))

    def k4_alone(x):
        """The wrapper's launches on x with the profile's rows read back
        once outside (as the main path's packing gives them on the host),
        so that a CUDA graph holds the launches alone."""
        rows = sud.profile_rows(x["prof_t"])
        outs = [torch.empty(x["t_idx"].shape[0], dtype=torch.int32,
                            device="cuda") for _ in range(3)]
        return rows, lambda: sud.uniform_launch(
            x["t_idx"], x["band_mask"], x["prof_t"], go, ge, rows, outs)

    # K4's wide-band walk on the largest launch of the --swipe --mesh 1 run
    x4w = {k: k4_big[k] for k in ("t_idx", "band_mask", "prof_t")}
    rows4w, alone4w = k4_alone(x4w)
    B4w, T4w = x4w["t_idx"].shape
    band4w = x4w["prof_t"].shape[1] - T4w
    R4w, strips4w = sud.uniform_shape(band4w, rows4w[1] - rows4w[0])
    walked4w = B4w * strips4w * 32 * R4w * T4w
    print(f"K4 wide batch: {B4w} targets of up to {T4w} letters x query of "
          f"{rows4w[1] - rows4w[0]} live profile rows, band {band4w}, "
          f"(rows a lane, strips) ({R4w}, {strips4w}): {k4_big['cells']} "
          f"matrix cells; at most {walked4w} cells walked (strip rows x "
          f"columns; the CTA path walked {B4w * band4w * T4w}); the largest "
          f"launch of --swipe --mesh 1")
    rows.append(("k4w", time_kernel(
        "k4w", lambda: sud.banded_swipe_uniform_cuda(
            x4w["t_idx"], x4w["band_mask"], x4w["prof_t"], go, ge,
            rows=rows4w),
        lambda: sud.banded_swipe_uniform_cuda_plain(
            x4w["t_idx"], x4w["band_mask"], x4w["prof_t"], go, ge),
        k4_big["cells"], K4W_OPS, K4W_NOTE,
        sum(v.numel() * v.element_size() for v in x4w.values()) + 12 * B4w,
        10, alone=alone4w)))
    k4w_pre, _ = bound(k4_big["cells"], K45_OPS, 0)
    print(f"k4w before DPX ({K45_OPS} int32 ops/cell: {K45_NOTE}): bound "
          f"{k4w_pre:.4f} ms, kernel only {rows[-1][1][4] / k4w_pre:.2f}x")

    # K4 on the benchmark's full-matrix row (64 targets of 256 x the query,
    # band 1,024: the wide-band walk)
    t4 = BENCH["T_full"]
    jobs4f = [(rng4.integers(0, 20, t4).astype(np.int8), -(t4 - 1), len(q4))
              for _ in range(BENCH["n_full"])]
    pk4f, meta4f = sud.pack_uniform_batch(q4, None, m.matrix32, jobs4f)
    x4f = {k: torch.from_numpy(v).cuda() for k, v in pk4f.items()}
    rows4f, alone4f = k4_alone(x4f)
    print(f"K4 batch: {len(jobs4f)} targets of {t4} x query of {len(q4)}, "
          f"band {meta4f['band']}, (rows a lane, strips) "
          f"{sud.uniform_shape(meta4f['band'], rows4f[1] - rows4f[0])} (the "
          f"benchmark's full-matrix row)")
    k4_full = time_kernel(
        "k4w", lambda: sud.banded_swipe_uniform_cuda(
            x4f["t_idx"], x4f["band_mask"], x4f["prof_t"], go, ge,
            rows=meta4f["rows"]),
        lambda: sud.banded_swipe_uniform_cuda_plain(
            x4f["t_idx"], x4f["band_mask"], x4f["prof_t"], go, ge),
        len(q4) * t4 * len(jobs4f), K4W_OPS, K4W_NOTE,
        sum(v.nbytes for v in pk4f.values()) + 3 * 4 * len(jobs4f), 20,
        alone=alone4f)
    k4f_pre, _ = bound(len(q4) * t4 * len(jobs4f), K45_OPS, 0)
    print(f"K4 full-matrix row: kernel {k4_full[0]:.4f} ms per call, "
          f"{k4_full[4]:.4f} ms kernel only, bound "
          f"{k4_full[2]:.5f} ms ({k4_full[3]}, {K4W_OPS} ops/cell), "
          f"{k4_full[4] / k4_full[2]:.1f}x kernel only ({k4f_pre:.5f} ms "
          f"and {k4_full[4] / k4f_pre:.1f}x at {K45_OPS}, before DPX): 64 "
          f"serial chains of 256 columns; {kind}, {name_power}")

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

    # D1's fused pass on the largest call of the stage-1/2 blastp run: per
    # call the wrapper (entries, two kernels, scan, the one sync), kernel
    # only its entries given and its rows preallocated (no sync)
    n_j, call_j, counts_j, rows_j = captured["d1j"]
    work_j, (qp_j, sp_j, qidx_j) = d1j_work(call_j, len(rows_j))
    ops_j = d1j_ops(work_j, D1J_OPS)
    issued_j = d1j_ops(work_j, D1J_ISSUED_OPS)
    bytes_j = d1j_bytes(call_j, len(rows_j))
    entries_j = d1m.join_entries(*call_j[3:6], call_j[7], call_j[8],
                                 call_j[9], counts_j[0])
    rows_buf = torch.empty_like(rows_j)
    print(f"D1 fused call: the largest of the stage-1/2 blastp run's "
          f"{paths['d1j']['launches']['d1j']} calls, work {json.dumps(work_j)}"
          f", {ops_j} int32 ops the function needs ({ops_j / n_j:.1f} a "
          f"pair: {D1J_NOTE}), {bytes_j} bytes (the blocks, seed mask and "
          f"tables once, the call's join, the rows)")
    issued_ms, _ = bound(issued_j, 1, 0)
    print(f"D1 fused call as csrc/stage12_join.cu issues it (a diagnostic, "
          f"not the bound): {issued_j} int32 ops ({issued_j / n_j:.1f} a "
          f"pair: {D1J_ISSUED_NOTE}), {issued_ms:.4f} ms at the int32 rate; "
          f"{kind}, {name_power}")
    rows.append(("d1j", time_kernel(
        "d1j", lambda: [d1m.stage12_join(*call_j, counts=counts_j)],
        lambda: [d1m.stage12_join_torch(*call_j)], n_j, ops_j / n_j,
        "the mean of this call's work", bytes_j, 20,
        alone=lambda: [d1m._join_launch(*call_j, *counts_j, entries=entries_j,
                                        rows_out=rows_buf)],
        unit="pair")))

    # D1's pair kernel, which no search path launches, on the same call's
    # pairs expanded, each with its query's window and cutoff
    a_j = call_j[-1]
    xd = [call_j[0], call_j[1], a_j.m32, qp_j.int(), sp_j.int(),
          a_j.win[qidx_j], a_j.cut[qidx_j]]
    hid = a_j.hamming_id
    n_d1 = len(qp_j)
    ops_d1 = d1_ops(xd[0], xd[1], xd[3], xd[4], xd[5])
    blocks = xd[0].numel() + (0 if xd[1] is xd[0] else xd[1].numel())
    n_bytes = 16 * n_d1 + blocks + 4 * 32 * 32 + (1 + 4) * n_d1
    out_d1 = (torch.empty(n_d1, dtype=torch.uint8, device="cuda"),
              torch.empty(n_d1, dtype=torch.int32, device="cuda"))
    print(f"D1 pair kernel on the fused call's {n_d1} pairs: {ops_d1} int32 "
          f"ops ({ops_d1 / n_d1:.1f} a pair: {D1_NOTE}), {n_bytes} bytes (16 "
          f"in and 5 out a pair, the letter blocks once); launches on the "
          f"search paths: {paths['d1j']['launches']['d1']}")
    rows.append(("d1", time_kernel(
        "d1", lambda: d1m.stage12_pairs(*xd, hid, checked=True),
        lambda: d1m.stage12_pairs_torch(*xd, hid), n_d1, ops_d1 / n_d1,
        "the mean of this batch's walks", n_bytes, 20,
        alone=lambda: d1m.stage12_pairs(*xd, hid, checked=True, out=out_d1),
        unit="pair")))

    # D4 on the largest traceback call of the blastp run: per call the
    # wrapper (its plan given, as tb_multi_device gives it: buffers, the
    # launches, the scan, the one sync for the ops' count, the
    # compaction), kernel only the launches, scan and compaction on
    # preallocated buffers; held against the plain version and the native
    # host call on the same arrays
    n_d4, a4 = d4_call
    c4 = dict(zip(TB_KEYS, a4[:10]))
    jobs4 = tbd.job_table(*(a4[k] for k in (2, 3, 4, 6, 7, 8, 9)))
    if a4[1] is None:
        jobs4[:, 2] = 0
    bias4 = np.zeros(1, np.int32) if a4[1] is None else a4[1]
    x4d = [torch.from_numpy(np.ascontiguousarray(v, dtype=dt)).cuda()
           for v, dt in ((a4[0], np.int8), (bias4, np.int32),
                         (a4[5], np.int8), (jobs4, np.int64))]
    plan4 = tbd.tb_plan(jobs4)
    r4 = tbd.tb_multi_device(*a4[:13], "cuda")
    nat4, orc4, low4, wrong4 = tb_check(c4, r4, m.matrix32, m.gap_open,
                                        m.gap_extend)
    cells4, steps4 = tb_work(jobs4[:, 4], jobs4[:, 1], jobs4[:, 5],
                             jobs4[:, 6], r4[1][:, 10])
    ops4 = cells4 * D4_OPS + steps4 * D4_WALK_OPS
    q4u = np.unique(jobs4[:, :2], axis=0)
    bytes4 = (cells4 + 5 * steps4 + int(jobs4[:, 4].sum())
              + 5 * int(q4u[:, 1].sum()) + 8 * jobs4.size
              + 8 * 15 * len(jobs4) + 4 * 32 * 32)
    R4 = tbd.rows_per_lane(jobs4[:, 6])
    print(f"D4 call: the largest of the blastp run's "
          f"{paths['d4']['d4_calls']} traceback calls, {n_d4} jobs in "
          f"{len(plan4.slices)} plane slices and {len(plan4.launches)} fill "
          f"launches (band class rows, jobs): "
          f"{[(32 * R, c) for R, _, c in plan4.launches]}; {cells4} exact "
          f"band cells ({int((jobs4[:, 4] * 32 * R4).sum())} walked), "
          f"{steps4} walk ops; against the native host call: {nat4} jobs "
          f"differ; {low4} jobs start below diagonal -(t_len - 1) (against "
          f"the numpy oracle: {orc4} differ; the native call {wrong4}); "
          f"failed walks {int((r4[1][:, 11] == 0).sum())}")
    if nat4 or orc4:
        raise RuntimeError("D4 disagrees with the native host call on the "
                           "main-path call")
    bufs4 = tbd.tb_buffers(plan4, "cuda")
    ref4 = tbd.banded_traceback_multi(*x4d, m32, go, ge, plan=plan4)
    outs4 = [torch.empty_like(t) for t in ref4]

    def d4_alone():
        tbd.tb_launch(*x4d, m32, go, ge, plan4, bufs4, outs4[0], outs4[1])
        n_ops = outs4[1][:, 10]
        torch.sub(torch.cumsum(n_ops, 0), n_ops, out=outs4[2])
        tbd.tb_compact(outs4[1], bufs4, outs4[2], outs4[3], outs4[4])
        return outs4

    rows.append(("d4", time_kernel(
        "d4", lambda: tbd.banded_traceback_multi(*x4d, m32, go, ge,
                                                 plan=plan4),
        lambda: tbd.banded_traceback_multi_plain(*x4d, m32, go, ge),
        cells4, ops4 / cells4,
        f"the mean a cell: {D4_OPS} a cell ({D4_NOTE}) and {D4_WALK_OPS} a "
        f"walk op ({D4_WALK_NOTE})", bytes4, 10, alone=d4_alone,
        plain_once=True)))
    d4_fill = int((jobs4[:, 4] * 32 * R4).sum())
    print(f"d4 bytes: the planes written and read ({cells4} cells x 4 bits, "
          f"twice), the ops ({steps4} x 5 bytes), targets, queries with "
          f"their bias, the job table and the outputs once; the blastp "
          f"card route's {paths['d4']['launches']['d4']} D4 launches; "
          f"{d4_fill} cells walked by the fill's warps; {kind}, "
          f"{name_power}")

    # tantan's scan at the benchmark's block; its launches are the blastp
    # self-search's (its two blocks)
    row, max_err["mask"] = mask_entry(args.seed, sm_clock_mhz, kind,
                                      name_power)
    rows.append(("mask", row))

    # the DB-side seed enumeration at the benchmark's block; its launches
    # are the -g run's (one a shape)
    row, max_err["seed"] = enum_entry(args.seed, sm_clock_mhz, kind,
                                      name_power)
    rows.append(("seed", row))

    # D3, MCL's dense step, on the matrices of the MCL run's card route: on
    # the card against the same torch ops on the CPU and the numpy loop
    phase("D3 parity and timing (MCL's dense step, torch ops)")
    d3_step = pmcl.mcl_dense_torch
    d3_cpu_diff = d3_np_diff = 0.0
    d3_mis = 0
    for M, a in d3_mats:
        got = d3_step(M, *a)
        cpu = d3_step(M, *a[:3], "cpu")
        npl = pmcl._mcl_dense(M.copy(), *a[:3], None)
        d3_cpu_diff = max(d3_cpu_diff, float(np.abs(got - cpu).max()))
        d3_np_diff = max(d3_np_diff, float(np.abs(got - npl).max()))
        want = pmcl._clusters_from_matrix(cpu)
        d3_mis += int((pmcl._clusters_from_matrix(got) != want).sum()
                      + (pmcl._clusters_from_matrix(npl) != want).sum())
    print(f"D3 parity: {len(d3_mats)} matrices (m = "
          f"{[len(M) for M, _ in d3_mats]}), cluster assignments card vs "
          f"CPU vs numpy loop mismatches {d3_mis}; largest |card - CPU| "
          f"{d3_cpu_diff:.3g}, |card - numpy| {d3_np_diff:.3g}")
    if d3_mis or not d3_mats:
        raise RuntimeError("D3's assignments disagree with its plain "
                           "versions")
    Mb, ab = max(d3_mats, key=lambda x: len(x[0]))
    mb = len(Mb)
    n_mm = [0]
    matmul = torch.Tensor.__matmul__

    def count_mm(x, y):
        n_mm[0] += 1
        return matmul(x, y)

    torch.Tensor.__matmul__ = count_mm
    try:
        d3_step(Mb, *ab)
    finally:
        torch.Tensor.__matmul__ = matmul
    iters = n_mm[0] // (ab[0] - 1)
    ms = cuda_ms(lambda: d3_step(Mb, *ab), 5)
    t0 = time.perf_counter()
    d3_step(Mb, *ab[:3], "cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pmcl._mcl_dense(Mb.copy(), *ab[:3], None)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    flops = 2 * mb ** 3 * (ab[0] - 1) * iters
    fp32_s = flops / (H100_SMS * FP32_LANES_PER_SM * 2 * sm_clock_mhz * 1e6)
    bytes_s = 2 * 4 * mb * mb / HBM_BYTES_PER_S
    bound_ms = max(fp32_s, bytes_s) * 1e3
    bound_by = "operations" if fp32_s >= bytes_s else "bytes"
    run_s = sum(t for _, t in mcl_out["card"][0]["d3"][1])
    print(f"d3: largest call m {mb}, {iters} iterations, {n_mm[0]} fp32 "
          f"matmuls, {flops} flops (2 m^3 (expansion - 1) an iteration), "
          f"{2 * 4 * mb * mb} bytes (the matrix in and out); per call "
          f"{ms:.4f} ms (copies and a scalar read back an iteration "
          f"included), CPU torch step {plain_ms:.2f} ms, numpy loop "
          f"{numpy_ms:.2f} ms, bound {bound_ms:.5f} ms ({bound_by}; fp32 "
          f"{fp32_s * 1e3:.5f} ms, bytes {bytes_s * 1e3:.5f} ms); the MCL "
          f"run's {paths['d3']['launches']['d3']} calls took {run_s:.4f} s "
          f"in all; library_ms null; {kind}, {name_power}")
    max_err["d3"] = d3_cpu_diff
    rows.append(("d3", (ms, plain_ms, bound_ms, bound_by, None)))

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
        # the same wrapper's wide-band walk (uniform_rows_kernel), on the
        # path that launches it most
        "k4w": ("banded_swipe_uniform_cuda, bands 513-8192",
                "diamond_tpu_torch/csrc/uniform_swipe.cu",
                "diamond_tpu/ops/swipe_pallas.py:114 (banded_swipe_pallas)",
                "swipe-mesh1"),
        "k5": ("swipe_sweep", "diamond_tpu_torch/csrc/swipe_sweep.cu",
               "diamond_tpu/ops/swipe_device.py:582 (banded_swipe_pallas_sweep)",
               "k5"),
        "k6": ("stage2_filter", "diamond_tpu_torch/csrc/stage2.cu",
               "diamond_tpu/ops/stage2_pallas.py:85 (stage2_pallas)", "bench"),
        # no search path launches the pair kernel any more: its launches
        # are those of the stage-1/2 route's run (0), its row off the path
        "d1": ("stage12_pairs", "diamond_tpu_torch/csrc/stage12.cu",
               "diamond_tpu/ops/stage12_jax.py:35 (_stage12_kernel)", "d1j"),
        "d1j": ("stage12_join", "diamond_tpu_torch/csrc/stage12_join.cu",
                "diamond_tpu/ops/stage12_jax.py:35 (_stage12_kernel) with "
                "the host steps of diamond_tpu/search/pipeline.py:699 "
                "(_stage12_device)", "d1j"),
        "d4": ("banded_traceback_multi",
               "diamond_tpu_torch/csrc/banded_traceback.cu",
               "diamond_tpu/native/src/banded_swipe.cc:369 "
               "(banded_swipe_tb_multi, host C++ of the traceback round, "
               "diamond_tpu/align/wave.py:135 _tb_multi)", "d4"),
        "mask": ("tantan_mask", "diamond_tpu_torch/csrc/tantan.cu",
                 "none: the host C++ scan tantan_repeat_prob_many of both "
                 "packages (native/src/tantan.cc:52-157), from "
                 "search/pipeline._mask_block", "mask"),
        "seed": ("enumerate_filtered", "diamond_tpu_torch/csrc/seed_enum.cu",
                 "none: the host C++ pass enumerate_seeds_filtered of both "
                 "packages (native/src/stages.cc:558), from "
                 "search/pipeline._enumerate_t_qindex", "seed"),
        # torch ops (fp32 matmul with TF32 off), not a hand-written kernel:
        # the reference computes this step with XLA outside any Pallas kernel
        "d3": ("mcl_dense_torch", "diamond_tpu_torch/cluster/mcl.py",
               "diamond_tpu/cluster/mcl.py:44 (_mcl_dense, jit/XLA)", "d3"),
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
        "hand_written": k != "d3",
        "on_path": k != "d1",
    } for k, (ms, plain_ms, bound_ms, bound_by, only_ms) in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-worker"]:
        sys.exit(cli_worker(sys.argv[2:]))
    sys.exit(main())
