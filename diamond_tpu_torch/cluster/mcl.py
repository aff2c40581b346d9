"""Markov clustering (--cluster-algo mcl).

Reference: src/contrib/mcl/ (mcl.cpp, clustering_variables.h): all-vs-all
self-search edges weighted by normalized_bitscore_global =
bitscore / max(query_self_aln, target_self_aln) * 100, thresholded
(default 50), symmetrized, split into connected components, then per
component the MCL iteration: column-normalize -> expansion (matrix power)
-> inflation (elementwise power + renormalize) until convergence; clusters
are the attractor systems.

Port design: the reference switches between Eigen sparse and dense
chunk-threaded kernels; here every component above a size cutoff runs the
expansion as dense fp32 torch matmuls on the resolved device (the CUDA card
unless the CPU is asked for) — the iteration is a chain of [n,n] matmuls +
elementwise powers — with the numpy loop for tiny components.
"""
from __future__ import annotations

import sys

import numpy as np

DEFAULT_THRESHOLD = 50.0   # reference mcl.cpp:36
JAX_MIN_COMPONENT = 128    # dense device iteration above this size


def connected_components(n: int, edges):
    """Union-find over undirected edges; returns labels [n]."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j, _ in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    return np.array([find(i) for i in range(n)], dtype=np.int64)


def _mcl_dense(M: np.ndarray, expansion: int, inflation: float,
               max_iter: int, device: str | None):
    """MCL iteration on a dense column-stochastic matrix: torch on
    ``device`` when one is given, else the numpy loop."""
    if device is not None:
        return mcl_dense_torch(M, expansion, inflation, max_iter, device)
    for _ in range(max_iter):
        M2 = M
        for _ in range(expansion - 1):
            M2 = M2 @ M2
        M2 = M2 ** inflation
        M2 /= np.maximum(M2.sum(axis=0, keepdims=True), 1e-30)
        if np.abs(M2 - M).max() < 1e-6:
            return M2
        M = M2
    return M



def mcl_dense_torch(M: np.ndarray, expansion: int, inflation: float,
                    max_iter: int, device: str):
    """The dense MCL step in fp32 torch ops on ``device``: expansion - 1
    squarings, the elementwise power, column normalisation; until the
    largest change is below 1e-6, one scalar read back an iteration."""
    import torch

    # TF32 keeps a 10-bit mantissa: its products can move an attractor, so
    # the products run in true fp32 and the global setting is restored
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        M = torch.as_tensor(M, dtype=torch.float32, device=device)
        for _ in range(max_iter):
            M2 = M
            for _ in range(expansion - 1):
                M2 = M2 @ M2
            M2 = M2 ** inflation
            M2 = M2 / torch.clamp(M2.sum(dim=0, keepdim=True), min=1e-30)
            done = float((M2 - M).abs().max()) < 1e-6
            M = M2
            if done:
                break
        if M.is_cuda:
            mcl_dense_torch.launches += 1
        return M.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


mcl_dense_torch.launches = 0  # calls on a CUDA device

def _clusters_from_matrix(M: np.ndarray, eps: float = 1e-6):
    """Canonical MCL interpretation (van Dongen): attractors are nodes with
    diagonal mass; overlapping attractor systems (attractors linked by
    positive entries) merge into one cluster; every node joins the system
    of the strongest attractor in its column."""
    n = M.shape[0]
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    attractors = [i for i in range(n) if M[i, i] > eps]
    aset = set(attractors)
    for i in attractors:
        for j in attractors:
            if M[i, j] > eps:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    out = np.arange(n, dtype=np.int64)
    for j in range(n):
        if j in aset:
            out[j] = find(j)
            continue
        col = M[:, j]
        best, best_w = j, eps
        for i in attractors:
            if col[i] > best_w:
                best, best_w = i, col[i]
        out[j] = find(best) if best != j else j
    return out


def mcl_cluster(n: int, edges, expansion: int = 2, inflation: float = 2.0,
                max_iter: int = 100, symmetric: bool = True,
                verbose: bool = False):
    """edges: (i, j, similarity).  Returns centroid assignment [n]."""
    labels = connected_components(n, edges)
    comp_nodes: dict[int, list] = {}
    for i in range(n):
        comp_nodes.setdefault(int(labels[i]), []).append(i)
    by_comp: dict[int, list] = {}
    for i, j, w in edges:
        by_comp.setdefault(int(labels[i]), []).append((i, j, w))

    from diamond_tpu_torch.utils.device import resolve_device

    device = None  # resolved at the first component that needs it

    assignment = np.arange(n, dtype=np.int64)
    n_comp = 0
    for root, nodes in comp_nodes.items():
        if len(nodes) <= 1:
            continue
        n_comp += 1
        idx = {g: k for k, g in enumerate(nodes)}
        m = len(nodes)
        M = np.zeros((m, m), dtype=np.float32)
        for i, j, w in by_comp.get(root, []):
            a, b = idx[i], idx[j]
            M[b, a] = max(M[b, a], w)  # column a = transitions out of i
            if symmetric:
                M[a, b] = max(M[a, b], w)
        np.fill_diagonal(M, np.maximum(M.diagonal(), 1.0))  # self loops
        M /= np.maximum(M.sum(axis=0, keepdims=True), 1e-30)
        if m >= JAX_MIN_COMPONENT and device is None:
            device = resolve_device()
        M = _mcl_dense(M, expansion, inflation, max_iter,
                       device if m >= JAX_MIN_COMPONENT else None)
        attract = _clusters_from_matrix(M)
        for k, g in enumerate(nodes):
            assignment[g] = nodes[int(attract[k])]
    if verbose:
        print(f"MCL: {n_comp} non-singleton components", file=sys.stderr)
    return assignment


def mcl_edges_from_search(block, matrix_name: str = "BLOSUM62",
                          threshold: float = DEFAULT_THRESHOLD,
                          sensitivity: str = "default", threads: int = 1):
    """All-vs-all self-search edges weighted by normalized_bitscore_global
    (reference clustering_variables.h:264-274); self-alignment bitscores
    via full-band SW of each sequence against itself."""
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.search.pipeline import Pipeline
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix
    from diamond_tpu_torch.data.block import Block

    mat = ScoreMatrix(matrix_name)
    # self-alignment bitscores (reference Block::compute_self_aln)
    self_bs = []
    for i in range(len(block)):
        s = block.seq(i)
        res = banded_swipe_batch_np(s, None, [(s, 0, 1)], mat.matrix32,
                                    mat.gap_open, mat.gap_extend)
        self_bs.append(float(mat.bitscore(res[0][0])))

    qb = Block.from_sequences([block.seq(i).copy() for i in range(len(block))],
                              list(block.ids))
    tb = Block.from_sequences([block.seq(i).copy() for i in range(len(block))],
                              list(block.ids))
    cfg = SearchConfig(matrix=mat, sensitivity=sensitivity,
                       max_target_seqs=2 ** 31 - 1, threads=threads)
    results = Pipeline(cfg, qb, tb).search()
    edges = []
    for qid, matches in results.items():
        for m in matches:
            t = m.target_block_id
            for h in m.hsp:
                sim = h.bit_score / max(self_bs[qid], self_bs[t]) * 100.0
                if sim >= threshold:
                    # self-hits become the MCL self-loops (the reference
                    # feeds the raw self-search into the matrix stream)
                    edges.append((qid, t, sim))
    return edges
