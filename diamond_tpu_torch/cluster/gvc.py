"""Greedy vertex cover clustering core.

Port of the reference GVC (reference src/util/algo/greedy_vertex_cover.cpp:
124-176): nodes are sequences, edges are accepted alignments; repeatedly pick
the node covering the most unassigned neighbors (lazy priority queue with
stale-count re-push), assign its neighbors to it; optional connected-
component expansion and weight-based reassignment.
"""
from __future__ import annotations

import heapq
from collections import deque

import numpy as np

NIL = -1


class EdgeGraph:
    """CSR adjacency: for each node, sorted unique (neighbor, weight) lists."""

    def __init__(self, n_nodes: int, edges):
        """edges: iterable of (node1, node2, weight) — directed as given
        (the caller adds both directions when appropriate) — or an
        utils.external_sort.ExternalSorter of EDGE_DTYPE records, whose
        bounded-memory merge produces the identical sorted order
        (reference util/algo/external_sort.h feeding
        tools/greedy_vertex_cover.cpp)."""
        from diamond_tpu_torch.utils.external_sort import sort_edges

        self.n = n_nodes
        self.nbr = [[] for _ in range(n_nodes)]
        self.wt = [[] for _ in range(n_nodes)]
        for n1, n2, w in sort_edges(edges):
            self.nbr[n1].append(n2)
            self.wt[n1].append(w)

    def count(self, i):
        return len(self.nbr[i])


def greedy_vertex_cover(graph: EdgeGraph, member_counts=None,
                        merge_recursive: bool = False, reassign: bool = False,
                        connected_component_depth: int = 0):
    """Returns centroid assignment per node (centroids[i] == i for reps)."""
    n = graph.n
    centroids = np.full(n, NIL, dtype=np.int64)

    def neighbor_count(node):
        if member_counts is not None:
            c = member_counts[node]
            for v in graph.nbr[node]:
                if centroids[v] == NIL:
                    c += member_counts[v]
            return c
        c = 0
        last = NIL
        for v in graph.nbr[node]:
            if centroids[v] == NIL and v != last:
                c += 1
                last = v
        return c

    # max-heap of (count, node); ties pop the larger node like
    # std::priority_queue<pair<Int,Int>>
    q = [(-(neighbor_count(i) if member_counts is not None else graph.count(i)),
          -i) for i in range(n)]
    heapq.heapify(q)

    while q:
        negc, negn = heapq.heappop(q)
        node = -negn
        if centroids[node] != NIL:
            continue
        count = neighbor_count(node)
        if q and count < -q[0][0]:
            heapq.heappush(q, (-count, -node))
            continue
        if connected_component_depth > 0:
            _make_cluster_cc(node, graph, centroids, connected_component_depth)
        else:
            _make_cluster_gvc(node, graph, centroids, merge_recursive)

    if reassign:
        weights = np.full(n, -np.inf)
        for node in range(n):
            if centroids[node] == node:
                for v, w in zip(graph.nbr[node], graph.wt[node]):
                    if centroids[v] != v and w > weights[v]:
                        weights[v] = w
                        centroids[v] = node

    if merge_recursive:
        i = 0
        while i < n:
            c = centroids[i]
            if centroids[c] != c:
                centroids[i] = centroids[c]
            else:
                i += 1

    return centroids


def _make_cluster_gvc(rep, graph, centroids, merge_recursive):
    centroids[rep] = rep
    for v in graph.nbr[rep]:
        if centroids[v] == NIL or (merge_recursive and centroids[v] == v):
            centroids[v] = rep


def _make_cluster_cc(rep, graph, centroids, depth):
    centroids[rep] = rep
    q = deque()
    for v in graph.nbr[rep]:
        if centroids[v] == NIL:
            q.append((v, 1))
    while q:
        node, d = q.popleft()
        if centroids[node] != NIL or d > depth:
            continue
        for v in graph.nbr[node]:
            if centroids[v] == NIL:
                q.append((v, d + 1))
        centroids[node] = rep
