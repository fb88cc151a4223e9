"""Weight-balanced graph partitioning of the meta-HNSW bottom layer.

The paper uses the Karlsruhe Fast Flow Partitioner (KaFFPa [34]), a
multilevel local-improvement partitioner. We implement a faithful stand-in
with the same contract — *balanced* (by vertex weight) partitions that
*minimise edge cut* — using:

  1. greedy weighted graph-growing for the initial partition, then
  2. Fiduccia–Mattheyses-style boundary refinement passes (move the vertex
     with the best cut-gain that keeps both sides within the balance bound).

The meta graph is small (m ≈ 1e3..1e5 vertices, degree ≤ 32), so a
host-side numpy implementation is appropriate — this runs once, offline,
at index-build time (Alg. 3 line 6).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _symmetrize(adj: np.ndarray) -> list:
    """[n, M] padded adjacency -> list of unique undirected neighbour arrays."""
    n = adj.shape[0]
    nbrs = [set() for _ in range(n)]
    for u in range(n):
        for v in adj[u]:
            if v >= 0 and v != u:
                nbrs[u].add(int(v))
                nbrs[v].add(u)
    return [np.fromiter(s, dtype=np.int64, count=len(s)) for s in nbrs]


def partition_graph(adj: np.ndarray, weights: np.ndarray, w: int, *,
                    epsilon: float = 0.10, refine_passes: int = 8,
                    seed: int = 0) -> np.ndarray:
    """Partition a padded adjacency graph into w weight-balanced parts.

    Args:
      adj: [n, M] int32 adjacency (directed ok; symmetrised internally).
      weights: [n] nonnegative vertex weights (cluster sizes, Alg. 3).
      w: number of partitions.
      epsilon: allowed imbalance; each part <= (1+eps) * total/w.

    Returns labels [n] int32 in [0, w).
    """
    n = adj.shape[0]
    weights = np.asarray(weights, dtype=np.float64)
    if w <= 1:
        return np.zeros(n, dtype=np.int32)
    if w > n:
        raise ValueError(f"w={w} > n={n}")
    rng = np.random.default_rng(seed)
    nbrs = _symmetrize(adj)
    total = float(weights.sum())
    target = total / w
    cap = (1.0 + epsilon) * target

    # --- phase 1: greedy graph growing -----------------------------------
    labels = np.full(n, -1, dtype=np.int32)
    part_weight = np.zeros(w, dtype=np.float64)
    unassigned = set(range(n))
    order = np.argsort(-weights)  # heavy seeds first
    for p in range(w):
        seed_v = next((v for v in order if labels[v] < 0), None)
        if seed_v is None:
            break
        frontier = [seed_v]
        while frontier and part_weight[p] < target:
            v = frontier.pop(0)
            if labels[v] >= 0:
                continue
            labels[v] = p
            part_weight[p] += weights[v]
            unassigned.discard(v)
            for u in nbrs[v]:
                if labels[u] < 0:
                    frontier.append(int(u))
    # leftovers -> currently lightest part (or neighbour-majority part)
    for v in sorted(unassigned, key=lambda v: -weights[v]):
        nb = [labels[u] for u in nbrs[v] if labels[u] >= 0]
        if nb:
            cands, counts = np.unique(nb, return_counts=True)
            ok = cands[part_weight[cands] + weights[v] <= cap]
            if ok.size:
                p = ok[np.argmax(counts[np.isin(cands, ok)])]
            else:
                p = int(np.argmin(part_weight))
        else:
            p = int(np.argmin(part_weight))
        labels[v] = p
        part_weight[p] += weights[v]

    # --- phase 2: FM-style boundary refinement ---------------------------
    for _ in range(refine_passes):
        moved = 0
        # connectivity counts conn[v, p] = # neighbours of v in part p
        conn = np.zeros((n, w), dtype=np.int32)
        for v in range(n):
            for u in nbrs[v]:
                conn[v, labels[u]] += 1
        boundary = [v for v in range(n)
                    if conn[v, labels[v]] < len(nbrs[v])]
        rng.shuffle(boundary)
        for v in boundary:
            p = labels[v]
            gains = conn[v] - conn[v, p]
            gains[p] = -1
            # balance: target part must stay under cap and source part
            # should not become too empty
            feasible = part_weight + weights[v] <= cap
            feasible[p] = False
            gains = np.where(feasible, gains, -(10 ** 9))
            q = int(np.argmax(gains))
            if gains[q] > 0 or (gains[q] == 0 and
                                part_weight[p] > part_weight[q] + weights[v]):
                labels[v] = q
                part_weight[p] -= weights[v]
                part_weight[q] += weights[v]
                for u in nbrs[v]:
                    conn[u, p] -= 1
                    conn[u, q] += 1
                moved += 1
        if moved == 0:
            break
    return labels


def edge_cut(adj: np.ndarray, labels: np.ndarray) -> int:
    """Number of (directed) edges crossing partitions — the Alg. 3 objective."""
    n, m = adj.shape
    src = np.repeat(np.arange(n), m)
    dst = adj.reshape(-1)
    valid = dst >= 0
    return int(np.sum(labels[src[valid]] != labels[dst[valid]]))


def balance_stats(weights: np.ndarray, labels: np.ndarray,
                  w: int) -> Tuple[float, np.ndarray]:
    """(max part weight / ideal, per-part weights)."""
    pw = np.zeros(w)
    np.add.at(pw, labels, weights)
    ideal = weights.sum() / w
    return float(pw.max() / max(ideal, 1e-12)), pw
