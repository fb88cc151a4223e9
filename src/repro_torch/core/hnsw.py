"""Array-based HNSW: numpy construction, batched PyTorch search.

Port of ``repro.core.hnsw``. Construction (Alg. 2) is the reference's
host-side numpy builder, copied, so the same data and seed give the same
adjacency. Search (Alg. 1) runs on tensors on the index's device:

  * the greedy upper-layer descent is batched over queries, with a
    tensor of current nodes; each level's data-dependent stop costs one
    host sync per level and step;
  * the bottom-layer beam walk for the whole batch is ONE call of
    ``repro_torch.kernels.beam_search`` (the CUDA kernel on the card);
  * ``search_one`` keeps the per-query loop as an oracle.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import filters as F
from repro_torch.core import metrics as M
from repro_torch.kernels.beam_search import beam_search
from repro_torch.kernels.beam_search.ref import score_rows

NEG_INF = np.float32(-np.inf)


def shard_seed(base: int, shard: int) -> int:
    """Construction seed for sub-HNSW ``shard`` of an index seeded with
    ``base`` (the same rule as the reference, so a shard's graph is
    bit-identical whichever path built it)."""
    return base + 1 + shard


# ---------------------------------------------------------------------------
# Graph container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HNSWGraph:
    """An HNSW index in array form (host numpy).

    Attributes:
      data:       [n, d] float32 item vectors (dataset order).
      ids:        [n] int64 external ids (global ids for a sub-HNSW).
      neighbors:  list over levels; level l is an int32 array [n, M_l]
                  padded with -1. Level 0 is the bottom layer.
      levels:     [n] int32, highest level of each node.
      entry:      int, entry vertex (node with the highest level).
      metric:     similarity function name.
      tags:       optional [n] int64 metadata tag bitsets.
    """

    data: np.ndarray
    ids: np.ndarray
    neighbors: List[np.ndarray]
    levels: np.ndarray
    entry: int
    metric: str
    tags: Optional[np.ndarray] = None

    def tags_or_zeros(self) -> np.ndarray:
        if self.tags is None:
            return np.zeros((self.n,), dtype=np.int64)
        return np.asarray(self.tags, dtype=np.int64)

    @property
    def n(self) -> int:
        return int(self.data.shape[0])

    @property
    def d(self) -> int:
        return int(self.data.shape[1])

    @property
    def max_level(self) -> int:
        return len(self.neighbors) - 1

    def upper_stack(self) -> np.ndarray:
        """Upper levels stacked into one padded [L, n, Mu] int32 array
        (L >= 1; all -1 when the graph has no upper level)."""
        m_upper = max([lv.shape[1] for lv in self.neighbors[1:]], default=1)
        upper = np.full((max(1, self.max_level), self.n, m_upper), -1,
                        dtype=np.int32)
        for l in range(1, self.max_level + 1):
            lv = self.neighbors[l]
            upper[l - 1, :, : lv.shape[1]] = lv
        return upper

    def device_arrays(self, device="cuda") -> "HNSWArrays":
        """The search-side tensors of this graph on ``device``."""
        dev = torch.device(device)
        return HNSWArrays(
            data=torch.tensor(self.data, dtype=torch.float32).to(dev),
            ids=torch.tensor(np.asarray(self.ids), dtype=torch.int32
                                ).to(dev),
            bottom=torch.tensor(self.neighbors[0], dtype=torch.int32
                                   ).to(dev),
            upper=torch.as_tensor(self.upper_stack()).to(dev),
            entry=int(self.entry),
            num_upper_levels=int(self.max_level))

    def quant_arrays(self, params, device="cuda") -> "QuantHNSWArrays":
        """Int8 twin of :meth:`device_arrays` on ``params``' grid
        (``repro_torch.core.quant.QuantParams``)."""
        g = self.device_arrays(device)
        dev = torch.device(device)
        return QuantHNSWArrays(
            data=torch.as_tensor(params.quantize(self.data)).to(dev),
            ids=g.ids, bottom=g.bottom, upper=g.upper, entry=g.entry,
            num_upper_levels=g.num_upper_levels,
            scale=torch.as_tensor(params.scale).to(dev),
            zero=torch.as_tensor(params.zero).to(dev))


@dataclasses.dataclass
class HNSWArrays:
    """Search-side tensors of one graph. The graph owns the scoring of
    its rows (:meth:`score_nodes`), so the int8 twin plugs into the same
    walk by carrying ``scale``/``zero``."""

    data: torch.Tensor       # [n, d] f32
    ids: torch.Tensor        # [n] i32 external ids
    bottom: torch.Tensor     # [n, M0] i32
    upper: torch.Tensor      # [L, n, Mu] i32 (L >= 1; all -1 rows if absent)
    entry: int
    num_upper_levels: int

    scale = None
    zero = None

    @property
    def device(self) -> torch.device:
        return self.data.device

    def score_nodes(self, q: torch.Tensor, nodes: torch.Tensor,
                    metric: str) -> torch.Tensor:
        """q [B, d] against rows ``nodes`` [B, m] (pre-clipped) -> [B, m]."""
        return score_rows(q, self.data[nodes], metric, self.scale,
                          self.zero)


@dataclasses.dataclass
class QuantHNSWArrays(HNSWArrays):
    """Int8-compressed twin of :class:`HNSWArrays`: ``data`` holds codes
    on a per-dimension affine grid and scoring is asymmetric (float32
    query against ``codes * scale + zero``)."""

    scale: torch.Tensor = None   # [d] f32
    zero: torch.Tensor = None    # [d] f32


# ---------------------------------------------------------------------------
# Construction (numpy, Alg. 2) -- copied from the reference builder
# ---------------------------------------------------------------------------


class _Builder:
    """Incremental HNSW builder (host-side)."""

    def __init__(self, d: int, metric: str, m: int, m_upper: int,
                 ef_construction: int, seed: int, capacity: int):
        self.metric = metric
        self.m0 = m
        self.mu = m_upper
        self.efc = ef_construction
        self.rng = np.random.default_rng(seed)
        self.ml = 1.0 / np.log(max(m, 2))
        self.data = np.zeros((capacity, d), dtype=np.float32)
        # l2: each row's squared norm, summed once as ``similarity_matrix_np``
        # sums it on every call (the same values, bit for bit)
        self.sqn = np.zeros(capacity, dtype=np.float32)
        self.levels = np.zeros(capacity, dtype=np.int32)
        self.n = 0
        self.entry = -1
        self.max_level = -1
        # adjacency: list over levels of [capacity, M_l] int32
        self.adj: List[np.ndarray] = []

    def _ensure_level(self, level: int) -> None:
        while len(self.adj) <= level:
            m = self.m0 if len(self.adj) == 0 else self.mu
            self.adj.append(
                np.full((self.data.shape[0], m), -1, dtype=np.int32))

    def _sims(self, node: int, rows) -> np.ndarray:
        """Similarities [len(rows)] of stored row ``node`` to stored rows
        ``rows``: ``similarity_matrix_np``'s arithmetic, with l2's squared
        norms taken from ``sqn``."""
        rows = np.asarray(rows)
        if self.metric != "l2":
            return M.similarity_matrix_np(self.data[node][None, :],
                                          self.data[rows], self.metric)[0]
        q = self.data[node:node + 1]
        return (2.0 * q @ self.data[rows].T - self.sqn[node:node + 1, None]
                - self.sqn[rows][None, :])[0]

    def _search_layer(self, q: np.ndarray, entry_points: List[Tuple[float, int]],
                      level: int, ef: int,
                      qnode: Optional[int] = None) -> List[Tuple[float, int]]:
        """Alg. 1 Search-Level. Returns up to ef (sim, id) best-first;
        ``qnode``: q is that stored row (its norm is cached)."""
        visited = set()
        cand: List[Tuple[float, int]] = []   # max-heap via negated sim
        best: List[Tuple[float, int]] = []   # min-heap of (sim, id)
        for sim, node in entry_points:
            if node in visited:
                continue
            visited.add(node)
            heapq.heappush(cand, (-sim, node))
            heapq.heappush(best, (sim, node))
        adj = self.adj[level]
        while cand:
            neg_sim, node = heapq.heappop(cand)
            if -neg_sim < best[0][0] and len(best) >= ef:
                break
            nbrs = adj[node]
            nbrs = nbrs[nbrs >= 0]
            fresh = [v for v in nbrs if v not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            fresh_arr = np.asarray(fresh, dtype=np.int64)
            sims = self._sims(qnode, fresh_arr) if qnode is not None else \
                M.similarity_matrix_np(q[None, :], self.data[fresh_arr],
                                       self.metric)[0]
            for v, s in zip(fresh, sims):
                s = float(s)
                if len(best) < ef or s > best[0][0]:
                    heapq.heappush(cand, (-s, v))
                    heapq.heappush(best, (s, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted(best, reverse=True)

    def _pair_bounds(self, ids: List[int]):
        """Lower and upper bounds [k, k] on the float32 similarities
        ``_sims`` gives between rows ``ids``: each pair's similarity in
        float64 (exact products of the float32 rows) less and plus twice
        the float32 rounding bound of any summation order, gamma_(d+4) *
        (|a| + |b|)^2 for l2 and gamma_(d+4) * |a| |b| for ip, with gamma_n
        = n u / (1 - n u) and u = 2^-24."""
        x = self.data[np.asarray(ids)].astype(np.float64)
        g = x @ x.T
        sq = np.diag(g).copy()
        nrm = np.sqrt(sq)
        if self.metric == "l2":
            sim = 2.0 * g - sq[:, None] - sq[None, :]
            w = nrm[:, None] + nrm[None, :]
            w *= w
        else:
            sim, w = g, np.outer(nrm, nrm)
        nu = (self.data.shape[1] + 4) * 2.0 ** -24
        w *= 2.0 * nu / (1.0 - nu)
        return sim - w, sim + w

    def _select_heuristic(self, q: np.ndarray,
                          cand: List[Tuple[float, int]], m: int) -> List[int]:
        """HNSW neighbour-selection heuristic (Malkov & Yashunin Alg. 4).

        Keeps a *diverse* neighbour set: candidate e joins only if it is
        more similar to q than to any already-selected neighbour. This keeps
        long-range edges between clusters — without it, well-separated
        clusters become disconnected graph components and recall collapses.
        Pruned candidates backfill remaining slots (keepPrunedConnections).

        Under l2 and ip a comparison is first decided from the candidates'
        pairwise similarities in float64 and their float32 rounding bounds
        (:meth:`_pair_bounds`); only a candidate within its bound of a
        selected one asks for the float32 similarities, so the choices
        are those of the float32 comparisons alone.
        """
        ordered = sorted(cand, reverse=True)
        bounded = self.metric in ("l2", "ip") and len(ordered) > 1
        if bounded:
            lo, hi = self._pair_bounds([v for _, v in ordered])
            # each candidate's largest bound over the selected ones
            top_lo = np.full(len(ordered), -np.inf)
            top_hi = np.full(len(ordered), -np.inf)
        selected: List[int] = []
        for i, (sim, v) in enumerate(ordered):
            if len(selected) == m:
                break
            if selected:
                if bounded and top_lo[i] > sim:
                    continue
                if (not bounded or top_hi[i] > sim) and \
                        (self._sims(v, selected) > sim).any():
                    continue
            selected.append(v)
            if bounded:
                np.maximum(top_lo, lo[i], out=top_lo)
                np.maximum(top_hi, hi[i], out=top_hi)
        if len(selected) < m:
            chosen = set(selected)
            for _, v in ordered:
                if v not in chosen:
                    selected.append(v)
                    chosen.add(v)
                    if len(selected) == m:
                        break
        return selected

    def _connect(self, node: int, neighbors: List[int], level: int) -> None:
        m = self.m0 if level == 0 else self.mu
        adj = self.adj[level]
        adj[node, : len(neighbors[:m])] = neighbors[:m]
        # add reverse edges, pruning to degree m with the diversity heuristic
        for v in neighbors[:m]:
            row = adj[v]
            slot = np.where(row < 0)[0]
            if slot.size:
                row[slot[0]] = node
            else:
                cand_ids = np.append(row, node)
                sims = self._sims(v, cand_ids)
                keep = self._select_heuristic(
                    self.data[v], list(zip(sims.tolist(), cand_ids.tolist())), m)
                adj[v] = np.asarray(keep, dtype=np.int32)

    def add(self, x: np.ndarray) -> int:
        node = self.n
        self.data[node] = x
        row = self.data[node:node + 1]
        self.sqn[node] = np.sum(row * row, axis=-1)[0]
        level = int(-np.log(self.rng.uniform(low=1e-12, high=1.0)) * self.ml)
        self.levels[node] = level
        self._ensure_level(level)
        self.n += 1
        if self.entry < 0:
            self.entry = node
            self.max_level = level
            return node
        # greedy descent through layers above `level` (search factor 1)
        sim_e = float(self._sims(node, [self.entry])[0])
        eps = [(sim_e, self.entry)]
        for l in range(self.max_level, level, -1):
            eps = self._search_layer(x, eps, l, ef=1, qnode=node)[:1]
        # insert with beam efC in layers min(level, max_level)..0
        for l in range(min(level, self.max_level), -1, -1):
            found = self._search_layer(x, eps, l, ef=self.efc, qnode=node)
            m = self.m0 if l == 0 else self.mu
            nbrs = self._select_heuristic(x, found, m)
            self._connect(node, nbrs, l)
            eps = found
        if level > self.max_level:
            self.max_level = level
            self.entry = node
        return node


def build_hnsw(data: np.ndarray,
               metric: str = "l2",
               max_degree: int = 32,
               max_degree_upper: int = 16,
               ef_construction: int = 100,
               seed: int = 0,
               ids: Optional[np.ndarray] = None,
               tags: Optional[np.ndarray] = None) -> HNSWGraph:
    """Alg. 2: sequential-insert HNSW construction (host-side).

    ``tags`` ([n] int64 bitsets, dataset order) are carried as metadata —
    they never influence construction, so tagged and untagged builds of
    the same data are graph-identical.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data.shape
    if n == 0:
        return empty_hnsw(d, metric=metric, max_degree=max_degree)
    b = _Builder(d, metric, max_degree, max_degree_upper,
                 ef_construction, seed, capacity=n)
    for i in range(n):
        b.add(data[i])
    neighbors = [b.adj[l][:n] for l in range(len(b.adj))] or [
        np.full((n, max_degree), -1, dtype=np.int32)]
    if ids is None:
        ids = np.arange(n, dtype=np.int64)
    if tags is not None:
        tags = np.asarray(tags, dtype=np.int64)
    return HNSWGraph(
        data=data, ids=np.asarray(ids), neighbors=neighbors,
        levels=b.levels[:n], entry=b.entry, metric=metric, tags=tags)


def empty_hnsw(d: int, *, metric: str = "l2",
               max_degree: int = 32) -> HNSWGraph:
    """A zero-item sub-HNSW (entry = -1). Deleting every item of a shard
    leaves this — the shard keeps its routing slot (meta centers still
    label it) but contributes nothing: searches skip it, and the arena
    stacks it as a single pad row (id -1) that every merge filters."""
    return HNSWGraph(
        data=np.zeros((0, d), dtype=np.float32),
        ids=np.zeros((0,), dtype=np.int64),
        neighbors=[np.full((0, max_degree), -1, dtype=np.int32)],
        levels=np.zeros((0,), dtype=np.int32),
        entry=-1, metric=metric,
        tags=np.zeros((0,), dtype=np.int64))


# ---------------------------------------------------------------------------
# Search (PyTorch, Alg. 1)
# ---------------------------------------------------------------------------


def _greedy_descend(data: torch.Tensor, upper: torch.Tensor,
                    entry: torch.Tensor, num_upper_levels: torch.Tensor,
                    graph: torch.Tensor, queries: torch.Tensor, metric: str,
                    *, scale: Optional[torch.Tensor] = None,
                    zero: Optional[torch.Tensor] = None,
                    max_steps: int = 64) -> torch.Tensor:
    """Greedy walk through the upper layers (search factor 1), batched
    over rows that may each sit in another graph of a stack.

    Args:
      data: [w, n, d] rows; upper: [w, L, n, Mu]; entry,
        num_upper_levels: [w]; graph: [R] graph index of each row;
        queries: [R, d].

    Returns the bottom-layer entry node of every row ([R] int64). A row
    moves to its best neighbour while that is strictly better, at most
    ``max_steps`` times per level; levels at or above the graph's own
    ``num_upper_levels`` are skipped.
    """
    graph = graph.long()
    node = entry.long()[graph]
    nul = num_upper_levels.long()[graph]
    g_col = graph[:, None]
    for lvl in range(upper.shape[1] - 1, -1, -1):
        on_level = lvl < nul
        if not bool(on_level.any()):
            continue
        cur = node
        cur_sim = score_rows(queries, data[graph, cur][:, None, :], metric,
                             scale, zero)[:, 0]
        moving = on_level
        for _ in range(max_steps):
            if not bool(moving.any()):
                break
            nbrs = upper[graph, lvl, cur].long()             # [R, Mu]
            sims = torch.where(
                nbrs >= 0, score_rows(queries, data[g_col, nbrs.clamp(min=0)],
                                      metric, scale, zero), -torch.inf)
            j = torch.argmax(sims, dim=1, keepdim=True)
            best = sims.gather(1, j)[:, 0]
            better = moving & (best > cur_sim)
            cur = torch.where(better, nbrs.gather(1, j)[:, 0], cur)
            cur_sim = torch.where(better, best, cur_sim)
            moving = better
        node = torch.where(on_level, cur, node)
    return node


def _descend_one_graph(g: HNSWArrays, queries: torch.Tensor, metric: str,
                       max_steps: int) -> torch.Tensor:
    dev = g.device
    rows = queries.shape[0]
    return _greedy_descend(
        g.data[None], g.upper[None],
        torch.tensor([g.entry], device=dev),
        torch.tensor([g.num_upper_levels], device=dev),
        torch.zeros(rows, dtype=torch.long, device=dev), queries, metric,
        scale=g.scale, zero=g.zero, max_steps=max_steps)


def _beam_search_bottom(g: HNSWArrays, q: torch.Tensor, entry: int,
                        metric: str, ef: int, max_iters: int):
    """Per-query best-first beam search on the bottom layer (Alg. 1
    Search-Level with search factor ef). Returns (scores [ef'], node ids
    [ef']) best-first."""
    n, m0 = g.bottom.shape
    ef = min(ef, n)
    dev = g.device
    visited = torch.zeros(n, dtype=torch.bool, device=dev)
    visited[entry] = True
    beam_i = torch.full((ef,), -1, dtype=torch.long, device=dev)
    beam_i[0] = entry
    beam_s = torch.full((ef,), -torch.inf, dtype=torch.float32, device=dev)
    beam_s[0] = g.score_nodes(q[None], torch.tensor([[entry]], device=dev),
                              metric)[0, 0]
    expanded = torch.zeros(ef, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        live = ~expanded & (beam_i >= 0)
        if not bool(live.any()):
            break
        j = int(torch.argmax(torch.where(live, beam_s, -torch.inf)))
        expanded[j] = True
        nbrs = g.bottom[int(beam_i[j])].long()
        rows = nbrs.clamp(min=0)
        valid = (nbrs >= 0) & ~visited[rows]
        sims = torch.where(valid, g.score_nodes(q[None], rows[None],
                                                metric)[0], -torch.inf)
        visited[nbrs[nbrs >= 0]] = True
        all_s = torch.cat([beam_s, sims])
        all_i = torch.cat([beam_i, torch.where(valid, nbrs, -1)])
        all_e = torch.cat([expanded, torch.zeros(m0, dtype=torch.bool,
                                                 device=dev)])
        top_s, order = torch.sort(all_s, descending=True, stable=True)
        beam_s, beam_i, expanded = top_s[:ef], all_i[order[:ef]], \
            all_e[order[:ef]]
    return beam_s, beam_i


def _top_external(g: HNSWArrays, scores: torch.Tensor, nodes: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-first top-k of [B, e] walk output, nodes -> external ids,
    (-1, -inf) padded to k. Ties keep walk order (stable sort)."""
    kk = min(k, scores.shape[1])
    top_s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s = top_s[:, :kk]
    top_n = nodes.gather(1, order[:, :kk]).long()
    ext = torch.where(top_n >= 0, g.ids[top_n.clamp(min=0)], -1)
    if kk < k:
        b = scores.shape[0]
        ext = torch.cat([ext, torch.full((b, k - kk), -1, dtype=ext.dtype,
                                         device=ext.device)], dim=1)
        top_s = torch.cat([top_s, torch.full((b, k - kk), -torch.inf,
                                             device=top_s.device)], dim=1)
    return ext.to(torch.int32), top_s


def search_one(g: HNSWArrays, q: torch.Tensor, *, metric: str, k: int,
               ef: int, max_iters: int = 400, max_steps: int = 64,
               tag_words: Optional[torch.Tensor] = None,
               filter_words: Optional[torch.Tensor] = None):
    """One query against one graph, as a per-query loop: greedy descent,
    bottom-layer beam search, optional alive-mask on the emitted
    candidates, top-k, node -> external id. The oracle of the batched
    path. Returns (ids [k] i32, scores [k] f32) best-first."""
    ef = max(ef, k)
    entry = int(_descend_one_graph(g, q[None], metric, max_steps)[0])
    scores, nodes = _beam_search_bottom(g, q, entry, metric, ef, max_iters)
    if tag_words is not None and filter_words is not None:
        alive = F.alive_words(tag_words[nodes.clamp(min=0)], filter_words)
        scores = torch.where(alive, scores, -torch.inf)
        nodes = torch.where(alive, nodes, -1)
    ext, top_s = _top_external(g, scores[None], nodes[None], k)
    return ext[0], top_s[0]


def search_batch(g: HNSWArrays, queries: torch.Tensor, *, metric: str,
                 k: int, ef: int, max_iters: int = 400,
                 max_steps: int = 64,
                 tag_words: Optional[torch.Tensor] = None,
                 filter_words: Optional[torch.Tensor] = None):
    """Batched search: greedy descent for every query, then ONE fused
    bottom-layer walk for the whole batch through ``beam_search``.
    ``tag_words`` ([n, 2] i32) + ``filter_words`` ([B, 2] i32) apply the
    alive-mask. Returns (ids [B, k] i32, scores [B, k] f32)."""
    ef = max(ef, k)
    entries = _descend_one_graph(g, queries, metric, max_steps)
    scores, nodes = beam_search(
        g.data[None], g.bottom[None], queries[None],
        entries[None].to(torch.int32), metric=metric, ef=ef,
        max_iters=max_iters, scale=g.scale, zero=g.zero,
        tag_words=None if tag_words is None else tag_words[None],
        filter_words=None if filter_words is None else filter_words[None])
    return _top_external(g, scores[0], nodes[0], k)


def hnsw_search(g: HNSWArrays, queries: torch.Tensor, *, metric: str,
                k: int, ef: int = 100, max_iters: int = 400,
                impl: str = "fused",
                tag_words: Optional[torch.Tensor] = None,
                filter_words: Optional[torch.Tensor] = None):
    """Batched HNSW search (Alg. 1) on the graph's device.

    impl: "fused" (default) walks the whole batch through the fused
    beam-walk op; "loop" runs :func:`search_one` per query. Results are
    identical. Returns (ids [B, k] i32 external ids (-1 pad), scores
    [B, k] f32) best-first.
    """
    queries = torch.as_tensor(queries, dtype=torch.float32).to(g.device)
    if impl == "fused":
        return search_batch(g, queries, metric=metric, k=k, ef=ef,
                            max_iters=max_iters, tag_words=tag_words,
                            filter_words=filter_words)
    if impl != "loop":
        raise ValueError(f"unknown impl {impl!r}")
    outs = [search_one(g, q, metric=metric, k=k, ef=ef, max_iters=max_iters,
                       tag_words=tag_words,
                       filter_words=None if filter_words is None
                       else filter_words[i])
            for i, q in enumerate(queries)]
    if not outs:
        return (torch.zeros((0, k), dtype=torch.int32, device=g.device),
                torch.zeros((0, k), dtype=torch.float32, device=g.device))
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def search_numpy(graph: HNSWGraph, queries: np.ndarray, k: int,
                 ef: int = 100, *, filter_tags=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side reference search (used during index building, Alg. 3 line 8,
    and as an oracle in tests).

    ``filter_tags`` (scalar int64, or [B] per query) applies the
    metadata alive-mask of ``repro_torch.core.filters`` on the walk's
    candidate set — the same navigate-unfiltered / emit-filtered
    contract as the device paths.
    """
    b = _Builder.__new__(_Builder)  # reuse _search_layer without re-init
    b.metric = graph.metric
    b.data = graph.data
    b.adj = graph.neighbors
    nq = queries.shape[0]
    out_ids = np.full((nq, k), -1, dtype=np.int64)
    out_scores = np.full((nq, k), -np.inf, dtype=np.float32)
    if graph.n == 0:
        return out_ids, out_scores
    filters = None
    if filter_tags is not None:
        filters = np.broadcast_to(
            np.asarray(filter_tags, dtype=np.int64), (nq,))
        tags = graph.tags_or_zeros()
    for i, q in enumerate(np.asarray(queries, dtype=np.float32)):
        sim_e = float(M.similarity_matrix_np(
            q[None, :], graph.data[graph.entry][None, :], graph.metric)[0, 0])
        eps = [(sim_e, graph.entry)]
        for l in range(graph.max_level, 0, -1):
            eps = b._search_layer(q, eps, l, ef=1)[:1]
        found = b._search_layer(q, eps, 0, ef=max(ef, k))
        if filters is not None and filters[i] != 0:
            found = [(s, v) for s, v in found
                     if F.alive_np(tags[v], filters[i])]
        for j, (s, v) in enumerate(found[:k]):
            out_ids[i, j] = graph.ids[v]
            out_scores[i, j] = s
    return out_ids, out_scores
