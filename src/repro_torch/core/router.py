"""Query -> sub-HNSW routing (Alg. 4 lines 4-6), port of
``repro.core.router``.

Routing searches the small meta-HNSW for each query's top-K meta
neighbours and marks the partitions that hold them. The meta search is
``hnsw_search``, so on the card its bottom-layer walk is the CUDA beam
kernel (the reference forces its plain version here only because of
``shard_map``). :func:`refresh_centroids` rebuilds the routing layer from
the current items (online maintenance).
"""
from __future__ import annotations

import warnings
from typing import Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import hnsw as H

_EF_RAISED_WARNED: Set[Tuple[int, int]] = set()


def effective_ef(ef: int, branching_factor: int) -> int:
    """The beam width routing searches with: at least K."""
    return max(ef, branching_factor)


def route_queries(meta: H.HNSWArrays, part_of_center: torch.Tensor,
                  queries: torch.Tensor, *, metric: str,
                  branching_factor: int, num_shards: int,
                  ef: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mask [B, w] bool -- shard s must serve query b, meta_ids
    [B, K] -- the routed meta vertices). ``ef`` below K is raised to K,
    with a warning once per (ef, K)."""
    eff = effective_ef(ef, branching_factor)
    if eff != ef and (ef, branching_factor) not in _EF_RAISED_WARNED:
        _EF_RAISED_WARNED.add((ef, branching_factor))
        warnings.warn(
            f"route_queries: requested ef={ef} is narrower than "
            f"branching_factor K={branching_factor}; searching the "
            f"meta-HNSW with effective ef={eff}",
            RuntimeWarning, stacklevel=2)
    meta_ids, _ = H.hnsw_search(meta, queries, metric=metric,
                                k=branching_factor, ef=eff)
    meta_ids = meta_ids.long()
    parts = part_of_center.long()[meta_ids.clamp(min=0)]
    parts = torch.where(meta_ids >= 0, parts, num_shards)   # spare column
    mask = torch.zeros((queries.shape[0], num_shards + 1), dtype=torch.bool,
                       device=parts.device)
    mask.scatter_(1, parts, True)
    return mask[:, :num_shards], meta_ids.to(torch.int32)


def access_rate(mask: torch.Tensor) -> float:
    """Fraction of sub-HNSWs touched per query (paper Fig. 5 metric)."""
    mask = torch.as_tensor(mask)
    return float((mask.sum(dim=1) / mask.shape[1]).float().mean())


def refresh_centroids(index, *, seed: Optional[int] = None,
                      init_centers: Optional[np.ndarray] = None):
    """Recompute the routing layer from the CURRENT items (in place).

    Under sustained inserts and deletes the live data drifts away from
    the k-means centroids frozen at build time, and routing recall and
    balance decay. This re-runs the build's routing stages over today's
    vectors -- sample -> k-means++ -> meta-HNSW -> balanced min-cut
    partition -> item reassignment -- then rebuilds every sub-HNSW
    through ``shard_seed`` (``w`` stays fixed; split and merge change
    it, see ``repro_torch.build.planner``). Deterministic given ``seed``
    (the config's seed by default), so replay from the store reproduces
    the same index. The k-means assignment (the top-k scan kernel) and
    the item routing (the beam-walk kernel) run on the index's device;
    the graph builds on the host. ``init_centers`` fixes the k-means
    starting centres, as in ``plan_build``.
    """
    from repro_torch.core.kmeans import kmeans
    from repro_torch.core.meta_index import _assign_items, _sample
    from repro_torch.core.partition import balance_stats, partition_graph

    cfg = index.config
    seed = cfg.seed if seed is None else seed
    live = [g for g in index.subs if g.n]
    if not live:
        return index
    x = np.concatenate([g.data for g in live])
    ids = np.concatenate([g.ids for g in live])
    # MIPS norm-replication stores one id in several shards: collapse to
    # one row per global id before re-partitioning
    _, first = np.unique(ids, return_index=True)
    first = np.sort(first)
    x, ids = x[first], ids[first]
    n = x.shape[0]
    m = min(cfg.meta_size, max(cfg.num_shards, n // 4))
    rng = np.random.default_rng(seed)
    sample = _sample(x, cfg.sample_size, rng)
    centers, counts = kmeans(sample, m, iters=cfg.kmeans_iters,
                             spherical=cfg.is_mips, seed=seed,
                             init="kmeans++", init_centers=init_centers,
                             device=index.device)
    metric = "ip" if cfg.is_mips else cfg.metric
    meta = H.build_hnsw(np.asarray(centers, np.float32), metric=metric,
                        max_degree=cfg.max_degree,
                        max_degree_upper=cfg.max_degree_upper,
                        ef_construction=cfg.ef_construction, seed=seed)
    weights = np.asarray(counts, dtype=np.float64) + 1.0
    part_of_center = partition_graph(
        meta.neighbors[0], weights, cfg.num_shards, seed=seed)
    item_part = _assign_items(
        x, meta.device_arrays(index.device), part_of_center, metric)
    for s in range(cfg.num_shards):
        sel = item_part == s
        index.subs[s] = H.build_hnsw(
            x[sel], metric=metric, max_degree=cfg.max_degree,
            max_degree_upper=cfg.max_degree_upper,
            ef_construction=cfg.ef_construction,
            seed=H.shard_seed(cfg.seed, s), ids=ids[sel])
    index.meta = meta
    index.part_of_center = part_of_center.astype(np.int32)
    index.build_stats["sub_sizes"] = [g.n for g in index.subs]
    index.build_stats["total_stored"] = sum(g.n for g in index.subs)
    index.build_stats["balance"], _ = balance_stats(
        weights, part_of_center, cfg.num_shards)
    index.build_stats["centroid_refreshes"] = 1 + int(
        index.build_stats.get("centroid_refreshes", 0))
    index.invalidate_device_cache()
    return index
