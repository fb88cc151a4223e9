"""Query -> sub-HNSW routing (Alg. 4 lines 4-6), port of
``repro.core.router``.

Routing searches the small meta-HNSW for each query's top-K meta
neighbours and marks the partitions that hold them. The meta search is
``hnsw_search``, so on the card its bottom-layer walk is the CUDA beam
kernel (the reference forces its plain version here only because of
``shard_map``).
"""
from __future__ import annotations

import warnings
from typing import Set, Tuple

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
