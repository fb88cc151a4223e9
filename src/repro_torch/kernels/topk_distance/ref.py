"""Plain version of the top-k similarity scan (port of
``repro.kernels.topk_distance.ref``)."""
from __future__ import annotations

import torch


def similarities(queries: torch.Tensor, database: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """[B, d] x [n, d] -> [B, n] with the ref's formulas (angular as
    ``x / (|x| + 1e-12)`` on both sides)."""
    q = queries.to(torch.float32)
    x = database.to(torch.float32)
    if metric == "l2":
        return 2.0 * (q @ x.T) - torch.sum(q * q, -1, keepdim=True) \
            - torch.sum(x * x, -1)[None, :]
    if metric == "ip":
        return q @ x.T
    if metric == "angular":
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        return qn @ xn.T
    raise ValueError(metric)


def topk_similarity_ref(queries: torch.Tensor, database: torch.Tensor, *,
                        k: int, metric: str = "l2"):
    """Exact top-k by similarity, ties to the lowest database row.
    Returns (scores [B, k] f32 descending, ids [B, k] i32)."""
    sims = similarities(queries, database, metric)
    scores, ids = torch.sort(sims, dim=1, descending=True, stable=True)
    return scores[:, :k].contiguous(), ids[:, :k].to(torch.int32)
