"""Similarity functions (port of ``repro.core.metrics``).

Larger is more similar (Sec. II): l2 uses s = -||q-x||^2 in the expanded
form ``2 q.x - |q|^2 - |x|^2``, ip uses q.x, angular the cosine with the
``+1e-12`` guard on both norms. The formulas are kept term for term so
that scores agree with the reference to the last bits that matter.
"""
from __future__ import annotations

import numpy as np
import torch

METRICS = ("l2", "ip", "angular")


def similarity_matrix(q: torch.Tensor, x: torch.Tensor,
                      metric: str) -> torch.Tensor:
    """Pairwise similarity, q:[B,d] x:[n,d] -> [B,n]. Larger = more similar."""
    if metric == "l2":
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        xn = torch.sum(x * x, dim=-1)
        return 2.0 * (q @ x.T) - qn - xn[None, :]
    if metric == "ip":
        return q @ x.T
    if metric == "angular":
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        return qn @ xn.T
    raise ValueError(f"unknown metric {metric!r}")


def row_similarity(q: torch.Tensor, rows: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """Per-row similarity: q [B, d] against its own rows [B, m, d] ->
    [B, m] (the batched form of ``similarity_matrix(q[None], rows)``)."""
    dot = torch.bmm(rows, q[:, :, None])[:, :, 0]
    if metric == "l2":
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        xn = torch.sum(rows * rows, dim=-1)
        return 2.0 * dot - qn - xn
    if metric == "ip":
        return dot
    if metric == "angular":
        qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12
        xn = torch.linalg.vector_norm(rows, dim=-1) + 1e-12
        return torch.bmm(rows / xn[:, :, None],
                         (q / qn)[:, :, None])[:, :, 0]
    raise ValueError(f"unknown metric {metric!r}")


def similarity_matrix_np(q: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    """Numpy twin of ``similarity_matrix`` for offline index building."""
    q = np.asarray(q, dtype=np.float32)
    x = np.asarray(x, dtype=np.float32)
    if metric == "l2":
        qn = np.sum(q * q, axis=-1, keepdims=True)
        xn = np.sum(x * x, axis=-1)
        return 2.0 * q @ x.T - qn - xn[None, :]
    if metric == "ip":
        return q @ x.T
    if metric == "angular":
        qn = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
        xn = x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
        return qn @ xn.T
    raise ValueError(f"unknown metric {metric!r}")


def brute_force_topk(q: np.ndarray, x: np.ndarray, k: int, metric: str):
    """Exact ground truth: (ids [B,k], scores [B,k]) by descending similarity."""
    sims = similarity_matrix_np(q, x, metric)
    k = min(k, x.shape[0])
    part = np.argpartition(-sims, k - 1, axis=1)[:, :k]
    part_scores = np.take_along_axis(sims, part, axis=1)
    order = np.argsort(-part_scores, axis=1)
    ids = np.take_along_axis(part, order, axis=1)
    scores = np.take_along_axis(part_scores, order, axis=1)
    return ids, scores


def preprocess_dataset(x: np.ndarray, metric: str) -> np.ndarray:
    """Dataset-side normalisation (angular -> unit norm, Sec. III-C)."""
    if metric == "angular":
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
    return np.asarray(x, dtype=np.float32)


def preprocess_queries(q: np.ndarray, metric: str) -> np.ndarray:
    if metric == "angular":
        return q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    return np.asarray(q, dtype=np.float32)
