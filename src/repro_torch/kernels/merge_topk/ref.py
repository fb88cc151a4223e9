"""Plain versions of the dedup-top-k merge (port of
``repro.kernels.merge_topk.ref``): Alg. 4 line 9, the coordinator
combine of per-shard partial lists ``[B, m]`` (scores, external ids).

Semantics shared by every implementation (CUDA kernel / torch / numpy):
  * ids < 0 are padding and never returned;
  * of a duplicate-id group only the best occurrence survives, score ties
    breaking to the lowest input position;
  * output is sorted descending, padded with (-inf, -1).
"""
from __future__ import annotations

import numpy as np
import torch


def merge_topk_ref(scores: torch.Tensor, ids: torch.Tensor, *, k: int):
    """k rounds of masked argmax; each round retires the winner and every
    other entry with its id. scores [B, m] f32, ids [B, m] int, k <= m.
    Returns (scores [B, k] f32 descending, ids [B, k] i32)."""
    ids = ids.to(torch.int32)
    s = torch.where(ids >= 0, scores.to(torch.float32), -torch.inf)
    cols = torch.arange(s.shape[1], device=s.device)[None, :]
    out_s, out_i = [], []
    for _ in range(k):
        j = torch.argmax(s, dim=1, keepdim=True)   # first of the maxima
        best_s = s.gather(1, j)
        alive = best_s > -torch.inf
        best_i = torch.where(alive, ids.gather(1, j), -1)
        out_s.append(torch.where(alive, best_s, -torch.inf))
        out_i.append(best_i)
        dup = (ids == best_i) & (best_i >= 0)
        s = torch.where((cols == j) | dup, -torch.inf, s)
    return torch.cat(out_s, dim=1), torch.cat(out_i, dim=1)


def merge_topk_np(scores: np.ndarray, ids: np.ndarray, *, k: int,
                  alive=None):
    """Numpy twin for host-side merging (the serving engine's coordinator
    merges tiny per-query lists). ``alive`` ([B, m] bool) demotes dead
    entries to (-inf, -1) before the merge. Returns (scores [B, k] f32
    descending, ids [B, k] int64)."""
    scores = np.asarray(scores, np.float32)
    ids = np.asarray(ids, np.int64)
    if alive is not None:
        ids = np.where(np.asarray(alive, bool), ids, -1)
    b, m = scores.shape
    s = np.where(ids >= 0, scores, -np.inf)
    eq = ids[:, :, None] == ids[:, None, :]
    beats = (s[:, :, None] > s[:, None, :]) | (
        (s[:, :, None] == s[:, None, :]) &
        (np.arange(m)[:, None] < np.arange(m)[None, :]))
    dominated = np.any(eq & beats & (ids >= 0)[:, :, None], axis=1)
    s = np.where(dominated, -np.inf, s)
    kk = min(k, m)
    order = np.argsort(-s, axis=1, kind="stable")[:, :kk]
    out_ids = np.full((b, k), -1, np.int64)
    out_scores = np.full((b, k), -np.inf, np.float32)
    out_scores[:, :kk] = np.take_along_axis(s, order, axis=1)
    out_ids[:, :kk] = np.take_along_axis(ids, order, axis=1)
    out_ids[:, :kk] = np.where(out_scores[:, :kk] > -np.inf,
                               out_ids[:, :kk], -1)
    return out_scores, out_ids
