"""Alg. 4 query processing on one device (port of the single-host half
of ``repro.core.distributed``).

``search_single_host`` is the entry point: it routes on the index's
device, then runs the arena pipeline with a precomputed mask and
capacity = the actual max per-shard load (no capacity drops), with the
batch padded to a power of two and the capacity rounded up to a multiple
of 32, as the reference does. ``search_single_host_python`` keeps the
per-shard Python loop with a host merge as an independent oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import filters as F
from repro_torch.core import hnsw as H
from repro_torch.core import metrics as M
from repro_torch.core import quant as Q
from repro_torch.core.arena import arena_search
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.core.router import route_queries


def _pow2(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


def _route(index: PyramidIndex, q: np.ndarray, naive: bool,
           kb: int, metric: str) -> np.ndarray:
    b, w = q.shape[0], index.num_shards
    if naive:
        return np.ones((b, w), dtype=bool)
    mask, _ = route_queries(
        index.meta_arrays(), index.part_of_center_tensor(),
        torch.as_tensor(q).to(index.device), metric=metric,
        branching_factor=kb, num_shards=w, ef=max(64, kb))
    return mask.cpu().numpy()


def search_single_host(index: PyramidIndex, queries: np.ndarray, k: int, *,
                       ef: Optional[int] = None,
                       branching_factor: Optional[int] = None,
                       naive: bool = False, quantize: bool = False,
                       rerank_factor: int = 4, filter_tags=None):
    """Alg. 4 on the index's device (``index.device``, CUDA unless the
    index was built or converted for the CPU).

    naive=True searches every shard (the HNSW-naive baseline).
    quantize=True walks the int8 arena, keeps ``rerank_factor * k``
    candidates and reranks them exactly in float32 against
    ``index.rerank_table()``. ``filter_tags`` (scalar int64, or [B])
    applies the tag alive-mask at the walk's candidate emission and
    inflates the candidate budget by 1/selectivity (capped).

    Returns (ids [B, k] int64, scores [B, k] f32, mask [B, w] bool) as
    numpy arrays.
    """
    resolve_device(index.device)
    cfg = index.config
    ef = ef or cfg.ef_search
    kb = branching_factor or cfg.branching_factor
    metric = "ip" if cfg.is_mips else cfg.metric
    q = M.preprocess_queries(queries, cfg.metric).astype(np.float32)
    b = q.shape[0]
    w = index.num_shards
    dev = index.device
    arena = index.arena("int8" if quantize else "float32")

    tag_words = None
    filters_np = None
    inflate = 1
    if filter_tags is not None:
        filters_np = np.broadcast_to(
            np.asarray(filter_tags, dtype=np.int64), (b,)).copy()
        if np.any(filters_np != 0):
            tag_words = index.tags_arena()
            sel = min(F.selectivity_np(index.tags_host(), int(f))
                      for f in np.unique(filters_np))
            inflate = F.inflation(sel)
        else:
            filters_np = None

    k_search = (k * rerank_factor if quantize else k) * inflate
    ef = max(ef * inflate, k_search)
    mask = _route(index, q, naive, kb, metric)

    bp = _pow2(b)
    qp, mp, fp = q, mask, filters_np
    if bp > b:   # pad with the first query, routed nowhere
        qp = np.concatenate([q, np.repeat(q[:1], bp - b, axis=0)])
        mp = np.concatenate([mask, np.zeros((bp - b, w), dtype=bool)])
        if fp is not None:   # pad rows run unfiltered (routed nowhere)
            fp = np.concatenate([fp, np.zeros(bp - b, np.int64)])
    max_load = int(mp.sum(axis=0).max())
    capacity = min(bp, max(32, -(-max_load // 32) * 32))

    filter_words = None
    if fp is not None:
        filter_words = torch.as_tensor(F.filter_words(fp)).to(dev)
    ids, scores, _ = arena_search(
        arena, None, None, torch.as_tensor(qp).to(dev), metric=metric,
        k=k_search, ef=ef, capacity=capacity,
        mask=torch.as_tensor(mp).to(dev), tag_words=tag_words,
        filter_words=filter_words)
    ids = ids.cpu().numpy()
    if quantize:
        table_ids, table_vecs = index.rerank_table()
        out_ids, out_scores = Q.exact_rerank_np(
            q, ids[:b], k, table_ids=table_ids, table_vecs=table_vecs,
            metric=metric)
        return out_ids, out_scores, mask
    return (ids[:b, :k].astype(np.int64), scores.cpu().numpy()[:b, :k],
            mask)


def search_single_host_python(index: PyramidIndex, queries: np.ndarray,
                              k: int, *, ef: Optional[int] = None,
                              branching_factor: Optional[int] = None,
                              naive: bool = False):
    """Oracle: per-shard ``hnsw_search`` on each sub-graph's own tensors,
    then a per-query Python dedup merge. Same return contract as
    :func:`search_single_host`."""
    resolve_device(index.device)
    cfg = index.config
    ef = ef or cfg.ef_search
    kb = branching_factor or cfg.branching_factor
    metric = "ip" if cfg.is_mips else cfg.metric
    q = M.preprocess_queries(queries, cfg.metric).astype(np.float32)
    b = q.shape[0]
    w = index.num_shards
    mask = _route(index, q, naive, kb, metric)

    all_scores = np.full((b, w, k), -np.inf, np.float32)
    all_ids = np.full((b, w, k), -1, np.int64)
    for s in range(w):
        sel = np.where(mask[:, s])[0]
        if sel.size == 0 or index.subs[s].n == 0:
            continue
        arrs = index.subs[s].device_arrays(index.device)
        kk = min(k, index.subs[s].n)
        ids, scores = H.hnsw_search(
            arrs, torch.as_tensor(q[sel]).to(index.device), metric=metric,
            k=kk, ef=ef)
        all_ids[sel, s, :kk] = ids.cpu().numpy()
        all_scores[sel, s, :kk] = scores.cpu().numpy()
    out_ids, out_scores = python_loop_merge(
        all_scores.reshape(b, -1), all_ids.reshape(b, -1), k)
    return out_ids, out_scores, mask


def python_loop_merge(flat_scores: np.ndarray, flat_ids: np.ndarray,
                      k: int):
    """Per-query Python dedup merge (argsort + ``set``)."""
    b = flat_scores.shape[0]
    order = np.argsort(-flat_scores, axis=1, kind="stable")
    out_ids = np.full((b, k), -1, np.int64)
    out_scores = np.full((b, k), -np.inf, np.float32)
    for i in range(b):
        seen = set()
        j = 0
        for idx in order[i]:
            v = int(flat_ids[i, idx])
            if v < 0 or v in seen:
                continue
            seen.add(v)
            out_ids[i, j] = v
            out_scores[i, j] = flat_scores[i, idx]
            j += 1
            if j == k:
                break
    return out_ids, out_scores
