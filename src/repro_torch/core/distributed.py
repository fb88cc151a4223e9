"""Alg. 4 query processing (port of ``repro.core.distributed``), on one
device and across the ranks of a mesh.

``search_single_host`` is the one-device entry point: it routes on the
index's device, then runs the arena pipeline with a precomputed mask and
capacity = the actual max per-shard load (no capacity drops), with the
batch padded to a power of two and the capacity rounded up to a multiple
of 32, as the reference does. ``search_single_host_python`` keeps the
per-shard Python loop with a host merge as an independent oracle.

``make_pyramid_search_fn`` is the SPMD program over a ``DeviceMesh``
(``repro_torch.launch.mesh``), called on every rank: each rank holds w /
|model| consecutive shards (:func:`local_arena`), routes its queries
through the replicated meta-HNSW, walks its shards under the capacity C
= ceil(B * K / w * capacity_factor), and the partials of every rank are
gathered over ``model`` (NCCL on the card, gloo on the CPU) into the same
scatter and dedup merge as the one-device pipeline -- the coordinator
merge of Alg. 4 line 9.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import filters as F
from repro_torch.core import hnsw as H
from repro_torch.core import metrics as M
from repro_torch.core import quant as Q
from repro_torch.core.arena import (QuantizedShardArena, ShardArena,
                                    arena_search, scatter_partials,
                                    shard_search)
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.core.router import route_queries
from repro_torch.kernels.merge_topk import merge_topk
from repro_torch.launch.mesh import axis_size, mesh_device


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


# ---------------------------------------------------------------------------
# SPMD path: every rank of a mesh runs the arena stages on its own shards
# ---------------------------------------------------------------------------


def local_shards(mesh, num_shards: int, model_axis: str = "model") -> range:
    """The shards this rank holds: the ``model``-rank's block of w /
    |model| consecutive shards."""
    n_model = axis_size(mesh, model_axis)
    if num_shards % n_model:
        raise ValueError(f"{num_shards} shards do not split over "
                         f"{n_model} ranks of {model_axis!r}")
    w_local = num_shards // n_model
    start = mesh.get_local_rank(model_axis) * w_local
    return range(start, start + w_local)


def local_arena(index: PyramidIndex, mesh, *, quantize: bool = False,
                model_axis: str = "model") -> ShardArena:
    """This rank's slice of ``index``'s arena (float32, or int8 with
    ``quantize``) on the index's device, stacked from its own shards
    only. When the rank holds every shard it is ``index.arena(...)``
    itself, with no second copy."""
    shards = local_shards(mesh, index.num_shards, model_axis)
    dtype = "int8" if quantize else "float32"
    if len(shards) == index.num_shards:
        return index.arena(dtype)
    if quantize:
        return QuantizedShardArena.from_index(
            index, index.device, index.quant_params(), shards=shards)
    return ShardArena.from_index(index, index.device, shards=shards)


def _gather_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated on the leading axis in
    rank order: [w_local, ...] partials over ``model`` give [w, ...] in
    shard order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def make_pyramid_search_fn(mesh, cfg: PyramidConfig, *, k: int, batch: int,
                           ef: Optional[int] = None, max_iters: int = 400,
                           naive: bool = False, model_axis: str = "model",
                           data_axis: Optional[str] = None,
                           quantize: bool = False, rerank_factor: int = 4,
                           index: Optional[PyramidIndex] = None):
    """Builds the SPMD search step of a ``DeviceMesh``, called on every
    rank.

    The returned fn has signature
      fn(local_arena, meta: HNSWArrays, part_of_center [m],
         queries [B, d]) -> (ids [B, k] i32, scores [B, k] f32)
    with ``local_arena`` this rank's shards (:func:`local_arena`), meta
    and ``part_of_center`` replicated, and the queries preprocessed.
    Every rank routes the queries, walks its shards under the capacity
    C = ceil(batch * K / w * capacity_factor) (C = batch for the naive
    baseline, which sends every query to every shard), then gathers
    every rank's partials over ``model_axis`` and runs the scatter and
    the dedup merge; every rank of the axis returns the same answer.

    When ``data_axis`` is given, the query batch is split over it: each
    of its ranks is a replica group of the whole index (the paper's
    replication axis) and serves its own ``batch`` rows of the global
    batch ``queries`` ([batch * |data|, d]), ``batch`` being the
    PER-REPLICA batch; the replicas' answers are gathered over
    ``data_axis`` in rank order, so every rank returns the global
    answer, as the reference's ``P(data_axis)`` in and out specs do.

    With ``quantize=True`` the fn takes the rank's int8 arena, walks
    and merges the top ``rerank_factor * k`` candidates on the device,
    then reranks them exactly in float32 on the host against
    ``index.rerank_table()`` read at call time, so ``index`` is required;
    that fn returns numpy ``(ids [B, k] int64, scores [B, k] f32)``.
    """
    metric = "ip" if cfg.is_mips else cfg.metric
    ef = ef or cfg.ef_search
    k_inner = k * rerank_factor if quantize else k
    ef = max(ef, k_inner)
    if quantize and index is None:
        raise ValueError(
            "make_pyramid_search_fn(quantize=True) needs index= for the "
            "exact float32 rerank table")
    w = cfg.num_shards
    shards = local_shards(mesh, w, model_axis)
    if naive:
        capacity = batch
    else:
        capacity = int(np.ceil(
            batch * cfg.branching_factor / w * cfg.capacity_factor))
        capacity = max(1, min(batch, capacity))
    group = mesh.get_group(model_axis)
    dev = mesh_device(mesh)
    if data_axis:
        n_data = axis_size(mesh, data_axis)
        replica = mesh.get_local_rank(data_axis)
        data_group = mesh.get_group(data_axis)

    def spmd(arena: ShardArena, meta: H.HNSWArrays,
             part_of_center: torch.Tensor, queries):
        queries = torch.as_tensor(queries).to(dev)
        if data_axis:
            if queries.shape[0] != batch * n_data:
                raise ValueError(
                    f"{queries.shape[0]} queries do not split into "
                    f"{n_data} replicas of batch={batch} over {data_axis!r}")
            queries = queries[replica * batch:(replica + 1) * batch]
        b = queries.shape[0]
        if naive:
            mask = torch.ones((b, w), dtype=torch.bool, device=dev)
        else:
            mask, _ = route_queries(
                meta, part_of_center, queries, metric=metric,
                branching_factor=cfg.branching_factor, num_shards=w,
                ef=max(64, cfg.branching_factor))
        qidx, ids, scores = shard_search(
            arena, mask[:, shards.start:shards.stop], queries,
            metric=metric, k=k_inner, ef=ef, capacity=capacity,
            max_iters=max_iters)
        # the coordinator merge: every rank's partials, in shard order
        # (merge_topk breaks ties by position), then the same scatter and
        # dedup merge as the one-device pipeline
        qidx, ids, scores = (_gather_ranks(t, group)
                             for t in (qidx, ids, scores))
        flat_s, flat_i = scatter_partials(qidx, ids, scores, b)
        top_s, top_i = merge_topk(flat_s, flat_i, k=k_inner)
        if data_axis:   # every replica's rows, in data-rank order
            top_i, top_s = (_gather_ranks(t, data_group)
                            for t in (top_i, top_s))
        return top_i, top_s

    if not quantize:
        return spmd

    def reranked(arena, meta, part_of_center, queries):
        cand_ids, _ = spmd(arena, meta, part_of_center, queries)
        # the table is read at CALL time: it is memoised on the index and
        # dropped by invalidate_device_cache, so ids added since the fn
        # was built are reranked against their own rows
        table_ids, table_vecs = index.rerank_table()
        q = torch.as_tensor(queries).cpu().numpy()
        return Q.exact_rerank_np(
            q, cand_ids.cpu().numpy(), k, table_ids=table_ids,
            table_vecs=table_vecs, metric=metric)

    return reranked
