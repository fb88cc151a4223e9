"""ShardArena -- the single device form of a PyramidIndex (port of
``repro.core.arena``).

All w sub-HNSWs are stacked on a leading shard axis, equal-padded with
isolated nodes (all -1 neighbours, id -1, zero vector) that the walk can
never reach nor return. ``arena_search`` is the route -> per-shard
capacity-bounded walk -> dedup-top-k merge pipeline:

  * ``shard_search`` drains each shard's queue of routed queries, runs
    the batched greedy descent, then ONE ``beam_search`` call over every
    (shard, slot) row (the CUDA kernel on the card); empty slots (the
    dummy row B) neither descend nor walk (entry -1), where the
    reference walks them from a clamped query and masks their output;
  * ``scatter_partials`` puts the per-shard partials back on query rows;
  * ``merge_topk`` (the CUDA kernel on the card) dedups and keeps k.

A :class:`QuantizedShardArena` is the int8 twin: codes on the index's
frozen per-dimension grid, scored asymmetrically inside the same walk.
Only the reference's ``"kernel"`` shard-axis strategy exists here;
``"vmap"`` and ``"map"`` are accepted and run the same code.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hnsw as H
from repro_torch.core.router import route_queries
from repro_torch.kernels.beam_search import beam_search
from repro_torch.kernels.merge_topk import merge_topk

SHARD_AXES = ("kernel", "vmap", "map")


@dataclasses.dataclass
class ShardArena:
    """All w sub-HNSWs stacked on a leading shard axis."""

    data: torch.Tensor     # [w, n_pad, d] f32
    ids: torch.Tensor      # [w, n_pad] i32 (-1 pad)
    bottom: torch.Tensor   # [w, n_pad, M0] i32
    upper: torch.Tensor    # [w, L, n_pad, Mu] i32
    entry: torch.Tensor    # [w] i32
    num_upper_levels: torch.Tensor  # [w] i32

    scale = None
    zero = None

    def __post_init__(self):
        self._views: Dict[int, H.HNSWArrays] = {}

    @property
    def num_shards(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def vector_nbytes(self) -> int:
        """Bytes of the vector payload (what quantization compresses:
        the rows, and the int8 grid's scale and zero)."""
        return int(sum(t.nbytes for t in (self.data, self.scale, self.zero)
                       if t is not None))

    @property
    def total_nbytes(self) -> int:
        return int(sum(getattr(self, f.name).nbytes
                       for f in dataclasses.fields(self)))

    def shard(self, i: int) -> H.HNSWArrays:
        """Uncached view of shard ``i``: its slices of the stacked
        tensors (no copy), as the graph that ``hnsw_search`` walks."""
        g = dict(data=self.data[i], ids=self.ids[i], bottom=self.bottom[i],
                 upper=self.upper[i], entry=int(self.entry[i]),
                 num_upper_levels=int(self.num_upper_levels[i]))
        if self.scale is None:
            return H.HNSWArrays(**g)
        return H.QuantHNSWArrays(**g, scale=self.scale[i], zero=self.zero[i])

    def shard_view(self, i: int) -> H.HNSWArrays:
        """Memoised view of shard ``i``: every executor replica serving
        the shard shares one set of device tensors, and the arena is
        memoised per index, so an engine holds one device copy."""
        if i not in self._views:
            self._views[i] = self.shard(i)
        return self._views[i]

    @classmethod
    def from_index(cls, index, device,
                   shards: Optional[range] = None) -> "ShardArena":
        """The arena of ``index.subs[shards]`` (all of them by default), on
        ``device``."""
        st = _stack_host(index, shards=shards)
        return cls(**{k: torch.as_tensor(v).to(device) for k, v in st.items()})


@dataclasses.dataclass
class QuantizedShardArena(ShardArena):
    """Int8 arena: ``data`` holds codes on the index's frozen grid;
    ``scale``/``zero`` are the global grid tiled per shard ([w, d])."""

    scale: torch.Tensor = None   # [w, d] f32
    zero: torch.Tensor = None    # [w, d] f32

    @classmethod
    def from_index(cls, index, device, params=None,
                   shards: Optional[range] = None) -> "QuantizedShardArena":
        params = params or index.quant_params()
        st = _stack_host(index, quantize=params.quantize, shards=shards)
        w = st["data"].shape[0]
        st["scale"] = np.tile(params.scale[None, :], (w, 1))
        st["zero"] = np.tile(params.zero[None, :], (w, 1))
        return cls(**{k: torch.as_tensor(v).to(device) for k, v in st.items()})


def _stack_host(index, quantize=None,
                shards: Optional[range] = None) -> Dict[str, np.ndarray]:
    """Stack ``index.subs`` (those of ``shards`` only, when given) into
    equal-padded host arrays. The padding is the whole index's, so a slice
    of shards stacks to that slice of the whole arena. ``quantize`` maps
    each shard's [n, d] float rows to int8 codes for the quantized arena;
    pad rows stay zero (they are unreachable)."""
    subs = index.subs
    n_pad = max(1, max(g.n for g in subs))
    l_pad = max(1, max(g.max_level for g in subs))
    mu = max([lv.shape[1] for g in subs for lv in g.neighbors[1:]],
             default=1)
    m0 = max(g.neighbors[0].shape[1] for g in subs)
    d = subs[0].d
    if shards is not None:
        subs = [subs[s] for s in shards]
    w = len(subs)

    data = np.zeros((w, n_pad, d),
                    np.int8 if quantize is not None else np.float32)
    ids = np.full((w, n_pad), -1, np.int32)
    bottom = np.full((w, n_pad, m0), -1, np.int32)
    upper = np.full((w, l_pad, n_pad, mu), -1, np.int32)
    entry = np.zeros((w,), np.int32)
    nul = np.zeros((w,), np.int32)
    for i, g in enumerate(subs):
        n = g.n
        data[i, :n] = quantize(g.data) if quantize is not None else g.data
        ids[i, :n] = g.ids
        bottom[i, :n, : g.neighbors[0].shape[1]] = g.neighbors[0]
        for lvl in range(1, g.max_level + 1):
            lv = g.neighbors[lvl]
            upper[i, lvl - 1, :n, : lv.shape[1]] = lv
        entry[i] = int(g.entry) if n else 0  # empty shard: enter pad row
        nul[i] = int(g.max_level)
    return {"data": data, "ids": ids, "bottom": bottom, "upper": upper,
            "entry": entry, "num_upper_levels": nul}


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------


def drain_queues(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """[B, w] routing mask -> [w, capacity] query rows per shard, in
    ascending order; empty and overflow slots hold the dummy row B."""
    b = mask.shape[0]
    col = mask.T
    _, order = torch.sort((~col).to(torch.int8), dim=1, stable=True)
    qidx = order[:, :capacity]
    return torch.where(col.gather(1, qidx), qidx, b)


def shard_search(arena: ShardArena, mask: torch.Tensor,
                 queries: torch.Tensor, *, metric: str, k: int, ef: int,
                 capacity: int, max_iters: int = 400,
                 shard_axis: str = "kernel",
                 tag_words: Optional[torch.Tensor] = None,
                 filter_words: Optional[torch.Tensor] = None):
    """Capacity-bounded beam search over every shard.

    Args:
      mask: [B, w] bool routing mask aligned with ``arena``.
      queries: [B, d] preprocessed queries.
      tag_words / filter_words: optional alive-mask: [w, n_pad, 2] i32
        item tag words and [B, 2] i32 per-query filter words. Dead
        candidates leave each shard as (-inf, -1).

    Returns (qidx [w, C] i32, ids [w, C, k] i32, scores [w, C, k] f32).
    """
    if shard_axis not in SHARD_AXES:
        raise ValueError(f"unknown shard_axis {shard_axis!r}")
    b, d = queries.shape
    w = arena.num_shards
    dev = queries.device
    qidx = drain_queues(mask, capacity)                      # [w, C]
    slot_valid = qidx < b
    qs = queries[qidx.clamp(max=b - 1)]                      # [w, C, d]
    scale = None if arena.scale is None else arena.scale[0]
    zero = None if arena.zero is None else arena.zero[0]
    graph = torch.arange(w, device=dev).repeat_interleave(capacity)
    # empty slots neither descend nor walk: entry -1
    valid = slot_valid.reshape(-1)
    entries = torch.full((w * capacity,), -1, dtype=torch.int64, device=dev)
    entries[valid] = H._greedy_descend(
        arena.data, arena.upper, arena.entry, arena.num_upper_levels,
        graph[valid], qs.reshape(w * capacity, d)[valid], metric,
        scale=scale, zero=zero, max_steps=64)
    entries = entries.reshape(w, capacity)
    fw = None
    if tag_words is not None and filter_words is not None:
        # the dummy row's zero words leave invalid slots unfiltered
        fw_pad = torch.cat([filter_words.to(torch.int32),
                            torch.zeros((1, 2), dtype=torch.int32,
                                        device=dev)])
        fw = fw_pad[qidx]
    scores, nodes = beam_search(
        arena.data, arena.bottom, qs, entries.to(torch.int32),
        metric=metric, ef=max(ef, k), max_iters=max_iters, scale=scale,
        zero=zero, tag_words=tag_words if fw is not None else None,
        filter_words=fw)
    kk = min(k, scores.shape[-1])
    top_s, order = torch.sort(scores, dim=2, descending=True, stable=True)
    top_s = top_s[:, :, :kk]
    top_n = nodes.gather(2, order[:, :, :kk]).long()
    ids_out = torch.where(
        top_n >= 0, arena.ids.long().gather(1, top_n.clamp(min=0).reshape(
            w, -1)).reshape(w, capacity, kk), -1)
    if kk < k:   # shards smaller than k: pad
        ids_out = torch.cat([ids_out, torch.full(
            (w, capacity, k - kk), -1, dtype=ids_out.dtype, device=dev)], 2)
        top_s = torch.cat([top_s, torch.full(
            (w, capacity, k - kk), -torch.inf, device=dev)], 2)
    ids_out = torch.where(slot_valid[:, :, None], ids_out, -1)
    scores_out = torch.where(slot_valid[:, :, None], top_s, -torch.inf)
    return qidx.to(torch.int32), ids_out.to(torch.int32), scores_out


def scatter_partials(qidx: torch.Tensor, ids: torch.Tensor,
                     scores: torch.Tensor, b: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard partials back to query rows: qidx [w, C], ids/scores
    [w, C, k] -> (scores [B, w*k] f32, ids [B, w*k] i32); the dummy row b
    absorbs invalid slots and is sliced off."""
    w, _, k = ids.shape
    dev = ids.device
    out_s = torch.full((b + 1, w, k), -torch.inf, device=dev)
    out_i = torch.full((b + 1, w, k), -1, dtype=torch.int32, device=dev)
    shard_col = torch.arange(w, device=dev)[:, None]
    q = qidx.long()
    out_s[q, shard_col] = scores
    out_i[q, shard_col] = ids
    return out_s[:b].reshape(b, w * k), out_i[:b].reshape(b, w * k)


def arena_search(arena: ShardArena, meta: Optional[H.HNSWArrays],
                 part_of_center: Optional[torch.Tensor],
                 queries: torch.Tensor, *, metric: str, k: int,
                 ef: int = 100, branching_factor: int = 4,
                 capacity: Optional[int] = None,
                 capacity_factor: float = 2.0, max_iters: int = 400,
                 naive: bool = False, mask: Optional[torch.Tensor] = None,
                 shard_axis: Optional[str] = None,
                 tag_words: Optional[torch.Tensor] = None,
                 filter_words: Optional[torch.Tensor] = None):
    """Distributed search over the device arena (Alg. 4): route through
    the meta-HNSW (unless ``mask`` is given or ``naive``), walk the
    routed shards under a per-shard capacity, merge with dedup top-k.

    capacity defaults to ``ceil(B * K / w * capacity_factor)`` (B when
    ``naive``). Returns (ids [B, k] i32, scores [B, k] f32, mask [B, w]).
    """
    b = queries.shape[0]
    w = arena.num_shards
    shard_axis = shard_axis or "kernel"
    if capacity is None:
        capacity = b if naive else int(np.ceil(
            b * branching_factor / w * capacity_factor))
    capacity = max(1, min(b, int(capacity)))
    if mask is None:
        if naive:
            mask = torch.ones((b, w), dtype=torch.bool, device=queries.device)
        else:
            mask, _ = route_queries(
                meta, part_of_center, queries, metric=metric,
                branching_factor=branching_factor, num_shards=w,
                ef=max(64, branching_factor))
    qidx, ids, scores = shard_search(
        arena, mask, queries, metric=metric, k=k, ef=ef, capacity=capacity,
        max_iters=max_iters, shard_axis=shard_axis, tag_words=tag_words,
        filter_words=filter_words)
    flat_s, flat_i = scatter_partials(qidx, ids, scores, b)
    top_s, top_i = merge_topk(flat_s, flat_i, k=k)
    return top_i, top_s, mask
