"""Pyramid index container and construction (Alg. 3 / Alg. 5), port of
``repro.core.meta_index``.

A :class:`PyramidIndex` holds the meta-HNSW over k-means centers, the
partition label of every meta vertex, and w sub-HNSWs whose ids are
global. It carries its device: the arena, the meta-HNSW tensors and the
tag words are built there once and cached. An index published to an
``repro_torch.store.IndexStore`` is attached to that version's delta
log, which ``repro_torch.core.updates`` journals through.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import DeviceLike
from repro_torch.core import hnsw as H


@dataclasses.dataclass
class PyramidIndex:
    config: PyramidConfig
    meta: H.HNSWGraph                 # meta-HNSW over kmeans centers
    part_of_center: np.ndarray        # [m] int32: partition of each center
    subs: List[H.HNSWGraph]           # w sub-HNSWs (ids are global)
    build_stats: dict
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.invalidate_device_cache()
        self._quant_params = None
        self._delta_log = None

    @property
    def num_shards(self) -> int:
        return len(self.subs)

    def arena(self, dtype: str = "float32"):
        """The stacked device form, built once per storage dtype:
        ``"float32"`` -> ``ShardArena``, ``"int8"`` -> the
        ``QuantizedShardArena`` on this index's frozen grid."""
        if dtype not in self._arena:
            from repro_torch.core.arena import QuantizedShardArena, ShardArena
            if dtype == "float32":
                self._arena[dtype] = ShardArena.from_index(self, self.device)
            elif dtype == "int8":
                self._arena[dtype] = QuantizedShardArena.from_index(
                    self, self.device, self.quant_params())
            else:
                raise ValueError(f"arena dtype must be 'float32' or 'int8', "
                                 f"got {dtype!r}")
        return self._arena[dtype]

    def quant_params(self):
        """This index's frozen int8 grid, derived from per-dimension
        min/max over all shards on first use (or attached)."""
        if self._quant_params is None:
            from repro_torch.core.quant import QuantParams
            self._quant_params = QuantParams.from_data(
                [g.data for g in self.subs if g.n])
        return self._quant_params

    def attach_quant_params(self, params) -> None:
        self._quant_params = params

    def rerank_table(self):
        """Host-side exact-rerank lookup: (sorted unique ids [N], float32
        vectors [N, d]) over every item (replication deduped)."""
        if self._rerank_table is None:
            ids_all = np.concatenate(
                [np.asarray(g.ids, np.int64) for g in self.subs])
            vecs_all = np.concatenate(
                [np.asarray(g.data, np.float32) for g in self.subs])
            uniq, first = np.unique(ids_all, return_index=True)
            self._rerank_table = (uniq, np.ascontiguousarray(
                vecs_all[first]))
        return self._rerank_table

    def tags_arena(self) -> torch.Tensor:
        """Device tag words aligned with the arena: [w, n_pad, 2] int32,
        pad rows all-zero."""
        if self._tags_arena is None:
            from repro_torch.core.filters import split_tag_words
            n_pad = max(1, max((g.n for g in self.subs), default=1))
            host = np.zeros((self.num_shards, n_pad), dtype=np.int64)
            for i, g in enumerate(self.subs):
                if g.n:
                    host[i, : g.n] = g.tags_or_zeros()
            self._tags_arena = torch.as_tensor(
                split_tag_words(host)).to(self.device)
        return self._tags_arena

    def tags_host(self) -> np.ndarray:
        """All item tag bitsets concatenated over shards ([sum n] int64)."""
        if self._tags_host is None:
            parts = [g.tags_or_zeros() for g in self.subs]
            self._tags_host = (np.concatenate(parts) if parts
                               else np.zeros((0,), np.int64))
        return self._tags_host

    def meta_arrays(self) -> H.HNSWArrays:
        if self._meta_arrays is None:
            self._meta_arrays = self.meta.device_arrays(self.device)
        return self._meta_arrays

    def part_of_center_tensor(self) -> torch.Tensor:
        if self._part_of_center is None:
            self._part_of_center = torch.as_tensor(
                np.asarray(self.part_of_center, np.int32)).to(self.device)
        return self._part_of_center

    def sub_arrays(self, i: int) -> H.HNSWArrays:
        """Device view of shard ``i``: a slice of the shared arena (shape
        [n_pad, ...]; read ``subs[i].n`` for the item count)."""
        return self.arena().shard_view(i)

    def invalidate_device_cache(self) -> None:
        """Drop the cached device tensors after an in-place mutation of
        ``subs``/``meta`` (``repro_torch.core.updates``). The int8 grid
        stays frozen, so a rebuilt int8 arena requantizes the mutated
        data onto the same grid."""
        self._arena = {}
        self._meta_arrays = None
        self._part_of_center = None
        self._rerank_table = None
        self._tags_arena = None
        self._tags_host = None

    def delta_log(self):
        """The append-only update journal this index is attached to, or
        ``None``. Set by ``repro_torch.store.IndexStore`` on publish and
        load; ``repro_torch.core.updates`` writes through it."""
        return self._delta_log

    def attach_delta_log(self, log) -> None:
        self._delta_log = log

    _RUNTIME_STATE = ("_arena", "_meta_arrays", "_part_of_center",
                      "_rerank_table", "_tags_arena", "_tags_host",
                      "_delta_log")

    def __getstate__(self):
        # device caches and the store attachment are runtime state: never
        # pickled. The int8 grid travels (frozen semantic state), and the
        # device as a string, so a pickle holds no tensor
        state = {k: v for k, v in self.__dict__.items()
                 if k not in self._RUNTIME_STATE}
        state["device"] = str(self.device)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.device = torch.device(self.device)
        self.__dict__.setdefault("_quant_params", None)
        self.invalidate_device_cache()
        self._delta_log = None


def _sample(x: np.ndarray, n_sample: int, rng) -> np.ndarray:
    if n_sample >= x.shape[0]:
        return x
    idx = rng.choice(x.shape[0], size=n_sample, replace=False)
    return x[idx]


def _assign_items(x: np.ndarray, meta_arrays: H.HNSWArrays,
                  part_of_center: np.ndarray, metric: str,
                  batch: int = 4096) -> np.ndarray:
    """Alg. 3 lines 7-10: nearest meta vertex -> its partition, per item
    (meta search on the meta arrays' device)."""
    n = x.shape[0]
    out = np.zeros(n, dtype=np.int32)
    for s in range(0, n, batch):
        qs = torch.as_tensor(x[s: s + batch]).to(meta_arrays.device)
        ids, _ = H.hnsw_search(meta_arrays, qs, metric=metric, k=1, ef=32)
        out[s: s + batch] = part_of_center[ids[:, 0].cpu().numpy()]
    return out


def build_pyramid_index(x: np.ndarray, cfg: PyramidConfig, *,
                        device: DeviceLike = "cuda",
                        sample_queries: Optional[np.ndarray] = None,
                        verbose: bool = False) -> PyramidIndex:
    """Builds the full two-level Pyramid index (Alg. 3 / Alg. 5) with the
    sub-HNSW builds in this process; see
    :func:`repro_torch.build.build_pyramid_index_parallel` for the
    process-pool fan-out (same result).

    Args:
      x: [n, d] dataset (raw; normalised internally for angular).
      cfg: index configuration; ``cfg.metric == 'ip'`` triggers Alg. 5.
      device: where the k-means, the item assignment and later searches
        run; ``"cuda"`` unless the caller asks for the CPU.
      sample_queries: optional [B, d]: center weights from query result
        frequency instead of cluster sizes.
    """
    from repro_torch.build.planner import build_pyramid_index_parallel
    return build_pyramid_index_parallel(
        x, cfg, device=device, workers=0, sample_queries=sample_queries,
        verbose=verbose)
