"""Distributed LSH baseline (PLSH [26] stand-in; port of
``repro.core.lsh``).

The paper compares against LSH-based distributed systems (PLSH; not open
source). This is a small-scale stand-in: random-projection hashing
(p-stable / SimHash family) with multi-table lookup, rows randomly
partitioned across shards and EVERY shard probed per query (PLSH's
broadcast model -- no routing, the contrast to Pyramid's selective
dispatch).

Hashing and the buckets are numpy with the reference's seeds, so the
tables are the reference's. Candidate generation is bucket lookup on the
host; the candidates are reranked exactly by the top-k scan
(``repro_torch.kernels.topk_distance``: the CUDA kernel on the card, its
plain version on the CPU), on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import metrics as M
from repro_torch.kernels.topk_distance import topk_similarity


@dataclasses.dataclass
class LSHTable:
    projections: np.ndarray    # [num_bits, d]
    offsets: np.ndarray        # [num_bits] (E2LSH-style, l2 only)
    width: float
    buckets: dict              # hash tuple -> np.ndarray of local ids


@dataclasses.dataclass
class LSHShard:
    ids: np.ndarray            # [n_local] global ids
    data: np.ndarray           # [n_local, d]
    tables: List[LSHTable]


@dataclasses.dataclass
class DistributedLSH:
    metric: str
    shards: List[LSHShard]
    num_bits: int
    num_tables: int


def _hash(table: LSHTable, x: np.ndarray, metric: str) -> np.ndarray:
    """[B, d] -> [B, num_bits] int codes."""
    proj = x @ table.projections.T
    if metric == "l2":
        return np.floor((proj + table.offsets) / table.width).astype(
            np.int32)
    return (proj > 0).astype(np.int32)   # SimHash for ip/angular


def build_lsh(x: np.ndarray, *, metric: str = "l2", num_shards: int = 8,
              num_tables: int = 8, num_bits: int = 12, width: float = 2.0,
              seed: int = 0) -> DistributedLSH:
    x = M.preprocess_dataset(x, metric)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shards = []
    for s in range(num_shards):
        local = perm[s::num_shards]
        data = x[local]
        tables = []
        for t in range(num_tables):
            trng = np.random.default_rng(seed * 1000 + s * 100 + t)
            proj = trng.normal(size=(num_bits, d)).astype(np.float32)
            off = trng.uniform(0, width, size=num_bits).astype(np.float32)
            table = LSHTable(proj, off, width, {})
            codes = _hash(table, data, metric)
            for i, code in enumerate(map(tuple, codes)):
                table.buckets.setdefault(code, []).append(i)
            table.buckets = {k: np.asarray(v, dtype=np.int64)
                             for k, v in table.buckets.items()}
            tables.append(table)
        shards.append(LSHShard(ids=local, data=data, tables=tables))
    return DistributedLSH(metric=metric, shards=shards,
                          num_bits=num_bits, num_tables=num_tables)


def search_lsh(index: DistributedLSH, queries: np.ndarray, k: int,
               max_candidates: int = 2048, *,
               device: DeviceLike = "cuda"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Probe ALL shards (PLSH broadcast), union buckets, exact rerank on
    ``device`` (``"cuda"`` unless the caller asks for the CPU).

    Returns (ids [B, k], scores [B, k]); -1/-inf padded when fewer than k
    candidates hash into the probed buckets.
    """
    dev = resolve_device(device)
    q = M.preprocess_queries(queries, index.metric)
    b = q.shape[0]
    out_ids = np.full((b, k), -1, np.int64)
    out_scores = np.full((b, k), -np.inf, np.float32)
    metric = "ip" if index.metric == "angular" else index.metric
    for i in range(b):
        cands: List[np.ndarray] = []
        gids: List[np.ndarray] = []
        for shard in index.shards:
            local: List[np.ndarray] = []
            for table in shard.tables:
                code = tuple(_hash(table, q[i: i + 1], index.metric)[0])
                hit = table.buckets.get(code)
                if hit is not None:
                    local.append(hit)
            if local:
                ulocal = np.unique(np.concatenate(local))
                cands.append(shard.data[ulocal])
                gids.append(shard.ids[ulocal])
        if not cands:
            continue
        cand = np.concatenate(cands)[:max_candidates]
        gid = np.concatenate(gids)[:max_candidates]
        kk = min(k, cand.shape[0])
        scores, idx = topk_similarity(
            torch.as_tensor(q[i: i + 1]).to(dev),
            torch.as_tensor(cand).to(dev), k=kk, metric=metric)
        out_ids[i, :kk] = gid[idx[0].cpu().numpy()]
        out_scores[i, :kk] = scores[0].cpu().numpy()
    return out_ids, out_scores
