"""Build planner: staged Pyramid construction with a parallel fan-out
(port of ``repro.build.planner``).

  * :func:`plan_build` -- the routing layer: sample -> k-means (on the
    device, assignment through the top-k scan kernel) -> meta-HNSW ->
    balanced min-cut partition -> item assignment (meta search on the
    device, the beam-walk kernel) -> MIPS norm-replication (the top-k
    scan kernel). Produces a :class:`BuildPlan`.
  * :func:`build_subgraphs` -- one numpy HNSW build per partition, fanned
    out over a spawn process pool. Each shard is a pure function of
    ``(sub-dataset, config, shard_seed(cfg.seed, i))``, so the parallel
    result equals the sequential loop. A failed shard is retried up to
    ``max_retries`` times, in-process once the pool is broken, and every
    retry is recorded in ``build_stats["build_timeline"]``.
  * :func:`plan_rebalance`, :func:`split_shard`, :func:`merge_shards` --
    online rebalancing, one shard split or merge a maintenance cycle.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import multiprocessing
import os
import shutil
import tempfile
import time
from concurrent.futures.process import BrokenProcessPool
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import hnsw as H
from repro_torch.core import metrics as M
from repro_torch.core.kmeans import kmeans
from repro_torch.core.meta_index import PyramidIndex, _assign_items, _sample
from repro_torch.core.partition import balance_stats, edge_cut, partition_graph
from repro_torch.kernels.topk_distance import topk_similarity

log = logging.getLogger(__name__)


class BuildError(RuntimeError):
    """A shard build failed past its retry budget."""


@dataclasses.dataclass
class BuildPlan:
    """Everything the sub-HNSW fan-out needs, fixed by the planner.

    ``x`` is the *preprocessed* dataset (normalised for angular);
    ``sub_ids[i]`` are the global ids assigned to partition ``i``.
    """

    x: np.ndarray
    cfg: PyramidConfig
    meta: H.HNSWGraph
    part_of_center: np.ndarray
    sub_ids: List[np.ndarray]
    stats: dict

    @property
    def metric(self) -> str:
        return "ip" if self.cfg.is_mips else self.cfg.metric

    @property
    def num_shards(self) -> int:
        return self.cfg.num_shards


@dataclasses.dataclass
class ShardSpec:
    """A picklable description of ONE sub-HNSW build."""

    shard: int
    data: np.ndarray          # [n_i, d] rows of this sub-dataset
    ids: np.ndarray           # [n_i] global ids
    metric: str
    max_degree: int
    max_degree_upper: int
    ef_construction: int
    seed: int


# ---------------------------------------------------------------------------
# Stage 1: the plan (sample -> kmeans -> meta-HNSW -> partition -> assign)
# ---------------------------------------------------------------------------


def plan_build(x: np.ndarray, cfg: PyramidConfig, *,
               device: DeviceLike = "cuda",
               sample_queries: Optional[np.ndarray] = None,
               init_centers: Optional[np.ndarray] = None) -> BuildPlan:
    """Alg. 3 lines 3-10 / Alg. 5 lines 3-15: everything up to (but not
    including) the per-partition sub-HNSW builds. ``init_centers``
    optionally fixes the k-means starting centres."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    x = M.preprocess_dataset(x, cfg.metric)
    n, d = x.shape
    m = min(cfg.meta_size, max(cfg.num_shards, n // 4))
    stats: dict = {"n": n, "d": d, "m": m, "w": cfg.num_shards}
    timings: dict = {}

    # -- Alg. 3 lines 3-5 / Alg. 5 lines 3-6: sample, kmeans, meta-HNSW ----
    t0 = time.perf_counter()
    sample = _sample(x, cfg.sample_size, rng)
    spherical = cfg.is_mips
    centers, counts = kmeans(sample, m, iters=cfg.kmeans_iters,
                             spherical=spherical, seed=cfg.seed,
                             init_centers=init_centers, device=dev)
    timings["kmeans_s"] = time.perf_counter() - t0
    meta_metric = "ip" if cfg.is_mips else cfg.metric
    t0 = time.perf_counter()
    meta = H.build_hnsw(centers, metric=meta_metric,
                        max_degree=cfg.max_degree,
                        max_degree_upper=cfg.max_degree_upper,
                        ef_construction=cfg.ef_construction, seed=cfg.seed)
    timings["meta_hnsw_s"] = time.perf_counter() - t0

    # -- center weights: cluster sizes (or query-frequency when provided) --
    if sample_queries is not None:
        k_hot = 10
        ids, _ = H.search_numpy(meta, sample_queries, k=k_hot,
                                ef=cfg.ef_search)
        weights = np.bincount(ids[ids >= 0].reshape(-1), minlength=m) + 1.0
    else:
        weights = np.asarray(counts, dtype=np.float64) + 1.0

    # -- Alg. 3 line 6: balanced min-cut partition of the bottom layer -----
    part_of_center = partition_graph(
        meta.neighbors[0], weights, cfg.num_shards, seed=cfg.seed)
    stats["edge_cut"] = edge_cut(meta.neighbors[0], part_of_center)
    stats["balance"], stats["part_weights"] = balance_stats(
        weights, part_of_center, cfg.num_shards)

    # -- Alg. 3 lines 7-10: assign every item to a sub-dataset -------------
    t0 = time.perf_counter()
    item_part = _assign_items(x, meta.device_arrays(dev), part_of_center,
                              meta_metric)
    timings["assign_s"] = time.perf_counter() - t0

    sub_ids: List[np.ndarray] = [
        np.where(item_part == i)[0] for i in range(cfg.num_shards)]

    # -- Alg. 5 lines 12-15: MIPS norm-replication -------------------------
    replicated = 0
    if cfg.is_mips and cfg.replication_r > 0:
        r = min(cfg.replication_r, n)
        # top-r MIPS neighbours of every meta vertex in the full dataset
        _, top_r = topk_similarity(
            torch.as_tensor(np.asarray(centers, np.float32)).to(dev),
            torch.as_tensor(x).to(dev), k=r, metric="ip")
        top_r = top_r.cpu().numpy()
        extra: List[set] = [set() for _ in range(cfg.num_shards)]
        for c in range(m):
            extra[part_of_center[c]].update(top_r[c].tolist())
        for i in range(cfg.num_shards):
            base = set(sub_ids[i].tolist())
            add = np.fromiter((v for v in extra[i] if v not in base),
                              dtype=np.int64, count=-1)
            replicated += add.size
            if add.size:
                sub_ids[i] = np.concatenate([sub_ids[i], add])
    stats["replicated_items"] = replicated

    # degenerate partitions get one random item, drawn in shard order so
    # the sequential and parallel paths consume the same rng stream
    for i in range(cfg.num_shards):
        if sub_ids[i].size == 0:
            sub_ids[i] = rng.choice(n, size=1)
    stats["total_stored"] = int(sum(s.size for s in sub_ids))
    stats["sub_sizes"] = [int(s.size) for s in sub_ids]
    stats["plan_timings"] = {k: round(v, 4) for k, v in timings.items()}
    return BuildPlan(x=x, cfg=cfg, meta=meta,
                     part_of_center=part_of_center.astype(np.int32),
                     sub_ids=sub_ids, stats=stats)


def shard_specs(plan: BuildPlan) -> List[ShardSpec]:
    """One picklable build spec per partition, seeds threaded via
    :func:`repro_torch.core.hnsw.shard_seed`."""
    cfg = plan.cfg
    return [
        ShardSpec(
            shard=i, data=plan.x[plan.sub_ids[i]], ids=plan.sub_ids[i],
            metric=plan.metric, max_degree=cfg.max_degree,
            max_degree_upper=cfg.max_degree_upper,
            ef_construction=cfg.ef_construction,
            seed=H.shard_seed(cfg.seed, i))
        for i in range(plan.num_shards)]


# ---------------------------------------------------------------------------
# Stage 2: the fan-out
# ---------------------------------------------------------------------------


def _build_shard(spec: ShardSpec) -> Tuple[H.HNSWGraph, float]:
    """Build one sub-HNSW. Pure numpy — safe to run in a spawned
    process, deterministic given the spec."""
    t0 = time.perf_counter()
    g = H.build_hnsw(
        spec.data, metric=spec.metric, max_degree=spec.max_degree,
        max_degree_upper=spec.max_degree_upper,
        ef_construction=spec.ef_construction, seed=spec.seed,
        ids=spec.ids)
    return g, time.perf_counter() - t0


@dataclasses.dataclass
class _ShardPayload:
    """What actually crosses the pool's call pipe: a file path plus
    scalars. Shard arrays go via a temp file, NOT through the pickled
    submit payload — a large payload stuck in the call-queue pipe when
    every worker has died deadlocks CPython 3.10's ``terminate_broken``
    (the feeder thread blocks in ``_send`` with no reader, and the
    broken-pool cleanup joins it forever, hanging interpreter exit)."""

    path: str
    shard: int
    metric: str
    max_degree: int
    max_degree_upper: int
    ef_construction: int
    seed: int


def _build_shard_payload(task: _ShardPayload) -> Tuple[H.HNSWGraph, float]:
    """Pool worker entry: load the shard's arrays from disk, build."""
    with np.load(task.path) as z:
        data, ids = z["data"], z["ids"]
    return _build_shard(ShardSpec(
        shard=task.shard, data=data, ids=ids, metric=task.metric,
        max_degree=task.max_degree,
        max_degree_upper=task.max_degree_upper,
        ef_construction=task.ef_construction, seed=task.seed))


def _default_pool(workers: int):
    # spawn, not fork: the parent holds a CUDA context (the planner's
    # device-batched assignment), which a forked child cannot use, and
    # forking its threads can deadlock; workers only need numpy
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def build_subgraphs(plan: BuildPlan, *, workers: int = 0,
                    max_retries: int = 2,
                    pool_factory: Optional[Callable] = None,
                    verbose: bool = False
                    ) -> Tuple[List[H.HNSWGraph], dict]:
    """Build every partition's sub-HNSW, optionally in parallel.

    ``workers <= 1`` runs the sequential in-process loop; otherwise the
    specs are fanned out over a process pool (``pool_factory() ->
    executor`` is injectable for tests). A shard whose worker raises or
    dies is retried up to ``max_retries`` times — through the pool while
    it is healthy, in-process once it is broken — and every retry is
    recorded in the returned stats' ``build_timeline``. Results are
    bit-identical either way: each shard is a pure function of its spec.
    """
    w = plan.num_shards
    subs: List[Optional[H.HNSWGraph]] = [None] * w
    shard_s = [0.0] * w
    timeline: List[dict] = []
    retries = 0
    t_start = time.perf_counter()

    if workers <= 1 or w <= 1:
        for spec in shard_specs(plan):
            subs[spec.shard], shard_s[spec.shard] = _build_shard(spec)
        mode = "sequential"
    else:
        mode = "parallel"
        factory = pool_factory or (lambda: _default_pool(min(workers, w)))
        pool = factory()
        pool_broken = False
        pending = {i: 0 for i in range(w)}   # shard -> attempts
        payload_dir = tempfile.mkdtemp(prefix="pyramid-build-")
        # payload files, not in-memory spec copies: the pool pipe then
        # carries only small descriptors (see _ShardPayload), and peak
        # memory stays ~1x the dataset — each shard's fancy-indexed
        # copy lives only for the duration of its write
        cfg = plan.cfg
        tasks: dict = {}
        for i in range(w):
            path = os.path.join(payload_dir, f"shard-{i}.npz")
            np.savez(path, data=plan.x[plan.sub_ids[i]],
                     ids=plan.sub_ids[i])
            tasks[i] = _ShardPayload(
                path=path, shard=i, metric=plan.metric,
                max_degree=cfg.max_degree,
                max_degree_upper=cfg.max_degree_upper,
                ef_construction=cfg.ef_construction,
                seed=H.shard_seed(cfg.seed, i))
        try:
            futs = {pool.submit(_build_shard_payload, tasks[i]): i
                    for i in range(w)}
            while futs:
                done, _ = concurrent.futures.wait(
                    futs, return_when=concurrent.futures.FIRST_COMPLETED)
                for fut in done:
                    shard = futs.pop(fut)
                    try:
                        subs[shard], shard_s[shard] = fut.result()
                        pending.pop(shard, None)
                        continue
                    except Exception as e:   # worker raised or died
                        attempt = pending[shard] = pending[shard] + 1
                        retries += 1
                        if isinstance(e, BrokenProcessPool):
                            pool_broken = True
                        if attempt > max_retries:
                            raise BuildError(
                                f"shard {shard} build failed after "
                                f"{max_retries} retries: {e!r}") from e
                        timeline.append({
                            "shard": shard, "event": "retry",
                            "attempt": attempt,
                            "via": ("inline" if pool_broken else "pool"),
                            "error": repr(e)})
                        if verbose:
                            log.info(f"[build] shard {shard} attempt "
                                 f"{attempt} failed ({e!r}); retrying "
                                 f"{'inline' if pool_broken else 'in pool'}")
                    if not pool_broken:
                        try:
                            futs[pool.submit(_build_shard_payload,
                                             tasks[shard])] = shard
                            continue
                        except BrokenProcessPool:
                            # the pool broke between this worker's
                            # failure and the resubmit (another worker
                            # died): fall through to the inline path
                            pool_broken = True
                            timeline[-1]["via"] = "inline"
                    # the pool died with the worker: rebuild this shard
                    # in-process (same payload -> same bits)
                    try:
                        subs[shard], shard_s[shard] = (
                            _build_shard_payload(tasks[shard]))
                    except Exception as e2:
                        raise BuildError(
                            f"shard {shard} inline rebuild failed "
                            f"after pool break: {e2!r}") from e2
                    pending.pop(shard, None)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            shutil.rmtree(payload_dir, ignore_errors=True)

    stats = {
        "build_mode": mode,
        "build_workers": int(workers),
        "build_retries": retries,
        "build_timeline": timeline,
        "shard_build_s": [round(t, 4) for t in shard_s],
        "subgraphs_wall_s": round(time.perf_counter() - t_start, 4),
    }
    return subs, stats   # type: ignore[return-value]


def build_pyramid_index_parallel(
        x: np.ndarray, cfg: PyramidConfig, *,
        device: DeviceLike = "cuda",
        workers: Optional[int] = None,
        sample_queries: Optional[np.ndarray] = None,
        init_centers: Optional[np.ndarray] = None,
        max_retries: int = 2,
        pool_factory: Optional[Callable] = None,
        verbose: bool = False) -> PyramidIndex:
    """Full Pyramid build with the sub-HNSW stage fanned out over a
    process pool. ``workers=None`` picks ``min(num_shards, cpu_count)``;
    ``workers=0`` (or 1) is the sequential path. The index lives on
    ``device`` (``"cuda"`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if workers is None:
        workers = min(cfg.num_shards, os.cpu_count() or 1)
    t0 = time.perf_counter()
    plan = plan_build(x, cfg, device=dev, sample_queries=sample_queries,
                      init_centers=init_centers)
    subs, build_stats = build_subgraphs(
        plan, workers=workers, max_retries=max_retries,
        pool_factory=pool_factory, verbose=verbose)
    stats = dict(plan.stats)
    stats.update(build_stats)
    stats["build_wall_s"] = round(time.perf_counter() - t0, 4)
    if verbose:
        log.info(f"[pyramid] build stats: {stats}")
    return PyramidIndex(config=cfg, meta=plan.meta,
                        part_of_center=plan.part_of_center,
                        subs=subs, build_stats=stats, device=dev)


# ---------------------------------------------------------------------------
# Online rebalancing: split / merge planning and apply (used by the store
# compactor, repro_torch.store.maintenance)
# ---------------------------------------------------------------------------


def plan_rebalance(index: PyramidIndex, *,
                   engine_stats: Optional[dict] = None,
                   split_factor: float = 4.0,
                   merge_factor: float = 0.25,
                   latency_factor: float = 4.0,
                   min_split_items: int = 8) -> Optional[Tuple]:
    """Decide at most ONE split/merge op for the next maintenance cycle.

    Signals, in priority order:
      * size skew -- a shard holding > ``split_factor`` x the mean
        sub-dataset size splits; two shards both under ``merge_factor``
        x the mean merge;
      * access/latency skew -- with ``engine_stats`` (the serving
        engine's ``stats()``), a shard whose streaming p99 exceeds
        ``latency_factor`` x the median p99 splits even when its size
        alone would not trigger.

    Returns ``("split", s)``, ``("merge", a, b)`` or ``None``. One op per
    cycle keeps shard indices stable while the op is applied; the
    compactor re-plans every cycle, so sustained skew drains over
    successive cycles.
    """
    sizes = [g.n for g in index.subs]
    w = len(sizes)
    total = sum(sizes)
    if w == 0 or total == 0:
        return None
    mean = total / w
    centers_per = np.bincount(
        np.asarray(index.part_of_center, np.int64), minlength=w)

    def splittable(s: int) -> bool:
        # routing granularity: a split relabels the shard's meta centers,
        # so it needs at least two of them (and enough items for two
        # non-trivial halves)
        return sizes[s] >= max(min_split_items, 2) and centers_per[s] >= 2

    order = np.argsort(sizes)[::-1]
    for s in order:
        if sizes[s] > split_factor * mean and splittable(int(s)):
            return ("split", int(s))
    lat = (engine_stats or {}).get("latency") or {}
    p99s = sorted(v["p99"] for v in lat.values() if v.get("n", 0))
    if p99s:
        med = p99s[len(p99s) // 2]
        hot = sorted(
            (int(s) for s, v in lat.items()
             if med > 0 and v["p99"] > latency_factor * med
             and splittable(int(s)) and sizes[int(s)] > mean),
            key=lambda s: -lat[s]["p99"])
        if hot:
            return ("split", hot[0])
    if w >= 2:
        a, b = sorted(np.argsort(sizes)[:2].tolist())
        if (sizes[a] < merge_factor * mean
                and sizes[b] < merge_factor * mean):
            return ("merge", int(a), int(b))
    return None


def split_shard(index: PyramidIndex, s: int, *,
                init_centers: Optional[np.ndarray] = None) -> PyramidIndex:
    """Split sub-HNSW ``s`` in two (in place): k-means++ (k = 2, on the
    index's device) over its items, the shard's meta centers relabelled
    to whichever half is nearest -- routing stays consistent because a
    query landing on one of those centers now probes exactly the half
    holding that center's items. Both halves rebuild through
    ``shard_seed`` and the new shard takes index ``w``
    (``config.num_shards`` grows by one). ``init_centers`` fixes the two
    starting centres, as in ``plan_build``."""
    cfg = index.config
    metric = "ip" if cfg.is_mips else cfg.metric
    g = index.subs[s]
    center_sel = np.where(np.asarray(index.part_of_center) == s)[0]
    if g.n < 2 or center_sel.size < 2:
        raise BuildError(
            f"shard {s} cannot split: {g.n} items, "
            f"{center_sel.size} meta centers")
    halves, _ = kmeans(g.data, 2, iters=cfg.kmeans_iters,
                       spherical=cfg.is_mips,
                       seed=H.shard_seed(cfg.seed, s), init="kmeans++",
                       init_centers=init_centers, device=index.device)
    halves = np.asarray(halves, np.float32)
    # relabel the partition's centers by nearest half, forcing at least
    # one center per side (k-means on near-duplicate data can collapse)
    cvecs = index.meta.data[center_sel]
    side = np.argmax(
        M.similarity_matrix_np(cvecs, halves, metric), axis=1)
    if (side == 0).all():
        side[np.argmin(
            M.similarity_matrix_np(cvecs, halves[:1], metric)[:, 0])] = 1
    elif (side == 1).all():
        side[np.argmin(
            M.similarity_matrix_np(cvecs, halves[1:], metric)[:, 0])] = 0
    w = len(index.subs)
    part = np.asarray(index.part_of_center).copy()
    part[center_sel[side == 1]] = w
    # items follow their nearest center WITHIN the old partition, so an
    # item ends up exactly where routing via its center now points
    nearest = np.argmax(
        M.similarity_matrix_np(g.data, cvecs, metric), axis=1)
    item_side = side[nearest]
    new_subs = []
    for hs, shard_id in ((0, s), (1, w)):
        sel = item_side == hs
        new_subs.append(H.build_hnsw(
            g.data[sel], metric=metric, max_degree=cfg.max_degree,
            max_degree_upper=cfg.max_degree_upper,
            ef_construction=cfg.ef_construction,
            seed=H.shard_seed(cfg.seed, shard_id), ids=g.ids[sel]))
    index.subs[s] = new_subs[0]
    index.subs.append(new_subs[1])
    index.part_of_center = part.astype(np.int32)
    index.config = dataclasses.replace(cfg, num_shards=w + 1)
    index.build_stats["sub_sizes"] = [g.n for g in index.subs]
    index.build_stats["total_stored"] = sum(g.n for g in index.subs)
    index.invalidate_device_cache()
    return index


def merge_shards(index: PyramidIndex, a: int, b: int) -> PyramidIndex:
    """Merge sub-HNSW ``b`` into ``a`` (in place): ``b``'s meta centers
    relabel to ``a``, the combined items (id-deduped -- MIPS replication
    can store one id in both) rebuild one graph through ``shard_seed``
    (two empty shards merge into an empty one), and every shard index
    above ``b`` shifts down by one."""
    if a == b:
        raise BuildError("merge_shards needs two distinct shards")
    a, b = sorted((a, b))
    cfg = index.config
    metric = "ip" if cfg.is_mips else cfg.metric
    ga, gb = index.subs[a], index.subs[b]
    data = np.concatenate([ga.data, gb.data])
    ids = np.concatenate([ga.ids, gb.ids])
    _, first = np.unique(ids, return_index=True)
    first = np.sort(first)
    index.subs[a] = H.build_hnsw(
        data[first], metric=metric, max_degree=cfg.max_degree,
        max_degree_upper=cfg.max_degree_upper,
        ef_construction=cfg.ef_construction,
        seed=H.shard_seed(cfg.seed, a), ids=ids[first])
    del index.subs[b]
    part = np.asarray(index.part_of_center).copy()
    part[part == b] = a
    part[part > b] -= 1
    index.part_of_center = part.astype(np.int32)
    index.config = dataclasses.replace(
        cfg, num_shards=cfg.num_shards - 1)
    index.build_stats["sub_sizes"] = [g.n for g in index.subs]
    index.build_stats["total_stored"] = sum(g.n for g in index.subs)
    index.invalidate_device_cache()
    return index
