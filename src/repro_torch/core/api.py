"""The paper's public API (Sec. IV-A, Listings 1-3; port of
``repro.core.api``).

Thin, faithful wrappers over the futures-based client surface
(``repro_torch.core.client``) so user code reads exactly like the paper:

    gc = GraphConstructor(data_path, name, metric)
    gc.build_graphs(para)

    coord = Coordinator(brokers, graph_path, name, metric)
    res = coord.execute(query, para)                 # sync
    coord.execute_async(query, para, callback)       # async + callback

    ex = Executor(brokers, graph_path_and_id, name, metric)
    ex.start(para)

New code should use :class:`repro_torch.core.client.PyramidClient`
directly; the classes here exist for fidelity with the paper's listings
and delegate everything to the client.

"brokers" is the in-process engine registry (the Kafka stand-in);
graph paths point at ``launch.build_index`` artifacts (store roots).
``Brokers(device=...)`` fixes where the indexes it loads from a path
live: the CUDA device unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.client import (PyramidClient,  # noqa: F401
                                     SearchFuture, gather)
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.launch.build_index import load_index
from repro_torch.serving.engine import QueryResult, ServingEngine

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class QueryPara:
    """Query-processing parameters (the paper's ``para``)."""
    k: int = 10
    branching_factor: Optional[int] = None   # K
    timeout_s: float = 60.0


@dataclasses.dataclass
class BuildPara:
    """Index-construction parameters (the paper's ``para``)."""
    meta_size: int = 1_000          # m
    num_shards: int = 16            # w
    sample_size: int = 20_000       # n'
    replication_r: int = 0          # r (MIPS, Alg. 5)
    max_degree: int = 32
    ef_construction: int = 100
    workers: int = 0                # >1: process-pool sub-HNSW fan-out


def _check_metric(index: PyramidIndex, metric: str) -> None:
    if not (index.config.metric == metric or
            (metric == "ip" and index.config.is_mips)):
        raise ValueError(
            f"index metric {index.config.metric} != {metric}")


class Brokers:
    """Stand-in for the Kafka broker list: owns one ServingEngine per
    dataset name. Clients/executors attach to it.

    Usable as a context manager::

        with Brokers() as brokers:
            client = brokers.open_client("wiki", path)
            ...
    # engines shut down on exit

    ``device`` is where every index this registry loads from a store
    path lives (``open_client``, ``replace_index`` with a path, the
    Listing shims).
    """

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._engines: Dict[str, ServingEngine] = {}
        self._lock = threading.Lock()

    # -- engine registry ---------------------------------------------------

    def engine_for(self, name: str, index: PyramidIndex, *,
                   replicas: Optional[int] = None,
                   **engine_kw) -> ServingEngine:
        """Get or create the engine serving ``name``.

        ``replicas=None`` means "attach to whatever is running". When an
        engine already exists, a conflicting request is never silently
        ignored: a different index config raises, a different replica
        count logs a structured warning (the running group is kept —
        resize explicitly via ``engine.scale``). Extra kwargs (e.g.
        ``registry=``/``tracer=`` for observability, ``quantize=True``)
        pass through to the :class:`ServingEngine` constructor and only
        apply when this call actually creates the engine.
        """
        with self._lock:   # checks under the lock: a concurrent
            eng = self._engines.get(name)   # replace_index must not hand
            if eng is not None:             # back a stale engine
                return self._check_attach(name, eng, index, replicas)
        # engine startup (array builds, thread spawns, jit warmup) is
        # expensive: build outside the lock, install with a re-check
        new = ServingEngine(index, replicas=replicas or 1, **engine_kw)
        with self._lock:
            eng = self._engines.get(name)
            if eng is None:
                self._engines[name] = new
                return new
        new.shutdown()   # lost the creation race: don't leak threads
        with self._lock:
            return self._check_attach(name, eng, index, replicas)

    def _check_attach(self, name: str, eng: ServingEngine,
                      index: PyramidIndex,
                      replicas: Optional[int]) -> ServingEngine:
        """Attach to a running engine — never silently: a conflicting
        index config raises, a conflicting replica count warns."""
        if index.config != eng.index.config:
            raise ValueError(
                f"brokers: engine '{name}' already serves an index "
                f"with config {eng.index.config}; refusing to attach "
                f"a mismatched index (config {index.config}). Use "
                f"replace_index() to hot-swap.")
        if replicas is not None and replicas != eng.replicas:
            logger.warning(
                "brokers.engine_for: engine=%s requested_replicas=%d "
                "configured_replicas=%d — request ignored; use "
                "engine.scale(shard, n) to resize the running group "
                "(live counts: engine.stats()['replicas'])",
                name, replicas, eng.replicas)
        return eng

    def get_engine(self, name: str) -> ServingEngine:
        with self._lock:
            if name not in self._engines:
                raise KeyError(
                    f"brokers: no engine named '{name}' "
                    f"(known: {sorted(self._engines)})")
            return self._engines[name]

    def replace_index(self, name: str,
                      index) -> Optional[ServingEngine]:
        """Hot-swap ``name``'s engine onto a freshly built index (the
        paper's ``refresh()`` notification). The replacement engine is
        started *before* the old one is torn down — carrying over the
        old engine's *live* per-shard replica counts (which ``scale()``
        may have grown past the constructor setting) — and clients
        opened via :meth:`open_client` resolve it on their next call.

        ``index`` may be a built :class:`PyramidIndex` or a *store
        path*: a ``str``/``PathLike`` is opened as a
        :class:`repro_torch.store.IndexStore` and its latest published
        version, loaded on this registry's device
        (plus delta-log replay) becomes the replacement — the paper's
        "constructor publishes to HDFS, serving layer refreshes" flow.

        If ``name`` has no running engine there is nothing to swap:
        returns ``None`` and the next ``open_client`` / ``engine_for``
        lazily starts on the fresh index (no engine is spawned for a
        dataset nobody is serving)."""
        if isinstance(index, (str, os.PathLike)):
            with self._lock:   # nothing to swap? don't pay a full store
                running = name in self._engines   # load just to drop it
            if not running:
                return None
            from repro_torch.store import IndexStore
            index = IndexStore(str(index)).load(device=self.device)
        with self._lock:
            old = self._engines.get(name)
        if old is None:
            return None
        # the replacement inherits the old engine's registry and tracer:
        # hedge/expiry/swap counters stay monotonic across hot-swaps
        # (registration is idempotent) and one trace spans the swap
        new = ServingEngine(index, replicas=old.replicas,
                            registry=old.obs, tracer=old.tracer)
        for s in range(min(old.w, new.w)):
            live = old.replica_count(s)
            if live >= 1 and live != new.replica_count(s):
                new.scale(s, live)
        with self._lock:
            current = self._engines.get(name)
            if current is old:   # won the race: install
                self._engines[name] = new
            else:   # lost to a concurrent replace_index or shutdown()
                loser = new
        if current is old:
            if old is not None:
                old.drain()     # in-flight futures finish on the old
                old.shutdown()  # engine; only then tear it down
            return new
        loser.shutdown()   # never installed: don't leak its threads
        if current is not None:
            return current
        raise RuntimeError(
            f"brokers: engine '{name}' was removed (brokers shut down?) "
            f"during replace_index")

    def close_engine(self, name: str) -> bool:
        """Shut down and deregister ONE engine (the tenant manager's
        eviction path). Returns whether an engine was actually closed;
        clients bound via :meth:`open_client` fail their next call with
        ``KeyError`` until the name is served again."""
        with self._lock:
            eng = self._engines.pop(name, None)
        if eng is None:
            return False
        eng.drain()
        eng.shutdown()
        return True

    def attach_maintenance(self, name: str, store, **opts):
        """Create a :class:`repro_torch.store.maintenance.Compactor` wired
        to this broker entry: it folds ``name``'s delta log into new
        versions of ``store`` and hot-swaps the engine through
        :meth:`replace_index`. The compactor is installed on the running
        engine (drain-hook step clock + ``stats()['maintenance']``) when
        one exists, and shares its registry and tracer; without one it
        loads the store's index on this registry's device. Call
        ``.start()`` on the result for the background thread, or drive
        ``run_once()``/``tick()`` deterministically."""
        from repro_torch.store import Compactor, IndexStore
        if not isinstance(store, IndexStore):
            store = IndexStore(str(store))
        with self._lock:
            eng = self._engines.get(name)
        index = (eng.index if eng is not None
                 else store.load(device=self.device))
        if eng is not None:   # share the serving observability plane:
            opts.setdefault("registry", eng.obs)   # one scrape / trace
            opts.setdefault("tracer", eng.tracer)  # covers both
        compactor = Compactor(store, index, brokers=self, name=name,
                              **opts)
        if eng is not None:
            compactor.install(eng)
        return compactor

    # -- client surface ----------------------------------------------------

    def open_client(self, name: str, path: str, *,
                    metric: Optional[str] = None,
                    replicas: Optional[int] = None) -> PyramidClient:
        """Return a :class:`PyramidClient` session bound to this broker
        entry — the client tracks ``replace_index`` hot-swaps.

        ``path`` is only read when ``name`` is not yet served (the first
        session pays the index load; later sessions attach to the
        running engine and validate against *its* index)."""
        with self._lock:
            eng = self._engines.get(name)
        index = (eng.index if eng is not None
                 else load_index(path, device=self.device))
        if metric is not None:
            _check_metric(index, metric)
        self.engine_for(name, index, replicas=replicas)
        return PyramidClient(
            engine_resolver=lambda: self.get_engine(name), name=name)

    def shutdown(self):
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
        for e in engines:
            e.shutdown()

    def __enter__(self) -> "Brokers":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class Coordinator:
    """Listing 1. Receives queries, routes via the meta-HNSW, merges.

    Shim over :class:`PyramidClient`: ``execute*`` submit through the
    client and block on the returned futures."""

    def __init__(self, brokers: Brokers, graph_path: str, name: str,
                 metric: str, replicas: int = 1):
        self.index = load_index(graph_path, device=brokers.device)
        _check_metric(self.index, metric)
        self.name = name
        self.engine = brokers.engine_for(name, self.index,
                                         replicas=replicas)
        # resolve through the brokers so a replace_index hot-swap (the
        # paper's refresh) keeps this coordinator working
        self.client = PyramidClient(
            engine_resolver=lambda: brokers.get_engine(name), name=name)

    def execute(self, query: np.ndarray, para: QueryPara) -> QueryResult:
        """Synchronous top-k search for ONE query vector."""
        return self.client.search(
            query, para.k,
            branching_factor=para.branching_factor).result(para.timeout_s)

    def execute_batch(self, queries: np.ndarray,
                      para: QueryPara) -> List[QueryResult]:
        """Synchronous batch search, one result per query (submit order).

        The whole batch shares one ``para.timeout_s`` deadline; a query
        missing it raises ``TimeoutError`` — a short result list can no
        longer be returned silently.
        """
        futures = self.client.search_batch(
            queries, para.k, branching_factor=para.branching_factor)
        return gather(futures, para.timeout_s)

    def execute_async(self, query: np.ndarray, para: QueryPara,
                      callback: Callable[[QueryResult], None]) -> None:
        """Returns immediately; ``callback`` fires with the final result
        (no per-query OS thread — delivery rides the engine's merger)."""
        fut = self.client.search(query, para.k,
                                 branching_factor=para.branching_factor)

        def deliver(f):
            if f.exception() is None:
                callback(f.result(0))
            else:   # failed future (e.g. engine shutdown): no result to
                logger.warning(   # deliver — don't raise into the merger
                    "execute_async: query %d failed: %s", f.query_id,
                    f.exception())

        fut.add_done_callback(deliver)


class Executor:
    """Listing 2. In the paper a standalone process serving one sub-HNSW;
    here executors live inside the engine — ``start`` grows the replica
    group for this dataset and ``stop`` shrinks it back, both through
    the public ``engine.scale`` API (elastic scalability, Sec. IV-B)."""

    def __init__(self, brokers: Brokers, graph_path: str, name: str,
                 metric: str, shard_id: Optional[int] = None):
        self.index = load_index(graph_path, device=brokers.device)
        _check_metric(self.index, metric)
        self.name = name
        self.brokers = brokers
        self.shard_id = shard_id
        self._started: List[int] = []

    def start(self, para: Optional[QueryPara] = None) -> None:
        engine = self.brokers.engine_for(self.name, self.index)
        shards = ([self.shard_id] if self.shard_id is not None
                  else range(engine.w))
        for s in shards:
            engine.scale(s, engine.replica_count(s) + 1)
            self._started.append(s)

    def stop(self) -> None:
        engine = self.brokers.engine_for(self.name, self.index)
        for s in self._started:
            engine.scale(s, max(1, engine.replica_count(s) - 1))
        self._started.clear()


class GraphConstructor:
    """Listing 3. Builds (and refreshes) the meta-HNSW + sub-HNSWs.

    The paper's constructor builds sub-HNSWs in parallel across the
    cluster and persists them to shared storage; here ``para.workers``
    fans the per-partition builds over a process pool
    (:func:`repro_torch.build.build_pyramid_index_parallel`,
    bit-identical to sequential; the k-means and item assignment run on
    ``device``) and ``build_graphs`` publishes a version into the
    :class:`repro_torch.store.IndexStore` at ``out_path``."""

    def __init__(self, data: np.ndarray, metric: str, out_path: str, *,
                 device: DeviceLike = "cuda"):
        self.data = data
        self.metric = metric
        self.out_path = out_path
        self.device = resolve_device(device)
        self._index: Optional[PyramidIndex] = None

    def build_graphs(self, para: BuildPara) -> PyramidIndex:
        from repro_torch.build import build_pyramid_index_parallel
        cfg = PyramidConfig(
            metric=self.metric, num_shards=para.num_shards,
            meta_size=para.meta_size,
            sample_size=min(para.sample_size, len(self.data)),
            max_degree=para.max_degree,
            max_degree_upper=max(para.max_degree // 2, 4),
            ef_construction=para.ef_construction,
            replication_r=para.replication_r)
        self._index = build_pyramid_index_parallel(
            self.data, cfg, device=self.device, workers=para.workers)
        from repro_torch.store import IndexStore
        IndexStore(self.out_path).publish(self._index)
        return self._index

    def refresh(self, new_data: np.ndarray, para: BuildPara,
                brokers: Optional[Brokers] = None,
                name: Optional[str] = None) -> PyramidIndex:
        """Re-read the dataset, rebuild, notify coordinators/executors
        (the paper's ``refresh()``): the engine for ``name`` is
        hot-swapped onto the fresh index via
        :meth:`Brokers.replace_index` — no private state is touched and
        clients bound through ``open_client`` keep working."""
        self.data = new_data
        index = self.build_graphs(para)
        if brokers is not None and name is not None:
            brokers.replace_index(name, index)
        return index
