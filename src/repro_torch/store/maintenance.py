"""Online index maintenance: delta-log compaction and shard rebalancing
(port of ``repro.store.maintenance``).

The delta log (``repro_torch.store.store.DeltaLog``) makes updates
durable but grows forever, and recovery replay cost grows with it; shard
assignment is frozen at build time, so sustained writes skew sub-dataset
sizes and drift the data away from the routing centroids.
:class:`Compactor` is the background loop (all I/O off the serving path,
the serving threads only bump a counter) that fixes both:

  * **compaction** -- fold the committed log into a freshly *published*
    store version, then truncate the log. The version-directory rename
    inside :meth:`IndexStore.publish` is the single commit point:
    ``IndexStore.latest`` is newest-wins, so a crash at ANY step --
    before the publish (nothing changed), between publish and truncate
    (new version wins, stale log belongs to the old version and is
    never replayed), between truncate and the ``CURRENT`` flip, or mid
    hot-swap -- recovers to the identical logical state with every
    record applied exactly once;
  * **rebalance** -- at most one shard split/merge per cycle when size
    or per-shard latency skew crosses a threshold
    (:func:`repro_torch.build.planner.plan_rebalance`), plus periodic
    meta-HNSW centroid refresh through the k-means++ path
    (:func:`repro_torch.core.router.refresh_centroids`);
  * **hot-swap** -- the folded candidate replaces the serving engine via
    ``Brokers.replace_index`` (new engine up before the old comes
    down), which is also when writes applied since the last swap become
    visible to queries.

The candidate is loaded on the live index's device, so on the card the
fold's inserts route through the beam-walk kernel and a split or refresh
runs its k-means through the top-k scan kernel; every shard rebuild is
the host builder's.

Writes route through :meth:`Compactor.add_items` /
:meth:`Compactor.remove_items`: a short write lock excludes them only
from the final catch-up + publish window -- the bulk fold runs from a
store snapshot, concurrent with serving AND writing.

Scheduling is step-based, never wall-clock: the compactor registers a
drain hook on the engine (the same batch-drain boundary the
``FaultSchedule`` ticks on), and tests drive :meth:`run_once` directly
-- fully deterministic, no sleeps. ``start()`` adds the production
background thread on top of the same ``run_once``.
"""
from __future__ import annotations

import itertools
import logging
import threading
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.meta_index import PyramidIndex
from repro_torch.obs import NULL_TRACER, MetricsRegistry
from repro_torch.store.store import IndexStore

logger = logging.getLogger(__name__)


class Compactor:
    """Background delta-log compaction + shard maintenance for one
    store-attached index.

    Args:
      store: the :class:`IndexStore` the index was loaded from /
        published to.
      index: the live (serving) index, attached to the current
        version's delta log.
      brokers, name: when given, each cycle hot-swaps the serving
        engine via ``brokers.replace_index(name, candidate)``.
      on_swap: alternative swap callback ``(candidate) -> engine|None``
        for callers not using :class:`repro_torch.core.api.Brokers`.
      threshold_records: fold once this many records were journaled
        through this compactor since the last cycle (``run_once`` with
        ``force=True`` ignores it).
      rebalance: enable split/merge planning (one op per cycle).
      split_factor / merge_factor / latency_factor: skew thresholds,
        see :func:`repro_torch.build.planner.plan_rebalance`.
      refresh_every: run the k-means++ centroid refresh every N cycles
        (0 disables — it is a full routing rebuild).
      gc_keep: run ``store.gc(keep=...)`` after a successful cycle
        (``None`` leaves old versions for crash forensics).
      fault_hook: test seam — called with the step name at every commit
        boundary (``"fold"``, ``"publish"``, ``"truncate"``, ``"flip"``,
        ``"swap"``); raising inside it simulates a kill at exactly that
        point.
      poll_s: background-thread wakeup period (thread mode only).
    """

    _STEPS = ("fold", "publish", "truncate", "flip", "swap")

    def __init__(self, store: IndexStore, index: PyramidIndex, *,
                 brokers=None, name: Optional[str] = None,
                 on_swap: Optional[Callable] = None,
                 threshold_records: int = 64,
                 rebalance: bool = True,
                 split_factor: float = 4.0, merge_factor: float = 0.25,
                 latency_factor: float = 4.0,
                 refresh_every: int = 0,
                 gc_keep: Optional[int] = None,
                 catchup_rounds: int = 4,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 poll_s: float = 1.0,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        self.store = store
        self.index = index
        self.brokers = brokers
        self.name = name
        self.on_swap = on_swap
        self.threshold_records = threshold_records
        self.rebalance = rebalance
        self.split_factor = split_factor
        self.merge_factor = merge_factor
        self.latency_factor = latency_factor
        self.refresh_every = refresh_every
        self.gc_keep = gc_keep
        self.catchup_rounds = catchup_rounds
        self.fault_hook = fault_hook
        self.poll_s = poll_s

        # write lock: writers hold it per update; the compactor holds it
        # only across the final catch-up + publish + truncate + flip +
        # swap window (the bulk fold runs lock-free from the store)
        self._write_lock = threading.Lock()
        self._cycle_lock = threading.Lock()   # one cycle at a time
        self._since_fold = 0    # records journaled through this object
        self._wake = threading.Event()
        self._installed_engine = None   # last engine install()ed on
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._active = False    # a cycle is in flight (stats)

        # counter-backed bookkeeping (pass the engine's registry — what
        # Brokers.attach_maintenance does — and one /metrics scrape
        # covers serving + maintenance; swap counts stay monotonic
        # across the hot-swaps this very loop performs)
        self.obs = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        m = self.obs
        self._m_cycles = m.counter(
            "pyramid_maintenance_cycles_total",
            "completed compaction cycles")
        self._m_folded = m.counter(
            "pyramid_maintenance_folded_records_total",
            "delta-log records folded into published versions")
        self._m_truncated = m.counter(
            "pyramid_maintenance_truncated_records_total",
            "delta-log records truncated after publish")
        self._m_swaps = m.counter(
            "pyramid_maintenance_swaps_total",
            "serving-engine hot-swaps performed")
        m.gauge("pyramid_maintenance_pending_records",
                "records journaled since the last fold",
                fn=lambda: self._since_fold)
        self.rebalance_ops: List[tuple] = []
        self.refreshes = 0
        self.last_version: Optional[str] = None
        self.last_error: Optional[str] = None

    # counter-backed views (the Prometheus series are the bookkeeping)
    @property
    def cycles(self) -> int:
        return int(self._m_cycles.value)

    @property
    def folded_records(self) -> int:
        return int(self._m_folded.value)

    @property
    def truncated_records(self) -> int:
        return int(self._m_truncated.value)

    @property
    def swaps(self) -> int:
        return int(self._m_swaps.value)

    # -- write path ---------------------------------------------------------

    def add_items(self, vectors: np.ndarray,
                  ids: Optional[np.ndarray] = None, *,
                  tags: Optional[np.ndarray] = None) -> PyramidIndex:
        """Journaled insert into the live index (excluded only from the
        compactor's brief publish window by the write lock)."""
        from repro_torch.core.updates import add_items
        with self._write_lock:
            out = add_items(self.index, vectors, ids, tags=tags)
            self._since_fold += 1
            return out

    def set_item_tags(self, ids: np.ndarray,
                      tags: np.ndarray) -> PyramidIndex:
        """Journaled tag assignment on the live index (folded and
        replayed like inserts, so tags survive compaction)."""
        from repro_torch.core.updates import set_item_tags
        with self._write_lock:
            out = set_item_tags(self.index, ids, tags)
            self._since_fold += 1
            return out

    def remove_items(self, ids: np.ndarray) -> PyramidIndex:
        """Journaled (tombstoned) delete from the live index.

        Also tombstones ``ids`` on the current serving engine: the
        engine serves its construction-time arena snapshot, so without
        the filter a removed id would keep surfacing in results until
        the next hot-swap."""
        from repro_torch.core.updates import remove_items
        with self._write_lock:
            out = remove_items(self.index, ids)
            self._since_fold += 1
        eng = self._engine()
        if eng is not None:
            eng.add_tombstones(ids)
        return out

    # -- scheduling ---------------------------------------------------------

    def install(self, engine) -> None:
        """Hook this compactor into a serving engine: a batch-drain step
        counter (the deterministic clock — no timers) and the
        ``stats()['maintenance']`` provider."""
        engine.add_drain_hook(self._on_drain)
        engine.set_maintenance_stats(self.stats)
        self._installed_engine = engine

    def _on_drain(self, actor: str) -> None:
        # executor thread: never do I/O here — just wake the worker
        if self._running and self._since_fold >= self.threshold_records:
            self._wake.set()

    def due(self) -> bool:
        return self._since_fold >= self.threshold_records

    def tick(self) -> Optional[str]:
        """Deterministic step: run one cycle if the journaled-record
        threshold is crossed (tests and storm loops call this at their
        own step boundaries)."""
        if self.due():
            return self.run_once(force=True)
        return None

    def start(self) -> "Compactor":
        """Production mode: a daemon thread that folds whenever woken by
        the drain hook (or every ``poll_s`` as a fallback)."""
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="compactor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def _loop(self) -> None:
        while self._running:
            self._wake.wait(timeout=self.poll_s)
            self._wake.clear()
            if not self._running:
                return
            try:
                if self.due():
                    self.run_once(force=True)
            except Exception as e:   # keep the loop alive; surface in
                self.last_error = repr(e)       # stats, not a dead thread
                logger.exception("compaction cycle failed")

    # -- the cycle ----------------------------------------------------------

    def _fault(self, step: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(step)

    def _apply(self, index: PyramidIndex, records) -> int:
        from repro_torch.core.updates import (add_items, remove_items,
                                        set_item_tags)
        n = 0
        for op, vectors, ids, tags in records:
            if op == "remove":
                remove_items(index, ids, log_delta=False)
            elif op == "tags":
                set_item_tags(index, ids, tags, log_delta=False)
            else:
                add_items(index, vectors, ids, tags=tags,
                          log_delta=False)
            n += 1
        return n

    def _plan_op(self):
        if not self.rebalance:
            return None
        from repro_torch.build.planner import plan_rebalance
        stats = None
        eng = self._engine()
        if eng is not None:
            try:
                stats = eng.stats()
            except Exception:
                stats = None
        return plan_rebalance(
            self.index, engine_stats=stats,
            split_factor=self.split_factor,
            merge_factor=self.merge_factor,
            latency_factor=self.latency_factor)

    def _engine(self):
        if self.brokers is not None and self.name is not None:
            try:
                return self.brokers.get_engine(self.name)
            except KeyError:
                return None
        return self._installed_engine

    def run_once(self, *, force: bool = False) -> Optional[str]:
        """One full maintenance cycle. Returns the new version id, or
        ``None`` when below threshold with nothing to rebalance.

        Sequence (commit boundaries in CAPS; a crash anywhere replays
        to the identical state — the RENAME is the one commit point):

          1. fold: load the current version fresh from the store and
             replay its committed log prefix (lock-free; serving and
             writers keep going);
          2. rebalance the candidate (split/merge/centroid refresh);
          3. catch-up rounds: replay the tail the storm appended while
             we folded (still lock-free);
          4. under the write lock: drain the final tail, PUBLISH the
             candidate (rename = commit), truncate the old log, flip
             ``CURRENT``, hot-swap the serving engine, and make the
             candidate the live write target (its fresh, empty log now
             takes the journal — "delta-log length returns to 0").
        """
        with self._cycle_lock:
            log = self.index.delta_log()
            if log is None:
                raise ValueError(
                    "compactor needs a store-attached index "
                    "(IndexStore.publish/load attach the delta log)")
            plan_op = self._plan_op()
            refresh_due = bool(
                self.refresh_every
                and (self.cycles + 1) % self.refresh_every == 0)
            if (not force and self._since_fold < self.threshold_records
                    and plan_op is None and not refresh_due):
                return None
            self._active = True
            try:
                return self._cycle(plan_op, refresh_due)
            finally:
                self._active = False

    def _cycle(self, plan_op, refresh_due: bool) -> str:
        store = self.store
        old_vid = store.latest()
        if old_vid is None:
            raise ValueError(f"no published version under {store.root}")
        old_log = store.reader(old_vid).delta_log()

        with self.tracer.span("compaction.cycle", version_from=old_vid,
                              rebalance=bool(plan_op)) as cyc:
            # 1. bulk fold from a snapshot — bounded by the count
            # observed NOW so a record committing mid-replay stays in
            # the tail
            snapshot = len(old_log)
            # on the live index's device: the store's own default is
            # the card, whatever device the index serves from
            candidate = store.load(version=old_vid, replay_delta=False,
                                   attach_delta=False,
                                   device=self.index.device)
            with self.tracer.span("compaction.fold", records=snapshot):
                applied = self._apply(candidate, itertools.islice(
                    old_log.replay(), snapshot))

            # 2. shard maintenance on the candidate (never the serving
            # index): split/merge by skew, periodic centroid refresh
            if plan_op is not None:
                from repro_torch.build.planner import (merge_shards,
                                                       split_shard)
                with self.tracer.span("compaction.rebalance",
                                      op=list(plan_op)):
                    if plan_op[0] == "split":
                        split_shard(candidate, plan_op[1])
                    else:
                        merge_shards(candidate, plan_op[1], plan_op[2])
                self.rebalance_ops.append(plan_op)
            if refresh_due:
                from repro_torch.core.router import refresh_centroids
                with self.tracer.span("compaction.refresh_centroids"):
                    refresh_centroids(candidate)
                self.refreshes += 1

            # 3. lock-free catch-up: drain writers' concurrent appends
            with self.tracer.span("compaction.catchup"):
                for _ in range(self.catchup_rounds):
                    n = self._apply(candidate,
                                    old_log.replay(start=applied))
                    applied += n
                    if n == 0:
                        break

            # 4. the commit window: writers excluded, queries flowing
            with self.tracer.span("compaction.commit"):
                with self._write_lock:
                    applied += self._apply(candidate,
                                           old_log.replay(start=applied))
                    self._fault("fold")
                    vid = store.publish(candidate, set_current=False)
                    self._fault("publish")  # <- RENAME landed: committed
                    self._m_truncated.inc(old_log.truncate())
                    self._fault("truncate")
                    store.set_current(vid)
                    self._fault("flip")
                    self._fault("swap")
                    new_engine = None
                    if self.brokers is not None and self.name is not None:
                        new_engine = self.brokers.replace_index(
                            self.name, candidate)
                    elif self.on_swap is not None:
                        new_engine = self.on_swap(candidate)
                    if new_engine is not None:
                        self._m_swaps.inc()
                        self.tracer.instant("maintenance.swap",
                                            version=vid)
                    self.index = candidate  # new live write target, its
                    self._since_fold = 0    # empty log takes the journal
            if new_engine is not None:
                self.install(new_engine)
            self._m_cycles.inc()
            self._m_folded.inc(applied)
            self.last_version = vid
            cyc.set(version_to=vid, folded=applied)
        if self.gc_keep is not None:
            store.gc(keep=self.gc_keep)
        return vid

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        return {
            "cycles": self.cycles,
            "swaps": self.swaps,
            "active": self._active,
            "pending_records": self._since_fold,
            "threshold_records": self.threshold_records,
            "folded_records": self.folded_records,
            "truncated_records": self.truncated_records,
            "rebalance_ops": [list(op) for op in self.rebalance_ops],
            "centroid_refreshes": self.refreshes,
            "last_version": self.last_version,
            "last_error": self.last_error,
        }
