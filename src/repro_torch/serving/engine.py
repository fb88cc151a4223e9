"""Coordinator/executor serving engine — the paper's Sec. IV system layer
(port of ``repro.serving.engine``).

Faithful *policy* reproduction of Fig. 4 with Python threads standing in
for the machine cluster:

  * one work queue per sub-HNSW = a Kafka *topic*;
  * executors subscribe to topics; several executors on the same topic form
    a replica group (the paper's replication for straggler/failure
    robustness). Queue semantics give Kafka's rebalancing for free: a slow
    executor simply drains fewer items, the rest are picked up by its
    replica peers;
  * coordinators search the (replicated) meta-HNSW, enqueue per-topic
    requests, and merge partial results returned over a direct result
    queue (the paper routes partials over bare connections, not Kafka —
    same here). Merged results are delivered into a per-query
    ``SearchFuture`` (``repro_torch.core.client``) keyed by query id, so any
    number of callers can share one engine without seeing each other's
    results;
  * a Monitor thread is the Zookeeper/Master analogue — and a real
    *supervisor*, not just a detector: on a dead or stuck executor it
    re-enqueues that executor's in-flight batch items and respawns the
    replica (bounded restarts with exponential backoff), recording a
    recovery timeline exposed via ``stats()``.

Active robustness (Fig. 12 / Fig. 13 mechanisms):

  * **hedged dispatch** — a per-shard :class:`LatencyTracker` streams
    p50/p99 over completed partials; the merger thread re-enqueues a
    query's shard-work once it has waited longer than a deadline derived
    from the tracked percentile (``hedge_factor * p99``), so a replica
    peer races the straggler. Duplicate partials are resolved
    first-result-wins in ``_merge_loop`` — the same dedup that makes the
    at-least-once requeue paths safe;
  * **automatic failure recovery** — executors publish their drained
    batch as ``inflight``; whichever of (the dying executor itself, the
    Monitor) gets there first re-enqueues the items, so a killed,
    crashed, or hung executor loses nothing.

Fault injection is scripted, not slept: a
:class:`repro_torch.serving.faults.FaultSchedule` fires kill / restart /
cpu_share events at deterministic batch-drain boundaries.

On the card. Executors are threads that hold CUDA tensors: every replica
of a shard reads the one memoised view of the engine's device arena
(``ShardArena.shard_view``), and each batch is one ``hnsw_search`` call,
whose bottom-layer walk is the CUDA beam kernel, launched on the
thread's current stream. The coordinator routes on the device
(``route_queries``, the same kernel over the meta-HNSW); the merger
merges and reranks on the host (``merge_topk_np``, ``exact_rerank_np``),
as the reference does. The engine builds and loads the beam kernel's
library in its constructor, before any executor starts: an executor's
warmup must not wait on ``nvcc`` under the Monitor's warmup grace. A
failed build raises there; nothing falls back to the plain version.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.utils import nearest_rank
from repro_torch.core import filters as F
from repro_torch.core import hnsw as H
from repro_torch.core import metrics as M
from repro_torch.core.arena import ShardArena
from repro_torch.core.client import (EngineShutdownError, QueryExpiredError,
                                     SearchFuture)
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.core.quant import exact_rerank_np
from repro_torch.core.router import effective_ef, route_queries
from repro_torch.kernels.beam_search import load_kernel
from repro_torch.kernels.merge_topk import merge_topk_np
from repro_torch.obs import NULL_TRACER, MetricsRegistry
from repro_torch.serving.faults import FaultSchedule

logger = logging.getLogger(__name__)


# the engine's base meta-search beam for routing; route_queries raises
# it to K when a caller's branching_factor is larger (stats()['routing']
# surfaces that raise)
_ROUTING_EF = 64


@dataclasses.dataclass
class QueryRequest:
    query_id: int
    vector: np.ndarray
    k: int
    num_topics: int           # how many partial results to expect
    submitted_at: float = 0.0  # for topic copies: this dispatch's enqueue time
    shard: int = -1           # which topic this copy was enqueued to
    attempt: int = 0          # 0 = primary dispatch, >0 = hedge/redispatch
    span_id: Optional[int] = None   # the query's root trace span, if any
    filter_tags: int = 0      # metadata filter bitset (0 = unfiltered)
    fetch_k: int = 0          # selectivity-inflated per-shard fetch width


@dataclasses.dataclass
class PartialResult:
    query_id: int
    ids: np.ndarray
    scores: np.ndarray
    shard: int = -1
    attempt: int = 0
    enqueued_at: float = 0.0  # dispatch time of the request copy served
    # the two latency views of this partial (they differ under queueing,
    # throttling, and hedging — conflating them was the old skew bug):
    service_s: float = 0.0    # executor-side: batch drain -> results posted
    e2e_s: float = 0.0        # merger-side: dispatch enqueue -> merge arrival


@dataclasses.dataclass
class QueryResult:
    query_id: int
    ids: np.ndarray
    scores: np.ndarray
    latency_s: float
    hedges: int = 0           # hedge re-dispatches issued for this query


@dataclasses.dataclass
class _Pending:
    """Coordinator-side state for one in-flight query."""
    req: QueryRequest
    fut: SearchFuture
    expected: Tuple[int, ...]             # shard ids awaited
    parts: Dict[int, PartialResult]       # shard -> first-arrived partial
    dispatched: Dict[int, float]          # shard -> last dispatch time
    attempts: Dict[int, int]              # shard -> dispatch count
    hedges: int = 0
    span: object = None                   # open root trace span (or None)


class LatencyTracker:
    """Streaming per-shard latency percentiles over completed partials.

    Bounded window per shard (default 256 newest observations); p50/p99
    are exact over the window. ``quantile`` returns ``None`` until a
    shard has ``min_samples`` observations so a cold engine does not
    hedge off noise.
    """

    def __init__(self, window: int = 256, min_samples: int = 8):
        self.min_samples = min_samples
        self._lat: Dict[int, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._lock = threading.Lock()

    def observe(self, shard: int, latency_s: float) -> None:
        with self._lock:
            self._lat[shard].append(latency_s)

    def quantile(self, shard: int, q: float) -> Optional[float]:
        """Exact q-th percentile (0..100) over the window, or None."""
        with self._lock:
            xs = sorted(self._lat.get(shard, ()))
        if len(xs) < self.min_samples:
            return None
        return nearest_rank(xs, q)

    def snapshot(self) -> Dict[int, Dict[str, float]]:
        with self._lock:
            data = {s: sorted(d) for s, d in self._lat.items()}
        return {s: {"n": len(xs), "p50": nearest_rank(xs, 50),
                    "p99": nearest_rank(xs, 99)}
                for s, xs in data.items() if xs}


class Executor(threading.Thread):
    """Serves one sub-HNSW replica; pulls from its topic queue."""

    def __init__(self, name: str, topic: "queue.Queue", shard_id: int,
                 arena: ShardArena, metric: str, ef: int,
                 result_bus: "queue.Queue", heartbeat: Dict[str, float],
                 batch_max: int = 32, warm_k: int = 10,
                 fault_tick=None, redispatch=None, k_factor: int = 1,
                 linger_s: float = 0.0, net_delay_s: float = 0.0,
                 tag_words=None, tracer=NULL_TRACER):
        super().__init__(name=name, daemon=True)
        self.topic = topic
        self.shard_id = shard_id
        self.arena = arena
        # this shard's device tag bitsets ([n_pad, 2] int32 word pairs,
        # repro_torch.core.filters) for metadata-filtered requests; None
        # on an untagged engine
        self.tag_words = tag_words
        # shared memoised view: every replica of every shard reads the
        # one engine-wide arena (one device copy per engine, not per
        # executor). A quantized engine hands every executor an int8
        # view — the per-engine device vector payload is the compressed
        # one.
        self.graph = arena.shard_view(shard_id)
        self.metric = metric
        self.ef = ef
        self.result_bus = result_bus
        self.heartbeat = heartbeat
        self.batch_max = batch_max
        self.warm_k = warm_k
        # >1 on a quantized engine: partials carry k_factor * k
        # candidates so the coordinator can exact-rerank the merged list
        self.k_factor = k_factor
        self.fault_tick = fault_tick   # engine hook: batch-drain boundary
        self.redispatch = redispatch   # engine hook: bookkept requeue
        # Kafka linger.ms analogue: after the first drained item, wait
        # up to this long for the rest of its burst before searching.
        # Every search op costs the full padded batch_max regardless of
        # fill, so a burst fragmented across two drains doubles the
        # shard's compute — which happens routinely when the submitting
        # thread is preempted mid-batch (single-core hosts, GIL). 0
        # preserves drain-what-is-there semantics.
        self.linger_s = linger_s
        # remote-deployment emulation: in the paper's architecture every
        # executor is a shard SERVER on another machine, so the client
        # sees an RPC round-trip on top of the search. In this
        # single-process reproduction that latency is emulated as a
        # per-batch sleep before the partials post — it consumes no CPU
        # (unlike cpu_share's throttle it neither scales with work nor
        # shrinks the fetch budget), which is exactly what makes it
        # hideable by a client that overlaps retrieval with decode.
        self.net_delay_s = net_delay_s
        self.tracer = tracer
        self.cpu_share = 1.0        # straggler injection: <1 adds sleep
        self.alive = True
        self.warmed = False         # past warmup (monitor grace gate)
        self.busy_since = 0.0       # >0 while blocked inside _search
        self.processed = 0
        self._inflight: List[QueryRequest] = []
        self._inflight_lock = threading.Lock()

    def kill(self) -> None:
        self.alive = False

    # -- in-flight handoff (at-least-once) ---------------------------------

    def _set_inflight(self, batch: List[QueryRequest]) -> None:
        with self._inflight_lock:
            self._inflight = list(batch)

    def take_inflight(self) -> List[QueryRequest]:
        """Atomically claim the drained-but-unfinished batch. Called by
        the dying executor itself AND by the supervising Monitor — the
        pop guarantees the items are re-enqueued exactly once."""
        with self._inflight_lock:
            items, self._inflight = self._inflight, []
            return items

    def has_inflight(self) -> bool:
        with self._inflight_lock:
            return bool(self._inflight)

    # -- search ------------------------------------------------------------

    def _warmup(self) -> None:
        """One search before claiming work (the reference fills its jit
        cache here; on the card it touches the kernel and the view)."""
        dummy = [QueryRequest(-1, np.zeros(self.graph.data.shape[1],
                                           np.float32), self.warm_k, 0)]
        self._search(dummy)

    def _search(self, batch):
        """Fixed-size padded search, as the reference runs it.

        A drained batch may mix requests with different ``k``: search
        once at ``max(k)`` rounded up to a power of two, at ``ef =
        max(self.ef, k)``, and trim per request, so mixed-k callers
        sharing the engine each get their own result width. The
        reference rounds k to keep its jit cache small; the port has no
        jit cache but keeps the rounding, because the searched ``k`` and
        ``ef`` decide the result.
        Returns ``[(ids [r.k * k_factor], scores [...]) for r in batch]``
        (``k_factor > 1`` on quantized engines: the wider partial feeds
        the coordinator's exact rerank).

        ``hnsw_search`` walks the bottom layer through the fused
        beam-walk op (``repro_torch.kernels.beam_search``: the CUDA
        kernel on the card, the plain version on the CPU); copying the
        ids and scores to the host is the batch's one synchronisation.

        Filtered requests (``r.filter_tags != 0``) search at their
        selectivity-inflated ``fetch_k`` with this shard's tag bitsets
        masked in on device (post-walk, pre-top-k — never a host-side
        post-filter that could under-fill); mixed batches work because
        filter word 0 means unfiltered per query.
        """
        k = max(max(r.k, r.fetch_k) for r in batch) * self.k_factor
        k = 1 << (k - 1).bit_length()   # bucket: log-many compiles total
        vecs = np.stack([r.vector for r in batch])
        if len(batch) < self.batch_max:  # pad to the compiled shape
            pad = np.repeat(vecs[:1], self.batch_max - len(batch), axis=0)
            vecs = np.concatenate([vecs, pad], axis=0)
        dev = self.graph.device
        filt_kw = {}
        filt = np.asarray([r.filter_tags for r in batch], np.int64)
        if self.tag_words is not None and np.any(filt):
            fp = np.zeros(self.batch_max, np.int64)
            fp[: len(batch)] = filt   # pad rows: word 0 = unfiltered
            filt_kw = dict(tag_words=self.tag_words,
                           filter_words=torch.as_tensor(
                               F.filter_words(fp)).to(dev))
        with self.tracer.span("kernel.beam_walk", shard=self.shard_id,
                              k=k, batch=len(batch)):
            ids, scores = H.hnsw_search(
                self.graph, torch.as_tensor(vecs).to(dev),
                metric=self.metric, k=k, ef=max(self.ef, k), **filt_kw)
            ids = ids.cpu().numpy()
            scores = scores.cpu().numpy()
        return [(ids[i, : max(r.k, r.fetch_k) * self.k_factor],
                 scores[i, : max(r.k, r.fetch_k) * self.k_factor])
                for i, r in enumerate(batch)]

    def _throttle(self, busy_s: float) -> None:
        """CPU-limit tool analogue: sleep off the lost share in small
        slices so a heavily throttled executor still heartbeats and
        still reacts to ``kill()`` promptly."""
        self._sleep(busy_s * (1.0 / self.cpu_share - 1.0))

    def _sleep(self, duration_s: float) -> None:
        """Heartbeating, kill-responsive sleep."""
        end = time.monotonic() + duration_s
        while self.alive:
            now = time.monotonic()
            if now >= end:
                break
            self.heartbeat[self.name] = now
            time.sleep(min(0.05, end - now))

    def run(self) -> None:
        try:
            self._warmup()
            self.warmed = True
            self.heartbeat[self.name] = time.monotonic()
            while self.alive:
                self.heartbeat[self.name] = time.monotonic()
                try:
                    first: QueryRequest = self.topic.get(timeout=0.05)
                except queue.Empty:
                    continue
                # fetch budget shrinks with cpu share (Kafka
                # max.poll.records semantics): a throttled consumer must
                # not hoard the queue — its unfetched records stay
                # available to replica peers. Quadratic, not linear: a
                # straggler's padded-batch search takes ~T/share end to
                # end no matter how few items it drained, so the budget
                # controls how MANY items suffer that delay — share**2
                # keeps the expected straggler-added latency per item
                # roughly constant (paper Fig. 12: throughput stable
                # until the straggler is extremely slow)
                budget = max(1, int(self.batch_max * self.cpu_share ** 2))
                batch = [first]
                deadline = time.monotonic() + self.linger_s
                while len(batch) < budget:
                    try:
                        batch.append(self.topic.get_nowait())
                    except queue.Empty:
                        # linger for the rest of the burst (releases the
                        # GIL, letting the submitter finish enqueueing)
                        wait = deadline - time.monotonic()
                        if wait <= 0:
                            break
                        try:
                            batch.append(self.topic.get(timeout=wait))
                        except queue.Empty:
                            break   # linger window expired, still empty
                self._set_inflight(batch)
                if self.fault_tick is not None:
                    self.fault_tick(self.name)   # drain boundary: a kill
                if not self.alive:      # event lands mid-batch, items
                    return              # in hand (finally re-enqueues)
                with self.tracer.span(
                        "executor.batch", executor=self.name,
                        shard=self.shard_id, n=len(batch),
                        queries=[r.query_id for r in batch]):
                    t0 = time.monotonic()
                    # a thread blocked in a search cannot heartbeat: flag the
                    # window so the monitor judges it on search_grace_s,
                    # not the loop-idle timeout
                    self.heartbeat[self.name] = t0
                    self.busy_since = t0
                    outs = self._search(batch)
                    # refresh the beat BEFORE dropping the busy flag: the
                    # instant busy_since clears, the monitor judges us on
                    # the short idle timeout again, and the pre-search
                    # heartbeat may already be older than that
                    self.heartbeat[self.name] = time.monotonic()
                    self.busy_since = 0.0
                    if self.cpu_share < 1.0:
                        self._throttle(time.monotonic() - t0)
                    if self.net_delay_s > 0.0:  # emulated RPC round-trip:
                        self._sleep(self.net_delay_s)  # no CPU consumed
                    if not self.alive:  # killed during search/throttle:
                        return          # a dead machine returns nothing
                    service_s = time.monotonic() - t0
                    for r, (ids_r, scores_r) in zip(batch, outs):
                        self.result_bus.put(PartialResult(
                            r.query_id, ids_r, scores_r,
                            shard=self.shard_id, attempt=r.attempt,
                            enqueued_at=r.submitted_at,
                            service_s=service_s))
                    self.processed += len(batch)
                    self._set_inflight([])
        finally:
            # crash, kill, or normal exit: nothing may die holding work.
            # Route through the engine's redispatch so the bookkeeping
            # (dispatch clocks, attempts, the ``redispatched`` counter,
            # completed-query filtering) matches the Monitor's path —
            # and the queued-behind-a-dead-executor time never pollutes
            # the latency tracker the hedge deadline is derived from
            self.alive = False
            if self.redispatch is not None:
                self.redispatch(self)
            else:   # engine-less executor (unit tests): raw requeue
                now = time.monotonic()
                for r in self.take_inflight():
                    self.topic.put(
                        dataclasses.replace(r, submitted_at=now))


class Monitor(threading.Thread):
    """Zookeeper/Master analogue, promoted to supervisor: detect dead or
    stuck executors, re-enqueue their in-flight work, and respawn them
    under bounded restarts with exponential backoff. Every action is
    appended to a recovery timeline surfaced by ``engine.stats()``.
    """

    def __init__(self, engine: "ServingEngine", timeout_s: float = 3.0,
                 period_s: float = 0.1, max_restarts: int = 5,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 warmup_grace_s: float = 30.0, search_grace_s: float = 30.0,
                 restart_reset_s: float = 30.0, timeline_cap: int = 200):
        super().__init__(name="monitor", daemon=True)
        self.engine = engine
        self.timeout_s = timeout_s
        self.period_s = period_s
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.warmup_grace_s = warmup_grace_s
        # a thread blocked inside one hnsw_search call cannot heartbeat,
        # so a long-but-healthy search must not be declared stuck on the
        # loop-idle timeout; it gets this (much longer) grace instead
        self.search_grace_s = search_grace_s
        # the restart budget decays after this much continuous health —
        # max_restarts bounds crash *loops*, not lifetime failures
        self.restart_reset_s = restart_reset_s
        self.running = True
        self._timeline: collections.deque = collections.deque(
            maxlen=timeline_cap)
        self._timeline_lock = threading.Lock()
        self._restart_counts: Dict[str, int] = {}
        self._next_allowed: Dict[str, float] = {}
        self._last_restart: Dict[str, float] = {}
        self._gave_up: Dict[str, bool] = {}
        self._suspected: set = set()

    @property
    def restarts(self) -> int:
        """Respawns actually performed. Counter-backed: the Prometheus
        ``pyramid_executor_restarts_total`` series IS the bookkeeping
        (reads 0 under a disabled registry, like all migrated stats)."""
        return int(self.engine._m_restarts.value)

    def _record(self, name: str, event: str, detail: str) -> None:
        with self._timeline_lock:
            self._timeline.append({
                "t": round(time.monotonic() - self.engine._t0, 4),
                "executor": name, "event": event, "detail": detail})

    def timeline_snapshot(self) -> List[dict]:
        with self._timeline_lock:
            return list(self._timeline)

    def run(self) -> None:
        while self.running:
            time.sleep(self.period_s)
            now = time.monotonic()
            for name, ex in list(self.engine.executors.items()):
                dead = not ex.is_alive() or not ex.alive
                if not dead:
                    # heartbeat is seeded at spawn time, so an executor
                    # that hangs before its first beat is *not* treated
                    # as live forever (the pre-seed bug); warmup and
                    # in-search windows get longer graces because a
                    # thread inside one search call cannot beat
                    hb = self.engine.heartbeat.get(name, 0.0)
                    grace = (self.warmup_grace_s if not ex.warmed
                             else self.search_grace_s if ex.busy_since
                             else self.timeout_s)
                    if now - hb > grace:
                        if self.engine.auto_restart:
                            ex.kill()   # fence the hung thread off
                            self._record(name, "stuck",
                                         f"no heartbeat for "
                                         f"{now - hb:.2f}s")
                            dead = True
                        elif name not in self._suspected:
                            # detector mode: killing a replica we will
                            # not respawn only makes things worse
                            self._suspected.add(name)
                            self._record(name, "stuck",
                                         f"no heartbeat for {now - hb:.2f}"
                                         "s (not fenced: auto_restart "
                                         "off)")
                    else:
                        self._suspected.discard(name)
                if not dead:
                    # healthy: decay the restart budget after sustained
                    # health so max_restarts bounds crash loops, not the
                    # executor's lifetime (scale() also reuses names)
                    if (name in self._restart_counts
                            and now - self._last_restart.get(name, 0.0)
                            > self.restart_reset_s):
                        self._restart_counts.pop(name, None)
                        self._next_allowed.pop(name, None)
                        self._gave_up.pop(name, None)
                    continue
                with self.engine.tracer.span("monitor.recover",
                                             executor=name):
                    self._recover(name, ex, now)

    def _recover(self, name: str, ex: Executor, now: float) -> None:
        """One supervision action for a dead executor: re-enqueue its
        in-flight work, then (maybe) respawn it. Runs inside a
        ``monitor.recover`` span; the redispatch and respawn instants it
        emits nest under that span, so a trace shows exactly which
        recovery handled which death."""
        # supervisor step 1: a dead executor's drained batch must
        # not be lost — re-enqueue whatever it still held (the
        # executor's own finally-requeue races us; take_inflight
        # is an atomic pop, so items go back exactly once)
        n = self.engine._redispatch_inflight(ex)
        if n:
            self._record(name, "redispatch",
                         f"re-enqueued {n} in-flight items")
            self.engine.tracer.instant("monitor.redispatch",
                                       executor=name, items=n)
        # supervisor step 2: respawn, bounded with backoff
        if not self.engine.auto_restart:
            return
        if now < self._next_allowed.get(name, 0.0):
            return
        count = self._restart_counts.get(name, 0)
        if count >= self.max_restarts:
            if not self._gave_up.get(name):
                self._gave_up[name] = True
                self._record(name, "gave_up",
                             f"max_restarts={self.max_restarts} "
                             "exhausted")
            return
        if self.engine.restart_executor(name):
            self.engine._m_restarts.inc()
            self._restart_counts[name] = count + 1
            self._last_restart[name] = now
            backoff = min(self.backoff_cap_s,
                          self.backoff_base_s * (2 ** count))
            self._next_allowed[name] = now + backoff
            self._record(name, "restart",
                         f"attempt {count + 1}/{self.max_restarts},"
                         f" next backoff {backoff:.2f}s")
            self.engine.tracer.instant("executor.respawn", executor=name,
                                       attempt=count + 1)


class ServingEngine:
    """The full Fig. 4 topology for one PyramidIndex."""

    def __init__(self, index: PyramidIndex, *, replicas: int = 1,
                 ef: Optional[int] = None, auto_restart: bool = True,
                 executor_batch: int = 16, warm_k: int = 10,
                 linger_s: float = 0.0, net_delay_s: float = 0.0,
                 pending_deadline_s: Optional[float] = 300.0,
                 quantize: bool = False, rerank_factor: int = 4,
                 hedge: bool = True,
                 hedge_deadline_s: Optional[float] = None,
                 hedge_percentile: float = 99.0,
                 hedge_factor: float = 3.0,
                 hedge_min_s: float = 0.05,
                 hedge_cold_s: float = 1.0,
                 hedge_max_attempts: int = 2,
                 fault_schedule: Optional[FaultSchedule] = None,
                 monitor_opts: Optional[dict] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None):
        self.index = index
        # an index on the card needs one: raises without it (the caller
        # asks for the CPU by building the index with device="cpu")
        self.device = resolve_device(index.device)
        if self.device.type == "cuda":
            # build and load the beam kernel once, here, before any
            # executor thread starts (see the module docstring)
            load_kernel()
        self.cfg = index.config
        self.metric = "ip" if self.cfg.is_mips else self.cfg.metric
        self.ef = ef or self.cfg.ef_search
        self.w = index.num_shards
        self.auto_restart = auto_restart
        self.executor_batch = executor_batch
        self.warm_k = warm_k
        # executor-side burst coalescing (Kafka linger.ms) and remote
        # shard-server RPC emulation: see Executor
        self.linger_s = linger_s
        self.net_delay_s = net_delay_s
        # a pending query whose shard lost every live replica would leak
        # forever (its partials can never arrive); after this deadline it
        # is failed with QueryExpiredError. None disables expiry.
        self.pending_deadline_s = pending_deadline_s
        # quantized serving: executors search the int8 arena and return
        # rerank_factor * k candidates per shard; the merger exact-
        # reranks the merged list against the host-side float32 table
        self.quantize = quantize
        self.rerank_factor = rerank_factor if quantize else 1
        # hedged dispatch: once a (query, shard) dispatch has waited
        # past hedge_factor * tracked p{hedge_percentile} (or the fixed
        # hedge_deadline_s override), re-enqueue it so a replica peer
        # races the straggler; at most hedge_max_attempts hedges per
        # (query, shard). First result wins, duplicates are dropped.
        self.hedge = hedge
        self.hedge_deadline_s = hedge_deadline_s
        self.hedge_percentile = hedge_percentile
        self.hedge_factor = hedge_factor
        self.hedge_min_s = hedge_min_s
        self.hedge_cold_s = hedge_cold_s
        self.hedge_max_attempts = hedge_max_attempts
        # hedging keeps its exact-percentile window (the deadline needs
        # an exact p99 over recent samples, which fixed-bucket histogram
        # quantiles cannot give); the registry histograms below are fed
        # at the same merge-loop site for exposition
        self.tracker = LatencyTracker()
        self.faults = fault_schedule
        # -- observability: the registry counters ARE the engine's
        # bookkeeping (stats() reads them back, so the Prometheus
        # endpoint and stats() can never disagree). Default is a fresh
        # private registry so per-engine stats stay per-engine; pass a
        # shared one to aggregate (Brokers.replace_index hands the old
        # engine's registry to its replacement so counters stay
        # monotonic across hot-swaps — registration is idempotent).
        # Caveat: under a disabled registry the migrated stats counters
        # read 0 (that is the documented cost of "free when off").
        self.obs = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        m = self.obs
        self._m_submitted = m.counter(
            "pyramid_queries_submitted_total",
            "queries accepted by submit()")
        self._m_expired = m.counter(
            "pyramid_queries_expired_total",
            "pending queries failed by the expiry sweep")
        self._m_hedged = m.counter(
            "pyramid_queries_hedged_total",
            "queries hedged at least once")
        self._m_redispatched = m.counter(
            "pyramid_redispatched_total",
            "shard-work re-enqueues (hedge + recovery)")
        self._m_restarts = m.counter(
            "pyramid_executor_restarts_total",
            "executor respawns performed by the monitor")
        self._m_partials = m.counter(
            "pyramid_partials_total",
            "winning partial results merged", labelnames=("shard",))
        self._h_service = m.histogram(
            "pyramid_shard_service_seconds",
            "executor-side batch service time (drain -> results posted)",
            labelnames=("shard",))
        self._h_e2e = m.histogram(
            "pyramid_shard_e2e_seconds",
            "dispatch-to-merge latency per winning partial "
            "(what hedge deadlines are derived from)",
            labelnames=("shard",))
        self._h_query = m.histogram(
            "pyramid_query_latency_seconds",
            "submit-to-resolve latency per completed query")
        # pre-bound per-shard children: the merge loop is the hot path
        shards = [str(s) for s in range(self.w)]
        self._m_partials_by = [self._m_partials.labels(shard=s)
                               for s in shards]
        self._h_service_by = [self._h_service.labels(shard=s)
                              for s in shards]
        self._h_e2e_by = [self._h_e2e.labels(shard=s) for s in shards]
        # lazy gauges: evaluated at scrape time, no poller thread
        m.gauge("pyramid_pending_queries", "in-flight queries",
                fn=lambda: len(self._pending))
        m.gauge("pyramid_queue_depth", "topic queue depth",
                labelnames=("shard",),
                fn=lambda: {(str(s),): self.topics[s].qsize()
                            for s in range(self.w)})
        m.gauge("pyramid_replicas_live", "live replicas per shard",
                labelnames=("shard",),
                fn=lambda: {(str(s),): self.replica_count(s)
                            for s in range(self.w)})
        m.gauge("pyramid_executor_heartbeat_staleness_seconds",
                "seconds since each executor's last heartbeat",
                labelnames=("executor",),
                fn=lambda: {(name,): time.monotonic() - hb
                            for name, hb in list(self.heartbeat.items())})
        # maintenance observability: a background compactor
        # (repro_torch.store.maintenance) registers a stats provider
        # here and hooks into the batch-drain tick — same deterministic step
        # clock the fault schedule uses, never a timer
        self._drain_hooks: List = []
        self._maintenance_stats = None
        # serving-layer delete filter (see add_tombstones): ids removed
        # from the live index after this engine snapshotted its arena
        self._tombstones = np.zeros((0,), np.int64)

        self.meta_arrays = index.meta_arrays()
        self.part_of_center = index.part_of_center_tensor()
        # one device arena per engine; int8 when quantized (the device
        # vector payload shrinks ~4x — see index.arena docs)
        self.arena = index.arena("int8" if quantize else "float32")
        # metadata-filter state, snapshotted with the arena: host tags
        # drive submit-time selectivity estimates, the device word pairs
        # feed the executors' on-device alive mask. Untagged indexes get
        # None, and a filtered query against an untagged engine
        # short-circuits to empty in submit() (selectivity 0)
        self._tags_host = index.tags_host()
        self._tags_arena = (index.tags_arena()
                            if self._tags_host.any() else None)
        if quantize:   # host-side full-precision copy for exact rerank
            self._rerank_table = index.rerank_table()
        # Fig. 5 routing observability: running access-rate accumulators
        # (shard hits / (queries * w)) and the branching factor the last
        # submit routed with (a caller override changes what the meta
        # search actually ran). The engine's base meta-search beam is
        # _ROUTING_EF; routing raises it to K when K is larger — stats()
        # reports both so the raise is observable.
        self._routed_hits = 0
        self._routed_queries = 0
        # per-shard dispatch counts: stats()['access_rate_per_shard'] is
        # the load signal the autoscaler reads (hot shards get replicas)
        self._routed_per_shard = np.zeros(self.w, np.int64)
        self._routing_kb = self.cfg.branching_factor

        self.topics: List[queue.Queue] = [queue.Queue()
                                          for _ in range(self.w)]
        self.result_bus: "queue.Queue" = queue.Queue()
        self.heartbeat: Dict[str, float] = {}
        self.executors: Dict[str, Executor] = {}
        self.replicas = replicas          # configured replicas per shard
        self._qid = 0
        self._pending: Dict[int, _Pending] = {}
        self._lock = threading.Lock()
        self._scale_lock = threading.Lock()
        self._shutdown = False
        self._t0 = time.monotonic()

        for s in range(self.w):
            for r in range(replicas):
                self._spawn(s, r)
        self.monitor = Monitor(self, **(monitor_opts or {}))
        self.monitor.start()
        self._merger = threading.Thread(target=self._merge_loop, daemon=True)
        self._merger_running = True
        self._merger.start()

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def from_store(cls, store_path: str, *, version: Optional[str] = None,
                   replay_delta: bool = True, device: DeviceLike = "cuda",
                   **engine_kw
                   ) -> "ServingEngine":
        """Recover an engine from a published
        :class:`repro_torch.store.IndexStore` version (default: the
        latest), its index loaded on ``device``.

        This is the crash-recovery path: an engine lost with its host
        reopens the last *published* index and replays the version's
        append-only delta log, so every update that happened after the
        publish is served again. ``quantize=True`` (via ``engine_kw``)
        reopens onto the manifest's frozen int8 grid — no re-derivation,
        and replayed inserts requantize bit-identically.
        """
        from repro_torch.store import IndexStore
        index = IndexStore(store_path).load(
            version=version, replay_delta=replay_delta, device=device)
        return cls(index, **engine_kw)

    def _spawn(self, shard: int, replica: int) -> Executor:
        name = f"exec-s{shard}-r{replica}"
        ex = Executor(name, self.topics[shard], shard,
                      self.arena, self.metric, self.ef,
                      self.result_bus, self.heartbeat,
                      batch_max=self.executor_batch, warm_k=self.warm_k,
                      fault_tick=self._fault_tick,
                      redispatch=self._redispatch_inflight,
                      k_factor=self.rerank_factor,
                      linger_s=self.linger_s,
                      net_delay_s=self.net_delay_s,
                      tag_words=(None if self._tags_arena is None
                                 else self._tags_arena[shard]),
                      tracer=self.tracer)
        # seed the heartbeat BEFORE the thread runs: an executor that
        # dies or hangs before its first beat must look stale, not
        # fresh-forever (the old ``heartbeat.get(name, now)`` bug)
        self.heartbeat[name] = time.monotonic()
        self.executors[name] = ex
        ex.start()
        return ex

    def restart_executor(self, name: str) -> bool:
        """Respawn a dead executor under its name; returns whether a
        respawn actually happened (the monitor counts only those)."""
        with self._lock:     # serialize against shutdown(): a respawn
            if self._shutdown:   # landing after its kill snapshot would
                return False     # leak a forever-running thread
            old = self.executors.get(name)
            if old is None:  # retired by scale() since the monitor's scan
                return False
            self._spawn(old.shard_id, self._replica_slot(name))
            return True

    def kill_executor(self, name: str) -> None:
        """Failure injection: the monitor may restart the executor."""
        self.executors[name].kill()

    def set_cpu_share(self, name: str, share: float) -> None:
        self.executors[name].cpu_share = share

    def install_fault_schedule(self, schedule: FaultSchedule) -> None:
        """Arm a (new) fault script; steps count from this engine's next
        batch drain. Replaces any previous schedule."""
        self.faults = schedule

    def _fault_tick(self, actor: str = "") -> None:
        fs = self.faults
        if fs is not None:
            fs.tick(self, actor)
        for hook in list(self._drain_hooks):
            try:
                hook(actor)
            except Exception:   # a maintenance hook must never be able
                logger.exception("drain hook failed")   # to kill serving

    def add_drain_hook(self, hook) -> None:
        """Register ``hook(actor)`` to run at every executor batch-drain
        boundary — the engine's deterministic step clock (exactly where
        ``FaultSchedule.tick`` fires). The maintenance compactor uses
        this to count work/poll cycles without wall-clock sleeps; hooks
        run on executor threads and must not block."""
        self._drain_hooks.append(hook)

    def remove_drain_hook(self, hook) -> None:
        try:
            self._drain_hooks.remove(hook)
        except ValueError:
            pass

    def set_maintenance_stats(self, provider) -> None:
        """Attach a zero-arg callable returning the maintenance
        subsystem's stats dict; surfaced as ``stats()['maintenance']``."""
        self._maintenance_stats = provider

    def add_tombstones(self, ids) -> None:
        """Hide ``ids`` from every future result of this engine.

        The engine serves the arena it snapshotted at construction, so a
        ``remove_items`` applied to the live index stays visible here
        until the next maintenance hot-swap publishes a folded index.
        The maintenance write path calls this to close that gap: merged
        results drop tombstoned ids immediately.  The set dies with the
        engine — by the time a compaction cycle swaps in a new engine,
        every journaled removal has been folded into its index.
        """
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if not ids.size:
            return
        with self._lock:
            self._tombstones = np.unique(
                np.concatenate([self._tombstones, ids]))

    @staticmethod
    def _replica_slot(name: str) -> int:
        """Slot number from an ``exec-s{shard}-r{slot}`` executor name."""
        return int(name.split("-r")[1])

    def replica_count(self, shard: int) -> int:
        """Live replicas currently serving ``shard``'s topic."""
        return len(self._live_replicas(shard))

    def _live_replicas(self, shard: int) -> List[str]:
        return sorted(
            (name for name, ex in list(self.executors.items())
             if ex.shard_id == shard and ex.alive),
            key=self._replica_slot)   # numeric: r10 sorts after r2

    def scale(self, shard: int, n_replicas: int) -> List[str]:
        """Elastic scaling (paper Sec. IV-B): resize ``shard``'s replica
        group to exactly ``n_replicas`` live executors.

        Scale-down retires the highest-numbered replicas *intentionally*
        (deregistered before the kill so the monitor does not resurrect
        them); scale-up spawns fresh replicas on unused slots. Returns
        the live replica names after the resize.
        """
        if not 0 <= shard < self.w:
            raise ValueError(f"shard {shard} out of range [0, {self.w})")
        if n_replicas < 1:
            # zero consumers would strand every query routed to this
            # topic: futures that never complete
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        with self._scale_lock, self._lock:
            # _lock serializes the registry mutation against shutdown():
            # either this resize lands before the kill snapshot (and is
            # torn down with the rest) or it observes _shutdown and stops
            if self._shutdown:
                raise EngineShutdownError("engine is shut down")
            # deregister this shard's dead-but-registered executors
            # (failure-injected crashes): scale is the authoritative
            # resize, so the monitor must not resurrect them afterwards
            for name, ex in list(self.executors.items()):
                if ex.shard_id == shard and not ex.alive:
                    self.executors.pop(name)
                    self.heartbeat.pop(name, None)
            live = self._live_replicas(shard)
            for name in reversed(live[n_replicas:]):   # retire extras
                ex = self.executors.pop(name)
                self.heartbeat.pop(name, None)
                ex.kill()
            used = {self._replica_slot(n)
                    for n, ex in list(self.executors.items())
                    if ex.shard_id == shard}
            r = 0
            for _ in range(n_replicas - len(live)):    # grow the group
                while r in used:
                    r += 1
                used.add(r)
                self._spawn(shard, r)
            live_after = self._live_replicas(shard)
            self.tracer.instant("engine.scale", shard=shard,
                                replicas=len(live_after))
            return live_after

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every in-flight future has resolved; returns
        ``False`` on timeout (stragglers then fail at ``shutdown``).

        The hot-swap path (``Brokers.replace_index``) calls this on the
        outgoing engine *after* installing its replacement: nothing new
        arrives here, the executors are still alive, so queries
        submitted before the swap complete normally instead of dying
        with ``EngineShutdownError`` — hot-swaps are invisible to
        callers holding futures."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    return True
            time.sleep(0.005)
        with self._lock:
            return not self._pending

    def stats(self) -> dict:
        """Public snapshot of engine state — replaces poking at
        ``engine.executors`` / ``engine._pending`` internals."""
        with self._lock:
            pending = len(self._pending)
            routed_hits = self._routed_hits
            routed_queries = self._routed_queries
            routed_per_shard = self._routed_per_shard.copy()
            routing_kb = self._routing_kb
        # counter-backed (same objects the Prometheus endpoint renders,
        # so /metrics and stats() can never disagree)
        hedged = int(self._m_hedged.value)
        redispatched = int(self._m_redispatched.value)
        execs = {
            name: {"shard": ex.shard_id, "alive": ex.alive,
                   "processed": ex.processed, "cpu_share": ex.cpu_share}
            for name, ex in sorted(list(self.executors.items()))}
        return {
            "num_shards": self.w,
            "quantized": self.quantize,
            "rerank_factor": self.rerank_factor,
            "arena_vector_bytes": self.arena.vector_nbytes,
            # Fig. 5 routing metric: mean fraction of sub-HNSWs a
            # submitted query touched (nan before any submit)
            "access_rate": (routed_hits / (routed_queries * self.w)
                            if routed_queries else float("nan")),
            # per-shard dispatch fraction (hot-shard signal for the
            # autoscaler): shard s appeared in this fraction of routes
            "access_rate_per_shard": (
                (routed_per_shard / routed_queries).tolist()
                if routed_queries else [float("nan")] * self.w),
            # what the last submit's meta routing actually searched
            # with: the engine requests a _ROUTING_EF-wide beam and the
            # router raises it to K when K is larger — requested !=
            # effective IS the observable raise
            "routing": {"requested_ef": _ROUTING_EF,
                        "branching_factor": routing_kb,
                        "effective_ef": effective_ef(
                            _ROUTING_EF, routing_kb)},
            "replicas": {s: self.replica_count(s) for s in range(self.w)},
            "executors": execs,
            "pending_queries": pending,
            # counter-backed like hedged/expired below: cumulative over
            # the registry's lifetime, so a hot-swapped engine that
            # inherited its predecessor's registry reports the
            # service-level total and /metrics parity holds exactly
            "submitted_queries": int(self._m_submitted.value),
            "expired_queries": int(self._m_expired.value),
            "hedged_queries": hedged,
            "redispatched": redispatched,
            "restarts": self.monitor.restarts,
            "monitor_restarts": self.monitor.restarts,   # legacy alias
            "recovery_timeline": self.monitor.timeline_snapshot(),
            "latency": self.tracker.snapshot(),
            "fault_step": self.faults.step if self.faults else 0,
            "queue_depths": [t.qsize() for t in self.topics],
            # background maintenance (repro_torch.store.maintenance), when a
            # compactor is attached: cycles, folded records, rebalance
            # ops, last published version
            "maintenance": (self._maintenance_stats()
                            if self._maintenance_stats else None),
        }

    def shutdown(self) -> None:
        with self._lock:   # no submit can register futures after this
            self._shutdown = True
            pending = list(self._pending.values())
            self._pending.clear()
        self.monitor.running = False
        self._merger_running = False
        for ex in list(self.executors.values()):   # snapshot: the monitor
            ex.kill()                              # may _spawn concurrently
        for entry in pending:   # fail in-flight futures loudly
            if entry.req.span_id is not None:
                entry.span.attrs.update(shutdown=True)
                self.tracer.end(entry.span)
            entry.fut.set_exception(EngineShutdownError(
                f"engine shut down with query {entry.req.query_id} "
                "in flight"))
        # join so no thread is left inside a device call at interpreter
        # teardown. One shared deadline: executors killed mid-warmup can
        # take a while to reach their alive check, but they warm up
        # concurrently, so the total wait is ~one warmup.
        deadline = time.monotonic() + 15.0
        for ex in list(self.executors.values()):
            ex.join(timeout=max(0.0, deadline - time.monotonic()))
        self.monitor.join(timeout=max(0.1, deadline - time.monotonic()))
        self._merger.join(timeout=max(0.1, deadline - time.monotonic()))

    # -- query path --------------------------------------------------------

    def submit(self, vectors: np.ndarray, k: int = 10,
               branching_factor: Optional[int] = None,
               filter_tags=None) -> List[SearchFuture]:
        """Coordinator: route + enqueue a batch; returns one
        :class:`SearchFuture` per query, in submit order.

        Each future is keyed by its query id inside the engine, so
        concurrent callers sharing this engine each observe exactly
        their own results (there is no shared completion queue to steal
        from), and a caller that times out gets ``TimeoutError`` from
        ``future.result()`` instead of a silently short batch.

        ``filter_tags`` (scalar or per-query int64 bitsets,
        ``repro_torch.core.filters`` semantics: 0 = unfiltered, else any-of
        bit intersection) restricts results to matching items. The
        per-shard fetch width is inflated by the estimated selectivity
        (``ceil(1/sel)``, capped) so low-selectivity filters keep their
        fill instead of being post-filtered into under-full results.
        """
        if self._shutdown:
            raise EngineShutdownError("engine is shut down")
        q = M.preprocess_queries(vectors, self.cfg.metric)
        kb = branching_factor or self.cfg.branching_factor
        filt = np.zeros(q.shape[0], np.int64)
        if filter_tags is not None:
            filt = np.broadcast_to(
                np.asarray(filter_tags, np.int64),
                (q.shape[0],)).copy()
        fetch = np.zeros(q.shape[0], np.int64)
        if filt.any():
            for f in np.unique(filt[filt != 0]):
                sel = F.selectivity_np(self._tags_host, int(f))
                fetch[filt == f] = k * F.inflation(sel)
        with self.tracer.span("coordinator.route", n=int(q.shape[0]),
                              branching_factor=kb):
            mask, _ = route_queries(
                self.meta_arrays, self.part_of_center,
                torch.as_tensor(q).to(self.device), metric=self.metric,
                branching_factor=kb, num_shards=self.w, ef=_ROUTING_EF)
            mask = mask.cpu().numpy()
        futures = []
        now = time.monotonic()
        with self._lock:
            if self._shutdown:   # re-check: shutdown may have raced the
                raise EngineShutdownError(  # routing work above
                    "engine is shut down")
            # Fig. 5 metric: fraction of sub-HNSWs each query touches,
            # plus the K this batch's meta routing actually used
            self._routed_hits += int(mask.sum())
            self._routed_queries += int(mask.shape[0])
            self._routed_per_shard += mask.sum(axis=0).astype(np.int64)
            self._routing_kb = kb
            for i in range(q.shape[0]):
                qid = self._qid
                self._qid += 1
                self._m_submitted.inc()
                topics = tuple(int(s) for s in np.where(mask[i])[0])
                fut = SearchFuture(qid)
                if not topics or (filt[i] and self._tags_arena is None):
                    # router selected nothing, or a non-empty filter on
                    # an untagged engine (selectivity 0): empty result
                    fut.set_result(QueryResult(
                        qid, np.empty(0, np.int64),
                        np.empty(0, np.float32), 0.0))
                    futures.append(fut)
                    continue
                # the query's root span stays open until the future
                # resolves (merge, expiry, or shutdown); every dispatch,
                # hedge, merge, and rerank span hangs off it
                qspan = self.tracer.start("query", qid=qid, k=k,
                                          shards=list(topics))
                req = QueryRequest(qid, q[i], k, len(topics), now,
                                   span_id=qspan.span_id,
                                   filter_tags=int(filt[i]),
                                   fetch_k=int(fetch[i]))
                self._pending[qid] = _Pending(
                    req=req, fut=fut, expected=topics, parts={},
                    dispatched={s: now for s in topics},
                    attempts={s: 1 for s in topics}, span=qspan)
                for s in topics:
                    self.tracer.instant("dispatch", parent=qspan.span_id,
                                        qid=qid, shard=s, attempt=0)
                    self.topics[s].put(
                        dataclasses.replace(req, shard=s))
                futures.append(fut)
        return futures

    # -- recovery / hedging ------------------------------------------------

    def _redispatch_inflight(self, ex: Executor) -> int:
        """Supervisor path: re-enqueue a dead executor's drained batch.
        Only (query, shard) pairs still awaited are re-dispatched; the
        rest were already answered by a replica peer. Returns how many
        items went back on the topic."""
        items = ex.take_inflight()
        if not items:
            return 0
        requeue = []
        now = time.monotonic()
        with self._lock:
            for r in items:
                entry = self._pending.get(r.query_id)
                if entry is None or r.shard in entry.parts:
                    continue   # answered elsewhere: drop, don't redo
                entry.attempts[r.shard] = (
                    entry.attempts.get(r.shard, 1) + 1)
                entry.dispatched[r.shard] = now
                self._m_redispatched.inc()
                requeue.append(dataclasses.replace(
                    r, attempt=entry.attempts[r.shard] - 1,
                    submitted_at=now))
        for r in requeue:
            # child of the query's root span: the trace shows which
            # query lost which shard-work to the dead executor
            self.tracer.instant("recovery.redispatch", parent=r.span_id,
                                qid=r.query_id, shard=r.shard,
                                attempt=r.attempt, executor=ex.name)
            self.topics[r.shard].put(r)
        return len(requeue)

    def _hedge_deadline(self, shard: int) -> float:
        if self.hedge_deadline_s is not None:
            return self.hedge_deadline_s
        p = self.tracker.quantile(shard, self.hedge_percentile)
        if p is None:          # cold shard: no percentile to trust yet
            return self.hedge_cold_s
        return max(self.hedge_min_s, self.hedge_factor * p)

    def _hedge_sweep(self, now: float) -> None:
        """Merger-side straggler mitigation: re-enqueue shard-work that
        has waited past its latency-derived deadline so a replica peer
        races the original dispatch (first result wins)."""
        # deadlines are per-shard, not per-query: compute each once per
        # sweep, outside the engine lock (sorting the tracker window
        # per pending entry would stall submit/merge under load)
        deadlines = [self._hedge_deadline(s) for s in range(self.w)]
        # only hedge shards whose topic queue is EMPTY: a non-empty
        # queue means the missing partial is (or is behind) backlog the
        # replicas simply haven't reached — re-enqueueing into that
        # backlog multiplies load exactly at peak (a burst submit must
        # not become a fleet-wide hedge storm). An empty queue with an
        # overdue dispatch means some executor drained the item and is
        # sitting on it — the straggler signature hedging exists for.
        idle = [self.topics[s].qsize() == 0 for s in range(self.w)]
        actions = []
        with self._lock:
            for entry in self._pending.values():
                for s in entry.expected:
                    if s in entry.parts or not idle[s]:
                        continue
                    attempts = entry.attempts.get(s, 1)
                    if attempts > self.hedge_max_attempts:
                        continue   # give up hedging; expiry still bounds
                    if now - entry.dispatched[s] <= deadlines[s]:
                        continue
                    entry.attempts[s] = attempts + 1
                    entry.dispatched[s] = now
                    if entry.hedges == 0:
                        self._m_hedged.inc()
                    entry.hedges += 1
                    entry.fut.record_hedge()
                    self._m_redispatched.inc()
                    actions.append(dataclasses.replace(
                        entry.req, shard=s, attempt=attempts,
                        submitted_at=now))
        for r in actions:
            # child of the query's root span even though the merger
            # thread emits it — the acceptance-tested causality edge
            self.tracer.instant("hedge.redispatch", parent=r.span_id,
                                qid=r.query_id, shard=r.shard,
                                attempt=r.attempt)
            self.topics[r.shard].put(r)

    # -- merge -------------------------------------------------------------

    def _merge_loop(self) -> None:
        sweep_every = 0.25
        if self.pending_deadline_s is not None:
            sweep_every = max(0.05, min(0.25, self.pending_deadline_s / 4))
        next_sweep = time.monotonic() + sweep_every
        next_hedge = 0.0
        while self._merger_running:
            try:
                part: Optional[PartialResult] = self.result_bus.get(
                    timeout=0.05)
            except queue.Empty:
                part = None
            now = time.monotonic()
            if self.hedge and now >= next_hedge:   # bounded sweep rate:
                next_hedge = now + 0.05            # a fast result stream
                self._hedge_sweep(now)             # must not sweep per-item
            if self.pending_deadline_s is not None and now >= next_sweep:
                next_sweep = now + sweep_every
                self._expire_pending(now)
            if part is None:
                continue
            with self._lock:
                entry = self._pending.get(part.query_id)
                if entry is None or part.shard in entry.parts:
                    # late or hedged duplicate (at-least-once delivery):
                    # first result won, drop this one
                    continue
                entry.parts[part.shard] = part
                self._m_partials_by[part.shard].inc()
                # per-shard e2e latency feeds the hedge deadline —
                # WINNING partials only: a persistent straggler's losing
                # deliveries would otherwise drag the tracked p99 up to
                # its own latency and self-disable the hedging aimed at
                # it (tracker has its own lock; never takes this one).
                # e2e (dispatch enqueue -> here) and service (executor
                # drain -> post) are recorded separately on the partial:
                # the hedge threshold and the histograms now measure the
                # same explicitly-named thing instead of a mix
                if part.enqueued_at > 0:
                    part.e2e_s = now - part.enqueued_at
                    self.tracker.observe(part.shard, part.e2e_s)
                    self._h_e2e_by[part.shard].observe(part.e2e_s)
                if part.service_s > 0:
                    self._h_service_by[part.shard].observe(part.service_s)
                if len(entry.parts) < len(entry.expected):
                    continue
                del self._pending[part.query_id]
            # shared dedup-top-k merge on the host (the same semantics
            # the fused arena pipeline runs through the merge_topk
            # kernel);
            # concatenate in shard order so score ties break identically
            # no matter which replica answered first. A quantized engine
            # merges the wider rerank_factor * k candidate list, then
            # exact-reranks it against the float32 table so the caller
            # sees full-precision scores and float-path recall.
            qsid = entry.req.span_id
            with self.tracer.span("merge", parent=qsid,
                                  qid=entry.req.query_id,
                                  parts=len(entry.parts)):
                parts = [entry.parts[s] for s in sorted(entry.parts)]
                ids = np.concatenate([p.ids for p in parts])[None, :]
                scores = np.concatenate(
                    [p.scores for p in parts])[None, :]
                tomb = self._tombstones
                # serving-layer delete filter: the arena still holds a
                # removed item's row until the next maintenance hot-swap,
                # but its id must never reach a caller. Applied as an
                # alive mask INSIDE the merge (not on the merged top-k):
                # a tombstoned id cannot crowd a live candidate out of
                # the k slots, so results stay full
                alive = (~np.isin(ids, tomb)) if tomb.size else None
                top_scores, top_ids = merge_topk_np(
                    scores, ids, k=entry.req.k * self.rerank_factor,
                    alive=alive)
                if self.quantize:
                    with self.tracer.span("rerank",
                                          qid=entry.req.query_id):
                        table_ids, table_vecs = self._rerank_table
                        top_ids, top_scores = exact_rerank_np(
                            entry.req.vector[None, :], top_ids,
                            entry.req.k, table_ids=table_ids,
                            table_vecs=table_vecs, metric=self.metric)
                found = top_ids[0] >= 0
            latency_s = time.monotonic() - entry.req.submitted_at
            self._h_query.observe(latency_s)
            if qsid is not None:   # None = null span (tracing off)
                entry.span.attrs.update(hedges=entry.hedges,
                                        latency_s=round(latency_s, 6))
                self.tracer.end(entry.span)   # resolve closes the root
            entry.fut.set_result(QueryResult(
                entry.req.query_id, top_ids[0][found],
                top_scores[0][found], latency_s,
                hedges=entry.hedges))

    def _expire_pending(self, now: float) -> None:
        """Fail pending queries older than the deadline (their shard may
        have lost every live replica — the leak this bounds)."""
        expired = []
        with self._lock:
            for qid, entry in list(self._pending.items()):
                if now - entry.req.submitted_at > self.pending_deadline_s:
                    del self._pending[qid]
                    expired.append(entry)
        for entry in expired:
            self._m_expired.inc()
            if entry.req.span_id is not None:
                entry.span.attrs.update(expired=True)
                self.tracer.end(entry.span)
            entry.fut.set_exception(QueryExpiredError(
                f"query {entry.req.query_id} expired after "
                f"{self.pending_deadline_s}s with "
                f"{len(entry.parts)}/{entry.req.num_topics} "
                f"partial results (shard replicas lost or overloaded)"))
