"""Futures-based client surface for distributed Pyramid search (port of
``repro.core.client``; it holds no device code).

User code talks to a :class:`PyramidClient` session and gets back
:class:`SearchFuture` handles, never touching the engine's threads,
topics, or replica groups::

    client = PyramidClient.from_index(index, replicas=2)
    fut = client.search(q, k=10)            # -> SearchFuture
    res = fut.result(timeout=5.0)           # raises TimeoutError

    futs = client.search_batch(Q, k=10)
    for fut in as_completed(futs):          # streaming merge order
        consume(fut.result())
    client.engine.shutdown()

Design notes:

  * every submitted query gets its own future, keyed by query id inside
    the engine, so two clients sharing one engine never see each other's
    results;
  * a timed-out ``result()`` raises :class:`TimeoutError` instead of the
    query silently vanishing from the batch;
  * engine shutdown fails all in-flight futures with
    :class:`EngineShutdownError` so callers never hang on a dead engine;
  * ``SearchFuture.hedges`` counts the engine's hedge/retry
    re-dispatches for that query (the final count also rides on
    ``QueryResult.hedges``).

The module does not import the serving engine at import time: the
client is duck-typed over any object with ``submit / scale / stats /
shutdown``. ``Brokers`` (``repro_torch.core.api``) binds clients to
named indexes and stores.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import (TYPE_CHECKING, Callable, Iterable, Iterator, List,
                    Optional, Tuple)

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.engine import QueryResult, ServingEngine

logger = logging.getLogger(__name__)


class EngineShutdownError(RuntimeError):
    """The engine serving this future was shut down before it completed."""


class QueryExpiredError(RuntimeError):
    """The engine gave up on this query: it sat in ``_pending`` past the
    engine's ``pending_deadline_s`` (e.g. its shard lost every live
    replica, so the missing partials can never arrive). Unlike the
    builtin ``TimeoutError`` from ``SearchFuture.result(timeout)`` —
    after which the query keeps running — an expired query is dropped by
    the engine and its future can never complete."""


class SearchFuture:
    """Handle for one in-flight query.

    Mirrors the ``concurrent.futures.Future`` surface we need —
    ``result(timeout)``, ``done()``, ``exception()``,
    ``add_done_callback()`` — but raises the *builtin* ``TimeoutError``
    and is completed by the engine's merger thread via ``set_result`` /
    ``set_exception`` (engine-side API; user code only reads).
    """

    def __init__(self, query_id: int = -1):
        self.query_id = query_id
        self._cond = threading.Condition()
        self._done = False
        self._result: Optional["QueryResult"] = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List[Callable[["SearchFuture"], None]] = []
        self._hedges = 0

    # -- reader side -------------------------------------------------------

    def done(self) -> bool:
        with self._cond:
            return self._done

    def result(self, timeout: Optional[float] = None) -> "QueryResult":
        """Block for the merged result.

        Raises ``TimeoutError`` if the result is not ready within
        ``timeout`` seconds (the query itself keeps running and the
        future may still complete later), or re-raises the exception the
        engine failed this future with.
        """
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"query {self.query_id} not completed within "
                    f"{timeout}s")
            if self._exception is not None:
                raise self._exception
            return self._result

    def exception(self,
                  timeout: Optional[float] = None) -> Optional[BaseException]:
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"query {self.query_id} not completed within "
                    f"{timeout}s")
            return self._exception

    @property
    def hedges(self) -> int:
        """Hedge/retry re-dispatches the engine has issued for this query
        so far (live counter; the final count also arrives on
        ``QueryResult.hedges``). 0 means the primary dispatch answered
        every shard within its latency deadline."""
        with self._cond:
            return self._hedges

    def add_done_callback(self,
                          fn: Callable[["SearchFuture"], None]) -> None:
        """Call ``fn(self)`` when the future completes (immediately if it
        already has). Callbacks run on the completing thread."""
        with self._cond:
            if not self._done:
                self._callbacks.append(fn)
                return
        fn(self)

    # -- engine side -------------------------------------------------------

    def record_hedge(self) -> None:
        """Engine-side: note one hedge/retry re-dispatch for this query
        (visible to callers via :attr:`hedges` while still pending)."""
        with self._cond:
            self._hedges += 1

    def set_result(self, result: "QueryResult") -> None:
        self._finish(result=result)

    def set_exception(self, exc: BaseException) -> None:
        self._finish(exc=exc)

    def _finish(self, result=None, exc=None) -> None:
        with self._cond:
            if self._done:  # first completion wins (duplicate delivery)
                return
            self._result = result
            self._exception = exc
            self._done = True
            callbacks, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:   # a bad callback must not kill the
                logger.exception(   # merger thread or abort shutdown
                    "done-callback for query %d raised", self.query_id)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = ("done" if self.done() else "pending")
        return f"SearchFuture(query_id={self.query_id}, {state})"


def gather(futures: Iterable[SearchFuture],
           timeout: Optional[float] = None, *,
           return_exceptions: bool = False) -> List:
    """Await a batch of futures under ONE shared deadline, preserving
    submit order.

    Raises the first per-query failure (``TimeoutError`` included) —
    or, with ``return_exceptions=True``, places the exception in the
    result list instead so callers can count stragglers.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    out = []
    for fut in futures:
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        try:
            out.append(fut.result(remaining))
        except Exception as exc:
            if not return_exceptions:
                raise
            out.append(exc)
    return out


def gather_arrays(futures: Iterable[SearchFuture], k: int,
                  timeout: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Bulk-resolve a batch of futures into dense ``(ids [B, k] int64,
    scores [B, k] float32)`` arrays in submit order, under ONE shared
    deadline.

    Short results are padded with ``-1`` ids / ``-inf`` scores; results
    wider than ``k`` are trimmed. This is the bulk path of the kNN-LM
    vocab scatter (``repro_torch.serving.retrieval.knn_probs``): one
    call per decode step resolves every slot's lookup at once.
    """
    futures = list(futures)
    ids = np.full((len(futures), k), -1, np.int64)
    scores = np.full((len(futures), k), -np.inf, np.float32)
    for i, r in enumerate(gather(futures, timeout)):
        n = min(len(r.ids), k)
        ids[i, :n] = r.ids[:n]
        scores[i, :n] = r.scores[:n]
    return ids, scores


def as_completed(futures: Iterable[SearchFuture],
                 timeout: Optional[float] = None
                 ) -> Iterator[SearchFuture]:
    """Yield futures as they complete (streaming-merge order, not submit
    order). Raises ``TimeoutError`` if not all complete within
    ``timeout`` seconds of the call."""
    futures = list(futures)
    ready: "queue.Queue[SearchFuture]" = queue.Queue()
    for fut in futures:
        fut.add_done_callback(ready.put)
    deadline = None if timeout is None else time.monotonic() + timeout
    for i in range(len(futures)):
        remaining = None
        if deadline is not None:
            remaining = max(0.0, deadline - time.monotonic())
        try:
            yield ready.get(timeout=remaining)
        except queue.Empty:
            raise TimeoutError(
                f"{len(futures) - i} of {len(futures)} futures did not "
                f"complete within {timeout}s") from None


class PyramidClient:
    """A search session against one serving engine.

    Construct it directly over an engine (or an ``engine_resolver``
    that returns the current engine), or start one with
    :meth:`from_index`. The client owns no engine state: closing it
    never tears the engine down, and many clients can share one engine —
    each receives exactly its own results.
    """

    def __init__(self, engine: Optional["ServingEngine"] = None, *,
                 engine_resolver: Optional[
                     Callable[[], "ServingEngine"]] = None,
                 name: Optional[str] = None):
        if (engine is None) == (engine_resolver is None):
            raise ValueError(
                "pass exactly one of engine / engine_resolver")
        self._engine = engine
        self._resolver = engine_resolver
        self._closed = False
        self.name = name

    @classmethod
    def from_index(cls, index, *, replicas: int = 1,
                   name: Optional[str] = None,
                   **engine_kw) -> "PyramidClient":
        """Start a :class:`ServingEngine` over ``index`` and return a
        session on it. The caller owns teardown:
        ``client.engine.shutdown()``."""
        from repro_torch.serving.engine import ServingEngine
        return cls(ServingEngine(index, replicas=replicas, **engine_kw),
                   name=name)

    @property
    def engine(self) -> "ServingEngine":
        if self._closed:
            raise RuntimeError(f"client {self.name or ''} is closed")
        return self._engine if self._engine is not None else self._resolver()

    # -- queries -----------------------------------------------------------

    def search(self, query: np.ndarray, k: int = 10, *,
               branching_factor: Optional[int] = None,
               filter_tags=None) -> SearchFuture:
        """Submit ONE query vector; returns its future immediately.

        ``filter_tags`` (int64 bitset; ``repro_torch.core.filters``
        semantics) restricts results to items whose tag bitset
        intersects it — 0 / ``None`` means unfiltered."""
        return self.search_batch(np.asarray(query)[None, :], k,
                                 branching_factor=branching_factor,
                                 filter_tags=filter_tags)[0]

    def search_batch(self, queries: np.ndarray, k: int = 10, *,
                     branching_factor: Optional[int] = None,
                     filter_tags=None) -> List[SearchFuture]:
        """Submit a [n, d] batch; returns one future per query, in
        submit order. Use :func:`as_completed` to stream the merges.
        ``filter_tags`` is a scalar or per-query int64 bitset (see
        :meth:`search`)."""
        return self.engine.submit(queries, k=k,
                                  branching_factor=branching_factor,
                                  filter_tags=filter_tags)

    # -- lifecycle / introspection (public replacements for the old
    # ``engine._spawn`` / ``engine.executors`` poking) ---------------------

    def scale(self, shard: int, n_replicas: int) -> List[str]:
        """Resize one shard's replica group; returns live replica names."""
        return self.engine.scale(shard, n_replicas)

    def stats(self) -> dict:
        return self.engine.stats()

    def close(self) -> None:
        """Detach from the engine (does NOT shut the engine down)."""
        self._closed = True

    def __enter__(self) -> "PyramidClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
