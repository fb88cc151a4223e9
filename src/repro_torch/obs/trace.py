"""Per-query trace spans with Chrome ``trace_event`` export.

A :class:`Tracer` records :class:`Span` records — name, span id, parent
id, start/end time, thread — into a bounded ring buffer. The serving
stack threads spans through the whole query path (client submit →
coordinator route → per-shard dispatch/hedge → executor batch drain →
beam-walk kernel call → merge → rerank → future resolve) plus the
streaming decode loop and maintenance compaction cycles, so one trace
shows exactly where a query's latency went and which recovery machinery
touched it.

Causality is explicit: a span's ``parent_id`` links it to the span that
caused it, across threads — a hedge re-dispatch span is a child of its
query's root span even though the merger thread emitted it, an executor
respawn span is a child of the monitor's recovery span for that death.
Within one thread, ``tracer.span(...)`` context managers nest
implicitly (a thread-local stack supplies the parent).

Determinism: the tracer takes an injectable monotonic ``clock`` — under
a :class:`repro_torch.serving.faults.FaultSchedule` replay with a scripted
clock the span set and its parent/child edges are reproducible (span
ids come from one atomic counter; timestamps come from the clock).

Export: :meth:`Tracer.chrome_trace` emits Chrome ``trace_event`` JSON
(the ``{"traceEvents": [...]}`` object form) loadable by Perfetto /
``chrome://tracing`` — complete (``ph: "X"``) events carry the span id
and parent id in ``args`` so causality survives the format.
:func:`validate_chrome_trace` checks the schema; ``launch/serve
--trace-out`` writes a validated file.

Cost: ``NULL_TRACER`` (the default everywhere) is a shared no-op whose
``span()`` returns a reusable null context manager — the disabled hot
path is one attribute lookup and one method call.
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Dict, List, Optional


class Span:
    """One finished (or in-flight) span. ``attrs`` are free-form
    key/values surfaced as Chrome trace ``args``."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "thread",
                 "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t0: float, thread: str, attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.thread = thread
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, dur={self.duration:.6f})")


class _NullSpan:
    """Reusable no-op context manager; also stands in for a Span handle
    (``span_id`` of a null span is ``None``, which ``start`` accepts as
    "no parent")."""

    __slots__ = ()
    span_id = None
    parent_id = None
    name = ""
    attrs: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context-manager handle pairing a live Span with its tracer (and
    the thread-local parent stack, resolved once at creation — the
    enter/exit fast path must not repay the thread-local lookup)."""

    __slots__ = ("tracer", "span", "stack")

    def __init__(self, tracer: "Tracer", span: Span, stack: list):
        self.tracer = tracer
        self.span = span
        self.stack = stack

    @property
    def span_id(self) -> int:
        return self.span.span_id

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)

    def __enter__(self) -> "_SpanCtx":
        self.stack.append(self.span)
        return self

    def __exit__(self, *exc) -> bool:
        span = self.span
        stack = self.stack
        if stack and stack[-1] is span:
            stack.pop()
        span.t1 = self.tracer.clock()
        self.tracer._spans.append(span)
        return False


class Tracer:
    """Bounded-buffer span recorder.

    Args:
      clock: monotonic-seconds callable; inject a scripted clock for
        deterministic replay traces (default ``time.monotonic``).
      capacity: finished-span ring size (oldest spans drop first).
      enabled: a disabled tracer records nothing but keeps the same
        surface; prefer the shared :data:`NULL_TRACER` for "off".
    """

    def __init__(self, clock=time.monotonic, capacity: int = 65536,
                 enabled: bool = True):
        self.enabled = enabled
        self.clock = clock
        self._ids = itertools.count(1)
        # the finished-span ring is lock-free: deque.append and
        # list(deque) are single C calls, atomic under the GIL, so the
        # hot path never contends executor/merger threads on a mutex
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._t_origin = clock()

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        local = self._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        return stack

    def _tname(self) -> str:
        local = self._local
        tname = getattr(local, "tname", None)
        if tname is None:
            tname = local.tname = threading.current_thread().name
        return tname

    def current(self) -> Optional[Span]:
        """The innermost open ``span()`` on this thread, if any."""
        stack = self._stack()
        return stack[-1] if stack else None

    def start(self, name: str, parent: Optional[int] = None,
              **attrs) -> Span:
        """Open a span explicitly (cross-thread handle: stash the
        returned span, ``end()`` it later, quote ``span.span_id`` as
        another span's ``parent``). ``parent=None`` inherits this
        thread's innermost open span."""
        if not self.enabled:
            return _NULL_SPAN
        if parent is None:
            stack = self._stack()
            if stack:
                parent = stack[-1].span_id
        return Span(name, next(self._ids), parent, self.clock(),
                    self._tname(), attrs)

    def end(self, span) -> None:
        if span is _NULL_SPAN or not self.enabled:
            return
        span.t1 = self.clock()
        self._spans.append(span)

    def span(self, name: str, parent: Optional[int] = None, **attrs):
        """Context manager form; nests via the thread-local stack."""
        if not self.enabled:
            return _NULL_SPAN
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1].span_id
        span = Span(name, next(self._ids), parent, self.clock(),
                    self._tname(), attrs)
        return _SpanCtx(self, span, stack)

    def instant(self, name: str, parent: Optional[int] = None,
                **attrs) -> None:
        """Zero-duration marker (rendered as a Chrome instant event)."""
        if not self.enabled:
            return
        span = self.start(name, parent, **attrs)
        span.t1 = span.t0
        self._spans.append(span)

    # -- reading / export --------------------------------------------------

    def snapshot(self) -> List[Span]:
        return list(self._spans)

    def find(self, name: str) -> List[Span]:
        return [s for s in self.snapshot() if s.name == name]

    def by_id(self) -> Dict[int, Span]:
        return {s.span_id: s for s in self.snapshot()}

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON (object form) — load in Perfetto
        or ``chrome://tracing``. Spans become complete (``"ph": "X"``)
        events; zero-duration spans become instants (``"ph": "i"``);
        thread names ride on ``"M"`` metadata events."""
        events = []
        tids: Dict[str, int] = {}
        for span in self.snapshot():
            tid = tids.setdefault(span.thread, len(tids) + 1)
            args = {"span_id": span.span_id}
            if span.parent_id is not None:
                args["parent_id"] = span.parent_id
            args.update(span.attrs)
            ev = {
                "name": span.name,
                "cat": span.name.split(".", 1)[0],
                "pid": 1,
                "tid": tid,
                "ts": round(1e6 * (span.t0 - self._t_origin), 3),
                "args": args,
            }
            if span.t1 is not None and span.t1 > span.t0:
                ev["ph"] = "X"
                ev["dur"] = round(1e6 * (span.t1 - span.t0), 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        for thread, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": thread}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> dict:
        payload = self.chrome_trace()
        validate_chrome_trace(payload)
        with open(path, "w") as f:
            json.dump(payload, f)
        return payload


class _NullTracer(Tracer):
    """Shared disabled tracer: every entry point is a constant-work
    no-op (no clock call, no allocation)."""

    def __init__(self):
        super().__init__(clock=lambda: 0.0, capacity=1, enabled=False)

    def start(self, name, parent=None, **attrs):
        return _NULL_SPAN

    def end(self, span):
        pass

    def span(self, name, parent=None, **attrs):
        return _NULL_SPAN

    def instant(self, name, parent=None, **attrs):
        pass


NULL_TRACER = _NullTracer()


def validate_chrome_trace(payload: dict) -> None:
    """Assert ``payload`` is schema-valid Chrome ``trace_event`` JSON
    (object form with a ``traceEvents`` list; every event carries the
    required keys with the right types; ``X`` events have a
    non-negative ``dur``; instants carry a valid scope). Raises
    ``ValueError`` with the first offending event."""
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError("chrome trace must be an object with "
                         "'traceEvents'")
    events = payload["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key, types in (("name", str), ("ph", str), ("pid", int),
                           ("tid", int)):
            if not isinstance(ev.get(key), types):
                raise ValueError(
                    f"traceEvents[{i}] missing/invalid {key!r}: {ev}")
        ph = ev["ph"]
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"traceEvents[{i}] missing numeric 'ts'")
        if ph == "X":
            if not (isinstance(ev.get("dur"), (int, float))
                    and ev["dur"] >= 0):
                raise ValueError(
                    f"traceEvents[{i}] 'X' event needs dur >= 0")
        elif ph == "i":
            if ev.get("s", "t") not in ("g", "p", "t"):
                raise ValueError(
                    f"traceEvents[{i}] instant scope must be g/p/t")
        else:
            raise ValueError(
                f"traceEvents[{i}] unsupported phase {ph!r} (exporter "
                "emits X/i/M only)")
