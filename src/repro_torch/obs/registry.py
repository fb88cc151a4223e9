"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms.

One schema for every signal the serving stack emits — the engine's
hedge/expiry/restart counters, per-shard latency histograms, stream
decode throughput, maintenance cycle counts — instead of the scattered
one-off dicts they used to live in. The registry is the single source
of truth: ``ServingEngine.stats()`` *reads* these counters rather than
keeping parallel attributes, so the Prometheus text endpoint
(``repro_torch.obs.stats_server``) and ``stats()`` can never disagree.

Design:

  * thread-safe — every mutation takes the metric's own lock (never a
    registry-wide one on the hot path);
  * near-zero-cost when disabled — ``MetricsRegistry(enabled=False)``
    hands out shared no-op metric singletons, so instrumented code pays
    one attribute call and nothing else. A disabled registry
    records NOTHING: engine ``stats()`` counters read back 0;
  * labels — a metric created with ``labelnames`` is a family;
    ``metric.labels(shard="3")`` returns (and caches) the child;
  * idempotent registration — asking for an existing name returns the
    existing collector (type and labelnames must match), so an engine
    hot-swap can re-bind onto a shared registry and counters keep their
    Prometheus monotonic-counter semantics across swaps.

Exposition: :meth:`MetricsRegistry.render_prometheus` emits the
Prometheus text format (``name{label="v"} value`` with
``_bucket``/``_sum``/``_count`` series for histograms);
:meth:`MetricsRegistry.snapshot` returns the same data as a
JSON-friendly dict.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

# default histogram buckets: serving latencies from 100us to 10s
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_INF = float("inf")


def _label_key(labelnames: Tuple[str, ...], labels: dict
               ) -> Tuple[str, ...]:
    try:
        return tuple(str(labels[n]) for n in labelnames)
    except KeyError as e:
        raise ValueError(
            f"metric expects labels {labelnames}, got "
            f"{sorted(labels)}") from e


def _fmt_labels(labelnames: Sequence[str], values: Sequence[str],
                extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(labelnames, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonic counter; ``inc`` only. A labeled family's children are
    reached via :meth:`labels`."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = threading.Lock()
        self._value = 0.0
        self._children: Dict[Tuple[str, ...], "Counter"] = {}

    def labels(self, **labels) -> "Counter":
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Counter(self.name, self.help)
                self._children[key] = child
            return child

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    # -- exposition --------------------------------------------------------

    def _series(self) -> Iterable[Tuple[Tuple[str, ...], float]]:
        if self.labelnames:
            with self._lock:
                items = list(self._children.items())
            for key, child in sorted(items):
                yield key, child.value
        else:
            yield (), self.value

    def render(self) -> Iterable[str]:
        for key, v in self._series():
            yield (f"{self.name}"
                   f"{_fmt_labels(self.labelnames, key)} {_num(v)}")

    def to_dict(self) -> list:
        return [{"labels": dict(zip(self.labelnames, key)), "value": v}
                for key, v in self._series()]


class Gauge(Counter):
    """Settable instantaneous value. Alternatively collected lazily: a
    ``fn`` returning a scalar (no labels) or ``{(label values): scalar}``
    is called at scrape/snapshot time — how the engine exposes queue
    depths and heartbeat staleness without a poller thread."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (),
                 fn: Optional[Callable] = None):
        super().__init__(name, help, labelnames)
        self.fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def _series(self):
        if self.fn is not None:
            out = self.fn()
            if isinstance(out, dict):
                for key, v in sorted(out.items()):
                    key = (key,) if isinstance(key, str) else tuple(
                        str(k) for k in key)
                    yield key, float(v)
            else:
                yield (), float(out)
            return
        yield from super()._series()


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus ``le``
    semantics) plus exact ``sum``/``count``. Buckets are chosen at
    registration; observations beyond the last bound land in ``+Inf``."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs >= 1 bucket")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +1: +Inf
        self._sum = 0.0
        self._count = 0
        self._children: Dict[Tuple[str, ...], "Histogram"] = {}

    def labels(self, **labels) -> "Histogram":
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.name, self.help,
                                  buckets=self.buckets)
                self._children[key] = child
            return child

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    # -- exposition --------------------------------------------------------

    def _snap(self) -> Tuple[list, float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def _series(self):
        if self.labelnames:
            with self._lock:
                items = list(self._children.items())
            for key, child in sorted(items):
                yield key, child._snap()
        else:
            yield (), self._snap()

    def render(self) -> Iterable[str]:
        for key, (counts, total, count) in self._series():
            cum = 0
            for le, c in zip(self.buckets + (_INF,), counts):
                cum += c
                le_s = "+Inf" if le == _INF else _num(le)
                lbl = _fmt_labels(self.labelnames, key, f'le="{le_s}"')
                yield f"{self.name}_bucket{lbl} {cum}"
            lbl = _fmt_labels(self.labelnames, key)
            yield f"{self.name}_sum{lbl} {_num(total)}"
            yield f"{self.name}_count{lbl} {count}"

    def to_dict(self) -> list:
        out = []
        for key, (counts, total, count) in self._series():
            cum, rows = 0, []
            for le, c in zip(self.buckets + (_INF,), counts):
                cum += c
                rows.append([le if le != _INF else "inf", cum])
            out.append({"labels": dict(zip(self.labelnames, key)),
                        "buckets": rows, "sum": total, "count": count})
        return out


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class _NullMetric:
    """Shared do-nothing stand-in handed out by a disabled registry —
    instrumented code pays a method call and nothing else."""

    kind = "null"
    name = help = ""
    labelnames: Tuple[str, ...] = ()
    value = 0.0

    def labels(self, **labels):
        return self

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def render(self):
        return ()

    def to_dict(self):
        return []


NULL_METRIC = _NullMetric()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Collector registry. Engines create a private one by default (so
    per-engine ``stats()`` stays per-engine); pass one explicitly to
    share counters across components — e.g. one registry for an engine
    plus its compactor plus the stream engine decoding over it, scraped
    by one :class:`repro_torch.obs.stats_server.StatsServer`."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw):
        if not self.enabled:
            return NULL_METRIC
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels "
                        f"{existing.labelnames}")
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              fn: Optional[Callable] = None) -> Gauge:
        g = self._register(Gauge, name, help, labelnames)
        if fn is not None and g is not NULL_METRIC:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def collect(self) -> list:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for m in self.collect():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-friendly dump of every collector."""
        return {m.name: {"type": m.kind, "help": m.help,
                         "series": m.to_dict()}
                for m in self.collect()}


# the process-wide default registry: shared by components that opt in
# via get_registry() (engines default to a PRIVATE registry instead so
# two engines in one process never mix counters)
_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL
