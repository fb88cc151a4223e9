"""Signal-driven elastic autoscaler over ``ServingEngine.scale()`` (port
of ``repro.serving.autoscaler``).

The observability layer makes per-shard load *legible* — tracked p99
service latency (``engine.tracker``) and per-shard access rates
(``stats()['access_rate_per_shard']``) — and this module closes the
loop: shards whose p99 inflates past ``p99_high_s`` or whose routing
access fraction exceeds ``access_high`` get another replica; shards
that stay below ``p99_low_s`` for ``scale_down_after`` consecutive
ticks shed one (hysteresis: a single quiet tick never triggers a
scale-down, and every action starts a per-shard cooldown so the
autoscaler cannot flap faster than new latency evidence arrives).

Deterministic by construction: all decisions happen in :meth:`tick`,
which reads the engine's current signals and calls ``engine.scale`` —
no wall-clock sleeps, no background sampling. Tests drive ``tick()``
directly and inject latency via ``engine.tracker.observe``;
production wires :meth:`start` for a thread that ticks every
``period_s``, or an engine drain hook via :meth:`install` for the same
step clock the fault schedule uses.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

from repro_torch.obs import MetricsRegistry


@dataclasses.dataclass
class AutoscalerConfig:
    """Thresholds and hysteresis knobs.

    Attributes:
      min_replicas / max_replicas: hard bounds per shard.
      p99_high_s: scale UP a shard whose tracked p99 exceeds this.
      p99_low_s: a tick with p99 below this is a scale-DOWN vote.
      access_high: scale UP a shard routed to by more than this
        fraction of queries (hot-shard signal; works before latency
        degrades). ``None`` disables the access-rate trigger.
      scale_down_after: consecutive low-p99 ticks required before one
        replica is shed (the hysteresis band: between ``p99_low_s`` and
        ``p99_high_s`` nothing happens and the streak resets).
      cooldown_ticks: ticks a shard sits out after any action, so the
        next decision sees latency evidence from the NEW replica count.
    """
    min_replicas: int = 1
    max_replicas: int = 4
    p99_high_s: float = 0.5
    p99_low_s: float = 0.1
    access_high: Optional[float] = 0.9
    scale_down_after: int = 3
    cooldown_ticks: int = 2


class Autoscaler:
    """Drives ``engine.scale()`` from the engine's own signals.

    ``registry``/``tracer`` default to the engine's, so autoscaler
    counters land next to the serving counters in one ``/metrics``
    scrape and scale actions show up as instants in the query trace.
    """

    def __init__(self, engine, config: Optional[AutoscalerConfig] = None,
                 *, registry: Optional[MetricsRegistry] = None,
                 tracer=None, period_s: float = 1.0):
        self.engine = engine
        self.config = config or AutoscalerConfig()
        if self.config.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 (a shard with "
                             "zero consumers strands its queries)")
        self.period_s = period_s
        self.obs = registry if registry is not None else engine.obs
        self.tracer = tracer if tracer is not None else engine.tracer
        m = self.obs
        self._m_ticks = m.counter(
            "pyramid_autoscaler_ticks_total", "autoscaler decisions run")
        self._m_up = m.counter(
            "pyramid_autoscaler_scale_ups_total",
            "replicas added", labelnames=("shard",))
        self._m_down = m.counter(
            "pyramid_autoscaler_scale_downs_total",
            "replicas removed", labelnames=("shard",))
        self._low_streak = [0] * engine.w
        self._cooldown = [0] * engine.w
        self.actions: List[Tuple[int, str, int, str]] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._wake = threading.Event()

    # -- the decision --------------------------------------------------------

    def _signals(self, shard: int) -> Tuple[Optional[float], float]:
        p99 = self.engine.tracker.quantile(shard, 99.0)
        access = self.engine.stats()["access_rate_per_shard"][shard]
        return p99, access

    def tick(self) -> List[Tuple[int, str, int, str]]:
        """One deterministic decision pass over all shards. Returns the
        actions taken: ``(shard, "up"|"down", new_replicas, reason)``."""
        cfg = self.config
        taken: List[Tuple[int, str, int, str]] = []
        with self._lock:
            self._m_ticks.inc()
            for s in range(self.engine.w):
                if self._cooldown[s] > 0:
                    self._cooldown[s] -= 1
                    continue
                p99, access = self._signals(s)
                cur = self.engine.replica_count(s)
                hot_lat = p99 is not None and p99 > cfg.p99_high_s
                hot_acc = (cfg.access_high is not None
                           and access == access       # nan-safe
                           and access > cfg.access_high)
                if (hot_lat or hot_acc) and cur < cfg.max_replicas:
                    n = cur + 1
                    reason = (f"p99={p99:.4f}s>{cfg.p99_high_s}s"
                              if hot_lat else
                              f"access={access:.3f}>{cfg.access_high}")
                    self.engine.scale(s, n)
                    self._m_up.labels(shard=str(s)).inc()
                    self.tracer.instant("autoscaler.scale_up", shard=s,
                                        replicas=n, reason=reason)
                    self._low_streak[s] = 0
                    self._cooldown[s] = cfg.cooldown_ticks
                    taken.append((s, "up", n, reason))
                    continue
                cold = p99 is not None and p99 < cfg.p99_low_s
                if cold and cur > cfg.min_replicas:
                    self._low_streak[s] += 1
                    if self._low_streak[s] >= cfg.scale_down_after:
                        n = cur - 1
                        reason = (f"p99={p99:.4f}s<{cfg.p99_low_s}s "
                                  f"for {self._low_streak[s]} ticks")
                        self.engine.scale(s, n)
                        self._m_down.labels(shard=str(s)).inc()
                        self.tracer.instant("autoscaler.scale_down",
                                            shard=s, replicas=n,
                                            reason=reason)
                        self._low_streak[s] = 0
                        self._cooldown[s] = cfg.cooldown_ticks
                        taken.append((s, "down", n, reason))
                else:
                    # in the hysteresis band (or at min): the streak
                    # resets — scale-down needs CONSECUTIVE quiet ticks
                    self._low_streak[s] = 0
            self.actions.extend(taken)
        return taken

    # -- production drivers --------------------------------------------------

    def install(self) -> None:
        """Tick off the engine's batch-drain step clock (the same
        deterministic boundary the fault schedule and the maintenance
        compactor use). The hook runs on executor threads, so it only
        sets a wake flag; pair with :meth:`start`."""
        self.engine.add_drain_hook(self._on_drain)

    def _on_drain(self, actor: str) -> None:
        if self._running:
            self._wake.set()

    def start(self) -> "Autoscaler":
        """Background mode: tick every ``period_s`` (or when woken by an
        installed drain hook)."""
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while self._running:
            self._wake.wait(timeout=self.period_s)
            self._wake.clear()
            if not self._running:
                return
            try:
                self.tick()
            except Exception:   # the engine may be shutting down; a
                pass            # scaler crash must never kill serving

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "ticks": int(self._m_ticks.value),
                "actions": [list(a) for a in self.actions],
                "low_streak": list(self._low_streak),
                "cooldown": list(self._cooldown),
                "config": dataclasses.asdict(self.config),
            }
