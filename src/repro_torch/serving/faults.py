"""Deterministic fault-injection control plane for the serving engine
(port of ``repro.serving.faults``; the same seed gives the same storm).

The paper's robustness figures (Fig. 12 straggler, Fig. 13 failure) and
the DIMS-style stress tests need *replayable* fault storms: the same
script of kill / restart / cpu_share events must hit the engine at the
same logical points on every run, on any machine. Wall-clock timers
cannot give that (a loaded CI box drains batches at a different rate),
so a :class:`FaultSchedule` is indexed by **batch-drain steps** instead:

  * every time any executor drains a batch from its topic it calls
    ``engine._fault_tick()`` (the paper's Kafka consumer poll boundary);
  * the tick advances one global step counter and fires every event
    whose ``step`` has been reached, exactly once;
  * the executor that triggered the tick then re-checks its own
    ``alive`` flag before searching — so a kill event aimed at it lands
    *mid-batch*, with the drained items still in hand (they are
    requeued, at-least-once).

Targets are executor names or ``fnmatch`` patterns over them
(``exec-s*-r0`` = every shard's replica-0). Schedules can be scripted
explicitly or generated from a seed (:meth:`FaultSchedule.storm`), and
record everything they fired in :attr:`FaultSchedule.fired` so a replay
can be asserted identical.

    schedule = FaultSchedule([
        FaultEvent(step=2, action="kill", target="exec-s*-r0"),
        FaultEvent(step=5, action="restart", target="exec-s0-r0"),
        FaultEvent(step=1, action="cpu_share", target="exec-s1-r1",
                   value=0.1),
    ])
    eng = ServingEngine(index, replicas=2, fault_schedule=schedule)
"""
from __future__ import annotations

import dataclasses
import fnmatch
import threading
from typing import List, Sequence, Tuple

import numpy as np

ACTIONS = ("kill", "restart", "cpu_share")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.

    ``step`` is the 1-based global batch-drain index at which the event
    becomes due (events with ``step <= 0`` fire on the first tick).
    ``target`` is an executor name or fnmatch pattern, expanded over the
    executors registered at fire time. ``value`` is the CPU share for
    ``cpu_share`` events and ignored otherwise. ``when_actor``
    (optional pattern) defers a due event until the executor *whose
    drain ticked the schedule* matches — e.g. ``when_actor=target`` on
    a kill guarantees the victim dies mid-batch with its drained items
    in hand, rather than idle because a peer ticked first.
    """
    step: int
    action: str
    target: str
    value: float = 0.0
    when_actor: str = ""

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; one of {ACTIONS}")
        if self.action == "cpu_share" and not 0.0 < self.value <= 1.0:
            raise ValueError(   # share 0 would divide-by-zero the
                f"cpu_share event needs value in (0, 1], "   # throttle
                f"got {self.value}")


class FaultSchedule:
    """A step-indexed script of :class:`FaultEvent`s one engine executes.

    Thread-safe: ticks arrive concurrently from every executor thread;
    the schedule serialises them so each event fires exactly once and
    ``fired`` is a single deterministic log. A schedule instance is
    single-use (it remembers what it fired); build a fresh one per
    engine/replay.
    """

    def __init__(self, events: Sequence[FaultEvent]):
        # stable order: by step, then script order for equal steps
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: e.step))
        self.step = 0
        self.fired: List[dict] = []
        self._done_flags = [False] * len(self.events)
        self._lock = threading.Lock()

    # -- engine side -------------------------------------------------------

    def tick(self, engine, actor: str = "") -> None:
        """Advance one batch-drain step and fire every due event.

        Called by executor threads at each drain boundary (``actor`` is
        the draining executor's name); applies events through the
        engine's public fault-injection surface (``kill_executor`` /
        ``restart_executor`` / ``set_cpu_share``). A due event with
        ``when_actor`` set stays pending until a matching executor
        ticks.
        """
        with self._lock:
            self.step += 1
            for i, ev in enumerate(self.events):
                if self._done_flags[i] or ev.step > self.step:
                    continue
                if ev.when_actor and not fnmatch.fnmatch(
                        actor, ev.when_actor):
                    continue   # deferred: wrong executor's drain
                self._done_flags[i] = True
                self._apply(engine, ev)

    def _apply(self, engine, ev: FaultEvent) -> None:
        names = fnmatch.filter(sorted(engine.executors), ev.target)
        matched = []
        for name in names:
            ex = engine.executors.get(name)
            if ex is None:
                continue
            if ev.action == "kill":
                ex.kill()
            elif ev.action == "cpu_share":
                ex.cpu_share = ev.value
            elif ev.action == "restart":
                # only a dead executor may be respawned under its name
                # (restarting a live one would double the consumer);
                # ``matched`` records respawns that actually happened
                if ex.alive and ex.is_alive():
                    continue
                if not engine.restart_executor(name):
                    continue
            matched.append(name)
        self.fired.append({
            "step": self.step, "action": ev.action, "target": ev.target,
            "value": ev.value, "matched": matched})

    def done(self) -> bool:
        with self._lock:
            return all(self._done_flags)

    # -- authoring ---------------------------------------------------------

    @classmethod
    def storm(cls, seed: int, *, num_shards: int, replicas: int,
              n_events: int = 8, max_step: int = 16,
              actions: Sequence[str] = ACTIONS) -> "FaultSchedule":
        """Seeded random storm: ``n_events`` events over drain steps
        ``[1, max_step]`` aimed at uniformly-drawn executors. The same
        seed always yields the same script (assert ``s.events ==
        FaultSchedule.storm(seed, ...).events`` to prove a replay).
        """
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            action = actions[int(rng.integers(len(actions)))]
            target = (f"exec-s{int(rng.integers(num_shards))}"
                      f"-r{int(rng.integers(replicas))}")
            value = (float(rng.uniform(0.05, 1.0))
                     if action == "cpu_share" else 0.0)
            events.append(FaultEvent(int(rng.integers(1, max_step + 1)),
                                     action, target, value))
        return cls(events)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"FaultSchedule(step={self.step}, "
                f"fired={len(self.fired)}/{len(self.events)})")
