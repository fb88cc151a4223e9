"""Multi-tenant namespaces over one device-memory budget (port of
``repro.serving.tenancy``).

A :class:`TenantManager` multiplexes many named Pyramid indexes
("tenants") onto one accelerator without letting their arenas
collectively exceed an HBM budget:

  * **admission control** — every tenant's arena footprint is estimated
    *before* any device allocation (same arithmetic as
    ``ShardArena.from_index``'s stacking: ``w * n_pad * d`` elements at
    the storage dtype) and charged against ``budget_bytes``. Once an
    engine is live, the estimate is trued up to the engine's actual
    ``arena_vector_bytes``. A tenant that cannot fit even after evicting
    every other idle tenant is refused with :class:`AdmissionError` —
    the device is never oversubscribed;
  * **LRU eviction** — admitting a new (or re-activating a cold) tenant
    evicts least-recently-accessed live tenants first: their engine is
    drained and shut down and the index's device cache is dropped
    (``invalidate_device_cache``), but the *host* index object is
    retained — and any store-attached mutations were already journaled —
    so eviction never loses data;
  * **transparent re-pinning** — every tenant-scoped call
    (``submit`` / ``client`` / ``scale`` / ``stats``) touches the
    tenant's LRU clock and lazily re-admits it if it was evicted. A
    caller holding a :class:`~repro_torch.core.client.PyramidClient`
    from :meth:`client` keeps working across an evict/re-pin cycle: the
    client resolves its engine through the manager on every call;
  * **replica arbitration** — :meth:`arbitrate` splits a global replica
    budget across tenants proportionally to their observed access rate
    and installs the shares as each tenant autoscaler's
    ``max_replicas`` (attach one per tenant with
    :meth:`attach_autoscaler`), so a hot tenant can grow only into
    headroom the cold tenants are not using.

Engines are registered in a :class:`repro_torch.core.api.Brokers` under
the tenant name, so everything built on brokers (hot-swap via
``replace_index``, ``open_client``) works per-tenant unchanged.

The budget is the reference's accounting: admission by
:func:`estimate_arena_bytes`, trued up from the live engine's
``stats()["arena_vector_bytes"]``. It does not read the card's
allocator. ``attach_maintenance`` wires a tenant's store to a
``Compactor`` through the brokers.
"""
from __future__ import annotations

import dataclasses
import gc
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.common.device import DeviceLike
from repro_torch.core.api import Brokers
from repro_torch.core.client import PyramidClient
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.obs import MetricsRegistry

logger = logging.getLogger(__name__)


class AdmissionError(RuntimeError):
    """The tenant's arena cannot fit in the device-memory budget, even
    after evicting every other evictable tenant."""


def estimate_arena_bytes(index: PyramidIndex, *,
                         quantize: bool = False) -> int:
    """Predicted vector-payload HBM footprint of ``index``'s arena,
    WITHOUT building it — mirrors ``ShardArena.from_index`` stacking
    (``repro_torch.core.arena._stack_host``):
    ``w`` shards equal-padded to the largest shard's item count.
    Quantized arenas store int8 codes plus the per-shard f32 grid."""
    subs = index.subs
    if not subs:
        return 0
    w = len(subs)
    n_pad = max(1, max(g.n for g in subs))
    d = subs[0].d
    if quantize:
        return w * n_pad * d + 2 * w * d * 4   # codes + scale/zero grid
    return w * n_pad * d * 4


@dataclasses.dataclass
class _Tenant:
    """Manager-side state for one namespace."""
    name: str
    index: PyramidIndex
    engine_kw: dict
    bytes_admitted: int = 0
    live: bool = False
    pinned: bool = False          # live and not evictable (mid-call)
    last_access: float = 0.0
    accesses: int = 0             # total tenant-scoped calls (LRU + rate)
    evictions: int = 0
    autoscaler: object = None
    autoscaler_cfg: object = None


class TenantManager:
    """Admission-controlled registry of named Pyramid tenants sharing
    one device-memory budget (see module docstring).

    ``budget_bytes`` bounds the sum of live tenants' arena vector
    payloads. ``brokers`` defaults to a private :class:`Brokers` on
    ``device`` (where an index loaded from a store path lives: the CUDA
    device unless the caller asks for the CPU); pass a shared one to
    co-host tenants next to other engines (their HBM is then NOT
    accounted here). Usable as a context manager — exit shuts down every
    live engine.
    """

    def __init__(self, budget_bytes: int, *,
                 brokers: Optional[Brokers] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device: DeviceLike = "cuda"):
        if budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be > 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.brokers = (brokers if brokers is not None
                        else Brokers(device=device))
        self._tenants: Dict[str, _Tenant] = {}
        self._lock = threading.RLock()
        self._shutdown = False
        self.obs = registry if registry is not None else MetricsRegistry()
        m = self.obs
        self._m_admissions = m.counter(
            "pyramid_tenant_admissions_total",
            "tenant arenas admitted to device memory",
            labelnames=("tenant",))
        self._m_evictions = m.counter(
            "pyramid_tenant_evictions_total",
            "tenant arenas evicted to make room",
            labelnames=("tenant",))
        self._m_rejections = m.counter(
            "pyramid_tenant_rejections_total",
            "admissions refused (AdmissionError)")
        self._m_accesses = m.counter(
            "pyramid_tenant_accesses_total",
            "tenant-scoped calls served", labelnames=("tenant",))
        m.gauge("pyramid_tenant_live", "1 if the tenant's arena is on "
                "device", labelnames=("tenant",),
                fn=lambda: {(t.name,): 1.0 if t.live else 0.0
                            for t in list(self._tenants.values())})
        m.gauge("pyramid_tenant_bytes",
                "admitted arena vector bytes per tenant",
                labelnames=("tenant",),
                fn=lambda: {(t.name,): float(t.bytes_admitted)
                            for t in list(self._tenants.values())})
        m.gauge("pyramid_tenant_budget_bytes",
                "device-memory budget shared by all tenants",
                fn=lambda: float(self.budget_bytes))
        m.gauge("pyramid_tenant_used_bytes",
                "admitted bytes summed over live tenants",
                fn=lambda: float(self._used_locked()))

    # -- accounting ---------------------------------------------------------

    def _used_locked(self) -> int:
        return sum(t.bytes_admitted for t in self._tenants.values()
                   if t.live)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used_locked()

    # -- registry -----------------------------------------------------------

    def create(self, name: str, index: PyramidIndex, *,
               activate: bool = True, **engine_kw) -> "TenantManager":
        """Register a tenant. ``activate=True`` (default) admits and
        spawns its engine immediately — raising :class:`AdmissionError`
        up front if it can never fit; ``False`` defers both to the first
        tenant-scoped call. ``engine_kw`` (``replicas=``,
        ``quantize=``, ...) is remembered and reapplied on every
        re-pin after an eviction."""
        with self._lock:
            self._check_open()
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already exists")
            est = estimate_arena_bytes(
                index, quantize=bool(engine_kw.get("quantize")))
            if est > self.budget_bytes:
                self._m_rejections.inc()
                raise AdmissionError(
                    f"tenant {name!r} needs ~{est} arena bytes, over "
                    f"the total budget of {self.budget_bytes}")
            self._tenants[name] = _Tenant(
                name=name, index=index, engine_kw=dict(engine_kw),
                bytes_admitted=est)
        if activate:
            self._ensure_live(name)
        return self

    def drop(self, name: str) -> None:
        """Remove a tenant entirely: evict if live, forget its state."""
        with self._lock:
            t = self._tenants.pop(name, None)
        if t is None:
            return
        self._teardown(t)

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    # -- admission / eviction ----------------------------------------------

    def _check_open(self) -> None:
        if self._shutdown:
            raise RuntimeError("tenant manager is shut down")

    def _get(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(
                f"unknown tenant {name!r} (known: {sorted(self._tenants)})")
        return t

    def _ensure_live(self, name: str):
        """Touch the tenant's LRU clock and return its live engine,
        admitting (and evicting colder tenants) if necessary."""
        evict: List[_Tenant] = []
        with self._lock:
            self._check_open()
            t = self._get(name)
            t.last_access = time.monotonic()
            t.accesses += 1
            self._m_accesses.labels(tenant=name).inc()
            if t.live:
                return self.brokers.get_engine(name)
            est = estimate_arena_bytes(
                t.index, quantize=bool(t.engine_kw.get("quantize")))
            t.bytes_admitted = est
            if est > self.budget_bytes:
                self._m_rejections.inc()
                raise AdmissionError(
                    f"tenant {name!r} needs ~{est} arena bytes, over "
                    f"the total budget of {self.budget_bytes}")
            # evict coldest-first until the newcomer fits (<= budget:
            # an arena exactly at the remaining budget is admitted)
            victims = sorted(
                (v for v in self._tenants.values()
                 if v.live and not v.pinned and v.name != name),
                key=lambda v: v.last_access)
            freed = 0
            while (self._used_locked() - freed + est > self.budget_bytes
                   and victims):
                v = victims.pop(0)
                evict.append(v)
                freed += v.bytes_admitted
            if self._used_locked() - freed + est > self.budget_bytes:
                self._m_rejections.inc()
                raise AdmissionError(
                    f"tenant {name!r} needs ~{est} arena bytes; only "
                    f"{self.budget_bytes - self._used_locked()} of "
                    f"{self.budget_bytes} free and no evictable tenant "
                    "frees enough")
            for v in evict:
                v.live = False   # claim under the lock; teardown below
            t.live = True        # claim the budget before releasing
            t.pinned = True      # don't let a racing admit evict us
        try:
            for v in evict:
                self._evict(v)
            engine = self.brokers.engine_for(name, t.index,
                                             **t.engine_kw)
            # true-up: the engine knows its actual payload
            with self._lock:
                t.bytes_admitted = int(
                    engine.stats()["arena_vector_bytes"])
            self._m_admissions.labels(tenant=name).inc()
            if t.autoscaler_cfg is not None and t.autoscaler is None:
                self._attach_autoscaler_locked(t, engine)
            return engine
        except BaseException:
            with self._lock:   # failed spawn must not leak budget
                t.live = False
            raise
        finally:
            with self._lock:
                t.pinned = False

    def _evict(self, t: _Tenant) -> None:
        """Off-device a tenant: stop its autoscaler, drain + shut down
        its engine, drop the index's device cache. Host state (graphs,
        tags, delta-log attachment) is untouched — a re-pin rebuilds the
        arena from it bit-identically."""
        logger.info("tenancy: evicting tenant %s (%d bytes)",
                    t.name, t.bytes_admitted)
        self._m_evictions.labels(tenant=t.name).inc()
        t.evictions += 1
        if t.autoscaler is not None:
            try:
                t.autoscaler.stop()
            except Exception:
                logger.exception("autoscaler stop failed for %s", t.name)
            t.autoscaler = None
        self.brokers.close_engine(t.name)
        t.index.invalidate_device_cache()
        # the closed engine sits in reference cycles (its executors hold
        # its bound methods, its registry's gauges close over it): collect
        # them now, so the arena's device memory is freed at the eviction
        # and not at the interpreter's next cyclic collection
        gc.collect()

    def _teardown(self, t: _Tenant) -> None:
        if t.autoscaler is not None:
            try:
                t.autoscaler.stop()
            except Exception:
                pass
            t.autoscaler = None
        self.brokers.close_engine(t.name)
        t.live = False

    def evict(self, name: str) -> bool:
        """Explicitly off-device one tenant (it re-pins lazily on its
        next call). Returns whether it was live."""
        with self._lock:
            t = self._get(name)
            if not t.live or t.pinned:
                return False
            t.live = False
        self._evict(t)
        return True

    # -- tenant-scoped serving surface --------------------------------------

    def engine(self, name: str):
        """The tenant's live engine (admitting / re-pinning first)."""
        return self._ensure_live(name)

    def client(self, name: str) -> PyramidClient:
        """A :class:`PyramidClient` session that follows the tenant
        across evictions, re-pins, and ``replace_index`` hot-swaps."""
        with self._lock:
            self._get(name)   # fail fast on unknown tenants
        return PyramidClient(
            engine_resolver=lambda: self._ensure_live(name), name=name)

    def submit(self, name: str, vectors: np.ndarray, k: int = 10,
               **kw):
        """Tenant-scoped :meth:`ServingEngine.submit` (``filter_tags=``
        and ``branching_factor=`` pass through)."""
        return self._ensure_live(name).submit(vectors, k=k, **kw)

    def scale(self, name: str, shard: int, n_replicas: int):
        return self._ensure_live(name).scale(shard, n_replicas)

    def replace_index(self, name: str, index) -> None:
        """Hot-swap the tenant onto a new index (store path or built
        :class:`PyramidIndex`) through the brokers, then refresh the
        byte accounting from the replacement's actual arena."""
        with self._lock:
            t = self._get(name)
        engine = self._ensure_live(name)
        new = self.brokers.replace_index(name, index)
        if new is None:
            return
        with self._lock:
            t.index = new.index
            t.bytes_admitted = int(new.stats()["arena_vector_bytes"])
        del engine

    def attach_maintenance(self, name: str, store, **opts):
        """Tenant-scoped :meth:`Brokers.attach_maintenance` (delta-log
        compaction + hot-swap for this tenant's store)."""
        self._ensure_live(name)
        return self.brokers.attach_maintenance(name, store, **opts)

    # -- autoscaling arbitration --------------------------------------------

    def attach_autoscaler(self, name: str, config=None):
        """Create (and remember) a per-tenant
        :class:`repro_torch.serving.autoscaler.Autoscaler`; recreated
        automatically after evict/re-pin cycles. Returns the live
        autoscaler."""
        from repro_torch.serving.autoscaler import AutoscalerConfig
        engine = self._ensure_live(name)
        with self._lock:
            t = self._get(name)
            t.autoscaler_cfg = config or AutoscalerConfig()
            self._attach_autoscaler_locked(t, engine)
            return t.autoscaler

    def _attach_autoscaler_locked(self, t: _Tenant, engine) -> None:
        from repro_torch.serving.autoscaler import Autoscaler
        t.autoscaler = Autoscaler(engine, t.autoscaler_cfg,
                                  registry=self.obs)

    def arbitrate(self, total_replicas: int) -> Dict[str, int]:
        """Split a global replica budget across tenants by access-rate
        share (largest-remainder rounding, floor 1 each) and install the
        shares as each attached autoscaler's ``max_replicas``. Returns
        ``{tenant: max_replicas}`` for every registered tenant — a
        tenant without an autoscaler still gets its share reported."""
        with self._lock:
            ts = list(self._tenants.values())
            if not ts:
                return {}
            total = max(total_replicas, len(ts))   # floor: 1 per tenant
            counts = np.asarray([t.accesses for t in ts], np.float64)
            if counts.sum() <= 0:
                counts = np.ones(len(ts))
            share = counts / counts.sum()
            raw = share * (total - len(ts))       # floor of 1 pre-paid
            alloc = np.ones(len(ts), np.int64) + raw.astype(np.int64)
            rem = total - int(alloc.sum())
            for i in np.argsort(-(raw - raw.astype(np.int64)))[:rem]:
                alloc[i] += 1
            out: Dict[str, int] = {}
            for t, n in zip(ts, alloc.tolist()):
                out[t.name] = int(n)
                if t.autoscaler is not None:
                    t.autoscaler.config.max_replicas = int(n)
            return out

    # -- introspection / lifecycle ------------------------------------------

    def stats(self, name: Optional[str] = None) -> dict:
        """Manager-level snapshot, or (with ``name``) that tenant's
        engine ``stats()`` extended with its tenancy state."""
        if name is not None:
            engine = self._ensure_live(name)
            s = engine.stats()
            with self._lock:
                t = self._get(name)
                s["tenancy"] = {
                    "live": t.live, "bytes": t.bytes_admitted,
                    "accesses": t.accesses, "evictions": t.evictions}
            return s
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "used_bytes": self._used_locked(),
                "tenants": {
                    t.name: {"live": t.live, "bytes": t.bytes_admitted,
                             "accesses": t.accesses,
                             "evictions": t.evictions}
                    for t in self._tenants.values()},
            }

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            ts = list(self._tenants.values())
        for t in ts:
            self._teardown(t)
        self.brokers.shutdown()

    def __enter__(self) -> "TenantManager":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
