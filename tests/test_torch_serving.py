"""The port's serving engine against the JAX package's, on the CPU.

The reference's own engine fixture (``clustered_vectors(1500, 12, 12)``,
4 shards, ``tests/test_faults.py``) is built once by ``repro`` and
carried into ``repro_torch`` by ``convert.py``; both engines answer the
same 48 queries in float32 and in int8 with rerank factor 4 (ids equal,
scores to rtol/atol 1e-5); at l2, ip (with MIPS replication) and angular,
float32 and int8, the two engines also agree under a scalar tag filter,
a filter mixed per query and a filter of selectivity 0, and after
``add_tombstones``. The reference's scripted fault storm,
replayed on the port's engine, fires the events the reference fires,
keeps the exactly-once contract and returns the ids of the port's
fault-free run; a seeded storm under the supervising Monitor does the
same. Mixed k, expiry, the futures surface, the metrics exposition, the
tracer's span tree and the autoscaler are held to the reference's
behaviour. The port's kernels take their plain PyTorch versions here;
every engine is closed by a context manager, and no wait is longer than
30 s.
"""
import contextlib
import copy
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.common.config import PyramidConfig as RefConfig
from repro.core.meta_index import build_pyramid_index as ref_build
from repro.data.synthetic import clustered_vectors, query_set
from repro.kernels.merge_topk import merge_topk_np as ref_merge_np
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import Tracer as RefTracer
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.faults import FaultSchedule as RefSchedule
from repro_torch import convert
from repro_torch.core.client import (EngineShutdownError, PyramidClient,
                                     QueryExpiredError, SearchFuture,
                                     as_completed, gather, gather_arrays)
from repro_torch.kernels import launch_counts
from repro_torch.kernels.merge_topk import merge_topk_np
from repro_torch.obs import MetricsRegistry, Tracer, validate_chrome_trace
from repro_torch.serving.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.serving.engine import (LatencyTracker, QueryRequest,
                                        ServingEngine)
from repro_torch.serving.faults import FaultEvent, FaultSchedule

K = 10
WAIT = 30.0          # the longest any test waits on one future or batch
CFG = dict(metric="l2", num_shards=4, meta_size=48, sample_size=800,
           branching_factor=2, max_degree=12, max_degree_upper=6,
           ef_construction=40, ef_search=50, kmeans_iters=6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's scripted storm (tests/test_faults.py): straggle one
# replica, kill every replica 0 mid-batch, restart two of them
STORM = ((3, "cpu_share", "exec-s2-r1", 0.1), (4, "kill", "exec-s*-r0", 0.0),
         (8, "restart", "exec-s0-r0", 0.0), (8, "restart", "exec-s1-r0", 0.0))
STORM_KW = dict(replicas=2, hedge=True, hedge_deadline_s=0.25,
                auto_restart=False, executor_batch=4)
# what the reference's engine fires for STORM (its fired log; each event
# at its own step, the kill on every replica 0, both restarts performed)
STORM_FIRED = [
    {"step": 3, "action": "cpu_share", "target": "exec-s2-r1", "value": 0.1,
     "matched": ["exec-s2-r1"]},
    {"step": 4, "action": "kill", "target": "exec-s*-r0", "value": 0.0,
     "matched": [f"exec-s{s}-r0" for s in range(4)]},
    {"step": 8, "action": "restart", "target": "exec-s0-r0", "value": 0.0,
     "matched": ["exec-s0-r0"]},
    {"step": 8, "action": "restart", "target": "exec-s1-r0", "value": 0.0,
     "matched": ["exec-s1-r0"]}]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def indexes():
    x = clustered_vectors(1500, 12, 12, seed=0)
    ref = ref_build(x, RefConfig(**CFG))
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    port = convert.index_from_arrays(
        dataclasses.asdict(ref.config), arrays(ref.meta), ref.part_of_center,
        [arrays(g) for g in ref.subs],
        quant=ref.quant_params().to_manifest(), device="cpu")
    return x, ref, port


# tagged indexes: the engine fixture's data and settings at each metric
# (ip over a replicated MIPS index), bit 0 on 5% of the items, bit 1 on
# all of them, bit 40 on none
TAGGED_CFGS = {"l2": {}, "ip": dict(metric="ip", replication_r=20),
               "angular": dict(metric="angular")}
ENGINE_FILTERS = {"scalar": 1, "mixed": (1, 2, 1 << 40), "zero": 1 << 40}


@pytest.fixture(scope="module", params=tuple(TAGGED_CFGS))
def tagged(request):
    """(metric, tags, reference index, port index), tags on both."""
    x = clustered_vectors(1500, 12, 12, seed=0)
    rng = np.random.default_rng(4)
    tags = np.full(len(x), 2, np.int64)
    tags[rng.choice(len(x), size=len(x) // 20, replace=False)] |= 1
    ref = ref_build(x, RefConfig(**{**CFG, **TAGGED_CFGS[request.param]}))
    for g in ref.subs:
        g.tags = tags[np.asarray(g.ids)]
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    port = convert.index_from_arrays(
        dataclasses.asdict(ref.config), arrays(ref.meta), ref.part_of_center,
        [arrays(g) for g in ref.subs],
        quant=ref.quant_params().to_manifest(), device="cpu")
    return request.param, x, tags, ref, port


@contextlib.contextmanager
def serving(index, cls=ServingEngine, **kw):
    eng = cls(index, **kw)
    try:
        yield eng
    finally:
        eng.shutdown()


@contextlib.contextmanager
def serving_of(client):
    """The engine a client started, shut down on leaving the block."""
    eng = client.engine
    try:
        yield eng
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def fault_free(indexes):
    """The port's fault-free answers to 48 queries: (queries, ids)."""
    x, _, port = indexes
    q = query_set(x, 48, seed=11)
    with serving(port, replicas=2, hedge=False, auto_restart=False) as eng:
        return q, _dense(_collect(eng.submit(q, k=K)))


def _collect(futures, timeout=WAIT):
    """Resolve all futures under one deadline; the exactly-once contract:
    each future resolves its own query, no id twice, best-first."""
    results = [f.result(timeout=timeout) for f in futures]
    assert [r.query_id for r in results] == [f.query_id for f in futures]
    for r in results:
        assert len(set(r.ids.tolist())) == len(r.ids)
        assert (np.diff(r.scores) <= 1e-5).all()
    return results


def _dense(results, k=K):
    ids = np.full((len(results), k), -1, np.int64)
    for i, r in enumerate(results):
        ids[i, :len(r.ids)] = r.ids
    return ids


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_engine_matches_reference_engine(indexes, fault_free, mode):
    _, ref, port = indexes
    q, free = fault_free
    kw = dict(quantize=True, rerank_factor=4) if mode == "int8" else {}
    before = launch_counts()
    with serving(ref, RefEngine, replicas=1, **kw) as eng:
        r_ids, r_s = gather_arrays(eng.submit(q, k=K), K, WAIT)
    with serving(port, replicas=1, **kw) as eng:
        t_ids, t_s = gather_arrays(eng.submit(q, k=K), K, WAIT)
        stats = eng.stats()
    np.testing.assert_array_equal(t_ids, r_ids)
    np.testing.assert_allclose(t_s, r_s, **SCORE_TOL)
    assert (t_ids >= 0).all()
    if mode == "float32":        # replicas and batch sizes change nothing
        np.testing.assert_array_equal(t_ids, free)
    assert stats["quantized"] == (mode == "int8")
    assert stats["submitted_queries"] == 48
    assert launch_counts() == before        # plain versions on the CPU


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_engine_filters_and_tombstones_match_reference(tagged, mode):
    """Both engines, side by side, answer 24 queries unfiltered, under
    each filter, then after tombstoning the best id of 8 queries: ids
    equal, scores to rtol/atol 1e-5, no id of a filtered answer misses
    its filter, no tombstoned id returns."""
    metric, x, tags, ref, port = tagged
    q = query_set(x, 24, seed=17)
    kw = dict(quantize=True, rerank_factor=4) if mode == "int8" else {}
    with serving(ref, RefEngine, replicas=1, **kw) as r_eng, \
            serving(port, replicas=1, **kw) as t_eng:
        def both(**sub):
            r = gather_arrays(r_eng.submit(q, k=K, **sub), K, WAIT)
            t = gather_arrays(t_eng.submit(q, k=K, **sub), K, WAIT)
            np.testing.assert_array_equal(t[0], r[0])
            np.testing.assert_allclose(t[1], r[1], **SCORE_TOL)
            return t[0]
        free = both()
        assert (free >= 0).all()
        for name, f in ENGINE_FILTERS.items():
            f = np.resize(np.asarray(f, np.int64), len(q)) \
                if isinstance(f, tuple) else np.int64(f)
            ids = both(filter_tags=f)
            live = ids >= 0
            rows = np.broadcast_to(f, (len(q),))[:, None]
            assert np.all((tags[np.where(live, ids, 0)] & rows)[live] != 0)
            if name == "zero":
                assert not live.any()
        dead = free[:8, 0]
        r_eng.add_tombstones(dead)
        t_eng.add_tombstones(dead)
        after = both()
    assert not np.isin(after, dead).any()
    untouched = ~np.isin(free, dead).any(axis=1)
    assert untouched.any(), metric
    np.testing.assert_array_equal(after[untouched], free[untouched])


def test_arena_accessors_match_reference(indexes):
    _, ref, port = indexes
    for dtype in ("float32", "int8"):
        a_r, a_t = ref.arena(dtype), port.arena(dtype)
        assert a_t.vector_nbytes == a_r.vector_nbytes
        assert a_t.total_nbytes == a_r.total_nbytes
        view = a_t.shard_view(2)
        assert a_t.shard_view(2) is view             # memoised
        assert view.data.data_ptr() == a_t.data[2].data_ptr()   # no copy
        r_view = a_r.shard_view(2)
        np.testing.assert_array_equal(view.data.numpy(),
                                      np.asarray(r_view.data))
        np.testing.assert_array_equal(view.bottom.numpy(),
                                      np.asarray(r_view.bottom))
        assert view.entry == int(r_view.entry)
        assert view.num_upper_levels == int(r_view.num_upper_levels)
        if dtype == "int8":
            np.testing.assert_array_equal(view.scale.numpy(),
                                          np.asarray(r_view.scale))


def test_scripted_storm_replays_exactly_once(indexes, fault_free):
    _, _, port = indexes
    q, free = fault_free
    storm = FaultSchedule([FaultEvent(*e) for e in STORM])
    with serving(port, fault_schedule=storm, **STORM_KW) as eng:
        results = _collect(eng.submit(q, k=K))
        stats = eng.stats()
    assert storm.done() and stats["fault_step"] >= 8
    assert storm.fired == STORM_FIRED
    np.testing.assert_array_equal(_dense(results), free)


def test_seeded_storm_under_the_monitor(indexes):
    x, _, port = indexes
    q = query_set(x, 32, seed=13)
    assert FaultSchedule.storm(21, num_shards=4, replicas=2).events == \
        tuple(FaultEvent(*dataclasses.astuple(e)) for e in
              RefSchedule.storm(21, num_shards=4, replicas=2).events)
    with serving(port, replicas=2, hedge=False) as eng:
        free = _dense(_collect(eng.submit(q, k=K)))
    storm = FaultSchedule.storm(21, num_shards=4, replicas=2, n_events=6,
                                max_step=10)
    with serving(port, replicas=2, auto_restart=True, executor_batch=4,
                 fault_schedule=storm,
                 monitor_opts={"backoff_base_s": 0.02,
                               "period_s": 0.05}) as eng:
        stormy = _dense(_collect(eng.submit(q, k=K)))
        assert storm.done()
    np.testing.assert_array_equal(stormy, free)


def test_when_actor_kill_is_redispatched_and_respawned(indexes):
    x, _, port = indexes
    victim = "exec-s2-r0"
    storm = FaultSchedule([FaultEvent(step=1, action="kill", target=victim,
                                      when_actor=victim)])
    with serving(port, replicas=1, hedge=False, executor_batch=4,
                 fault_schedule=storm,
                 monitor_opts={"backoff_base_s": 0.02,
                               "period_s": 0.05}) as eng:
        results = _collect(eng.submit(query_set(x, 24, seed=19), k=5))
        stats = eng.stats()
    assert len(results) == 24 and storm.fired[0]["matched"] == [victim]
    assert stats["redispatched"] >= 1 and stats["restarts"] >= 1
    assert any(e["event"] == "restart" for e in stats["recovery_timeline"])


# ---------------------------------------------------------------------------
# engine behaviour (tests/test_serving.py, tests/test_client.py)
# ---------------------------------------------------------------------------


def test_mixed_k_batches_search_at_max_k(indexes):
    x, _, port = indexes
    q = query_set(x, 8, seed=7)
    with serving(port, replicas=1) as eng:
        ex = next(iter(eng.executors.values()))
        outs = ex._search([QueryRequest(0, q[0], 3, 1),
                           QueryRequest(1, q[1], 9, 1),
                           QueryRequest(2, q[2], 1, 1)])
        assert [len(ids) for ids, _ in outs] == [3, 9, 1]
        small = _collect(eng.submit(q[:4], k=2))
        large = _collect(eng.submit(q[4:], k=12))
    assert all(len(r.ids) == 2 for r in small)
    assert all(len(r.ids) == 12 for r in large)


def test_pending_queries_expire(indexes):
    x, _, port = indexes
    with serving(port, replicas=1, auto_restart=False,
                 pending_deadline_s=1.0) as eng:
        for name in list(eng.executors):
            eng.kill_executor(name)
        time.sleep(0.3)
        futs = eng.submit(query_set(x, 4, seed=8), k=5)
        for f in futs:
            with pytest.raises(QueryExpiredError):
                f.result(timeout=10)
        assert eng.stats()["expired_queries"] == 4
        assert eng.stats()["pending_queries"] == 0


def test_client_surface(indexes):
    x, _, port = indexes
    q = query_set(x, 16, seed=3)
    client = PyramidClient.from_index(port, replicas=1, name="port")
    with serving_of(client) as eng:
        one = client.search(q[0], k=5).result(timeout=WAIT)
        futs = client.search_batch(q, k=5)
        done = list(as_completed(futs, timeout=WAIT))
        assert sorted(f.query_id for f in done) == \
            sorted(f.query_id for f in futs)
        ids, scores = gather_arrays(futs, 7, WAIT)   # padded past k
        assert ids.shape == (16, 7) and (ids[:, 5:] == -1).all()
        assert np.isneginf(scores[:, 5:]).all()
        np.testing.assert_array_equal(ids[0, :5], one.ids)
        assert client.scale(1, 2) == ["exec-s1-r0", "exec-s1-r1"]
        assert client.scale(1, 1) == ["exec-s1-r0"]
        assert client.stats()["replicas"][1] == 1
    with pytest.raises(EngineShutdownError):
        eng.submit(q, k=5)
    client.close()
    with pytest.raises(RuntimeError, match="closed"):
        client.engine


def test_futures_timeout_and_errors():
    fut = SearchFuture(7)
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    seen = []
    fut.add_done_callback(seen.append)
    fut.set_exception(QueryExpiredError("gone"))
    fut.set_result(None)                      # first completion wins
    assert seen == [fut]
    assert isinstance(gather([fut], return_exceptions=True)[0],
                      QueryExpiredError)
    with pytest.raises(TimeoutError):
        list(as_completed([SearchFuture(8)], timeout=0.01))


def test_shutdown_fails_inflight_futures_and_from_store_is_unported(
        indexes, fault_free, tmp_path):
    """Shutdown fails in-flight futures. ``from_store``, unported when
    this test was named, now recovers an engine from a published store:
    it raises on an empty one and answers with the fault-free ids."""
    x, _, port = indexes
    with serving(port, replicas=1, auto_restart=False) as eng:
        for name in list(eng.executors):
            eng.kill_executor(name)
        time.sleep(0.2)
        futs = eng.submit(query_set(x, 4, seed=5), k=5)
    for f in futs:
        with pytest.raises(EngineShutdownError):
            f.result(timeout=WAIT)
    from repro_torch.store import IndexStore, StoreError
    with pytest.raises(StoreError, match="no published"):
        ServingEngine.from_store(str(tmp_path), device="cpu")
    IndexStore(str(tmp_path)).publish(copy.deepcopy(port))
    q, free = fault_free
    with serving(port, cls=lambda _, **kw: ServingEngine.from_store(
            str(tmp_path), device="cpu", **kw), replicas=2, hedge=False,
            auto_restart=False) as eng:
        np.testing.assert_array_equal(_dense(_collect(eng.submit(q, k=K))),
                                      free)


def test_concurrent_clients_get_only_their_own_results(indexes,
                                                       fault_free):
    """Three callers share one engine (13 threads in all, with a short
    switch interval to interleave them): each gets exactly its own
    answers, the fault-free ones."""
    _, _, port = indexes
    q, free = fault_free
    out = [None] * 3
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with serving(port, replicas=2) as eng:
            def run(i):
                out[i] = _dense(_collect(eng.submit(q[i::3], k=K)))
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for i in range(3):
        np.testing.assert_array_equal(out[i], free[i::3])


def test_autoscaler_scales_on_p99(indexes):
    _, _, port = indexes
    with serving(port, replicas=1) as eng:
        scaler = Autoscaler(eng, AutoscalerConfig(
            p99_high_s=0.5, access_high=None, cooldown_ticks=1))
        for _ in range(16):
            eng.tracker.observe(0, 2.0)
        assert scaler.tick() == [(0, "up", 2, "p99=2.0000s>0.5s")]
        assert eng.replica_count(0) == 2
        assert scaler.tick() == []            # cooldown
        text = eng.obs.render_prometheus()
    assert 'pyramid_autoscaler_scale_ups_total{shard="0"} 1' in text


def test_latency_tracker_matches_reference():
    from repro.serving.engine import LatencyTracker as RefTracker
    rng = np.random.default_rng(2)
    a, b = LatencyTracker(window=16), RefTracker(window=16)
    for v in rng.exponential(size=40):
        a.observe(1, float(v))
        b.observe(1, float(v))
    assert a.snapshot() == b.snapshot()
    assert a.quantile(1, 99.0) == b.quantile(1, 99.0)
    assert a.quantile(3, 50.0) is None


# ---------------------------------------------------------------------------
# observability and the host merge against the reference
# ---------------------------------------------------------------------------


def _drive_registry(reg):
    c = reg.counter("pyramid_queries_total", "queries", labelnames=("shard",))
    c.labels(shard="0").inc(3)
    c.labels(shard="1").inc()
    reg.gauge("pyramid_depth", "depth").set(7)
    reg.gauge("pyramid_lazy", "lazy", labelnames=("shard",),
              fn=lambda: {("0",): 1.5, ("1",): 2.5})
    h = reg.histogram("pyramid_latency_seconds", "latency")
    for v in (0.0004, 0.003, 0.2, 7.0):
        h.observe(v)
    return reg.render_prometheus(), reg.snapshot()


def test_metrics_exposition_matches_reference():
    assert _drive_registry(MetricsRegistry()) == \
        _drive_registry(RefRegistry())


def _drive_tracer(tr):
    with tr.span("query", qid=1) as root:
        with tr.span("coordinator.route", n=4):
            pass
        tr.instant("dispatch", parent=root.span_id, shard=2)

    def executor():
        with tr.span("executor.batch", parent=root.span_id, shard=2):
            pass
    worker = threading.Thread(target=executor)
    worker.start()
    worker.join()
    payload = tr.chrome_trace()
    return sorted((e["name"], e["ph"], e.get("args", {}).get("parent_id"),
                   e.get("ts"), e.get("dur"))
                  for e in payload["traceEvents"] if e["ph"] != "M"), payload


def test_tracer_exports_the_reference_span_tree():
    ticks_a = iter(float(t) for t in range(100))
    ticks_b = iter(float(t) for t in range(100))
    ours, payload = _drive_tracer(Tracer(clock=lambda: next(ticks_a)))
    theirs, _ = _drive_tracer(RefTracer(clock=lambda: next(ticks_b)))
    validate_chrome_trace(payload)
    assert ours == theirs


def test_signed_zero_ties_merge_like_the_numpy_twin():
    """The engine merges on the host with ``merge_topk_np``: -0.0 and
    +0.0 tie, the lower position wins, as in the reference's twin."""
    scores = np.array([[-0.0, 0.0, -1.0, 0.0, -0.0, -2.0]], np.float32)
    ids = np.array([[5, 9, 3, 5, 7, 1]], np.int64)
    got = merge_topk_np(scores, ids, k=4)
    want = ref_merge_np(scores, ids, k=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1][0], [5, 9, 7, 3])
