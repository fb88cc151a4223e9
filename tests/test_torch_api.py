"""The port's paper API (``Brokers``, the Listing 1-3 shims) and tenancy
(``TenantManager``) against the JAX package's, on the CPU.

The reference's ``GraphConstructor`` builds and publishes the API
fixture (``clustered_vectors(1000, 12, 16)``, 4 shards: half the rows of
``tests/test_api.py``); the port's ``Coordinator`` loads that store on
the CPU and answers with the reference ``Coordinator``'s ids (scores to
rtol/atol 1e-5). The tenancy tests mirror ``tests/test_tenancy.py`` on
reference-built indexes carried into the port by ``convert.py``: the
evict and re-pin cycle returns the reference manager's ids,
``estimate_arena_bytes`` equals the reference's and the port engine's
``arena_vector_bytes``, and ``arbitrate`` splits a replica budget as the
reference does. The hot swap of ``tests/test_obs_e2e.py`` keeps its
registry, a client opened by ``open_client`` follows a swap onto a store
path, and ``launch.serve --tenant`` runs. Every engine is closed by a
context manager; no wait is longer than 60 s.
"""
import copy
import dataclasses
import threading
import weakref

import numpy as np
import pytest
import torch

from repro.common.config import PyramidConfig as RefConfig
from repro.core.api import Brokers as RefBrokers
from repro.core.api import BuildPara as RefBuildPara
from repro.core.api import Coordinator as RefCoordinator
from repro.core.api import GraphConstructor as RefGraphConstructor
from repro.core.api import QueryPara as RefQueryPara
from repro.core.client import gather_arrays as ref_gather_arrays
from repro.core.meta_index import build_pyramid_index as ref_build
from repro.core.updates import add_items as ref_add
from repro.data.synthetic import clustered_vectors, query_set
from repro.serving.tenancy import TenantManager as RefTenantManager
from repro.serving.tenancy import \
    estimate_arena_bytes as ref_estimate_arena_bytes
from repro.store import IndexStore as RefStore
from repro_torch import convert
from repro_torch.core import metrics as M
from repro_torch.core.api import (Brokers, BuildPara, Coordinator, Executor,
                                  GraphConstructor, QueryPara)
from repro_torch.core.client import gather, gather_arrays
from repro_torch.core.updates import remove_items
from repro_torch.launch import serve
from repro_torch.launch.build_index import load_index
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.tenancy import (AdmissionError, TenantManager,
                                         estimate_arena_bytes)
from repro_torch.store import Compactor, IndexStore

WAIT = 60.0
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
BUILD = dict(meta_size=48, num_shards=4, sample_size=1000, max_degree=12,
             ef_construction=40)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _twin(ref):
    """The port's index of a reference index, on the CPU."""
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    quant = getattr(ref, "_quant_params", None)
    return convert.index_from_arrays(
        dataclasses.asdict(ref.config), arrays(ref.meta), ref.part_of_center,
        [arrays(g) for g in ref.subs],
        quant=None if quant is None else quant.to_manifest(),
        build_stats=copy.deepcopy(ref.build_stats), device="cpu")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(x, store path, reference index): the reference constructor's
    published store."""
    path = str(tmp_path_factory.mktemp("idx"))
    x = clustered_vectors(1000, 12, 16, seed=0)
    ref = RefGraphConstructor(x, "l2", path).build_graphs(
        RefBuildPara(**BUILD))
    return x, path, ref


# ---------------------------------------------------------------------------
# the paper's API (tests/test_api.py)
# ---------------------------------------------------------------------------


def test_coordinator_execute(built):
    x, path, _ = built
    with Brokers(device="cpu") as brokers:
        coord = Coordinator(brokers, path, "demo", "l2")
        assert coord.index.device == torch.device("cpu")
        q = query_set(x, 1, seed=1)[0]
        res = coord.execute(q, QueryPara(k=5, branching_factor=2))
        assert res.ids.shape[0] == 5
        true_ids, _ = M.brute_force_topk(q[None], x, 5, "l2")
        assert len(set(res.ids.tolist()) & set(true_ids[0].tolist())) >= 3


def test_coordinator_batch_matches_reference(built):
    """Listing 1 over the reference's published store: the port's
    ``Coordinator`` returns the reference ``Coordinator``'s ids."""
    x, path, _ = built
    q = query_set(x, 32, seed=4)
    with Brokers(device="cpu") as brokers:
        res = Coordinator(brokers, path, "cmp", "l2").execute_batch(
            q, QueryPara(k=10))
    ref_brokers = RefBrokers()
    try:
        ref_res = RefCoordinator(ref_brokers, path, "cmp", "l2"
                                 ).execute_batch(q, RefQueryPara(k=10))
    finally:
        ref_brokers.shutdown()
    np.testing.assert_array_equal(np.stack([r.ids for r in res]),
                                  np.stack([r.ids for r in ref_res]))
    np.testing.assert_allclose(np.stack([r.scores for r in res]),
                               np.stack([r.scores for r in ref_res]),
                               **SCORE_TOL)


def test_coordinator_execute_async_callback(built):
    x, path, _ = built
    with Brokers(device="cpu") as brokers:
        coord = Coordinator(brokers, path, "demo2", "l2")
        q = query_set(x, 1, seed=2)[0]
        done = threading.Event()
        out = {}

        def cb(res):
            out["res"] = res
            done.set()

        coord.execute_async(q, QueryPara(k=5), cb)
        assert done.wait(timeout=WAIT)
        assert out["res"].ids.shape[0] == 5


def test_executor_elastic_scaling(built):
    """Sec. IV-B: executors can be added to a replica group at runtime."""
    x, path, _ = built
    with Brokers(device="cpu") as brokers:
        coord = Coordinator(brokers, path, "demo3", "l2")
        eng = brokers.engine_for("demo3", coord.index)
        before = len(eng.executors)
        ex = Executor(brokers, path, "demo3", "l2", shard_id=0)
        ex.start()
        assert len(eng.executors) == before + 1
        res = coord.execute_batch(query_set(x, 8, seed=3), QueryPara(k=5))
        assert len(res) == 8
        ex.stop()
        assert eng.replica_count(0) == 1


def test_graph_constructor_refresh(tmp_path):
    """The port's constructor builds (on the CPU) and publishes; a
    refresh hot-swaps the running engine onto the rebuilt index."""
    x = clustered_vectors(400, 12, 8, seed=5)
    para = BuildPara(meta_size=24, num_shards=2, sample_size=400,
                     max_degree=12, ef_construction=40)
    path = str(tmp_path)
    gc = GraphConstructor(x, "l2", path, device="cpu")
    gc.build_graphs(para)
    with Brokers(device="cpu") as brokers:
        coord = Coordinator(brokers, path, "demo4", "l2")
        res = coord.execute(x[0], QueryPara(k=3))
        assert res.ids.shape[0] == 3
        old = brokers.get_engine("demo4")
        x2 = x + 100.0
        gc.refresh(x2, para, brokers=brokers, name="demo4")
        assert brokers.get_engine("demo4") is not old
        coord2 = Coordinator(brokers, path, "demo4", "l2")
        res2 = coord2.execute(x2[0], QueryPara(k=3))
        true_ids, _ = M.brute_force_topk(x2[0][None], x2, 3, "l2")
        assert len(set(res2.ids.tolist()) & set(true_ids[0].tolist())) >= 2
        # the first coordinator resolves through the brokers: it follows
        res1 = coord.execute(x2[0], QueryPara(k=3))
        np.testing.assert_array_equal(res1.ids, res2.ids)


def test_open_client_follows_replace_index_onto_a_store_path(built,
                                                             tmp_path):
    """A client from ``open_client`` answers from the new engine after
    ``replace_index(name, store path)``: the ids of the same store served
    by ``ServingEngine.from_store``."""
    x, path, ref = built
    updated = copy.deepcopy(ref)
    new_root = str(tmp_path / "v2")
    RefStore(new_root).publish(updated)
    # 16 rows beside one shard's rows: the insert rebuilds few shards
    extra = (x[np.sort(ref.subs[0].ids)[:16]] + 0.05).astype(np.float32)
    ref_add(updated, extra)           # journaled into the new store
    q = np.concatenate([extra, query_set(x, 16, seed=6)])
    with Brokers(device="cpu") as brokers:
        client = brokers.open_client("svc", path, metric="l2")
        before, _ = gather_arrays(client.search_batch(q, k=5), 5, WAIT)
        assert not np.isin(before, np.arange(1000, 1016)).any()
        brokers.replace_index("svc", new_root)
        after, _ = gather_arrays(client.search_batch(q, k=5), 5, WAIT)
    eng = ServingEngine.from_store(new_root, device="cpu")
    try:
        want, _ = gather_arrays(eng.submit(q, k=5), 5, WAIT)
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(after, want)
    assert np.isin(after[:16, 0], np.arange(1000, 1016)).mean() >= 0.75


def test_replace_index_without_engine_is_a_no_op(built):
    _, path, ref = built
    with Brokers(device="cpu") as brokers:
        assert brokers.replace_index("nobody", path) is None
        assert brokers.replace_index("nobody", _twin(ref)) is None
        with pytest.raises(KeyError, match="no engine named"):
            brokers.get_engine("nobody")


def test_mismatched_attach_raises_and_close_engine(built):
    x, path, ref = built
    other = _twin(ref)
    other.config = dataclasses.replace(other.config, ef_search=7)
    with Brokers(device="cpu") as brokers:
        client = brokers.open_client("svc", path)
        with pytest.raises(ValueError, match="mismatched index"):
            brokers.engine_for("svc", other)
        assert brokers.close_engine("svc") is True
        assert brokers.close_engine("svc") is False
        with pytest.raises(KeyError):
            client.search(x[0], k=3)


def test_registry_survives_hot_swap():
    """``Brokers.replace_index`` hands the old engine's registry to the
    replacement, so counters keep accumulating across a hot-swap
    (``tests/test_obs_e2e.py``)."""
    x, _, idx = _make()
    registry = MetricsRegistry()
    with Brokers(device="cpu") as brokers:
        brokers.engine_for("svc", idx, replicas=1, registry=registry,
                           tracer=Tracer())
        q = query_set(x, 16, seed=3)
        eng = brokers.get_engine("svc")
        [f.result(timeout=WAIT) for f in eng.submit(q, k=5)]
        before = int(eng._m_submitted.value)
        assert before == 16
        brokers.replace_index("svc", idx)
        eng2 = brokers.get_engine("svc")
        assert eng2 is not eng
        assert eng2.obs is registry
        [f.result(timeout=WAIT) for f in eng2.submit(q, k=5)]
        assert int(eng2._m_submitted.value) == before + 16
        assert eng2.stats()["submitted_queries"] == 32


def test_brokers_need_the_card_unless_asked(monkeypatch, built):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Brokers()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TenantManager(1 << 20)
    with Brokers(device="cpu") as brokers:
        eng = brokers.engine_for("svc", load_index(built[1], device="cpu"))
        comp = brokers.attach_maintenance("svc", built[1])
        assert isinstance(comp, Compactor) and comp.index is eng.index
        assert comp.obs is eng.obs and comp.tracer is eng.tracer
        assert eng.stats()["maintenance"] == comp.stats()


# ---------------------------------------------------------------------------
# tenancy (tests/test_tenancy.py)
# ---------------------------------------------------------------------------

_MADE = {}


def _make(n=500, d=8, seed=0, shards=2):
    """(x, reference index, port index), built once per argument set."""
    key = (n, d, seed, shards)
    if key not in _MADE:
        x = clustered_vectors(n, d, 8, seed=seed)
        cfg = RefConfig(metric="l2", num_shards=shards, meta_size=16,
                        sample_size=min(n, 300), branching_factor=2,
                        max_degree=10, max_degree_upper=5,
                        ef_construction=40, ef_search=50,
                        kmeans_iters=5, seed=seed)
        ref = ref_build(x, cfg)
        _MADE[key] = (x, ref, _twin(ref))
    x, ref, port = _MADE[key]
    return x, copy.deepcopy(ref), copy.deepcopy(port)


def _ids(client, queries, k=10):
    ids, _ = gather_arrays(client.search_batch(queries, k=k), k, WAIT)
    return ids


@pytest.mark.parametrize("quantize", [False, True])
def test_estimate_matches_reference_and_engine(quantize):
    _, ref, idx = _make()
    est = estimate_arena_bytes(idx, quantize=quantize)
    assert est == ref_estimate_arena_bytes(ref, quantize=quantize)
    eng = ServingEngine(idx, quantize=quantize)
    try:
        assert eng.stats()["arena_vector_bytes"] == est
    finally:
        eng.shutdown()


def test_admission_at_exact_budget():
    _, _, idx = _make()
    est = estimate_arena_bytes(idx)
    assert est > 0
    with TenantManager(est, device="cpu") as tm:
        tm.create("a", idx)
        assert tm.stats()["tenants"]["a"]["live"]
        assert tm.used_bytes == est   # estimate == engine's true-up
    with TenantManager(est - 1, device="cpu") as tm:
        with pytest.raises(AdmissionError, match="over the total"):
            tm.create("a", idx)
        assert tm.tenants() == []


def test_budget_must_be_positive():
    with pytest.raises(ValueError, match="budget_bytes"):
        TenantManager(0, device="cpu")


def test_admission_error_when_nothing_evictable():
    _, _, ia = _make(seed=0)
    _, _, ib = _make(seed=1)
    _, _, big = _make(n=900, d=10, seed=0, shards=3)
    est = estimate_arena_bytes(ia)
    assert estimate_arena_bytes(big) > 2 * est
    with TenantManager(2 * est, device="cpu") as tm:
        tm.create("a", ia)
        tm.create("b", ib)
        with pytest.raises(AdmissionError):
            tm.create("big", big)
        assert tm.stats()["used_bytes"] <= 2 * est


def test_evict_repin_roundtrip_identical():
    """One tenant fits at a time: admitting b evicts a, a's client
    re-pins it (evicting b), and a's ids are identical before and after
    and equal to the reference manager's through the same cycle."""
    xa, ref_a, ia = _make(seed=0)
    xb, ref_b, ib = _make(seed=1)
    qa, qb = query_set(xa, 8, seed=2), query_set(xb, 8, seed=3)
    budget = int(max(estimate_arena_bytes(ia),
                     estimate_arena_bytes(ib)) * 1.25)
    with TenantManager(budget, device="cpu") as tm:
        tm.create("a", ia)
        ca = tm.client("a")
        ids0 = _ids(ca, qa)
        tm.create("b", ib)
        st = tm.stats()["tenants"]
        assert st["b"]["live"] and not st["a"]["live"]
        assert tm.stats()["used_bytes"] <= budget
        ids_b = _ids(tm.client("b"), qb)
        ids1 = _ids(ca, qa)
        st = tm.stats()["tenants"]
        assert st["a"]["live"] and not st["b"]["live"]
        np.testing.assert_array_equal(ids0, ids1)
        assert st["a"]["evictions"] == 1
    with RefTenantManager(budget) as rtm:
        rtm.create("a", ref_a)
        rca = rtm.client("a")
        rids0, _ = ref_gather_arrays(rca.search_batch(qa, k=10), 10, WAIT)
        rtm.create("b", ref_b)
        rids_b, _ = ref_gather_arrays(rtm.client("b").search_batch(qb, k=10),
                                      10, WAIT)
        rids1, _ = ref_gather_arrays(rca.search_batch(qa, k=10), 10, WAIT)
        ref_stats = rtm.stats()
    np.testing.assert_array_equal(ids0, rids0)
    np.testing.assert_array_equal(ids1, rids1)
    np.testing.assert_array_equal(ids_b, rids_b)
    assert ref_stats["tenants"]["a"]["evictions"] == 1


def test_explicit_evict_and_lazy_repin(tmp_path):
    x, _, idx = _make()
    q = query_set(x, 4, seed=1)
    with TenantManager(4 * estimate_arena_bytes(idx), device="cpu") as tm:
        tm.create("a", idx)
        ids0 = _ids(tm.client("a"), q)
        arena_rows = weakref.ref(idx.arena().data)
        assert tm.evict("a") is True
        assert not tm.stats()["tenants"]["a"]["live"]
        assert idx._arena == {}            # the device cache is dropped
        assert arena_rows() is None        # and its tensors are freed
        assert tm.evict("a") is False
        ids1 = _ids(tm.client("a"), q)
        np.testing.assert_array_equal(ids0, ids1)
        IndexStore(str(tmp_path)).publish(idx)
        comp = tm.attach_maintenance("a", str(tmp_path))
        assert isinstance(comp, Compactor)
        assert tm.engine("a").stats()["maintenance"] == comp.stats()


def test_remove_items_in_one_tenant_never_affects_other():
    xa, _, ia = _make(seed=0)
    xb, _, ib = _make(seed=1)
    qa, qb = query_set(xa, 8, seed=4), query_set(xb, 8, seed=5)
    with TenantManager(4 * (estimate_arena_bytes(ia)
                            + estimate_arena_bytes(ib)),
                       device="cpu") as tm:
        tm.create("a", ia)
        tm.create("b", ib)
        ids_b0 = _ids(tm.client("b"), qb)
        victims = np.unique(_ids(tm.client("a"), qa)[:, 0])
        remove_items(ia, victims)
        tm.evict("a")
        ids_a = _ids(tm.client("a"), qa)
        assert not np.isin(victims, ids_a).any()
        np.testing.assert_array_equal(_ids(tm.client("b"), qb), ids_b0)
        assert tm.stats()["tenants"]["b"]["evictions"] == 0


def test_arbitrate_splits_replica_budget_by_access_rate():
    xa, _, ia = _make(seed=0)
    _, _, ib = _make(seed=1)
    qa = query_set(xa, 4, seed=6)
    with TenantManager(4 * (estimate_arena_bytes(ia)
                            + estimate_arena_bytes(ib)),
                       device="cpu") as tm:
        tm.create("a", ia)
        tm.create("b", ib)
        tm.attach_autoscaler("a")
        tm.attach_autoscaler("b")
        for _ in range(8):                  # make a the hot tenant
            gather(tm.submit("a", qa, k=5), WAIT)
        alloc = tm.arbitrate(8)
        assert sum(alloc.values()) == 8
        assert alloc["a"] > alloc["b"] >= 1
        st = tm.stats("a")
        assert st["tenancy"]["live"]


@pytest.mark.parametrize("accesses,total", [
    ((9, 1), 8), ((1, 1, 1), 2), ((0, 0, 0, 0), 7), ((5, 3, 2), 11),
    ((100, 1, 1), 5)])
def test_arbitrate_split_matches_reference(accesses, total):
    """The largest-remainder split, floor 1 a tenant, for access counts
    and replica budgets the reference manager is given alike."""
    _, ref, idx = _make()
    ref_tm = RefTenantManager(1 << 30)
    with TenantManager(1 << 30, device="cpu") as tm:
        for i, n in enumerate(accesses):
            tm.create(f"t{i}", idx, activate=False)
            ref_tm.create(f"t{i}", ref, activate=False)
            tm._tenants[f"t{i}"].accesses = n
            ref_tm._tenants[f"t{i}"].accesses = n
        assert tm.arbitrate(total) == ref_tm.arbitrate(total)
    ref_tm.shutdown()


@pytest.mark.faults
def test_two_tenant_storm_exactly_once_per_tenant():
    from repro_torch.serving.faults import FaultSchedule
    xa, _, ia = _make(n=900, d=10, seed=0, shards=3)
    xb, _, ib = _make(n=700, d=10, seed=1, shards=3)
    qa, qb = query_set(xa, 24, seed=7), query_set(xb, 24, seed=8)
    with TenantManager(4 * (estimate_arena_bytes(ia)
                            + estimate_arena_bytes(ib)),
                       device="cpu") as tm:
        tm.create("a", ia, replicas=2, hedge=True,
                  hedge_deadline_s=0.25, executor_batch=4,
                  fault_schedule=FaultSchedule.storm(
                      13, num_shards=3, replicas=2))
        tm.create("b", ib, replicas=2, hedge=True,
                  hedge_deadline_s=0.25, executor_batch=4,
                  fault_schedule=FaultSchedule.storm(
                      14, num_shards=3, replicas=2))
        futs = {"a": tm.client("a").search_batch(qa, k=10),
                "b": tm.client("b").search_batch(qb, k=10)}
        for t, (x, q) in (("a", (xa, qa)), ("b", (xb, qb))):
            results = [f.result(timeout=WAIT) for f in futs[t]]
            qids = [r.query_id for r in results]
            assert qids == [f.query_id for f in futs[t]]
            assert len(set(qids)) == len(qids)
            for r in results:
                assert len(set(r.ids.tolist())) == len(r.ids)
            true_ids, _ = M.brute_force_topk(q, x, 10, "l2")
            hits = sum(
                len(set(r.ids.tolist()) & set(true_ids[i].tolist()))
                for i, r in enumerate(results))
            assert hits / true_ids.size >= 0.8, \
                f"tenant {t} lost recall under the storm"


def test_serve_tenant_runs_on_cpu():
    """``launch.serve --retrieval --tenant t --tenant-budget-mb 64`` admits
    the datastore as a tenant and decodes the tokens of the run without
    a tenant."""
    argv = ["--tokens", "3", "--retrieval", "--device", "cpu"]
    gen = serve.main(argv + ["--tenant", "t", "--tenant-budget-mb", "64"])
    assert gen.shape == (2, 3)
    np.testing.assert_array_equal(gen, serve.main(argv))
