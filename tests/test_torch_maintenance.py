"""The port's online maintenance against the JAX package's, on the CPU:
k-means++ seeding, ``plan_rebalance``, ``split_shard``, ``merge_shards``,
``refresh_centroids``, the ``Compactor`` and its launcher.

Indexes are built by ``repro`` and carried into ``repro_torch`` with
``convert.index_from_arrays(..., device="cpu")``; segment checksums are
``content_checksum(graph_to_arrays(g))``. ``jax.random`` cannot be
reproduced, so where k-means++ seeds a split or a refresh the reference's
own ``_init_centers(..., method="kmeans++")`` output is recorded and
injected into the port (``init_centers=``): then centres are held to
1e-5 and every checksum must be equal. With the port's own seeding the
result is held to recall within 0.02 of the reference's.

Sizes follow ``tests/test_maintenance.py`` (``_cfg``: max_degree 10,
ef_construction 30) at 300 to 800 rows, with most shards small: every
update rebuilds its shards with the host builder in both packages, about
5 ms a row here. The storm is about 30 records, not 100.
"""
import contextlib
import copy
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.kmeans as RK
from repro.build.planner import merge_shards as ref_merge
from repro.build.planner import plan_rebalance as ref_plan
from repro.build.planner import split_shard as ref_split
from repro.common.config import PyramidConfig as RefConfig
from repro.core import hnsw as RH
from repro.core.distributed import search_single_host as ref_search
from repro.core.meta_index import build_pyramid_index as ref_build
from repro.core.router import refresh_centroids as ref_refresh
from repro.core.updates import add_items as ref_add
from repro.core.updates import remove_items as ref_remove
from repro.store import Compactor as RefCompactor
from repro.store import IndexStore as RefStore
from repro.store import content_checksum as ref_checksum
from repro.store import graph_to_arrays as ref_graph_to_arrays
from repro_torch import convert
from repro_torch.build.planner import (BuildError, merge_shards,
                                       plan_rebalance, split_shard)
from repro_torch.common.config import PyramidConfig
from repro_torch.core import hnsw as H
from repro_torch.core import metrics as M
from repro_torch.core.api import Brokers
from repro_torch.core.client import gather_arrays
from repro_torch.core.distributed import search_single_host
from repro_torch.core.kmeans import kmeans
from repro_torch.core.meta_index import build_pyramid_index
from repro_torch.core.router import refresh_centroids
from repro_torch.core.updates import add_items, remove_items
from repro_torch.data.synthetic import clustered_vectors, query_set
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.store import (Compactor, IndexStore, content_checksum,
                               graph_to_arrays)

CENTRE_TOL = dict(rtol=1e-5, atol=1e-5)
WAIT = 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(num_shards=4, **kw):
    """``tests/test_maintenance.py``'s configuration."""
    base = dict(metric="l2", num_shards=num_shards, meta_size=24,
                sample_size=400, branching_factor=2, max_degree=10,
                max_degree_upper=5, ef_construction=30, ef_search=50,
                kmeans_iters=4)
    base.update(kw)
    return base


def _twin(ref):
    """The port's index of a reference index, on the CPU."""
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    return convert.index_from_arrays(
        dataclasses.asdict(ref.config), arrays(ref.meta), ref.part_of_center,
        [arrays(g) for g in ref.subs],
        build_stats=copy.deepcopy(ref.build_stats), device="cpu")


def _checksums(index):
    return [content_checksum(graph_to_arrays(g)) for g in index.subs]


def _ref_checksums(ref):
    return [ref_checksum(ref_graph_to_arrays(g)) for g in ref.subs]


def _assert_same_index(ref, port):
    assert _checksums(port) == _ref_checksums(ref)
    np.testing.assert_array_equal(port.part_of_center,
                                  np.asarray(ref.part_of_center))
    assert port.config.num_shards == ref.config.num_shards
    assert port.build_stats["sub_sizes"] == ref.build_stats["sub_sizes"]


def _stored_ids(index):
    return np.sort(np.concatenate([g.ids for g in index.subs]))


def _recall(ids, true_ids):
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(np.asarray(ids), true_ids)) / true_ids.size


def _near(index, shard, m, seed, noise=0.01):
    """``m`` new rows beside stored rows of one shard (they route there,
    so an insert rebuilds one shard)."""
    g = index.subs[shard]
    rng = np.random.default_rng(seed)
    rows = np.asarray(g.data)[rng.choice(g.n, m)]
    return (rows + noise * rng.normal(size=rows.shape)).astype(np.float32)


@contextlib.contextmanager
def _recording_ref_inits():
    """Records each starting-centre array the reference's k-means seeds
    with (``repro.core.kmeans._init_centers``)."""
    seen = []
    inner = RK._init_centers

    def rec(x, m, seed, *, method="uniform"):
        c = inner(x, m, seed, method=method)
        seen.append((method, np.asarray(c)))
        return c
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RK, "_init_centers", rec)
        yield seen


# ---------------------------------------------------------------------------
# k-means++ seeding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spherical", (False, True))
def test_kmeanspp_from_reference_centres(spherical):
    x = clustered_vectors(500, 8, 6, seed=2)
    with _recording_ref_inits() as seen:
        r_c, r_n = RK.kmeans(x, 9, iters=6, spherical=spherical, seed=4,
                             init="kmeans++")
    (method, init), = seen
    assert method == "kmeans++"
    t_c, t_n = kmeans(x, 9, iters=6, spherical=spherical, seed=4,
                      init="kmeans++", init_centers=init, device="cpu")
    np.testing.assert_allclose(t_c, np.asarray(r_c), **CENTRE_TOL)
    np.testing.assert_array_equal(t_n, np.asarray(r_n))


def test_kmeanspp_init_flag():
    """``tests/test_distributed_substrate.py::test_kmeanspp_init_flag``'s
    properties on its data, held on the port's own seeding."""
    x = clustered_vectors(1500, 8, 12, seed=5)

    def inertia(centers):
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        return float(d2.min(axis=1).mean())

    c_pp, n_pp = kmeans(x, 12, iters=8, seed=1, init="kmeans++",
                        device="cpu")
    assert c_pp.shape == (12, 8)
    assert len(np.unique(c_pp, axis=0)) == 12
    assert int(n_pp.sum()) == 1500
    c_uni, _ = kmeans(x, 12, iters=8, seed=1, init="uniform", device="cpu")
    assert inertia(c_pp) <= inertia(c_uni) * 1.5

    with pytest.raises(ValueError, match="unknown init"):
        kmeans(x, 4, iters=2, seed=0, init="bogus", device="cpu")


def test_kmeanspp_draws_by_squared_distance():
    """D² seeding never draws a row at distance 0 from a chosen centre
    while another row is left: three distinct points, repeated, give
    three distinct centres for every seed; one point repeated gives that
    point m times (the all-zero fallback)."""
    pts = np.asarray([[0, 0], [5, 0], [0, 7]], np.float32)
    x = np.repeat(pts, [40, 3, 1], axis=0)
    for seed in range(8):
        c, _ = kmeans(x, 3, iters=0, seed=seed, init="kmeans++",
                      device="cpu")
        assert {tuple(r) for r in c.tolist()} == \
            {tuple(r) for r in pts.tolist()}
    c, _ = kmeans(x[:5], 4, iters=0, seed=0, init="kmeans++", device="cpu")
    np.testing.assert_array_equal(c, np.zeros((4, 2), np.float32))
    a, _ = kmeans(x, 3, iters=0, seed=3, init="kmeans++", device="cpu")
    b, _ = kmeans(x, 3, iters=0, seed=3, init="kmeans++", device="cpu")
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# rebalance planning, split and merge (tests/test_maintenance.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def balanced():
    """A 4-shard reference index of 600 rows and its port twin."""
    x = clustered_vectors(600, 10, 8, seed=11)
    ref = ref_build(x, RefConfig(**_cfg()))
    return x, ref


def _fresh(balanced):
    x, ref = balanced
    ref = copy.deepcopy(ref)
    return x, ref, _twin(ref)


def test_plan_rebalance_balanced_is_noop(balanced):
    _, ref, idx = _fresh(balanced)
    assert ref_plan(ref) is None
    assert plan_rebalance(idx) is None


def test_size_skew_split_matches_reference(balanced):
    """A shard piled with inserts splits; with the reference's k-means++
    centres injected, the split gives the reference's routing labels,
    shard count, sizes and graphs."""
    _, ref, idx = _fresh(balanced)
    s = int(np.argmax([g.n for g in idx.subs]))
    new = _near(idx, s, 200, seed=12)
    ref_add(ref, new, log_delta=False)
    add_items(idx, new, log_delta=False)
    sizes = [g.n for g in idx.subs]
    heavy = int(np.argmax(sizes))
    assert sizes[heavy] > 1.5 * (sum(sizes) / len(sizes))
    op = plan_rebalance(idx, split_factor=1.5)
    assert op == ref_plan(ref, split_factor=1.5) == ("split", heavy)

    with _recording_ref_inits() as seen:
        ref_split(ref, heavy)
    (method, init), = seen
    assert method == "kmeans++" and init.shape == (2, 10)
    w = len(idx.subs)
    before = _stored_ids(idx)
    split_shard(idx, heavy, init_centers=init)
    _assert_same_index(ref, idx)
    assert len(idx.subs) == w + 1 and idx.subs[w].n > 0
    assert np.array_equal(_stored_ids(idx), before)
    # routing still lands on every item's shard
    probe = np.concatenate([idx.subs[heavy].data[:10], idx.subs[w].data[:10]])
    want = np.concatenate([idx.subs[heavy].ids[:10], idx.subs[w].ids[:10]])
    ids, _, _ = search_single_host(idx, probe, 4)
    ref_ids, _, _ = ref_search(ref, probe, k=4)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    assert np.mean([a in row for a, row in zip(want, ids)]) >= 0.9


def test_plan_rebalance_latency_skew_splits(balanced):
    _, ref, idx = _fresh(balanced)
    sizes = [g.n for g in idx.subs]
    hot = int(np.argmax(sizes))
    lat = {s: {"n": 100, "p50": 1.0, "p99": 2.0} for s in range(len(sizes))}
    lat[hot] = {"n": 100, "p50": 5.0, "p99": 40.0}
    stats = {"latency": lat}
    assert plan_rebalance(idx, engine_stats=stats, latency_factor=4.0) \
        == ref_plan(ref, engine_stats=stats, latency_factor=4.0) \
        == ("split", hot)
    assert plan_rebalance(idx) is None


def test_merge_small_shards_matches_reference(balanced):
    _, ref, idx = _fresh(balanced)
    sizes = [g.n for g in idx.subs]
    small = np.argsort(sizes)[:2].tolist()
    for s in small:   # shrink the two smallest shards to 4 items each
        victims = idx.subs[s].ids[4:]
        remove_items(idx, victims, log_delta=False)
        ref_remove(ref, victims, log_delta=False)
    a, b = sorted(small)
    assert plan_rebalance(idx, merge_factor=0.25) \
        == ref_plan(ref, merge_factor=0.25) == ("merge", a, b)
    w = len(idx.subs)
    before = set(_stored_ids(idx).tolist())
    merge_shards(idx, a, b)
    ref_merge(ref, a, b)
    _assert_same_index(ref, idx)
    assert len(idx.subs) == w - 1
    assert set(_stored_ids(idx).tolist()) == before
    q = query_set(balanced[0], 8, seed=3)
    ids, sc, _ = search_single_host(idx, q, 5)
    ref_ids, ref_sc, _ = ref_search(ref, q, k=5)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))
    np.testing.assert_allclose(sc, np.asarray(ref_sc), rtol=1e-5, atol=1e-5)


def test_merging_two_empty_shards(balanced):
    """Two emptied shards: both packages plan their merge and build an
    empty graph for it (an index with empty partitions meets this)."""
    x, ref, idx = _fresh(balanced)
    d = x.shape[1]
    for s in (1, 3):
        ref.subs[s] = RH.empty_hnsw(d, metric="l2", max_degree=10)
        idx.subs[s] = H.empty_hnsw(d, metric="l2", max_degree=10)
    ref.invalidate_device_cache()
    idx.invalidate_device_cache()
    assert plan_rebalance(idx) == ref_plan(ref) == ("merge", 1, 3)
    merge_shards(idx, 1, 3)
    ref_merge(ref, 1, 3)
    _assert_same_index(ref, idx)
    assert idx.subs[1].n == 0 and idx.subs[1].entry == -1
    q = query_set(x, 8, seed=5)   # queries routed only there find nothing
    ids, _, _ = search_single_host(idx, q, 5)
    ref_ids, _, _ = ref_search(ref, q, k=5)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))


def test_split_shard_rejects_degenerate(balanced):
    x, _, idx = _fresh(balanced)
    idx.subs[0] = H.empty_hnsw(x.shape[1], metric="l2", max_degree=10)
    idx.invalidate_device_cache()
    with pytest.raises(BuildError, match="cannot split"):
        split_shard(idx, 0)


# ---------------------------------------------------------------------------
# centroid refresh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drifted(balanced):
    """The balanced pair after the same drifted insert, the reference
    refreshed (its k-means++ centres recorded), and the live corpus."""
    x, ref, idx = _fresh(balanced)
    drift = (clustered_vectors(200, 10, 4, seed=14) + 3.0).astype(np.float32)
    ref_add(ref, drift, log_delta=False)
    add_items(idx, drift, log_delta=False)
    port_before = copy.deepcopy(idx)
    with _recording_ref_inits() as seen:
        ref_refresh(ref)
    (method, init), = seen
    assert method == "kmeans++"
    corpus = np.concatenate([x, drift])
    return ref, port_before, init, corpus


def test_refresh_centroids_matches_reference(drifted):
    ref, before, init, _ = drifted
    idx = copy.deepcopy(before)
    refresh_centroids(idx, init_centers=init)
    np.testing.assert_allclose(idx.meta.data, ref.meta.data, **CENTRE_TOL)
    for lp, lr in zip(idx.meta.neighbors, ref.meta.neighbors):
        np.testing.assert_array_equal(lp, lr)
    _assert_same_index(ref, idx)
    assert idx.build_stats["centroid_refreshes"] == 1
    assert idx.build_stats["balance"] == pytest.approx(
        ref.build_stats["balance"])


def test_refresh_centroids_own_seeding_keeps_recall(drifted):
    """The port's own k-means++ draw: recall@10 within 0.02 of the
    reference's refreshed index, and every probed row found at its own
    position (``test_refresh_centroids_preserves_quality``)."""
    ref, before, _, corpus = drifted
    idx = copy.deepcopy(before)
    refresh_centroids(idx)
    assert idx.build_stats["centroid_refreshes"] == 1
    assert np.array_equal(_stored_ids(idx), np.arange(len(corpus)))
    q = query_set(corpus, 40, seed=15)
    true_ids, _ = M.brute_force_topk(q, corpus, 10, "l2")
    ids, _, _ = search_single_host(idx, q, 10)
    ref_ids, _, _ = ref_search(ref, q, k=10)
    assert _recall(ids, true_ids) >= _recall(ref_ids, true_ids) - 0.02
    probe = np.random.default_rng(13).choice(len(corpus), 40, replace=False)
    ids, _, _ = search_single_host(idx, corpus[probe], 4)
    assert np.mean([p in row for p, row in zip(probe, ids)]) >= 0.9


# ---------------------------------------------------------------------------
# the Compactor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """A 4-shard reference index of 300 rows (shards of about 75)."""
    x = clustered_vectors(300, 10, 6, seed=3)
    return x, ref_build(x, RefConfig(**_cfg()))


def _stores(tmp_path, small, name="s"):
    """The reference index published to a reference store and its port
    twin to a port store."""
    _, ref = small
    rs = RefStore(str(tmp_path / f"{name}-ref"))
    rs.publish(copy.deepcopy(ref))
    ps = IndexStore(str(tmp_path / f"{name}-port"))
    ps.publish(_twin(ref))
    return rs, ps


def test_fold_matches_reference_compactor(tmp_path, small):
    """The same add / tags / remove records through each package's
    Compactor, then a cycle that also merges (merge_factor 1.5 merges the
    two smallest shards): the published versions' checksums are equal."""
    x, _ = small
    rs, ps = _stores(tmp_path, small)
    rc = RefCompactor(rs, rs.load(), merge_factor=1.5)
    pc = Compactor(ps, ps.load(device="cpu"), merge_factor=1.5)
    new = _near(pc.index, 0, 6, seed=21)
    for comp in (rc, pc):
        comp.add_items(new, tags=np.full(6, 1 << 3, np.int64))
        comp.set_item_tags(np.arange(300, 303), np.int64(1 << 4))
        comp.remove_items(np.asarray([300, 5]))
    assert len(pc.index.delta_log()) == len(rc.index.delta_log()) == 3
    vid_r = rc.run_once(force=True)
    vid_p = pc.run_once(force=True)
    assert vid_p == vid_r
    assert rc.rebalance_ops == pc.rebalance_ops and pc.rebalance_ops
    assert pc.rebalance_ops[0][0] == "merge"
    assert _checksums(pc.index) == _ref_checksums(rc.index)
    assert ps.reader().manifest["shards"] == rs.reader().manifest["shards"]
    assert len(pc.index.delta_log()) == 0
    loaded = ps.load(device="cpu")
    assert _checksums(loaded) == _ref_checksums(rc.index)
    q = query_set(x, 8, seed=22)
    ids, _, _ = search_single_host(loaded, q, 5)
    ref_ids, _, _ = ref_search(rs.load(), q, k=5)
    np.testing.assert_array_equal(ids, np.asarray(ref_ids))


class SimulatedCrash(RuntimeError):
    pass


def _apply_ops(comp, x):
    """The crash tests' script: two insert records beside shard 0's rows
    and one tombstone record (a built row and an inserted one). Returns
    the surviving id set."""
    n = len(x)
    comp.add_items(_near(comp.index, 0, 3, seed=7))
    comp.add_items(_near(comp.index, 0, 3, seed=8))
    comp.remove_items(np.asarray([int(comp.index.subs[0].ids[0]), n + 1]))
    return comp


@pytest.fixture(scope="module")
def crash_control(small, tmp_path_factory):
    """The fault-free cycle of the crash script: its checksums and ids."""
    x, ref = small
    store = IndexStore(str(tmp_path_factory.mktemp("ctrl")))
    store.publish(_twin(ref))
    ctrl = _apply_ops(Compactor(store, store.load(device="cpu"),
                                rebalance=False), x)
    ctrl.run_once(force=True)
    return _checksums(ctrl.index), _stored_ids(ctrl.index)


@pytest.mark.parametrize("crash_at", Compactor._STEPS)
def test_crash_window_recovers_exactly_once(tmp_path, small, crash_control,
                                            crash_at):
    """Kill the compactor at each commit boundary: before the publish,
    between publish and truncation, between truncation and the CURRENT
    flip, before and mid hot-swap. Recovery from the store lands on the
    fault-free cycle's state, shard by shard: every record applied once,
    no tombstone resurrected."""
    x, ref = small
    want_sums, want_ids = crash_control

    def boom(step):
        if step == crash_at:
            raise SimulatedCrash(step)
    store = IndexStore(str(tmp_path))
    store.publish(_twin(ref))
    comp = _apply_ops(Compactor(store, store.load(device="cpu"),
                                rebalance=False, fault_hook=boom), x)
    with pytest.raises(SimulatedCrash):
        comp.run_once(force=True)
    recovered = IndexStore(str(tmp_path)).load(device="cpu")
    assert _checksums(recovered) == want_sums
    assert np.array_equal(_stored_ids(recovered), want_ids)
    replayed = len(recovered.delta_log())
    assert replayed == (3 if crash_at == "fold" else 0)
    ids, _, _ = search_single_host(recovered, x[:8], 10)
    assert len(ids[ids >= 0]) == 80
    assert np.isin(ids[ids >= 0], want_ids).all()


def test_run_once_below_threshold_is_noop(tmp_path, small):
    x, ref = small
    store = IndexStore(str(tmp_path))
    store.publish(_twin(ref))
    comp = Compactor(store, store.load(device="cpu"), threshold_records=10,
                     rebalance=False)
    comp.set_item_tags(np.arange(3), np.int64(2))   # no rebuild
    assert comp.run_once() is None          # 1 record < threshold 10
    assert comp.cycles == 0
    assert comp.tick() is None
    vid = comp.run_once(force=True)         # force folds regardless
    assert vid is not None and comp.cycles == 1
    assert len(comp.index.delta_log()) == 0
    st = comp.stats()
    assert st["folded_records"] == 1 and st["pending_records"] == 0


def test_compactor_requires_store_attached_index(small):
    _, ref = small
    idx = _twin(ref)

    class FakeStore:
        root = "nowhere"
    comp = Compactor(FakeStore(), idx, rebalance=False)
    with pytest.raises(ValueError, match="store-attached"):
        comp.run_once(force=True)


def test_compactor_counters_match_stats(tmp_path, small):
    """The twin of ``tests/test_obs.py::test_compactor_counters_match_stats``."""
    x, ref = small
    store = IndexStore(str(tmp_path / "store"))
    store.publish(_twin(ref))
    reg, tr = MetricsRegistry(), Tracer()
    comp = Compactor(store, store.load(device="cpu"), rebalance=False,
                     registry=reg, tracer=tr)
    comp.add_items(_near(comp.index, 1, 4, seed=1))
    comp.run_once(force=True)
    stats = comp.stats()
    prom = reg.render_prometheus()
    assert f"pyramid_maintenance_cycles_total {stats['cycles']}" in prom
    assert (f"pyramid_maintenance_folded_records_total "
            f"{stats['folded_records']}") in prom
    assert (f"pyramid_maintenance_truncated_records_total "
            f"{stats['truncated_records']}") in prom
    assert f"pyramid_maintenance_swaps_total {stats['swaps']}" in prom
    assert "pyramid_maintenance_pending_records 0" in prom
    names = {s.name for s in tr.snapshot()}
    assert {"compaction.cycle", "compaction.fold", "compaction.catchup",
            "compaction.commit"} <= names
    cycle = next(s for s in tr.snapshot() if s.name == "compaction.cycle")
    fold = next(s for s in tr.snapshot() if s.name == "compaction.fold")
    assert fold.parent_id == cycle.span_id
    assert cycle.attrs["folded"] == 1


def test_compactor_folds_tags(tmp_path, small):
    """The twin of ``tests/test_filtered.py::test_compactor_folds_tags``."""
    x, ref = small
    store = IndexStore(str(tmp_path / "store"))
    store.publish(_twin(ref))
    comp = Compactor(store, store.load(device="cpu"), rebalance=False)
    comp.add_items(_near(comp.index, 2, 10, seed=1), np.arange(2000, 2010),
                   tags=np.full(10, 1 << 5, np.int64))
    comp.set_item_tags(np.arange(2000, 2005), np.int64(1 << 6))
    assert comp.run_once(force=True) is not None
    loaded = store.load(device="cpu")
    assert len(loaded.delta_log()) == 0
    tags = {}
    for g in loaded.subs:
        for i, gid in enumerate(np.asarray(g.ids)):
            tags[int(gid)] = int(g.tags_or_zeros()[i])
    assert tags[2001] == (1 << 6)    # set_item_tags assigns, not ORs
    assert tags[2007] == (1 << 5)


def test_insert_only_log_stays_byte_identical(tmp_path, small):
    """Insert-only delta logs carry no ``op`` field; a tombstone does."""
    _, ref = small
    store = IndexStore(str(tmp_path))
    store.publish(_twin(ref))
    idx = store.load(device="cpu")
    add_items(idx, _near(idx, 0, 3, seed=6))
    add_items(idx, _near(idx, 0, 2, seed=7))
    log_path = idx.delta_log().dir
    with open(os.path.join(log_path, "LOG")) as f:
        text = f.read()
    assert text.count("\n") == 2
    assert '"op"' not in text
    remove_items(idx, np.asarray([300]))
    with open(os.path.join(log_path, "LOG")) as f:
        lines = f.read().splitlines()
    assert '"op"' not in lines[0] and '"op"' not in lines[1]
    assert '"remove"' in lines[2]


def test_tombstones_survive_restart(tmp_path, small):
    x, ref = small
    store = IndexStore(str(tmp_path))
    store.publish(_twin(ref))
    idx = store.load(device="cpu")
    add_items(idx, _near(idx, 0, 4, seed=9))
    gone = [int(idx.subs[0].ids[0]), int(idx.subs[0].ids[1]), 300, 301]
    remove_items(idx, np.asarray(gone))
    add_items(idx, _near(idx, 0, 2, seed=10))
    recovered = store.load(device="cpu")   # inserts AND tombstones, in order
    assert np.array_equal(_stored_ids(recovered), _stored_ids(idx))
    assert _checksums(recovered) == _checksums(idx)
    assert not (set(_stored_ids(recovered).tolist()) & set(gone))
    ids, _, _ = search_single_host(recovered, x[gone[:2]], 10)
    assert not (set(ids.reshape(-1).tolist()) & set(gone))


def test_storm_through_brokers_attach_maintenance(tmp_path):
    """A short write+query storm through ``Brokers.attach_maintenance``:
    30 records (inserts and tombstones) with a threshold of 10 fold into
    new versions and hot-swap the engine mid-storm; no removed id is ever
    returned, and recall@10 at the end is within 0.02 of a storm-free
    build over the same corpus."""
    rng = np.random.default_rng(0)
    x = clustered_vectors(300, 10, 6, seed=0)
    cfg = PyramidConfig(**_cfg(num_shards=8))   # small shards: cheap rebuilds
    store = IndexStore(str(tmp_path))
    store.publish(build_pyramid_index(x, cfg, device="cpu"))
    live = {i: x[i] for i in range(300)}
    removed, leaks = set(), set()
    next_id = 300
    with Brokers(device="cpu") as brokers:
        brokers.engine_for("storm", store.load(device="cpu"), replicas=1)
        comp = brokers.attach_maintenance(
            "storm", store, threshold_records=10, rebalance=False)
        assert brokers.get_engine("storm").stats()["maintenance"] \
            == comp.stats()
        for step in range(24):               # 24 inserts + 6 removes
            base = x[rng.choice(300, 1)].repeat(2, axis=0)   # one shard
            new = (base + 0.02 * rng.normal(size=base.shape)
                   ).astype(np.float32)
            comp.add_items(new)
            for v in new:
                live[next_id] = v
                next_id += 1
            if step % 4 == 3:
                pool = sorted(set(live) - removed)
                victims = np.asarray(
                    [pool[int(r)] for r in rng.choice(len(pool), 2,
                                                      replace=False)])
                comp.remove_items(victims)
                removed.update(victims.tolist())
                for v in victims.tolist():
                    del live[v]
            futs = None
            if step % 3 == 0:   # submitted before the tick: in-flight
                eng = brokers.get_engine("storm")   # futures cross a swap
                futs = eng.submit(x[rng.choice(300, 4)], k=10)
            comp.tick()
            if futs is not None:
                ids, _ = gather_arrays(futs, 10, WAIT)
                leaks |= set(ids.reshape(-1).tolist()) & removed
        assert not leaks, leaks
        assert comp.cycles >= 2 and comp.swaps == comp.cycles
        comp.run_once(force=True)            # drain the tail
        assert len(comp.index.delta_log()) == 0
        assert comp.folded_records == 30 == comp.truncated_records
        eng = brokers.get_engine("storm")
        assert eng.stats()["maintenance"]["cycles"] == comp.cycles
        live_ids = np.asarray(sorted(live))
        corpus = np.stack([live[i] for i in live_ids.tolist()])
        assert np.array_equal(_stored_ids(comp.index), live_ids)
        q = query_set(corpus, 30, seed=1)
        true_pos, _ = M.brute_force_topk(q, corpus, 10, "l2")
        got, _ = gather_arrays(eng.submit(q, k=10), 10, WAIT)
        assert not (set(got.reshape(-1).tolist()) & removed)
        storm_recall = _recall(got, live_ids[true_pos])
    fresh = build_pyramid_index(corpus, cfg, device="cpu")
    ref_ids, _, _ = search_single_host(fresh, q, 10)
    assert storm_recall >= _recall(ref_ids, true_pos) - 0.02


# ---------------------------------------------------------------------------
# across packages, and the launcher
# ---------------------------------------------------------------------------


def test_compacted_versions_load_across_packages(tmp_path, small):
    """A version the port compacted loads in ``repro``, and one the
    reference compacted loads in the port, with equal checksums."""
    x, ref = small
    rs, ps = _stores(tmp_path, small)
    pc = Compactor(ps, ps.load(device="cpu"), rebalance=False)
    rc = RefCompactor(rs, rs.load(), rebalance=False)
    new = _near(pc.index, 3, 4, seed=31)
    pc.add_items(new)
    rc.add_items(new)
    pc.run_once(force=True)
    rc.run_once(force=True)
    in_ref = RefStore(ps.root).load()
    in_port = IndexStore(rs.root).load(device="cpu")
    assert _ref_checksums(in_ref) == _checksums(pc.index)
    assert _checksums(in_port) == _ref_checksums(rc.index)
    assert _checksums(pc.index) == _ref_checksums(rc.index)


def test_maintain_launcher_runs_on_cpu(tmp_path, small):
    _, ref = small
    store = IndexStore(str(tmp_path))
    store.publish(_twin(ref))
    idx = store.load(device="cpu")
    add_items(idx, _near(idx, 0, 3, seed=41))
    remove_items(idx, np.asarray([300]))
    assert len(idx.delta_log()) == 2
    src = os.path.dirname(os.path.dirname(convert.__file__))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.maintain",
         "--store", str(tmp_path), "--device", "cpu", "--no-rebalance",
         "--gc-keep", "1"],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "compacted 2 delta records into v0000002" in out.stdout
    assert '"folded_records": 2' in out.stdout
    assert store.versions() == ["v0000002"]
    loaded = store.load(device="cpu")
    assert len(loaded.delta_log()) == 0
    assert _checksums(loaded) == _checksums(idx)


def test_reference_centres_are_what_the_reference_seeds_with():
    """The recorder sees the reference's own draw: its k-means from the
    recorded centres reproduces ``kmeans(..., init="kmeans++")``."""
    x = clustered_vectors(200, 6, 4, seed=8)
    with _recording_ref_inits() as seen:
        c1, _ = RK.kmeans(x, 5, iters=3, seed=2, init="kmeans++")
    (_, init), = seen
    c2, _ = RK._kmeans_jit(jnp.asarray(x), jnp.asarray(init), m=5, iters=3,
                           spherical=False)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


def test_maintain_launcher_watch_mode_folds(tmp_path, small):
    """``--watch`` polls the log and folds once it holds ``--threshold``
    records (the reference launcher's watch mode dies on its first log
    line: it rebinds its logger's name to the delta log)."""
    _, ref = small
    store = IndexStore(str(tmp_path))
    store.publish(_twin(ref))
    idx = store.load(device="cpu")
    idx.delta_log().append_tags(np.arange(4), np.full(4, 2, np.int64))
    src = os.path.dirname(os.path.dirname(convert.__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.maintain",
         "--store", str(tmp_path), "--device", "cpu", "--watch",
         "--threshold", "1", "--poll-s", "0.1"],
        env=dict(os.environ, PYTHONPATH=src), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "published" in line or len(lines) > 50:
                break
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert "cycle 1: published v0000002" in lines[-1], lines
    assert store.latest() == "v0000002"
    assert len(store.load(device="cpu").delta_log()) == 0
