"""The port's online updates and index store against the JAX package's,
on the CPU.

Indexes are built by ``repro`` (``clustered_vectors(700, 12, 8)``, and
``norm_spread_vectors`` with MIPS replication for ip: the sizes of the
reference's ``tests/test_store.py``) and carried into ``repro_torch`` by
``convert.py``; the reference's update tests
(``tests/test_lsh_and_updates.py``) run here on the same 700-row indexes
rather than on their 2,000 rows, since every insert rebuilds shards with
the host builder in both packages, and most inserts here are rows beside
one shard's rows, so that few shards rebuild. Each update twin applies the same ``add_items``,
``set_item_tags`` and ``remove_items`` calls in both packages and holds
every shard's segment checksum (``content_checksum(graph_to_arrays(g))``)
equal, search ids equal and scores to rtol/atol 1e-5. The store tests
mirror ``tests/test_store.py`` and the two store tests of
``tests/test_quant.py`` on the port, and add the cross-package cases: a
store published by one package loads in the other, a delta log written
by one replays in the other to the same graphs, and a reference
``index.pkl`` is refused without importing ``repro``.
"""
import copy
import dataclasses
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.common.config import PyramidConfig as RefConfig
from repro.core.distributed import search_single_host as ref_search
from repro.core.meta_index import build_pyramid_index as ref_build
from repro.core.updates import add_items as ref_add
from repro.core.updates import remove_items as ref_remove
from repro.core.updates import set_item_tags as ref_set_tags
from repro.data.synthetic import (clustered_vectors, norm_spread_vectors,
                                  query_set)
from repro.store import IndexStore as RefStore
from repro.store import content_checksum as ref_checksum
from repro.store import graph_to_arrays as ref_graph_to_arrays
from repro_torch import convert
from repro_torch.core import hnsw as H
from repro_torch.core import metrics as M
from repro_torch.core.client import gather_arrays
from repro_torch.core.distributed import (search_single_host,
                                          search_single_host_python)
from repro_torch.core.updates import add_items, remove_items, set_item_tags
from repro_torch.launch.build_index import load_index, save_index
from repro_torch.serving.engine import ServingEngine
from repro_torch.store import (IndexStore, StoreCorruptionError, StoreError,
                               content_checksum, graph_to_arrays)

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
WAIT = 30.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(metric):
    return dict(metric=metric, num_shards=4, meta_size=32, sample_size=400,
                branching_factor=2, max_degree=10, max_degree_upper=5,
                ef_construction=30, ef_search=40, kmeans_iters=4,
                replication_r=30 if metric == "ip" else 0)


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
def built():
    """(x, queries, reference index, port index) per metric."""
    out = {}
    for metric in ("l2", "angular", "ip"):
        if metric == "ip":
            x = norm_spread_vectors(700, 12, 8, seed=2)
            q = np.random.default_rng(3).normal(
                size=(12, 12)).astype(np.float32)
        else:
            x = clustered_vectors(700, 12, 8, seed=0)
            q = query_set(x, 12, seed=1)
        ref = ref_build(x, RefConfig(**_cfg(metric)))
        out[metric] = (x, q, ref, _twin(ref))
    return out


def _fresh(built, metric="l2"):
    """Private copies of a fixture's indexes, free to mutate."""
    x, q, ref, port = built[metric]
    return x, q, copy.deepcopy(ref), copy.deepcopy(port)


def _checksums(index):
    return [content_checksum(graph_to_arrays(g)) for g in index.subs]


def _ref_checksums(ref):
    return [ref_checksum(ref_graph_to_arrays(g)) for g in ref.subs]


def _assert_same_graphs(ref, port):
    assert _checksums(port) == _ref_checksums(ref)
    assert ref.build_stats.get("max_assigned_id") == \
        port.build_stats.get("max_assigned_id")


def _assert_same_search(ref, port, q, k=5, scores=True, **kw):
    """Equal ids, and (``scores``) scores to rtol/atol 1e-5. A query AT a
    stored row scores about 0 from terms of |x|^2 ~ 10^2, where the two
    packages' float32 sums in another order part by 1 to 2 ulp of those
    terms (up to 1.1e-5): such queries are held to equal ids, and their
    tests hold scores on the fixture's noisy queries."""
    ids_r, sc_r, _ = ref_search(ref, q, k=k, **kw)
    ids_p, sc_p, _ = search_single_host(port, q, k, **kw)
    np.testing.assert_array_equal(ids_p, np.asarray(ids_r))
    if scores:
        np.testing.assert_allclose(sc_p, np.asarray(sc_r), **SCORE_TOL)


def _near(index, shard, m, seed):
    """``m`` new rows beside stored rows of one shard: they route to one
    or two shards, so an insert rebuilds few shards (each rebuild is the
    host builder in both packages)."""
    g = index.subs[shard]
    rng = np.random.default_rng(seed)
    rows = np.asarray(g.data)[rng.choice(g.n, m, replace=False)]
    return (rows + 0.01 * rng.normal(size=rows.shape)).astype(np.float32)


def _stored(index):
    return np.concatenate([g.ids for g in index.subs])


def _emptied(g, d):
    m0 = g.neighbors[0].shape[1]
    return dict(data=np.zeros((0, d), np.float32),
                ids=np.zeros((0,), np.int64),
                neighbors=[np.full((0, m0), -1, np.int32)],
                levels=np.zeros((0,), np.int32), entry=-1, metric="l2")


# ---------------------------------------------------------------------------
# incremental updates (the update half of tests/test_lsh_and_updates.py)
# ---------------------------------------------------------------------------


def test_add_items_searchable(built):
    x, _, ref, idx = _fresh(built)
    rng = np.random.default_rng(5)
    # noisy copies of stored rows of two shards (few shards rebuild)
    rows = np.concatenate([idx.subs[0].ids, idx.subs[2].ids])
    new = (x[rng.choice(rows, 24)] +
           0.02 * rng.normal(size=(24, 12))).astype(np.float32)
    before = idx.build_stats["total_stored"]
    add_items(idx, new)
    ref_add(ref, new)
    assert idx.build_stats["total_stored"] == before + 24
    _assert_same_graphs(ref, idx)
    # querying exactly at the new points must surface their new ids
    ids, _, _ = search_single_host(idx, new[:12], 3)
    new_id_set = set(range(len(x), len(x) + 24))
    found = sum(1 for row in ids if set(row.tolist()) & new_id_set)
    assert found >= 10, found


def test_remove_items_gone(built):
    x, _, ref, idx = _fresh(built)
    victims = np.sort(idx.subs[0].ids)[:20]   # one shard rebuilds
    remove_items(idx, victims)
    ref_remove(ref, victims)
    assert not (set(victims.tolist()) & set(_stored(idx).tolist()))
    _assert_same_graphs(ref, idx)
    ids, _, _ = search_single_host(idx, x[victims][:10], 5)
    assert not (set(ids.reshape(-1).tolist()) & set(victims.tolist()))


def test_add_items_with_empty_shard(built):
    """``add_items`` on an index with a zero-item shard continues after
    the max id of the non-empty shards, as the reference does."""
    from repro.core import hnsw as RH
    x, _, ref, idx = _fresh(built)
    d = x.shape[1]
    idx.subs[1] = H.HNSWGraph(**_emptied(idx.subs[0], d))
    ref.subs[1] = RH.HNSWGraph(**_emptied(ref.subs[0], d))
    idx.invalidate_device_cache()
    ref.invalidate_device_cache()
    start = max(int(g.ids.max()) for g in idx.subs if g.ids.size) + 1
    new = _near(idx, 2, 12, seed=9)
    add_items(idx, new)   # must not raise
    ref_add(ref, new)
    assert set(range(start, start + 12)) <= set(_stored(idx).tolist())
    _assert_same_graphs(ref, idx)


def test_add_items_all_shards_empty_starts_at_zero(built):
    from repro.core import hnsw as RH
    x, _, ref, idx = _fresh(built)
    for s in range(idx.num_shards):
        idx.subs[s] = H.HNSWGraph(**_emptied(idx.subs[0], 12))
        ref.subs[s] = RH.HNSWGraph(**_emptied(ref.subs[0], 12))
    idx.invalidate_device_cache()
    ref.invalidate_device_cache()
    # a fresh index of emptied shards: no high-water mark yet
    idx.build_stats.pop("max_assigned_id", None)
    ref.build_stats.pop("max_assigned_id", None)
    add_items(idx, x[:10])
    ref_add(ref, x[:10])
    assert set(_stored(idx).tolist()) == set(range(10))
    _assert_same_graphs(ref, idx)


def test_add_after_remove_does_not_reuse_freed_ids(built):
    """Ids freed by ``remove_items`` (the largest ids, the current max
    among them) are never handed to new vectors (the high-water mark
    ``max_assigned_id``)."""
    x, _, ref, idx = _fresh(built)
    n = len(x)
    s = next(i for i, g in enumerate(idx.subs) if n - 1 in g.ids)
    victims = np.sort(idx.subs[s].ids)[-10:]
    new = _near(idx, s, 5, seed=12)
    remove_items(idx, victims)
    add_items(idx, new)
    ref_remove(ref, victims)
    ref_add(ref, new)
    assert set(_stored(idx).tolist()) - set(range(n)) == \
        set(range(n, n + 5))
    _assert_same_graphs(ref, idx)


def test_remove_whole_shard_never_resurfaces(built):
    """Deleting every item of a shard leaves it truly empty, and none of
    the three search paths (the arena pipeline, the per-shard loop, the
    serving engine) returns a removed id."""
    x, _, ref, idx = _fresh(built)
    victim_shard = int(np.argmin([g.n for g in idx.subs]))
    victims = idx.subs[victim_shard].ids.copy()
    remove_items(idx, victims)
    ref_remove(ref, victims)
    assert idx.subs[victim_shard].n == 0
    _assert_same_graphs(ref, idx)
    gone = set(victims.tolist())
    q = x[victims[:16]]
    ids_fused, _, _ = search_single_host(idx, q, 10)
    assert not (set(ids_fused.reshape(-1).tolist()) & gone)
    ids_py, _, _ = search_single_host_python(idx, q, 10)
    assert not (set(ids_py.reshape(-1).tolist()) & gone)
    eng = ServingEngine(idx, replicas=1)
    try:
        ids_eng, _ = gather_arrays(eng.submit(q, k=10), 10, timeout=WAIT)
    finally:
        eng.shutdown()
    assert not (set(np.asarray(ids_eng).reshape(-1).tolist()) & gone)
    _assert_same_search(ref, idx, q, k=10, scores=False)


def test_update_then_quality_holds(built):
    x, _, ref, idx = _fresh(built)
    new = clustered_vectors(80, 12, 8, seed=7)
    add_items(idx, new)
    ref_add(ref, new)
    _assert_same_graphs(ref, idx)
    full = np.concatenate([x, new])
    q = query_set(full, 30, seed=8)
    ids, _, _ = search_single_host(idx, q, 10)
    true_ids, _ = M.brute_force_topk(q, full, 10, "l2")
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, true_ids))
    assert hits / true_ids.size > 0.7


@pytest.mark.parametrize("metric", ["l2", "angular", "ip"])
def test_update_sequence_matches_reference(built, metric):
    """The same add (tagged), tag and remove calls in both packages give
    equal segment checksums after every step (the tag column is part of
    a segment), equal search ids (float32, and int8 with rerank factor 4)
    and scores to 1e-5; the tag filter selects exactly the tagged
    items."""
    x, q, ref, idx = _fresh(built, metric)
    idx.quant_params()   # freeze the grid before the updates, as
    ref.quant_params()   # publish does
    new = _near(idx, 1, 16, seed=3)
    tags = np.where(np.arange(16) % 3 == 0, 5, 0).astype(np.int64)
    add_items(idx, new, tags=tags)
    ref_add(ref, new, tags=tags)
    _assert_same_graphs(ref, idx)
    n = len(x)
    tag_ids = np.concatenate([np.arange(n, n + 16, 4),
                              idx.subs[1].ids[:4]])
    set_item_tags(idx, tag_ids, 2)
    ref_set_tags(ref, tag_ids, 2)
    _assert_same_graphs(ref, idx)
    gone = np.concatenate([np.arange(n, n + 16, 8), idx.subs[1].ids[2:8]])
    remove_items(idx, gone)
    ref_remove(ref, gone)
    _assert_same_graphs(ref, idx)
    _assert_same_search(ref, idx, q)
    _assert_same_search(ref, idx, q, quantize=True, rerank_factor=4)
    tagged = set(tag_ids.tolist()) - set(gone.tolist())
    selected = {int(i) for g in idx.subs
                for i, t in zip(g.ids, g.tags_or_zeros()) if t & 2}
    assert selected == tagged
    ids, _, _ = search_single_host(idx, new, 5, filter_tags=2)
    assert set(ids[ids >= 0].tolist()) <= tagged
    assert (ids >= 0).any()


def test_set_item_tags_clears_only_tag_caches(built):
    """Tags never touch the graphs: the arena stays cached, the tag
    caches are dropped, and an engine started after the write sees the
    new tags while one started before keeps its snapshot, as in the
    reference."""
    x, q, _, idx = _fresh(built)
    eng_old = ServingEngine(idx, replicas=1)
    arena = idx.arena()
    try:
        set_item_tags(idx, np.arange(0, 50), 1)
        assert idx.arena() is arena
        eng_new = ServingEngine(idx, replicas=1)
        try:
            new_ids, _ = gather_arrays(
                eng_new.submit(x[:8], k=5, filter_tags=1), 5, timeout=WAIT)
            old_ids, _ = gather_arrays(
                eng_old.submit(x[:8], k=5, filter_tags=1), 5, timeout=WAIT)
        finally:
            eng_new.shutdown()
    finally:
        eng_old.shutdown()
    assert set(new_ids[new_ids >= 0].tolist()) <= set(range(50))
    assert (new_ids >= 0).any()
    assert not (old_ids >= 0).any()   # the old snapshot has no tag 1


# ---------------------------------------------------------------------------
# round-trip parity (tests/test_store.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "angular", "ip"])
def test_publish_load_search_parity(built, metric, tmp_path):
    """A loaded index answers bit-identically to the in-memory one, and
    the port's manifest checksums equal the reference's."""
    x, q, ref, index = built[metric]
    store = IndexStore(str(tmp_path / "port"))
    vid = store.publish(copy.deepcopy(index))
    assert store.latest() == vid
    loaded = store.load(device="cpu")
    assert loaded.config == index.config
    assert loaded.device == torch.device("cpu")
    np.testing.assert_array_equal(loaded.part_of_center,
                                  index.part_of_center)
    ids_a, sc_a, _ = search_single_host(index, q, 5)
    ids_b, sc_b, _ = search_single_host(loaded, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)
    ref_store = RefStore(str(tmp_path / "ref"))
    ref_store.publish(copy.deepcopy(ref))
    mine, theirs = store.reader().manifest, ref_store.reader().manifest
    assert mine["meta"]["checksum"] == theirs["meta"]["checksum"]
    assert [s["checksum"] for s in mine["shards"]] == \
        [s["checksum"] for s in theirs["shards"]]
    assert mine["config"] == theirs["config"]
    assert mine["quant"] == theirs["quant"]


def test_reader_lazy_shard_parity(built, tmp_path):
    _, _, _, index = built["l2"]
    store = IndexStore(str(tmp_path))
    store.publish(copy.deepcopy(index))
    reader = store.reader()
    assert reader.num_shards == index.num_shards
    g = reader.load_shard(2)
    np.testing.assert_array_equal(g.ids, index.subs[2].ids)
    np.testing.assert_array_equal(g.data, index.subs[2].data)
    assert g.entry == index.subs[2].entry
    assert len(g.neighbors) == len(index.subs[2].neighbors)


def test_empty_store_raises(tmp_path):
    with pytest.raises(StoreError, match="no published"):
        IndexStore(str(tmp_path)).load(device="cpu")


# ---------------------------------------------------------------------------
# corruption & atomicity
# ---------------------------------------------------------------------------


def test_corrupted_segment_is_rejected(built, tmp_path):
    _, _, _, index = built["l2"]
    store = IndexStore(str(tmp_path))
    vid = store.publish(copy.deepcopy(index))
    seg = os.path.join(store.version_dir(vid), "shard-0001.npz")
    blob = bytearray(open(seg, "rb").read())
    mid = len(blob) // 2
    blob[mid:mid + 64] = bytes(b ^ 0xFF for b in blob[mid:mid + 64])
    with open(seg, "wb") as f:
        f.write(blob)
    with pytest.raises(StoreCorruptionError):
        store.load(device="cpu")
    reader = store.reader()
    reader.load_shard(0)
    with pytest.raises(StoreCorruptionError):
        reader.load_shard(1)


def test_concurrent_publish_atomicity(built, tmp_path):
    """Two racing publishers both land complete, distinct versions."""
    _, q, _, index = built["l2"]
    store = IndexStore(str(tmp_path))
    barrier = threading.Barrier(2)
    got, errs = [], []

    def publisher():
        try:
            barrier.wait(timeout=WAIT)
            got.append(IndexStore(str(tmp_path)).publish(
                copy.deepcopy(index)))
        except Exception as e:   # pragma: no cover - failure detail
            errs.append(e)

    ts = [threading.Thread(target=publisher) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert not errs
    assert len(set(got)) == 2
    assert sorted(store.versions()) == sorted(got)
    assert store.latest() in got
    loaded = store.load(device="cpu")
    ids_a, _, _ = search_single_host(index, q, 5)
    ids_b, _, _ = search_single_host(loaded, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp-")]


def test_pickle_migration_shim(built, tmp_path):
    """A port-pickled ``index.pkl`` still loads (with a deprecation
    warning; no tensor rides in the pickle), and ``save_index``
    publishes store versions."""
    x, q, ref, index = built["l2"]
    index = copy.deepcopy(index)
    index.arena()   # a cached device arena must not be pickled
    index.quant_params()
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    with open(legacy / "index.pkl", "wb") as f:
        pickle.dump(index, f)
    state = index.__getstate__()
    assert state["device"] == "cpu" and "_arena" not in state
    assert "_quant_params" in state
    with pytest.warns(DeprecationWarning, match="legacy pickle"):
        loaded = load_index(str(legacy), device="cpu")
    ids_a, _, _ = search_single_host(index, q, 5)
    ids_b, _, _ = search_single_host(loaded, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)
    with pytest.warns(DeprecationWarning, match="save_index"):
        save_index(index, str(tmp_path / "migrated"))
    assert IndexStore(str(tmp_path / "migrated")).versions()
    ids_c, _, _ = search_single_host(
        load_index(str(tmp_path / "migrated"), device="cpu"), q, 5)
    np.testing.assert_array_equal(ids_a, ids_c)
    # save/load on the legacy dir returns the fresh publish, never the
    # stale pickle (which is moved aside)
    shifted = ref_build(x + 25.0, RefConfig(**_cfg("l2")))
    with pytest.warns(DeprecationWarning, match="save_index"):
        save_index(_twin(shifted), str(legacy))
    assert not (legacy / "index.pkl").exists()
    reloaded = load_index(str(legacy), device="cpu")
    np.testing.assert_array_equal(reloaded.subs[0].data,
                                  shifted.subs[0].data)


def test_reference_pickle_is_refused_without_importing_it(built, tmp_path):
    """A reference ``index.pkl`` names ``repro.*`` classes: the port's
    ``load_index`` raises ``StoreError`` saying so, and never imports
    ``repro`` (checked in a fresh interpreter)."""
    _, _, ref, _ = built["l2"]
    with open(tmp_path / "index.pkl", "wb") as f:
        pickle.dump(copy.deepcopy(ref), f)
    with pytest.raises(StoreError, match="reference package"):
        load_index(str(tmp_path), device="cpu")
    code = ("import sys, warnings\n"
            "warnings.simplefilter('ignore')\n"
            "from repro_torch.launch.build_index import load_index\n"
            "from repro_torch.store import StoreError\n"
            "try:\n"
            f"    load_index({str(tmp_path)!r}, device='cpu')\n"
            "except StoreError as e:\n"
            "    assert 'reference package' in str(e), e\n"
            "else:\n"
            "    raise SystemExit('loaded')\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "print('refused')\n")
    src = os.path.dirname(os.path.dirname(convert.__file__))
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"


# ---------------------------------------------------------------------------
# delta log
# ---------------------------------------------------------------------------


def test_delta_log_replay_parity(built, tmp_path):
    """Post-publish inserts are journaled and replayed on load — the
    reloaded index is bit-identical to the in-memory one."""
    x, q, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    store.publish(index)
    assert index.delta_log() is not None
    extra = _near(index, 0, 16, seed=9)
    add_items(index, extra)
    extra2 = _near(index, 3, 8, seed=10)
    add_items(index, extra2)
    assert len(index.delta_log()) == 2
    loaded = store.load(device="cpu")
    assert _checksums(loaded) == _checksums(index)
    ids_a, sc_a, _ = search_single_host(index, q, 5)
    ids_b, sc_b, _ = search_single_host(loaded, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)
    assert int(_stored(loaded).max()) == len(x) + 16 + 8 - 1
    assert len(loaded.delta_log()) == 2   # replay does not re-journal


def test_uncommitted_delta_record_is_ignored(built, tmp_path):
    """A record file without its LOG line is not replayed, and the next
    committed append does not collide with its name."""
    _, q, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    vid = store.publish(index)
    delta_dir = os.path.join(store.version_dir(vid), "delta")
    os.makedirs(delta_dir, exist_ok=True)
    np.savez(os.path.join(delta_dir, "d000001.npz"),
             vectors=np.zeros((3, 12), np.float32),
             ids=np.arange(3, dtype=np.int64))   # never committed
    loaded = store.load(device="cpu")
    ids_a, _, _ = search_single_host(index, q, 5)
    ids_b, _, _ = search_single_host(loaded, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)
    add_items(index, _near(index, 1, 8, seed=12))
    assert len(index.delta_log()) == 1
    assert _checksums(store.load(device="cpu")) == _checksums(index)


def test_torn_log_tail_is_healed_on_next_append(built, tmp_path):
    _, q, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    vid = store.publish(index)
    add_items(index, _near(index, 2, 10, seed=13))
    log_path = os.path.join(store.version_dir(vid), "delta", "LOG")
    with open(log_path, "a") as f:
        f.write('{"file": "d9')   # torn fragment, no trailing newline
    index.delta_log()._count = None   # fresh process: no cached count
    add_items(index, _near(index, 2, 6, seed=14))
    assert len(index.delta_log()) == 2
    loaded = store.load(device="cpu")
    ids_a, _, _ = search_single_host(index, q, 5)
    ids_b, _, _ = search_single_host(loaded, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)


def test_delta_replay_parity_float64_angular(built, tmp_path):
    """float64 input on an angular index replays bit-identically (the
    journal stores float32; the apply casts before normalising)."""
    x, _, _, index = _fresh(built, "angular")
    store = IndexStore(str(tmp_path))
    store.publish(index)
    extra = (_near(index, 0, 12, seed=5) + 1e-3 * np.random.default_rng(
        5).normal(size=(12, 12)))   # float64
    add_items(index, extra)
    loaded = store.load(device="cpu")
    q = query_set(x, 10, seed=22)
    ids_a, sc_a, _ = search_single_host(index, q, 5)
    ids_b, sc_b, _ = search_single_host(loaded, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)


def test_newlineless_tail_is_uncommitted_everywhere(built, tmp_path):
    _, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    vid = store.publish(index)
    add_items(index, _near(index, 0, 8, seed=30))
    log_path = os.path.join(store.version_dir(vid), "delta", "LOG")
    with open(log_path, "rb") as f:
        body = f.read()
    with open(log_path, "wb") as f:
        f.write(body.rstrip(b"\n"))   # the crash ate the newline
    assert len(store.reader().delta_log()) == 0
    idx2 = store.load(device="cpu")
    add_items(idx2, _near(idx2, 0, 4, seed=31))
    assert len(idx2.delta_log()) == 1
    again = store.load(device="cpu")
    q = query_set(np.asarray(idx2.subs[0].data), 6, seed=32)
    ids_a, _, _ = search_single_host(idx2, q, 5)
    ids_b, _, _ = search_single_host(again, q, 5)
    np.testing.assert_array_equal(ids_a, ids_b)


def test_append_to_gcd_version_fails_loudly(built, tmp_path):
    _, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    store.publish(index)
    idx2 = store.load(device="cpu")
    store.publish(idx2)
    store.gc(keep=1)
    before = _checksums(index)
    with pytest.raises(StoreError, match="gone"):
        add_items(index, _near(index, 0, 5, seed=33))
    assert _checksums(index) == before   # failed before mutating
    assert len(store.versions()) == 1


# ---------------------------------------------------------------------------
# the store across packages
# ---------------------------------------------------------------------------


def test_reference_store_loads_in_port(built, tmp_path):
    """A store the reference published, with a delta log it journaled
    (insert, tags, remove), loads and replays in the port to the
    reference's live graphs, int8 grid and search ids."""
    x, q, ref, _ = _fresh(built)
    RefStore(str(tmp_path)).publish(ref)
    ref_add(ref, _near(ref, 2, 12, seed=20), tags=np.full(12, 4, np.int64))
    ref_set_tags(ref, ref.subs[3].ids[:20], 4)
    ref_remove(ref, ref.subs[2].ids[:10])
    port = IndexStore(str(tmp_path)).load(device="cpu")
    _assert_same_graphs(ref, port)
    np.testing.assert_array_equal(port.quant_params().scale,
                                  ref.quant_params().scale)
    np.testing.assert_array_equal(port.quant_params().zero,
                                  ref.quant_params().zero)
    _assert_same_search(ref, port, q)
    _assert_same_search(ref, port, q, quantize=True, rerank_factor=4)


def test_port_store_loads_in_reference(built, tmp_path):
    """A store the port published, with a delta log the port journaled,
    loads and replays in the reference to the port's live graphs; the
    reference then journals on into the same log, and the port replays
    the mixed log to the reference's graphs."""
    x, q, _, port = _fresh(built)
    IndexStore(str(tmp_path)).publish(port)
    add_items(port, _near(port, 1, 12, seed=40),
              tags=np.arange(12, dtype=np.int64) % 2)
    set_item_tags(port, port.subs[0].ids[:10], 8)
    remove_items(port, port.subs[1].ids[:6])
    ref = RefStore(str(tmp_path)).load()
    _assert_same_graphs(ref, port)
    _assert_same_search(ref, port, q)
    ref_add(ref, _near(ref, 1, 4, seed=41))
    again = IndexStore(str(tmp_path)).load(device="cpu")
    _assert_same_graphs(ref, again)


# ---------------------------------------------------------------------------
# versioning & GC
# ---------------------------------------------------------------------------


def test_gc_keeps_current_and_newest(built, tmp_path):
    _, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    vids = [store.publish(index) for _ in range(3)]
    assert store.versions() == vids
    removed = store.gc(keep=1)
    assert removed == vids[:2]
    assert store.versions() == [vids[-1]]
    assert store.latest() == vids[-1]
    store.load(device="cpu")
    with pytest.raises(ValueError):
        store.gc(keep=0)


def test_publish_keep_runs_gc(built, tmp_path):
    _, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    for _ in range(3):
        store.publish(index, keep=2)
    assert len(store.versions()) == 2


def test_gc_spares_fresh_tmpdirs(built, tmp_path):
    _, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    store.publish(index)
    fresh = tmp_path / ".tmp-inflight"
    fresh.mkdir()
    stale = tmp_path / ".tmp-crashed"
    stale.mkdir()
    old = time.time() - 2 * IndexStore.ORPHAN_GRACE_S
    os.utime(stale, (old, old))
    store.gc(keep=1)
    assert fresh.exists(), "gc deleted a possibly-live publish tmpdir"
    assert not stale.exists(), "gc left a stale crash orphan"


def test_current_flip_is_newest_wins(built, tmp_path):
    _, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    v1 = store.publish(index)
    v2 = store.publish(index)
    assert store.latest() == v2
    store._set_current(v1)   # the late, stale flip
    assert store.latest() == v2


def test_latest_falls_back_without_current(built, tmp_path):
    _, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path))
    vid = store.publish(index)
    os.remove(os.path.join(str(tmp_path), "CURRENT"))
    assert store.latest() == vid
    store.load(device="cpu")


# ---------------------------------------------------------------------------
# quantized stores (tests/test_quant.py) and engine crash recovery
# ---------------------------------------------------------------------------


def test_store_reopen_parity_for_quantized_manifest(built, tmp_path):
    """Reopen attaches the manifest's grid before replay: the replayed
    int8 arena's codes are bit-identical to the live index's."""
    x, q, _, idx = _fresh(built)
    qp = idx.quant_params()
    store = IndexStore(str(tmp_path))
    store.publish(idx)
    add_items(idx, _near(idx, 3, 16, seed=32))
    loaded = store.load(device="cpu")
    qp2 = loaded.quant_params()
    np.testing.assert_array_equal(qp.scale, qp2.scale)
    np.testing.assert_array_equal(qp.zero, qp2.zero)
    np.testing.assert_array_equal(idx.arena("int8").data.numpy(),
                                  loaded.arena("int8").data.numpy())
    ids_live, s_live, _ = search_single_host(idx, q, 10, quantize=True)
    ids_re, s_re, _ = search_single_host(loaded, q, 10, quantize=True)
    np.testing.assert_array_equal(ids_live, ids_re)
    np.testing.assert_array_equal(s_live, s_re)


def test_from_store_serves_quantized_without_requantizing(built, tmp_path):
    x, q, _, idx = _fresh(built, "angular")
    qp = idx.quant_params()
    IndexStore(str(tmp_path)).publish(idx)
    eng = ServingEngine.from_store(str(tmp_path), replicas=1, quantize=True,
                                   device="cpu")
    try:
        np.testing.assert_array_equal(eng.index.quant_params().scale,
                                      qp.scale)
        ids_eng, _ = gather_arrays(eng.submit(q, k=10), 10, timeout=WAIT)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert st["quantized"] and st["rerank_factor"] == 4
    ids_single, _, _ = search_single_host(idx, q, 10, quantize=True)
    np.testing.assert_array_equal(ids_eng, ids_single)


def _recall(ids, queries, corpus, k=10):
    true_ids, _ = M.brute_force_topk(queries, corpus, k, "l2")
    return sum(len(set(r.tolist()) & set(t.tolist()))
               for r, t in zip(ids, true_ids)) / true_ids.size


@pytest.mark.faults
def test_engine_crash_recovers_from_store(built, tmp_path):
    """Publish -> serve through a scripted kill storm -> crash ->
    ``ServingEngine.from_store`` replays the post-publish delta log and
    answers within 0.02 recall of the pre-crash engine."""
    from repro_torch.serving.faults import FaultEvent, FaultSchedule
    x, _, _, index = _fresh(built)
    store = IndexStore(str(tmp_path / "store"))
    store.publish(index)
    extra = _near(index, 0, 20, seed=7)
    add_items(index, extra)
    corpus = np.concatenate([x, extra])
    q = query_set(corpus, 32, seed=11)
    storm = FaultSchedule([FaultEvent(step=2, action="kill",
                                      target="exec-s*-r0")])
    eng = ServingEngine(index, replicas=2, executor_batch=4,
                        fault_schedule=storm,
                        monitor_opts={"backoff_base_s": 0.02,
                                      "period_s": 0.05})
    try:
        futs = eng.submit(q, k=10)
        pre = [f.result(timeout=WAIT) for f in futs]
        assert [r.query_id for r in pre] == [f.query_id for f in futs]
        assert storm.done()
    finally:
        eng.shutdown()   # the crash: the in-memory index is lost
    del index
    eng2 = ServingEngine.from_store(str(tmp_path / "store"), replicas=1,
                                    device="cpu")
    try:
        post = [f.result(timeout=WAIT) for f in eng2.submit(q, k=10)]
    finally:
        eng2.shutdown()
    recall_pre = _recall([r.ids for r in pre], q, corpus)
    recall_post = _recall([r.ids for r in post], q, corpus)
    assert abs(recall_post - recall_pre) <= 0.02, (recall_pre, recall_post)
    assert any(int(i) >= len(x) for r in post for i in r.ids)
