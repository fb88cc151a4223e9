"""The port's slice as a whole against the JAX package: an index built by
``repro`` is carried into ``repro_torch`` by ``convert.py`` and both
answer the same queries through ``search_single_host`` (ids equal, scores
to rtol/atol 1e-5), over naive and routed search, int8 storage with
rerank factors 1 and 4, and tag filters at selectivity 0, 0.05 and 1;
at ip (with MIPS replication, ``replication_r``) and angular, float32 and
int8, unfiltered and with a scalar filter, a filter mixed per query and a
filter of selectivity 0; the port's ``shard_search``, which neither
descends nor walks empty queue slots, returns the reference's ``(qidx,
ids, scores)``, whose walk covers every slot; and a build by each package
on the same data reaches recall@10 within 0.02 of the other's.

Everything runs on the CPU at a small size (n=600, d=16): the port's
kernels take their plain PyTorch versions there.
"""
import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import PyramidConfig as RefConfig
from repro.core import arena as RA
from repro.core import distributed as RD
from repro.core import metrics as RM
from repro.core.meta_index import build_pyramid_index as ref_build
from repro_torch import convert
from repro_torch.build import build_pyramid_index_parallel, build_subgraphs
from repro_torch.build import plan_build
from repro_torch.common.config import PyramidConfig
from repro_torch.core import arena as TA
from repro_torch.core import distributed as TD
from repro_torch.core.meta_index import build_pyramid_index

N, D, K = 600, 16, 10
CFG = dict(metric="l2", num_shards=4, meta_size=40, sample_size=400,
           branching_factor=2, max_degree=8, max_degree_upper=4,
           ef_construction=32, ef_search=32, kmeans_iters=6, seed=0)
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)   # l2: cancellation in 2q.x-|q|^2-|x|^2
# the other metrics' indexes: ip with MIPS replication, and angular
METRIC_CFGS = {"ip": dict(metric="ip", replication_r=20),
               "angular": dict(metric="angular")}
# filters: none; bit 0 (5% of the items); mixed per query (bit 0, bit 1 on
# every item, and bit 40 on none); bit 40 (selectivity 0)
FILTERS = {"none": None, "scalar": 1, "mixed": (1, 2, 1 << 40),
           "zero": 1 << 40}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, D))
    x = centers[rng.integers(0, 12, size=N)] + 0.3 * rng.normal(size=(N, D))
    q = x[rng.integers(0, N, size=24)] + 0.05 * rng.normal(size=(24, D))
    # tag bit 0 on 5% of the items, bit 1 on all of them, bit 40 on none
    tags = np.full(N, 2, np.int64)
    tags[rng.choice(N, size=N // 20, replace=False)] |= 1
    return x.astype(np.float32), q.astype(np.float32), tags


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def ref_index(data):
    x, _, tags = data
    index = ref_build(x, RefConfig(**CFG))
    for g in index.subs:   # tags ride the sub-graphs, aligned with ids
        g.tags = tags[np.asarray(g.ids)]
    return index


def _graph_arrays(g):
    return {f: getattr(g, f) for f in convert.GRAPH_FIELDS}


def _carry(ref_index):
    return convert.index_from_arrays(
        dataclasses.asdict(ref_index.config), _graph_arrays(ref_index.meta),
        ref_index.part_of_center,
        [_graph_arrays(g) for g in ref_index.subs],
        quant=ref_index.quant_params().to_manifest(), device="cpu")


@pytest.fixture(scope="module")
def port_index(ref_index):
    return _carry(ref_index)


@pytest.fixture(scope="module", params=tuple(METRIC_CFGS))
def metric_indexes(request, data):
    """(metric, reference index, port index) at ip and at angular."""
    x, _, tags = data
    ref = ref_build(x, RefConfig(**{**CFG, **METRIC_CFGS[request.param]}))
    for g in ref.subs:
        g.tags = tags[np.asarray(g.ids)]
    return request.param, ref, _carry(ref)


def _assert_same(ref_out, port_out, tol=SCORE_TOL):
    r_ids, r_s, r_mask = ref_out
    t_ids, t_s, t_mask = port_out
    np.testing.assert_array_equal(np.asarray(r_mask), t_mask)
    np.testing.assert_array_equal(np.asarray(r_ids), t_ids)
    np.testing.assert_allclose(np.asarray(r_s), t_s, **tol)


def _filter_of(name, b):
    f = FILTERS[name]
    return np.resize(np.asarray(f, np.int64), b) if isinstance(f, tuple) \
        else f


def test_convert_carries_the_index(ref_index, port_index):
    assert port_index.device == torch.device("cpu")
    assert port_index.num_shards == ref_index.num_shards
    for a, b in zip(ref_index.subs, port_index.subs):
        np.testing.assert_array_equal(a.ids, b.ids)
        for la, lb in zip(a.neighbors, b.neighbors):
            np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ref_index.quant_params().scale,
                                  port_index.quant_params().scale)


@pytest.mark.parametrize("naive", (False, True), ids=("routed", "naive"))
def test_search_single_host_matches_reference(data, ref_index, port_index,
                                              naive):
    _, q, _ = data
    _assert_same(RD.search_single_host(ref_index, q, K, naive=naive),
                 TD.search_single_host(port_index, q, K, naive=naive))


@pytest.mark.parametrize("rerank_factor", (1, 4))
def test_quantized_search_matches_reference(data, ref_index, port_index,
                                            rerank_factor):
    _, q, _ = data
    kw = dict(quantize=True, rerank_factor=rerank_factor)
    _assert_same(RD.search_single_host(ref_index, q, K, **kw),
                 TD.search_single_host(port_index, q, K, **kw))


@pytest.mark.parametrize("filter_tags,selectivity",
                         ((1 << 40, 0.0), (1, 0.05), (2, 1.0)))
def test_filtered_search_matches_reference(data, ref_index, port_index,
                                           filter_tags, selectivity):
    _, q, tags = data
    assert np.mean((tags & filter_tags) != 0) == selectivity
    ref_out = RD.search_single_host(ref_index, q, K, filter_tags=filter_tags)
    port_out = TD.search_single_host(port_index, q, K,
                                     filter_tags=filter_tags)
    _assert_same(ref_out, port_out)
    live = port_out[0][port_out[0] >= 0]
    assert np.all((tags[live] & filter_tags) != 0)


@pytest.mark.parametrize("filt", tuple(FILTERS))
@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_other_metrics_match_reference(data, metric_indexes, mode, filt):
    """ip (replicated MIPS index) and angular: ids equal, scores to
    rtol = atol = 1e-5, float32 and int8 (rerank factor 4), under every
    kind of filter."""
    _, q, tags = data
    metric, ref, port = metric_indexes
    if metric == "ip":
        assert ref.build_stats["replicated_items"] > 0
    kw = dict(quantize=True, rerank_factor=4) if mode == "int8" else {}
    f = _filter_of(filt, len(q))
    ref_out = RD.search_single_host(ref, q, K, filter_tags=f, **kw)
    port_out = TD.search_single_host(port, q, K, filter_tags=f, **kw)
    _assert_same(ref_out, port_out, dict(rtol=1e-5, atol=1e-5))
    if f is not None:
        live = port_out[0] >= 0
        rows = np.broadcast_to(np.asarray(f), (len(q),))
        hits = tags[np.where(live, port_out[0], 0)] & rows[:, None]
        assert np.all(hits[live] != 0)


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_shard_search_skips_empty_slots(data, ref_index, port_index, mode):
    """A capacity of the whole batch, twice the mean shard load, leaves
    half the queue slots empty: the port neither descends nor walks them
    (entry -1) and returns what the reference returns from its walk over
    every slot."""
    _, q, _ = data
    mask = TD._route(port_index, q, False, 2, "l2")
    capacity = len(q)
    kw = dict(metric="l2", k=K, ef=32, capacity=capacity)
    r_qidx, r_ids, r_s = RA.shard_search(
        ref_index.arena(mode), jnp.asarray(mask), jnp.asarray(q), **kw)
    t_qidx, t_ids, t_s = TA.shard_search(
        port_index.arena(mode), torch.as_tensor(mask), torch.as_tensor(q),
        **kw)
    np.testing.assert_array_equal(np.asarray(r_qidx), t_qidx.numpy())
    np.testing.assert_array_equal(np.asarray(r_ids), t_ids.numpy())
    np.testing.assert_allclose(np.asarray(r_s), t_s.numpy(), **SCORE_TOL)
    empty = t_qidx.numpy() >= len(q)
    assert empty.mean() >= 0.4
    assert (t_ids.numpy()[empty] == -1).all()


def test_python_oracle_agrees_with_fused_path(data, port_index):
    _, q, _ = data
    ids, scores, _ = TD.search_single_host(port_index, q, K)
    o_ids, o_scores, _ = TD.search_single_host_python(port_index, q, K)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(scores, o_scores, **SCORE_TOL)


def _recall(ids, truth):
    return np.mean([len(set(a) & set(b)) / len(b)
                    for a, b in zip(ids.tolist(), truth.tolist())])


def test_whole_build_recall_within_two_percent(data, ref_index):
    x, q, _ = data
    index = build_pyramid_index(x, PyramidConfig(**CFG), device="cpu")
    assert index.device == torch.device("cpu")
    assert index.build_stats["total_stored"] == N
    truth, _ = RM.brute_force_topk(q, x, K, "l2")
    port_recall = _recall(TD.search_single_host(index, q, K)[0], truth)
    ref_recall = _recall(np.asarray(RD.search_single_host(
        ref_index, q, K)[0]), truth)
    assert port_recall >= 0.9
    assert abs(port_recall - ref_recall) <= 0.02, (port_recall, ref_recall)


def test_pool_fan_out_equals_sequential(data):
    x, _, _ = data
    cfg = PyramidConfig(**{**CFG, "num_shards": 3})
    plan = plan_build(x[:240], cfg, device="cpu")
    seq, seq_stats = build_subgraphs(plan, workers=0)
    par, par_stats = build_subgraphs(
        plan, workers=2,
        pool_factory=lambda: concurrent.futures.ThreadPoolExecutor(2))
    assert (seq_stats["build_mode"], par_stats["build_mode"]) == (
        "sequential", "parallel")
    for a, b in zip(seq, par):
        for la, lb in zip(a.neighbors, b.neighbors):
            np.testing.assert_array_equal(la, lb)


def test_pool_takes_the_largest_shards_first(data):
    x, _, _ = data
    cfg = PyramidConfig(**{**CFG, "num_shards": 3})
    plan = plan_build(x[:240], cfg, device="cpu")
    submitted = []

    class Recording(concurrent.futures.ThreadPoolExecutor):
        def submit(self, fn, task, *args, **kwargs):
            submitted.append(task.shard)
            return super().submit(fn, task, *args, **kwargs)

    build_subgraphs(plan, workers=2, pool_factory=lambda: Recording(2))
    sizes = [len(plan.sub_ids[i]) for i in submitted]
    assert sorted(submitted) == list(range(3))
    assert sizes == sorted(sizes, reverse=True)


def test_mips_build_replicates_and_dedups(data):
    x, q, _ = data
    cfg = PyramidConfig(**{**CFG, "metric": "ip", "replication_r": 20})
    index = build_pyramid_index_parallel(x, cfg, device="cpu", workers=0)
    assert index.build_stats["replicated_items"] > 0
    ids, _, _ = TD.search_single_host(index, q, K)
    for row in ids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
