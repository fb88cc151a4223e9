"""The port's HNSW (``repro_torch.core.hnsw``) against ``repro.core.hnsw``
on the CPU: the copied numpy builder gives identical graphs from the same
data and seed, and ``hnsw_search`` returns the reference's ids (scores to
rtol 1e-5, atol 1e-5, l2 atol 1e-4) for every metric x storage (float32,
int8) x tag filter (on, off), in both its fused and per-query loop forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as RF
from repro.core import hnsw as RH
from repro.core import metrics as RM
from repro.core.quant import QuantParams as RQ
from repro_torch.core import filters as TF
from repro_torch.core import hnsw as TH
from repro_torch.core.quant import QuantParams as TQ

METRICS = ("l2", "ip", "angular")
N, D, B, K = 300, 12, 20, 10
BUILD = dict(max_degree=8, max_degree_upper=4, ef_construction=32, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tol(metric):
    return dict(rtol=1e-5, atol=1e-4 if metric == "l2" else 1e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    tags = np.where(rng.random(N) < 0.3, 1, 2).astype(np.int64)
    tags[::7] |= 1 << 40
    filters = np.resize(np.array([1, 1 << 40, 0, 3], np.int64), B)
    return x, q, tags, filters


@pytest.fixture(scope="module")
def graphs(data):
    x, _, tags, _ = data
    out = {}
    for metric in METRICS:
        xm = RM.preprocess_dataset(x, metric)
        out[metric] = (RH.build_hnsw(xm, metric=metric, tags=tags, **BUILD),
                       TH.build_hnsw(xm, metric=metric, tags=tags, **BUILD))
    return out


@pytest.mark.parametrize("metric", METRICS)
def test_builder_gives_identical_graph(graphs, metric):
    ref, port = graphs[metric]
    assert port.entry == ref.entry
    np.testing.assert_array_equal(port.levels, ref.levels)
    assert len(port.neighbors) == len(ref.neighbors)
    for a, b in zip(ref.neighbors, port.neighbors):
        np.testing.assert_array_equal(a, b)


def _hard_data(kind: str) -> np.ndarray:
    """Data whose float32 similarities the selection's float64 bounds
    cannot all decide: small integers (exact ties and duplicate rows), or
    a tight cloud far from the origin (bounds wider than the gaps)."""
    rng = np.random.default_rng(11)
    if kind == "ties":
        return rng.integers(-2, 3, size=(200, 8)).astype(np.float32)
    return (1000.0 + 0.01 * rng.normal(size=(200, 24))).astype(np.float32)


@pytest.mark.parametrize("kind", ("ties", "far"))
@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_builder_gives_identical_graph_where_bounds_cannot_decide(kind,
                                                                  metric):
    """The neighbour selection decides from float64 bounds where it can
    and asks the float32 similarities elsewhere: the reference's graph,
    also where many comparisons fall within the bounds."""
    x = _hard_data(kind)
    ref = RH.build_hnsw(x, metric=metric, **BUILD)
    port = TH.build_hnsw(x, metric=metric, **BUILD)
    assert port.entry == ref.entry
    np.testing.assert_array_equal(port.levels, ref.levels)
    for a, b in zip(ref.neighbors, port.neighbors, strict=True):
        np.testing.assert_array_equal(a, b)


def _ref_arrays(g, quantized):
    arrs = g.device_arrays()
    if not quantized:
        return arrs
    p = RQ.from_data(g.data)
    return RH.QuantHNSWArrays(
        data=jnp.asarray(p.quantize(g.data)), ids=arrs.ids,
        bottom=arrs.bottom, upper=arrs.upper, entry=arrs.entry,
        num_upper_levels=arrs.num_upper_levels, scale=jnp.asarray(p.scale),
        zero=jnp.asarray(p.zero))


def _port_arrays(g, quantized):
    if not quantized:
        return g.device_arrays("cpu")
    return g.quant_arrays(TQ.from_data(g.data), "cpu")


@pytest.mark.parametrize("filtered", (False, True), ids=("all", "filtered"))
@pytest.mark.parametrize("quantized", (False, True), ids=("f32", "int8"))
@pytest.mark.parametrize("metric", METRICS)
def test_hnsw_search_matches_reference(data, graphs, metric, quantized,
                                       filtered):
    _, q, tags, filters = data
    ref_g, port_g = graphs[metric]
    qm = RM.preprocess_queries(q, metric)
    kw_r, kw_t = {}, {}
    if filtered:
        tw, fw = TF.split_tag_words(tags), TF.filter_words(filters)
        np.testing.assert_array_equal(tw, RF.split_tag_words(tags))
        kw_r = dict(tag_words=jnp.asarray(tw), filter_words=jnp.asarray(fw))
        kw_t = dict(tag_words=torch.as_tensor(tw),
                    filter_words=torch.as_tensor(fw))
    r_ids, r_s = RH.hnsw_search(_ref_arrays(ref_g, quantized),
                                jnp.asarray(qm), metric=metric, k=K, ef=40,
                                **kw_r)
    port = _port_arrays(port_g, quantized)
    t_ids, t_s = TH.hnsw_search(port, torch.as_tensor(qm), metric=metric,
                                k=K, ef=40, **kw_t)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(r_s), **_tol(metric))
    l_ids, l_s = TH.hnsw_search(port, torch.as_tensor(qm), metric=metric,
                                k=K, ef=40, impl="loop", **kw_t)
    np.testing.assert_array_equal(l_ids.numpy(), t_ids.numpy())
    np.testing.assert_allclose(l_s.numpy(), t_s.numpy(), **_tol(metric))
    if filtered:
        live = t_ids.numpy()
        for row, f in zip(live, filters):
            assert np.all(RF.alive_np(tags[row[row >= 0]], f))


@pytest.mark.parametrize("metric", METRICS)
def test_greedy_descent_matches_reference(data, graphs, metric):
    _, q, _, _ = data
    ref_g, port_g = graphs[metric]
    qm = RM.preprocess_queries(q, metric)
    ga = ref_g.device_arrays()
    r_e = jax.vmap(lambda v: RH._greedy_descend(ga, v, metric, 64))(
        jnp.asarray(qm))
    t_e = TH._descend_one_graph(port_g.device_arrays("cpu"),
                                torch.as_tensor(qm), metric, 64)
    np.testing.assert_array_equal(t_e.numpy(), np.asarray(r_e))


def test_search_numpy_matches_reference(data, graphs):
    _, q, tags, filters = data
    ref_g, port_g = graphs["l2"]
    for f in (None, filters):
        r = RH.search_numpy(ref_g, q, K, ef=40, filter_tags=f)
        t = TH.search_numpy(port_g, q, K, ef=40, filter_tags=f)
        np.testing.assert_array_equal(t[0], r[0])
        np.testing.assert_array_equal(t[1], r[1])


def test_graph_smaller_than_k_pads():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    g = TH.build_hnsw(x, metric="l2", **BUILD).device_arrays("cpu")
    ids, scores = TH.hnsw_search(g, torch.as_tensor(x[:3]), metric="l2",
                                 k=9, ef=4)
    assert ids.shape == (3, 9)
    assert (ids[:, 6:] == -1).all() and torch.isinf(scores[:, 6:]).all()
    np.testing.assert_array_equal(ids[:, 0].numpy(), [0, 1, 2])
    empty = TH.empty_hnsw(4)
    assert empty.n == 0 and empty.entry == -1
