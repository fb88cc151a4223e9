"""The port's LSH baseline (``repro_torch.core.lsh``) against the JAX
package's (``repro.core.lsh``), on the CPU.

The tables are numpy with the reference's seeds, so projections, offsets
and every bucket must be identical. Search ids must be equal and scores
within 1e-5 on the data of ``tests/test_lsh_and_updates.py``'s two LSH
tests, whose two properties (recall above 0.5; recall growing with the
tables) are held here on the port. The reference's exact rerank runs
through its plain top-k (``use_kernel=False``, the JAX reference of the
Pallas scan): in interpret mode the scan recompiles for every candidate
count, one per query.
"""
import functools

import numpy as np
import pytest

from repro.core import lsh as RL
from repro.kernels.topk_distance import ops as ref_topk_ops
from repro_torch.core import metrics as M
from repro_torch.core.lsh import build_lsh, search_lsh
from repro_torch.data.synthetic import clustered_vectors, query_set

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def ref_plain_rerank(monkeypatch):
    monkeypatch.setattr(RL, "topk_similarity", functools.partial(
        ref_topk_ops.topk_similarity, use_kernel=False))


def _recall(ids, true_ids):
    hits = sum(len(set(a[a >= 0].tolist()) & set(b.tolist()))
               for a, b in zip(ids, true_ids))
    return hits / true_ids.size


@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
def test_tables_equal_reference(metric):
    x = clustered_vectors(600, 12, 8, seed=0)
    kw = dict(metric=metric, num_shards=3, num_tables=4, num_bits=6,
              width=2.5, seed=3)
    ref, port = RL.build_lsh(x, **kw), build_lsh(x, **kw)
    assert (port.metric, port.num_bits, port.num_tables) == \
        (ref.metric, ref.num_bits, ref.num_tables)
    assert len(port.shards) == len(ref.shards)
    for sp, sr in zip(port.shards, ref.shards):
        np.testing.assert_array_equal(sp.ids, sr.ids)
        np.testing.assert_array_equal(sp.data, sr.data)
        for tp, tr in zip(sp.tables, sr.tables):
            np.testing.assert_array_equal(tp.projections, tr.projections)
            np.testing.assert_array_equal(tp.offsets, tr.offsets)
            assert tp.width == tr.width
            assert tp.buckets.keys() == tr.buckets.keys()
            for key in tr.buckets:
                np.testing.assert_array_equal(tp.buckets[key],
                                              tr.buckets[key])


@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
def test_search_matches_reference(metric, ref_plain_rerank):
    """The data of ``test_lsh_finds_near_neighbours``, 40 queries, each
    metric; a cap of 64 candidates cuts some queries' candidate lists."""
    x = clustered_vectors(4000, 16, 24, seed=0)
    q = query_set(x, 40, seed=1)
    kw = dict(metric=metric, num_shards=4, num_tables=12, num_bits=8,
              width=3.0)
    ref, port = RL.build_lsh(x, **kw), build_lsh(x, **kw)
    for cap in (2048, 64):
        ids_r, sc_r = RL.search_lsh(ref, q, k=10, max_candidates=cap)
        ids_p, sc_p = search_lsh(port, q, k=10, max_candidates=cap,
                                 device="cpu")
        np.testing.assert_array_equal(ids_p, ids_r)
        np.testing.assert_allclose(sc_p, np.asarray(sc_r), **SCORE_TOL)


def test_search_pads_queries_without_candidates(ref_plain_rerank):
    """Far-off queries hash into no bucket (l2, narrow width): -1 / -inf
    rows, as in the reference; a query with fewer than k candidates is
    padded after them."""
    x = clustered_vectors(300, 8, 4, seed=2)
    kw = dict(metric="l2", num_shards=2, num_tables=2, num_bits=10,
              width=0.5)
    ref, port = RL.build_lsh(x, **kw), build_lsh(x, **kw)
    q = np.concatenate([x[:3], x[:2] + 100.0]).astype(np.float32)
    ids_r, sc_r = RL.search_lsh(ref, q, k=10)
    ids_p, sc_p = search_lsh(port, q, k=10, device="cpu")
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_allclose(sc_p, np.asarray(sc_r), **SCORE_TOL)
    assert (ids_p[3:] == -1).all() and np.isneginf(sc_p[3:]).all()
    assert (ids_p[:3, 0] == np.arange(3)).all()


def test_lsh_finds_near_neighbours():
    x = clustered_vectors(4000, 16, 24, seed=0)
    q = query_set(x, 40, seed=1)
    idx = build_lsh(x, metric="l2", num_shards=4, num_tables=12,
                    num_bits=8, width=3.0)
    ids, scores = search_lsh(idx, q, k=10, device="cpu")
    true_ids, _ = M.brute_force_topk(q, x, 10, "l2")
    recall = _recall(ids, true_ids)
    assert recall > 0.5, recall  # LSH is the weaker baseline, by design
    for r_ids, r_s in zip(ids, scores):   # sorted among valid entries
        v = r_s[r_ids >= 0]
        assert (np.diff(v) <= 1e-5).all()


def test_lsh_recall_grows_with_tables():
    x = clustered_vectors(3000, 16, 24, seed=2)
    q = query_set(x, 30, seed=3)
    true_ids, _ = M.brute_force_topk(q, x, 10, "l2")

    def rec(num_tables):
        idx = build_lsh(x, metric="l2", num_shards=4,
                        num_tables=num_tables, num_bits=8, width=3.0)
        ids, _ = search_lsh(idx, q, k=10, device="cpu")
        return _recall(ids, true_ids)

    assert rec(12) > rec(2)


def test_search_needs_the_card_unless_asked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = clustered_vectors(100, 4, 2, seed=0)
    idx = build_lsh(x, num_shards=2, num_tables=2, num_bits=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_lsh(idx, x[:2], k=3)
