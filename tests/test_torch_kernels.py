"""The port's kernel modules against the JAX package, on the CPU.

For each module that holds a Hopper kernel (``beam_search``,
``merge_topk``, ``topk_distance``, ``quant_distance``,
``decode_attention``, ``ssd``) the
same numpy inputs go through the
reference (its jnp oracle, its numpy twin, or its Pallas kernel in
interpret mode) and through the port's dispatch, which on CPU tensors
takes the plain PyTorch version. Ids must be equal; scores agree to
rtol/atol 1e-5 (l2 to atol 1e-4, for the cancellation in
``2q.x - |q|^2 - |x|^2``); k-means centres to 1e-4 from the same start;
decode attention to 1e-5 against the jnp oracle and to 2e-4 against the
Pallas kernel in interpret mode (its online softmax sums in another
order, the tolerance of the reference's own kernel test); the SSD scan to
1e-4 against the jnp oracle and to 2e-3 against the Pallas kernel in
interpret mode (the tolerance of ``tests/test_kernel_ssd.py``).
Float inputs are drawn from a normal distribution so that no two scores
tie; integer-grid cases, whose ties are exact, are held against the
numpy twin, which breaks ties as the port does (-0.0 == +0.0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as RK
from repro.core import metrics as RM
from repro.core.quant import QuantParams
from repro.kernels.decode_attention.kernel import flash_decode_pallas
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as ref_decode_attention
from repro.kernels.beam_search import beam_search_np as ref_beam_np
from repro.kernels.beam_search import beam_search_ref as ref_beam
from repro.kernels.beam_search.ops import _apply_filter as ref_apply_filter
from repro.kernels.merge_topk import merge_topk_np as ref_merge_np
from repro.kernels.merge_topk import merge_topk_ref as ref_merge
from repro.kernels.quant_distance import quant_scores as ref_quant_dispatch
from repro.kernels.quant_distance import quant_scores_np as ref_quant_np
from repro.kernels.quant_distance import quant_scores_ref as ref_quant
from repro.kernels.quant_distance.kernel import quant_distance_pallas
from repro.kernels.ssd.kernel import ssd_pallas
from repro.kernels.ssd.ref import ssd_ref as ref_ssd
from repro.kernels.topk_distance import topk_similarity_ref as ref_topk
from repro.kernels.topk_distance.kernel import topk_similarity_pallas
from repro_torch.core import kmeans as TK
from repro_torch.core import metrics as TM
from repro_torch.kernels import launch_counts
from repro_torch.kernels.beam_search import beam_search, beam_search_cuda
from repro_torch.kernels.beam_search import beam_search_np
from repro_torch.kernels.beam_search import ref as TB
from repro_torch.kernels.beam_search.ops import _apply_filter
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  flash_decode,
                                                  flash_decode_cuda)
from repro_torch.kernels.merge_topk import merge_topk, merge_topk_cuda
from repro_torch.kernels.merge_topk import merge_topk_np
from repro_torch.kernels.quant_distance import (quant_impl, quant_scores,
                                                quant_scores_cuda,
                                                quant_scores_np,
                                                quant_scores_ref)
from repro_torch.kernels.ssd import ssd_cuda, ssd_ref, ssd_scan
from repro_torch.kernels.topk_distance import (topk_similarity,
                                               topk_similarity_cuda)

METRICS = ("l2", "ip", "angular")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tol(metric):
    return dict(rtol=1e-5, atol=1e-4 if metric == "l2" else 1e-5)


def _float_case(s, n, d, c, m0, seed, quantized=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, n, d)).astype(np.float32)
    bottom = rng.integers(-1, n, size=(s, n, m0)).astype(np.int32)
    queries = rng.normal(size=(s, c, d)).astype(np.float32)
    entries = rng.integers(0, n, size=(s, c)).astype(np.int32)
    scale = zero = None
    if quantized:
        params = QuantParams.from_data(x.reshape(s * n, d))
        x = np.stack([params.quantize(x[i]) for i in range(s)])
        scale, zero = params.scale, params.zero
    return x, bottom, queries, entries, scale, zero


def _grid_case(s, n, d, c, m0, seed):
    """Integer-grid vectors (exact in f32) over -1-padded adjacency, the
    reference tests' adversarial case generator."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, size=(s, n, d)).astype(np.float32)
    bottom = rng.integers(-1, n, size=(s, n, m0)).astype(np.int32)
    queries = rng.integers(-8, 9, size=(s, c, d)).astype(np.float32)
    entries = rng.integers(0, n, size=(s, c)).astype(np.int32)
    return x, bottom, queries, entries, None, None


def _port_walk(x, bottom, queries, entries, scale, zero, **kw):
    t = torch.as_tensor
    s, i = beam_search(t(x), t(bottom), t(queries), t(entries),
                       scale=None if scale is None else t(scale),
                       zero=None if zero is None else t(zero), **kw)
    return s.numpy(), i.numpy()


def _against_np_twin(case, **kw):
    """Port walk == reference numpy twin == port numpy twin."""
    s_p, i_p = _port_walk(*case, **kw)
    x, b, q, e, sc, zr = case
    s_n, i_n = ref_beam_np(x, b, q, e, scale=sc, zero=zr, **kw)
    s_t, i_t = beam_search_np(x, b, q, e, scale=sc, zero=zr, **kw)
    np.testing.assert_array_equal(i_p, i_n)
    np.testing.assert_array_equal(i_t, i_n)
    np.testing.assert_allclose(s_p, s_n, **_tol(kw["metric"]))
    np.testing.assert_array_equal(s_t, s_n)
    return s_p, i_p


@pytest.mark.parametrize("quantized", (False, True), ids=("f32", "int8"))
@pytest.mark.parametrize("metric", METRICS)
def test_beam_walk_matches_reference(metric, quantized):
    case = _float_case(2, 60, 8, 5, 6, seed=7, quantized=quantized)
    kw = dict(metric=metric, ef=12, max_iters=400)
    s_p, i_p = _against_np_twin(case, **kw)
    x, b, q, e, sc, zr = case
    j = jnp.asarray
    sz = {} if sc is None else dict(scale=j(sc), zero=j(zr))
    s_r, i_r = ref_beam(j(x), j(b), j(q), j(e), **kw, **sz)
    np.testing.assert_array_equal(i_p, np.asarray(i_r))
    np.testing.assert_allclose(s_p, np.asarray(s_r), **_tol(metric))
    assert s_p.shape == (2, 5, 12) and i_p.dtype == np.int32


@pytest.mark.parametrize("c", (1, 5))
def test_beam_walk_work_counts(c):
    """``return_work`` leaves the walk as it is and counts what a bound
    needs: with one slot a graph's distinct data rows are its scored rows
    and its distinct adjacency rows its expansions; with more slots the
    union lies between the largest slot's count and the sum of them.
    Adjacency rows hold no node twice, so no row is scored twice."""
    case = _float_case(2, 60, 8, c, 6, seed=11)
    rng = np.random.default_rng(12)
    bottom = np.stack([np.stack([rng.permutation(60)[:6] for _ in range(60)])
                       for _ in range(2)]).astype(np.int32)
    bottom[rng.random(bottom.shape) < 0.2] = -1
    t = [torch.as_tensor(a) for a in (case[0], bottom, *case[2:4])]
    kw = dict(metric="l2", ef=12, max_iters=400)
    s_w, i_w, expansions, scored, rows, adj = TB.beam_search_ref(
        *t, return_work=True, **kw)
    s_p, i_p = TB.beam_search_ref(*t, **kw)
    assert torch.equal(i_w, i_p) and torch.equal(s_w, s_p)
    assert rows.shape == adj.shape == (2,)
    if c == 1:
        assert torch.equal(rows, scored[:, 0])
        assert torch.equal(adj, expansions[:, 0])
    for got, per_slot in ((rows, scored), (adj, expansions)):
        assert torch.all(got >= per_slot.max(dim=1).values)
        assert torch.all(got <= torch.clamp(per_slot.sum(dim=1), max=60))
    assert torch.all(adj <= rows)


def test_duplicate_neighbour_slots_stay_in_parity():
    """A node listed twice in one adjacency row passes the visited test
    twice (the test precedes the mark)."""
    n, m0 = 6, 4
    bottom = np.full((1, n, m0), -1, np.int32)
    for i in range(n):
        bottom[0, i] = [(i + 1) % n, (i + 1) % n, (i + 2) % n, -1]
    x = np.arange(n, dtype=np.float32)[None, :, None] * np.ones(
        (1, n, 3), np.float32)
    queries = np.full((1, 2, 3), 2.0, np.float32)
    entries = np.array([[0, 3]], np.int32)
    _, i_p = _against_np_twin((x, bottom, queries, entries, None, None),
                              metric="l2", ef=4, max_iters=400)
    assert any(len(set(r[r >= 0])) < (r >= 0).sum() for r in i_p[0])


def test_revisit_ring_and_isolated_entry():
    n, m0 = 6, 3
    bottom = np.full((1, n, m0), -1, np.int32)
    for i in range(n):
        bottom[0, i] = [(i + 1) % n, (i + 2) % n, -1]
    x = np.arange(n, dtype=np.float32)[None, :, None] * np.ones(
        (1, n, 3), np.float32)
    queries = np.full((1, 2, 3), 2.0, np.float32)
    entries = np.array([[0, 3]], np.int32)
    _, i_p = _against_np_twin((x, bottom, queries, entries, None, None),
                              metric="l2", ef=4, max_iters=400)
    for row in i_p.reshape(-1, 4):
        assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()
    lone = (np.ones((1, 5, 2), np.float32), np.full((1, 5, 3), -1, np.int32),
            np.full((1, 3, 2), 0.5, np.float32),
            np.array([[4, 0, 2]], np.int32), None, None)
    s_p, i_p = _against_np_twin(lone, metric="ip", ef=4, max_iters=400)
    np.testing.assert_array_equal(i_p[0, :, 0], [4, 0, 2])
    assert (i_p[0, :, 1:] == -1).all() and np.isneginf(s_p[0, :, 1:]).all()


@pytest.mark.parametrize("max_iters,ef", ((0, 6), (1, 6), (3, 6), (400, 64)))
def test_iteration_bound_and_ef_clamp(max_iters, ef):
    case = _grid_case(2, 30, 5, 4, 4, seed=23)
    s_p, _ = _against_np_twin(case, metric="l2", ef=ef, max_iters=max_iters)
    assert s_p.shape[-1] == min(ef, 30)


def test_exact_ties_break_like_the_numpy_twin():
    n = 8
    x = np.ones((1, n, 4), np.float32)          # all rows identical
    bottom = np.random.default_rng(5).integers(
        -1, n, size=(1, n, 3)).astype(np.int32)
    case = (x, bottom, np.ones((1, 4, 4), np.float32),
            np.array([[0, 3, 5, 7]], np.int32), None, None)
    _against_np_twin(case, metric="l2", ef=5, max_iters=400)


def test_pinned_signed_zero_case_matches_numpy_twin():
    """Hypothesis case (2, 19, 1, 1, 3, 1, 1, 'ip') of the reference's
    three-way property test: every score of shard 0 is +-0, where
    ``lax.top_k`` ranks +0.0 above -0.0. The port follows the numpy twin
    and the Pallas kernel (-0.0 == +0.0, lowest position wins)."""
    case = _grid_case(2, 19, 1, 1, 3, seed=1)
    _against_np_twin(case, metric="ip", ef=1, max_iters=400)


def test_filter_mask_matches_reference():
    rng = np.random.default_rng(3)
    s, n, c, e = 2, 30, 4, 7
    scores = rng.normal(size=(s, c, e)).astype(np.float32)
    nodes = rng.integers(-1, n, size=(s, c, e)).astype(np.int32)
    scores[nodes < 0] = -np.inf
    tag_words = rng.integers(-2 ** 31, 2 ** 31, size=(s, n, 2)).astype(
        np.int32) & np.int32(0x0F0F)
    fw = np.array([[[1, 0], [0, 0], [0, 256], [3, 3]]] * s, np.int32)
    r_s, r_i = ref_apply_filter(jnp.asarray(scores), jnp.asarray(nodes),
                                jnp.asarray(tag_words), jnp.asarray(fw))
    t_s, t_i = _apply_filter(torch.as_tensor(scores), torch.as_tensor(nodes),
                             torch.as_tensor(tag_words), torch.as_tensor(fw))
    np.testing.assert_array_equal(np.asarray(r_i), t_i.numpy())
    np.testing.assert_array_equal(np.asarray(r_s), t_s.numpy())


@pytest.mark.parametrize("b,m,k,alive", ((6, 40, 10, False),
                                         (5, 24, 8, True),
                                         (4, 6, 9, False)))
def test_merge_topk_matches_reference(b, m, k, alive):
    rng = np.random.default_rng(m)
    scores = rng.normal(size=(b, m)).astype(np.float32)
    ids = rng.integers(-1, m // 3, size=(b, m)).astype(np.int32)
    scores[ids < 0] = -np.inf
    mask = rng.random(size=(b, m)) > 0.3 if alive else None
    t_s, t_i = merge_topk(torch.as_tensor(scores), torch.as_tensor(ids), k=k,
                          alive=None if mask is None else torch.as_tensor(mask))
    n_s, n_i = ref_merge_np(scores, ids, k=k, alive=mask)
    np.testing.assert_array_equal(t_i.numpy(), n_i)
    np.testing.assert_array_equal(t_s.numpy(), n_s)
    p_s, p_i = merge_topk_np(scores, ids, k=k, alive=mask)
    np.testing.assert_array_equal(p_i, n_i)
    if k <= m:
        r_s, r_i = ref_merge(jnp.asarray(scores), jnp.asarray(ids), k=k,
                             alive=None if mask is None else jnp.asarray(mask))
        np.testing.assert_array_equal(t_i.numpy(), np.asarray(r_i))
        np.testing.assert_allclose(t_s.numpy(), np.asarray(r_s), rtol=1e-5,
                                   atol=1e-5)
    real = t_i.numpy()
    for row in real:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


@pytest.mark.parametrize("metric,k", (("l2", 1), ("ip", 5), ("angular", 4),
                                      ("l2", 16)))
def test_topk_similarity_matches_reference(metric, k):
    rng = np.random.default_rng(k)
    q = rng.normal(size=(20, 12)).astype(np.float32)
    x = rng.normal(size=(200, 12)).astype(np.float32)
    t_s, t_i = topk_similarity(torch.as_tensor(q), torch.as_tensor(x), k=k,
                               metric=metric)
    r_s, r_i = ref_topk(jnp.asarray(q), jnp.asarray(x), k=k, metric=metric)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(r_s), **_tol(metric))
    if metric != "angular":   # the Pallas kernel places the eps elsewhere
        p_s, p_i = topk_similarity_pallas(
            jnp.asarray(q), jnp.asarray(x), k=k, metric=metric, block_n=64,
            interpret=True)
        np.testing.assert_array_equal(t_i.numpy(), np.asarray(p_i))
        np.testing.assert_allclose(t_s.numpy(), np.asarray(p_s),
                                   **_tol(metric))


@pytest.mark.parametrize("spherical", (False, True))
def test_kmeans_matches_reference_from_same_start(spherical):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(8, 6))[rng.integers(0, 8, size=300)]
         + 0.2 * rng.normal(size=(300, 6))).astype(np.float32)
    init = x[rng.choice(300, size=10, replace=False)]
    xs = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12) \
        if spherical else x
    i0 = init / (np.linalg.norm(init, axis=1, keepdims=True) + 1e-12) \
        if spherical else init
    r_c, r_n = RK._kmeans_jit(jnp.asarray(xs), jnp.asarray(i0), m=10,
                              iters=5, spherical=spherical)
    t_c, t_n = TK.kmeans(x, 10, iters=5, spherical=spherical,
                         init_centers=init, device="cpu")
    np.testing.assert_allclose(t_c, np.asarray(r_c), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_n, np.asarray(r_n))


def test_kmeans_draws_distinct_starting_rows():
    x = np.random.default_rng(2).normal(size=(50, 4)).astype(np.float32)
    c, n = TK.kmeans(x, 7, iters=0, seed=3, device="cpu")
    assert len({tuple(r) for r in c.tolist()}) == 7
    assert all(any(np.array_equal(r, y) for y in x) for r in c)
    c2, _ = TK.kmeans(x, 60, iters=0, seed=3, device="cpu")
    assert c2.shape == (60, 4)


@pytest.mark.parametrize("metric", METRICS)
def test_similarity_and_quant_scores_match_reference(metric):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(5, 9)).astype(np.float32)
    x = rng.normal(size=(30, 9)).astype(np.float32)
    np.testing.assert_allclose(
        TM.similarity_matrix(torch.as_tensor(q), torch.as_tensor(x),
                             metric).numpy(),
        np.asarray(RM.similarity_matrix(jnp.asarray(q), jnp.asarray(x),
                                        metric)), **_tol(metric))
    np.testing.assert_array_equal(TM.similarity_matrix_np(q, x, metric),
                                  RM.similarity_matrix_np(q, x, metric))
    p = QuantParams.from_data(x)
    codes = p.quantize(x)
    np.testing.assert_allclose(
        quant_scores(torch.as_tensor(q), torch.as_tensor(codes),
                     torch.as_tensor(p.scale), torch.as_tensor(p.zero),
                     metric=metric).numpy(),
        np.asarray(ref_quant(jnp.asarray(q), jnp.asarray(codes),
                             jnp.asarray(p.scale), jnp.asarray(p.zero),
                             metric=metric)),
        **_tol(metric))


def _quant_case(b, n, d, seed):
    """The reference kernel test's inputs (tests/test_kernel_quant_distance
    .py): per-dimension scales of 0.5 to 3 on the rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * \
        rng.uniform(0.5, 3.0, size=(1, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    params = QuantParams.from_data(x)
    return q, params.quantize(x), params


# the reference kernel test's shapes, with 37 x 53 (not a multiple of any
# block) and B = 1
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,n,d", [(5, 24, 8), (130, 70, 16), (1, 8, 4),
                                   (37, 53, 8)])
def test_quant_scores_match_reference(metric, b, n, d):
    """The port's dispatch (its plain version on the CPU) against the
    reference's dispatch, its Pallas kernel in interpret mode and its
    numpy twin, to the family's rtol/atol 1e-5."""
    q, codes, params = _quant_case(b, n, d, seed=b * n + d)
    t = [torch.as_tensor(a) for a in (q, codes, params.scale, params.zero)]
    got = quant_scores(*t, metric=metric).numpy()
    assert got.shape == (b, n) and got.dtype == np.float32
    j = [jnp.asarray(a) for a in (q, codes, params.scale, params.zero)]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(ref_quant_dispatch(*j, metric=metric)), **tol)
    np.testing.assert_allclose(got, np.asarray(quant_distance_pallas(
        *j, metric=metric, block_q=16, block_n=16, interpret=True)), **tol)
    np.testing.assert_allclose(
        got, ref_quant_np(q, codes, params.scale, params.zero,
                          metric=metric), **tol)
    np.testing.assert_array_equal(
        quant_scores_np(q, codes, params.scale, params.zero, metric=metric),
        ref_quant_np(q, codes, params.scale, params.zero, metric=metric))
    np.testing.assert_array_equal(
        got, quant_scores_ref(*t, metric=metric).numpy())


def test_wrappers_take_only_cuda_tensors():
    """On CPU tensors the dispatch runs the plain versions and no kernel
    is counted; the kernel wrappers themselves refuse CPU tensors."""
    before = launch_counts()
    case = _float_case(1, 10, 4, 2, 3, seed=0)
    t = [torch.as_tensor(a) for a in case[:4]]
    beam_search(*t, metric="l2", ef=4, max_iters=10)
    merge_topk(torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32), k=2)
    topk_similarity(torch.zeros(2, 4), torch.zeros(5, 4), k=1)
    kv = torch.zeros(2, 8, 2, 16)
    pos = torch.zeros(2, dtype=torch.int32)
    flash_decode(torch.zeros(2, 4, 16), kv, kv, pos)
    ssd_in = (torch.zeros(1, 5, 2, 4), torch.ones(1, 5, 2), -torch.ones(2),
              torch.zeros(1, 5, 8), torch.zeros(1, 5, 8))
    ssd_scan(*ssd_in, chunk=4)
    quant_scores(torch.zeros(2, 4), torch.zeros(3, 4, dtype=torch.int8),
                 torch.ones(4), torch.zeros(4), metric="l2")
    assert quant_impl("cpu") == "torch-plain"
    assert quant_impl("cuda") == "cuda-kernel"
    assert launch_counts() == before
    with pytest.raises(ValueError):
        beam_search_cuda(*t, metric="l2", ef=4, max_iters=10)
    with pytest.raises(ValueError):
        merge_topk_cuda(torch.zeros(2, 4),
                        torch.zeros(2, 4, dtype=torch.int32), k=2)
    with pytest.raises(ValueError):
        topk_similarity_cuda(torch.zeros(2, 4), torch.zeros(5, 4), k=1)
    with pytest.raises(ValueError):
        flash_decode_cuda(torch.zeros(2, 4, 16), kv, kv, pos)
    with pytest.raises(ValueError):
        ssd_cuda(*ssd_in, chunk=4)
    with pytest.raises(ValueError):
        quant_scores_cuda(torch.zeros(2, 4),
                          torch.zeros(3, 4, dtype=torch.int8),
                          torch.ones(4), torch.zeros(4), metric="l2")


def _decode_case(b, s, h, kvh, hd, pos_mode, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    if pos_mode == "full":
        pos = np.full(b, s - 1, np.int32)
    elif pos_mode == "start":
        pos = np.zeros(b, np.int32)
    else:
        pos = rng.integers(0, s, size=b).astype(np.int32)
    return q, k, v, pos


# the reference kernel test's shapes (B, S, H, KV, hd), G = 2, 2, 1, 3,
# and two with S not a multiple of the Pallas block
@pytest.mark.parametrize("shape", [
    (2, 128, 8, 4, 32), (1, 300, 16, 8, 64), (3, 64, 4, 4, 16),
    (2, 96, 6, 2, 32), (2, 130, 8, 4, 32), (1, 70, 4, 2, 16)])
@pytest.mark.parametrize("pos_mode", ["full", "start", "random"])
def test_decode_attention_matches_reference(shape, pos_mode):
    case = _decode_case(*shape, pos_mode, seed=sum(shape) + len(pos_mode))
    ours = decode_attention_ref(*(torch.as_tensor(a) for a in case))
    assert ours.dtype == torch.float32
    jcase = [jnp.asarray(a) for a in case]
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(ref_decode_attention(*jcase)),
        rtol=1e-5, atol=1e-5)
    pallas = flash_decode_pallas(*jcase, block_s=64, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas),
                               rtol=2e-4, atol=2e-4)
    # the dispatch takes the plain version on CPU tensors
    torch.testing.assert_close(
        flash_decode(*(torch.as_tensor(a) for a in case)), ours,
        rtol=0, atol=0)


def test_decode_attention_reads_bf16_caches_in_float32():
    q, k, v, pos = _decode_case(2, 200, 8, 4, 32, "random", seed=5)
    kb = torch.as_tensor(k).to(torch.bfloat16)
    vb = torch.as_tensor(v).to(torch.bfloat16)
    ours = decode_attention_ref(torch.as_tensor(q), kb, vb,
                                torch.as_tensor(pos))
    ref = ref_decode_attention(jnp.asarray(q), jnp.asarray(kb.float()),
                               jnp.asarray(vb.float()), jnp.asarray(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _ssd_case(b, s, h, p, n, seed, initial=False):
    """The inputs of tests/test_kernel_ssd.py::_case (and an initial
    state)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    init = rng.normal(size=(b, h, n, p)).astype(np.float32) if initial \
        else None
    return (x, dt, a, bm, cm), init


# (B, S, H, P, N, chunk) of tests/test_kernel_ssd.py: multi-chunk, head
# blocks, a large chunk, S not a multiple of the chunk (50, 33), a
# single chunk
@pytest.mark.parametrize("shape", [
    (1, 64, 4, 8, 16, 16), (2, 96, 8, 16, 8, 32), (1, 128, 2, 8, 32, 64),
    (1, 50, 4, 8, 16, 16), (2, 33, 2, 8, 8, 32), (1, 16, 2, 4, 8, 16)],
    ids=str)
def test_ssd_matches_reference(shape):
    *dims, chunk = shape
    case, _ = _ssd_case(*dims, seed=sum(shape))
    y, st = ssd_ref(*(torch.as_tensor(a) for a in case), chunk=chunk)
    jcase = [jnp.asarray(a) for a in case]
    y_ref, st_ref = ref_ssd(*jcase, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-4,
                               atol=1e-4)
    y_pl, st_pl = ssd_pallas(*jcase, chunk=chunk, block_h=4, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_pl), rtol=2e-3,
                               atol=2e-3)
    # the dispatch takes the plain version on CPU tensors
    y_d, st_d = ssd_scan(*(torch.as_tensor(a) for a in case), chunk=chunk)
    torch.testing.assert_close(y_d, y, rtol=0, atol=0)
    torch.testing.assert_close(st_d, st, rtol=0, atol=0)


@pytest.mark.parametrize("s, chunk", [(64, 16), (33, 32), (20, 64)])
def test_ssd_initial_state_matches_reference(s, chunk):
    """A carried initial state, across chunks, a ragged chunk and S below
    one chunk; and a scan split in two halves, the second started from
    the first's final state, equals the whole scan."""
    case, init = _ssd_case(2, s, 4, 8, 16, seed=s + chunk, initial=True)
    ours = ssd_ref(*(torch.as_tensor(a) for a in case), chunk=chunk,
                   initial_state=torch.as_tensor(init))
    ref = ref_ssd(*(jnp.asarray(a) for a in case), chunk=chunk,
                  initial_state=jnp.asarray(init))
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    x, dt, a, bm, cm = (torch.as_tensor(v) for v in case)
    half = s // 2
    y1, st1 = ssd_ref(x[:, :half], dt[:, :half], a, bm[:, :half],
                      cm[:, :half], chunk=chunk)
    y2, st2 = ssd_ref(x[:, half:], dt[:, half:], a, bm[:, half:],
                      cm[:, half:], chunk=chunk, initial_state=st1)
    whole = ssd_ref(x, dt, a, bm, cm, chunk=chunk)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), whole[0],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st2, whole[1], rtol=1e-4, atol=1e-4)
