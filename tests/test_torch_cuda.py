"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a CUDA device every test here skips. Run
them on a GPU machine with ``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_cuda.py`` (the suite's conftest
imports jax, which these tests do not need).

Tolerances: ids must be equal in at least 99.9% of positions (the kernel
sums a dot product in another order than cuBLAS, which can swap two
candidates whose scores differ in the last bit), and scores of equal ids
agree to rtol 1e-5, atol 1e-4. Flash-decode agrees with its plain version
to rtol/atol 1e-4: both read the same cache values and sum in float32.
The SSD scan agrees with its plain version on float32 copies of the same
inputs to 1e-4 of the largest |y| (and of the largest |state|): both sum
in float32, in another order, and the decays are exponentials of
differences of float32 prefix sums that reach |cum| ~ 10^3 in a chunk.
The int8 distance scan agrees with its plain version to rtol/atol 1e-5
where it sums d <= 16 products (both dequantize the same way and sum in
another order); over longer rows (d = 128 to 2,048) it is held to
1e-5 of the largest |score|, as in ``chip_smoke.py``, since two orders of
a longer sum can part by more than 1e-5 at a score near zero. The
serving engine on the card returns the ids of the same engine on the CPU
in at least 99% of positions. The SPMD search on NCCL at world size 1
returns its CPU twin's ids (over gloo) exactly, scores to rtol 1e-5 and
atol 1e-4; ``kmeans_distributed`` there ends on ``kmeans``'s counts, and
its centres to rtol 1e-5, atol 1e-6 (the same kernel calls, one rank).
The SSD backward agrees with autograd through the plain scan on float64
copies to 1e-4 of each output's largest |value| for float32 outputs and
2^-8 for bf16 ones (their own rounding); the reduced train step on the
card agrees with the CPU's to 1e-4 in loss and in each leaf's gradient
(of its largest |g|).
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.common.config import PyramidConfig
from repro_torch.core import distributed as TD
from repro_torch.core.client import gather_arrays
from repro_torch.core.meta_index import build_pyramid_index
from repro_torch.data.synthetic import clustered_vectors, query_set
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.beam_search import beam_search_cuda, beam_search_ref
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  flash_decode_cuda)
from repro_torch.kernels.merge_topk import merge_topk_cuda, merge_topk_ref
from repro_torch.kernels.quant_distance import (quant_scores,
                                                quant_scores_cuda,
                                                quant_scores_ref)
from repro_torch.kernels.ssd import ssd_cuda, ssd_ref
from repro_torch.serving.engine import ServingEngine
from repro_torch.kernels.topk_distance import (topk_similarity_cuda,
                                               topk_similarity_ref)

pytestmark = pytest.mark.cuda
# the kernels of the index build and of Alg. 4 search
PYRAMID_KERNELS = ("beam_search", "merge_topk", "topk_distance")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(ids_k, ids_r, s_k, s_r):
    same = ids_k == ids_r
    assert same.float().mean().item() >= 0.999
    torch.testing.assert_close(s_k[same], s_r[same], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("quantized", (False, True), ids=("f32", "int8"))
@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
def test_beam_kernel_matches_plain(cuda, metric, quantized):
    g = torch.Generator(device=cuda).manual_seed(0)
    s, n, d, m0, c = 2, 4096, 128, 32, 64
    x = torch.randn(s, n, d, device=cuda, generator=g)
    bottom = torch.randint(-1, n, (s, n, m0), device=cuda, generator=g,
                           dtype=torch.int32)
    q = torch.randn(s, c, d, device=cuda, generator=g)
    e = torch.randint(0, n, (s, c), device=cuda, generator=g,
                      dtype=torch.int32)
    scale = zero = None
    if quantized:
        scale = torch.full((d,), 0.03, device=cuda)
        zero = torch.zeros(d, device=cuda)
        x = torch.clamp(torch.round(x / 0.03), -127, 127).to(torch.int8)
    kw = dict(metric=metric, ef=100, max_iters=400, scale=scale, zero=zero)
    s_k, i_k = beam_search_cuda(x, bottom, q, e, **kw)
    s_r, i_r = beam_search_ref(x, bottom, q, e, **kw)
    _close(i_k, i_r, s_k, s_r)


def _beam_case(dev, s, n, d, m0, c, *, quantized=False, seed=0,
               grid=False):
    """Random -1-padded graphs of s x n rows: normal rows, or integer
    rows (exact scores) where ``grid``; int8 codes on a fixed grid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if grid:
        x = torch.randint(-2, 3, (s, n, d), device=dev, generator=g).float()
        q = torch.randint(-2, 3, (s, c, d), device=dev, generator=g).float()
    else:
        x = torch.randn(s, n, d, device=dev, generator=g)
        q = torch.randn(s, c, d, device=dev, generator=g)
    bottom = torch.randint(-1, n, (s, n, m0), device=dev, generator=g,
                           dtype=torch.int32)
    e = torch.randint(0, n, (s, c), device=dev, generator=g,
                      dtype=torch.int32)
    scale = zero = None
    if quantized:
        scale = torch.full((d,), 0.03, device=dev)
        zero = torch.zeros(d, device=dev)
        x = torch.clamp(torch.round(x / 0.03), -127, 127).to(torch.int8)
    return x, bottom, q, e, dict(scale=scale, zero=zero)


# (S, n, d, M0, C, ef, int8, metric): ef = 800; n on both sides of the
# shared visited bitmask's limit (786,432 nodes); M0 of 16, 32 and 48;
# d of 13 (scalar copies), 128, 1,536 and 2,048 (every row at once for
# at most one walk an SM, in slices of d for 256 walks); C of 1, 8, 16,
# 128 and 4,096 (four warps a walk, one at 4,096)
BEAM_SHAPES = (
    (4, 2048, 128, 32, 64, 800, False, "l2"),
    (2, 4096, 128, 32, 128, 800, True, "ip"),
    (1, 786_432, 16, 16, 8, 64, False, "l2"),
    (1, 786_433, 16, 16, 8, 64, False, "ip"),
    (2, 1000, 64, 16, 16, 100, False, "angular"),
    (2, 1000, 64, 48, 16, 100, True, "l2"),
    (1, 3000, 13, 32, 16, 50, False, "l2"),
    (1, 3000, 13, 32, 16, 50, True, "ip"),
    (1, 2000, 1536, 24, 8, 60, False, "l2"),
    (1, 2000, 2048, 24, 8, 60, False, "ip"),
    (1, 2000, 2048, 48, 1, 60, True, "angular"),
    (2, 2000, 2048, 24, 128, 60, False, "l2"),
    (1, 8192, 128, 32, 4096, 100, False, "l2"),
)


@pytest.mark.parametrize("shape", BEAM_SHAPES, ids=str)
def test_beam_kernel_shapes_match_plain(cuda, shape):
    s, n, d, m0, c, ef, quantized, metric = shape
    x, bottom, q, e, qz = _beam_case(cuda, s, n, d, m0, c,
                                     quantized=quantized, seed=n + d)
    kw = dict(metric=metric, ef=ef, max_iters=400, **qz)
    s_k, i_k = beam_search_cuda(x, bottom, q, e, **kw)
    s_r, i_r = beam_search_ref(x, bottom, q, e, **kw)
    torch.cuda.synchronize()
    _close(i_k, i_r, s_k, s_r)
    assert torch.equal(i_k < 0, torch.isneginf(s_k))


@pytest.mark.parametrize("c", (1, 16, 512))
def test_beam_kernel_skips_empty_slots(cuda, c):
    """Entry -1 slots return (-inf, -1) without walking; the other slots
    answer as they do alone."""
    x, bottom, q, e, _ = _beam_case(cuda, 2, 3000, 128, 32, c, seed=c)
    e[:, ::3] = -1
    kw = dict(metric="l2", ef=100, max_iters=400)
    s_k, i_k = beam_search_cuda(x, bottom, q, e, **kw)
    s_r, i_r = beam_search_ref(x, bottom, q, e, **kw)
    torch.cuda.synchronize()
    assert (i_k[:, ::3] == -1).all() and torch.isneginf(s_k[:, ::3]).all()
    _close(i_k, i_r, s_k, s_r)


@pytest.mark.parametrize("quantized", (False, True), ids=("f32", "int8"))
@pytest.mark.parametrize("c", (8, 4096))
def test_beam_kernel_ties_on_duplicate_rows(cuda, c, quantized):
    """Integer rows, each stored four times, and integer queries: every
    score is exact and ties four ways at least; the kernel keeps the
    plain version's order (the old beam first, then slot order)."""
    x, bottom, q, e, qz = _beam_case(cuda, 1, 2048, 32, 32, c, grid=True,
                                     seed=c)
    x = x[:, :512].repeat(1, 4, 1)
    if quantized:
        qz = dict(scale=torch.ones(32, device=cuda),
                  zero=torch.zeros(32, device=cuda))
        x = x.to(torch.int8)
    kw = dict(metric="l2", ef=64, max_iters=200, **qz)
    s_k, i_k = beam_search_cuda(x, bottom, q, e, **kw)
    s_r, i_r = beam_search_ref(x, bottom, q, e, **kw)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_r)
    assert torch.equal(s_k, s_r)


def test_merge_and_topk_kernels_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    sc = torch.randn(256, 640, device=cuda, generator=g)
    ids = torch.randint(-1, 300, (256, 640), device=cuda, generator=g,
                        dtype=torch.int32)
    k_s, k_i = merge_topk_cuda(sc, ids, k=40)
    r_s, r_i = merge_topk_ref(sc, ids, k=40)
    assert torch.equal(k_i, r_i) and torch.equal(k_s, r_s)
    q = torch.randn(512, 128, device=cuda, generator=g)
    x = torch.randn(1000, 128, device=cuda, generator=g)
    for k, metric in ((1, "l2"), (16, "ip")):
        k_s, k_i = topk_similarity_cuda(q, x, k=k, metric=metric)
        r_s, r_i = topk_similarity_ref(q, x, k=k, metric=metric)
        _close(k_i, r_i, k_s, r_s)


MERGE_WIDTHS = (1, 5, 31, 32, 33, 64, 100, 160, 161, 640, 1280, 1281,
                2000, 5120)


def _merge_inputs(cuda, b, m, ids_mode, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if ids_mode == "zeros":
        # +0.0 and -0.0 at every other position, a few larger scores
        scores = torch.zeros(b, m, device=cuda)
        scores[:, 1::2] = -0.0
        scores[:, ::7] = torch.randn(b, (m + 6) // 7, device=cuda,
                                     generator=g)
    else:
        scores = torch.randn(b, m, device=cuda, generator=g)
    if ids_mode == "empty":
        ids = torch.full((b, m), -1, dtype=torch.int32, device=cuda)
    elif ids_mode == "same":
        ids = torch.full((b, m), 7, dtype=torch.int32, device=cuda)
    else:   # duplicates spread over the lanes, some empty entries
        ids = torch.randint(-1, max(2, m // 3), (b, m), device=cuda,
                            generator=g, dtype=torch.int32)
    return scores, ids


@pytest.mark.parametrize("ids_mode", ("dups", "empty", "same", "zeros"))
@pytest.mark.parametrize("k_of", ("one", "all"))
@pytest.mark.parametrize("m", MERGE_WIDTHS)
def test_merge_kernel_matches_plain_exactly(cuda, m, k_of, ids_mode):
    """Ids and scores equal the plain rounds' exactly, from the warp path
    (m <= 1,280) to the block path (m up to 5,120), at k = 1 and k = m."""
    b = 37 if m <= 1280 else 5
    k = 1 if k_of == "one" else m
    scores, ids = _merge_inputs(cuda, b, m, ids_mode, m)
    before = merge_topk_cuda.launches
    k_s, k_i = merge_topk_cuda(scores, ids, k=k)
    r_s, r_i = merge_topk_ref(scores, ids, k=k)
    torch.cuda.synchronize()
    assert merge_topk_cuda.launches == before + 1
    assert torch.equal(k_i, r_i)
    assert torch.equal(k_s, r_s)
    # a -0.0 comes back as it went in
    assert torch.equal(torch.signbit(k_s), torch.signbit(r_s))


def test_merge_kernel_counts_its_launches(cuda):
    scores, ids = _merge_inputs(cuda, 3, 40, "dups", 0)
    reset_launch_counts()
    merge_topk_cuda(scores, ids, k=5)
    merge_topk_cuda(scores[:0], ids[:0], k=5)     # no row: no launch
    assert launch_counts()["merge_topk"] == 1
    with pytest.raises(ValueError, match="at most"):
        merge_topk_cuda(torch.zeros(1, 20_000, device=cuda),
                        torch.zeros(1, 20_000, dtype=torch.int32,
                                    device=cuda), k=1)


def test_search_on_card_matches_cpu(cuda):
    x = clustered_vectors(3000, 32, 24, seed=0)
    q = query_set(x, 64, seed=1)
    cfg = PyramidConfig(num_shards=4, meta_size=64, sample_size=2000,
                        max_degree=12, max_degree_upper=6,
                        ef_construction=40, ef_search=40)
    reset_launch_counts()
    index = build_pyramid_index(x, cfg)
    ids, _, _ = TD.search_single_host(index, q, 10)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in PYRAMID_KERNELS), counts
    cpu = build_pyramid_index(x, cfg, device="cpu")
    ids_cpu, _, _ = TD.search_single_host(cpu, q, 10)
    truth = np.argsort(-(2 * q @ x.T - (x * x).sum(1)), axis=1)[:, :10]
    rec = [np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, truth)])
           for i in (ids, ids_cpu)]
    assert rec[0] >= 0.9 and abs(rec[0] - rec[1]) <= 0.02


# (B, n, d): the reference kernel test's shapes, the ragged 37 x 53 and
# shapes that are not multiples of the 64 x 64 tile or the 32-wide slice;
# then B and n across the 128 x 128 tiles of the tensor-core kernel
QUANT_SHAPES = [(5, 24, 8), (130, 70, 16), (1, 8, 4), (37, 53, 8),
                (65, 129, 3), (1, 1, 1), (130, 300, 16), (257, 129, 8)]
# longer sums, held to 1e-5 of the largest |score|: d off the 16-column
# k-step (130, two 128-column slices, the second ragged), the kNN-LM width
# (2,048, sixteen slices), the main path's d = 128 with B and n off the
# tiles, and a d past the 64 slices whose scale and zero the kernel holds
# at once (8,320)
QUANT_WIDE_SHAPES = [(129, 257, 130), (33, 65, 2048), (200, 300, 128),
                     (1, 5, 2048), (3, 5, 8320)]


def _quant_case(cuda, b, n, d):
    g = torch.Generator(device=cuda).manual_seed(b * n + d)
    x = torch.randn(n, d, device=cuda, generator=g) * (
        0.5 + 2.5 * torch.rand(1, d, device=cuda, generator=g))
    q = torch.randn(b, d, device=cuda, generator=g)
    lo, hi = x.amin(dim=0), x.amax(dim=0)
    scale = torch.clamp((hi - lo) / 254.0, min=1e-12)
    zero = (hi + lo) / 2.0
    codes = torch.clamp(torch.round((x - zero) / scale), -127, 127).to(
        torch.int8)
    return q, codes, scale, zero


@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=str)
def test_quant_kernel_matches_plain(cuda, shape, metric):
    q, codes, scale, zero = _quant_case(cuda, *shape)
    before = quant_scores_cuda.launches
    got = quant_scores(q, codes, scale, zero, metric=metric)
    assert quant_scores_cuda.launches == before + 1
    want = quant_scores_ref(q, codes, scale, zero, metric=metric)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        quant_scores_cuda(q, codes.float(), scale, zero, metric=metric)


@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
def test_quant_kernel_over_several_slices(cuda, metric):
    q, codes, scale, zero = _quant_case(cuda, 70, 200, 130)
    got = quant_scores_cuda(q, codes, scale, zero, metric=metric)
    want = quant_scores_ref(q, codes, scale, zero, metric=metric)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
@pytest.mark.parametrize("shape", QUANT_WIDE_SHAPES, ids=str)
def test_quant_kernel_on_wide_rows(cuda, shape, metric):
    q, codes, scale, zero = _quant_case(cuda, *shape)
    got = quant_scores_cuda(q, codes, scale, zero, metric=metric)
    want = quant_scores_ref(q, codes, scale, zero, metric=metric)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_engine_on_card_matches_cpu(cuda):
    x = clustered_vectors(1500, 12, 12, seed=0)
    q = query_set(x, 48, seed=11)
    cfg = PyramidConfig(num_shards=4, meta_size=48, sample_size=800,
                        branching_factor=2, max_degree=12,
                        max_degree_upper=6, ef_construction=40,
                        ef_search=50, kmeans_iters=6)
    cpu = build_pyramid_index(x, cfg, device="cpu")
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    card = convert.index_from_arrays(
        cfg.__dict__, arrays(cpu.meta), cpu.part_of_center,
        [arrays(g) for g in cpu.subs], device="cuda")
    out = {}
    for quantize in (False, True):
        for name, index in (("cpu", cpu), ("cuda", card)):
            reset_launch_counts()
            eng = ServingEngine(index, replicas=2, quantize=quantize)
            try:
                out[name] = gather_arrays(eng.submit(q, k=10), 10, 30.0)
            finally:
                eng.shutdown()
            assert (launch_counts()["beam_search"] > 0) == (name == "cuda")
        # ids equal in 99% of positions, as phase 3 of chip_smoke.py holds
        # the card's search to the CPU's: the walk's float32 sums run in
        # another order, which can swap two near-tied candidates
        same = out["cuda"][0] == out["cpu"][0]
        assert same.mean() >= 0.99
        np.testing.assert_allclose(out["cuda"][1][same], out["cpu"][1][same],
                                   rtol=1e-5, atol=1e-4)


def _card_and_cpu_twin():
    x = clustered_vectors(1200, 16, 12, seed=3)
    cfg = PyramidConfig(num_shards=4, meta_size=48, sample_size=800,
                        branching_factor=2, max_degree=12,
                        max_degree_upper=6, ef_construction=40,
                        ef_search=50, kmeans_iters=6)
    cpu = build_pyramid_index(x, cfg, device="cpu")
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    card = convert.index_from_arrays(
        cfg.__dict__, arrays(cpu.meta), cpu.part_of_center,
        [arrays(g) for g in cpu.subs], build_stats=dict(cpu.build_stats),
        device="cuda")
    return x, cpu, card


def _checksums(index):
    from repro_torch.store import content_checksum, graph_to_arrays
    return [content_checksum(graph_to_arrays(g)) for g in index.subs]


def _updates(index, x):
    """An insert beside shard 0's rows (tagged), a tag write and a
    removal of inserted and old ids; the checksums after each step."""
    from repro_torch.core.updates import (add_items, remove_items,
                                          set_item_tags)
    rows = x[np.sort(index.subs[0].ids)[:24]] + 0.01
    n = len(x)
    steps = []
    add_items(index, rows, tags=np.arange(24, dtype=np.int64) % 2)
    steps.append(_checksums(index))
    set_item_tags(index, np.arange(n, n + 24, 3), 4)
    steps.append(_checksums(index))
    remove_items(index, np.concatenate([np.arange(n, n + 24, 5),
                                        index.subs[1].ids[:5]]))
    steps.append(_checksums(index))
    return steps


def test_updates_on_card_match_cpu_twin(cuda):
    """The same update sequence on a card index (routing through the
    beam kernel) and on its CPU twin rebuilds the same shards: every
    segment checksum is equal after every step."""
    x, cpu, card = _card_and_cpu_twin()
    reset_launch_counts()
    on_card = _updates(card, x)
    assert launch_counts()["beam_search"] > 0
    assert on_card == _updates(cpu, x)
    q = query_set(x, 48, seed=4)
    ids_card, _, _ = TD.search_single_host(card, q, 10)
    ids_cpu, _, _ = TD.search_single_host(cpu, q, 10)
    assert (ids_card == ids_cpu).mean() >= 0.99


def test_publish_on_card_loads_on_cpu(cuda, tmp_path):
    """A store published from a card index, with a delta log journaled on
    the card, loads on the CPU to the same graphs and the CPU twin's ids,
    and on the card to the live card index's ids."""
    from repro_torch.store import IndexStore
    x, cpu, card = _card_and_cpu_twin()
    IndexStore(str(tmp_path)).publish(card)
    _updates(card, x)
    _updates(cpu, x)
    q = query_set(x, 48, seed=5)
    on_cpu = IndexStore(str(tmp_path)).load(device="cpu")
    assert _checksums(on_cpu) == _checksums(card)
    np.testing.assert_array_equal(TD.search_single_host(on_cpu, q, 10)[0],
                                  TD.search_single_host(cpu, q, 10)[0])
    on_card = IndexStore(str(tmp_path)).load()
    assert on_card.device.type == "cuda"
    np.testing.assert_array_equal(TD.search_single_host(on_card, q, 10)[0],
                                  TD.search_single_host(card, q, 10)[0])


# (B, S, H, KV, hd): G = 1, 2, 3 and 8; S not a multiple of any tile; the
# long ones take several spans (and, at S = 32,768, spans of several
# tiles); 64 x 8 = 512 (batch row, kv head) pairs
DECODE_SHAPES = [(2, 128, 8, 8, 32), (3, 300, 16, 8, 128), (2, 97, 6, 2, 64),
                 (1, 70, 8, 1, 16), (2, 5000, 16, 8, 128),
                 (64, 1024, 16, 8, 128), (2, 32_768, 16, 8, 128)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("pos_mode", ("full", "start", "random"))
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=str)
def test_flash_decode_kernel_matches_plain(cuda, shape, pos_mode, dtype):
    b, s, h, kvh, hd = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q = torch.randn(b, h, hd, device=cuda, generator=g)
    k = torch.randn(b, s, kvh, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, s, kvh, hd, device=cuda, generator=g).to(dtype)
    if pos_mode == "full":
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=cuda)
    elif pos_mode == "start":
        pos = torch.zeros(b, dtype=torch.int32, device=cuda)
    else:
        pos = torch.randint(0, s, (b,), device=cuda, generator=g,
                            dtype=torch.int32)
    before = flash_decode_cuda.launches
    out = flash_decode_cuda(q, k, v, pos)
    torch.cuda.synchronize()
    assert flash_decode_cuda.launches == before + 1
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, pos),
                               rtol=1e-4, atol=1e-4)


def _decode_inputs(cuda, b, s, h, kvh, hd, dtype, pos, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, h, hd, device=cuda, generator=g)
    k = torch.randn(b, s, kvh, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, s, kvh, hd, device=cuda, generator=g).to(dtype)
    return q, k, v, torch.as_tensor(pos, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("hd", (16, 32, 64, 128))
@pytest.mark.parametrize("groups", range(1, 9))
def test_flash_decode_every_group_and_head_dim(cuda, groups, hd, dtype):
    """Ragged rows in one batch: pos 0, S - 1, one tile, and between."""
    s = 700
    q, k, v, pos = _decode_inputs(cuda, 5, s, 2 * groups, 2, hd, dtype,
                                  [0, s - 1, 63, 64, 411], groups + hd)
    out = flash_decode_cuda(q, k, v, pos)
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, pos),
                               rtol=1e-4, atol=1e-4)


def test_flash_decode_at_the_served_shape(cuda):
    """qwen3-1.7b's decode step in chip_smoke.py's phase 5: 8 slots of a
    1,024-row cache at prompt lengths of 64 to 256 plus up to 64 new
    tokens."""
    rng = np.random.default_rng(0)
    pos = rng.integers(64, 257, 8) + rng.integers(0, 65, 8) - 1
    q, k, v, pos = _decode_inputs(cuda, 8, 1024, 16, 8, 128, torch.bfloat16,
                                  pos, 7)
    torch.testing.assert_close(flash_decode_cuda(q, k, v, pos),
                               decode_attention_ref(q, k, v, pos),
                               rtol=1e-4, atol=1e-4)


def test_flash_decode_reuses_its_workspace(cuda):
    """Two calls in a row, and a call after one over more (batch row, kv
    head) pairs, give the same output bit for bit: the workspace and its
    counters are reused (the counters are back at 0 after every call),
    and a call allocates only its output."""
    from repro_torch.kernels.decode_attention import ops
    small = _decode_inputs(cuda, 4, 3000, 16, 8, 128, torch.bfloat16,
                           [2999, 1500, 64, 0], 1)
    big = _decode_inputs(cuda, 32, 3000, 16, 8, 64, torch.float32,
                         list(range(2999, 0, -93))[:32], 2)
    first = flash_decode_cuda(*small)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()["allocation.all.allocated"]
    again = flash_decode_cuda(*small)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == stats + 1
    assert torch.equal(first, again)
    flash_decode_cuda(*big)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    part, counters = ops._workspaces[(cuda.index or 0, stream)]
    assert counters.numel() >= 32 * 8 and int(counters.abs().sum()) == 0
    after = flash_decode_cuda(*small)
    assert torch.equal(first, after)
    torch.testing.assert_close(after, decode_attention_ref(*small),
                               rtol=1e-4, atol=1e-4)


def test_flash_decode_refuses_what_it_is_not_built_for(cuda):
    q = torch.zeros(1, 4, 48, device=cuda)
    kv = torch.zeros(1, 8, 2, 48, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode_cuda(q, kv, kv, pos)
    q = torch.zeros(1, 34, 32, device=cuda)
    kv = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="kv heads"):
        flash_decode_cuda(q, kv, kv, pos)
    q = torch.zeros(1, 4, 32, device=cuda)
    with pytest.raises(ValueError, match="window"):
        flash_decode_cuda(q, kv, kv, pos, window=-1)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("hd", (80, 112, 240))
@pytest.mark.parametrize("groups", (1, 2, 4, 5, 8))
def test_flash_decode_wide_and_ragged_head_dims(cuda, groups, hd, dtype):
    """hd = 80, 112 and 240 (idle lanes; two pieces a lane at 240 in
    float32),
    with and without a window, over ragged rows: pos 0, S - 1, one tile,
    and between."""
    s = 700
    q, k, v, pos = _decode_inputs(cuda, 5, s, 2 * groups, 2, hd, dtype,
                                  [0, s - 1, 31, 64, 411], groups + hd)
    for window in (0, 1, 50, 4096):
        out = flash_decode_cuda(q, k, v, pos, window)
        torch.testing.assert_close(
            out, decode_attention_ref(q, k, v, pos, window), rtol=1e-4,
            atol=1e-4)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("hd", (64, 80, 128, 240))
@pytest.mark.parametrize("groups", range(9, 17))
def test_flash_decode_nine_to_sixteen_groups(cuda, groups, hd, dtype):
    """G = 9 to 16 query heads a kv head (chatglm3-6b's 16): blocks over
    slices of at most 8 heads (4 at hd = 240), the last slice ragged at
    odd G; with and without a window."""
    s = 600
    q, k, v, pos = _decode_inputs(cuda, 3, s, 2 * groups, 2, hd, dtype,
                                  [s - 1, 0, 300], 7 * groups + hd)
    for window in (0, 64):
        torch.testing.assert_close(
            flash_decode_cuda(q, k, v, pos, window),
            decode_attention_ref(q, k, v, pos, window), rtol=1e-4,
            atol=1e-4)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_flash_decode_zamba2_shape(cuda, dtype):
    """zamba2-7b's shared attention: 32 query heads over 32 kv heads at
    hd = 112 (14 bf16 pieces on 16 lanes, 28 float32 pieces on 32), 8
    slots of a 2,048-row cache at pos 0, S - 1 and between."""
    s = 2048
    q, k, v, pos = _decode_inputs(cuda, 8, s, 32, 32, 112, dtype,
                                  [0, s - 1, 127, 128, 1000, 1500, 64, 2000],
                                  112)
    torch.testing.assert_close(flash_decode_cuda(q, k, v, pos),
                               decode_attention_ref(q, k, v, pos), rtol=1e-4,
                               atol=1e-4)


# (B, S, H, KV, hd, window): gemma3-12b's local layers (1,024-slot rings
# read at pos_eff = min(pos, R - 1), and a full-size cache on a local
# layer), h2o-danube-1.8b's (a 4,096-slot ring at hd = 80), and long
# caches with a window whose lower bound skips most spans
WINDOW_SHAPES = [(8, 1024, 16, 8, 240, 1024), (8, 2048, 16, 8, 240, 1024),
                 (4, 4096, 32, 8, 80, 4096), (2, 32_768, 16, 8, 128, 1000),
                 (3, 5000, 32, 2, 128, 777)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=str)
def test_flash_decode_windows_and_rings(cuda, shape, dtype):
    b, s, h, kvh, hd, window = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v, _ = _decode_inputs(cuda, b, s, h, kvh, hd, dtype, [0] * b,
                                sum(shape))
    pos = torch.randint(0, s, (b,), device=cuda, generator=g,
                        dtype=torch.int32)
    pos[0] = s - 1
    if s <= window:         # a ring: the kernel reads slots 0..min(pos, R-1)
        absolute = pos + torch.randint(0, 3 * s, (b,), device=cuda,
                                       generator=g, dtype=torch.int32)
        pos = absolute.clamp(max=s - 1)
        window = 0
    out = flash_decode_cuda(q, k, v, pos, window)
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, pos,
                                                         window),
                               rtol=1e-4, atol=1e-4)


def test_flash_decode_layout(cuda):
    """The kernel's layout (``flash_decode_layout``): a row's lanes cover
    its 16-byte pieces on a power of two of lanes, one piece a lane (as
    many lanes as pieces) at hd = 16 to 128, no lane idle in both pieces;
    a kv head's query heads are cut into blocks of a power of two of
    heads, at most 8 (4 at hd = 240), none empty, one block up to 8
    heads at hd <= 128."""
    from repro_torch.kernels.decode_attention.ops import (HEAD_DIMS,
                                                          MAX_GROUPS,
                                                          kernel_layout)
    for hd in HEAD_DIMS:
        for bf16 in (False, True):
            pieces = hd * (2 if bf16 else 4) // 16
            for groups in range(1, MAX_GROUPS + 1):
                lay = kernel_layout(2 * groups, 2, hd, bf16)
                assert lay.lanes & (lay.lanes - 1) == 0
                assert 2 <= lay.lanes <= 32 and lay.pieces in (1, 2)
                assert lay.lanes * lay.pieces >= pieces
                assert lay.lanes * (lay.pieces - 1) < pieces
                if hd & (hd - 1) == 0:
                    assert (lay.lanes, lay.pieces) == (max(pieces, 2), 1)
                cap = 4 if hd > 128 else 8
                assert lay.heads & (lay.heads - 1) == 0
                assert lay.heads <= cap
                assert (lay.slices - 1) * lay.heads < groups \
                    <= lay.slices * lay.heads
                assert lay.slices == -(-groups // cap)


@pytest.mark.parametrize("arch", ("gemma3-12b", "h2o-danube-1.8b",
                                  "chatglm3-6b"))
def test_sliding_batcher_on_card_matches_cpu(cuda, arch):
    """The reduced sliding-window, local-global and 2-D rope configs
    (window 8, so that rings wrap; gemma3 at six layers, one of them
    global) served on the card: flash-decode once a layer and step, and
    the CPU's tokens."""
    import dataclasses
    from repro_torch.common.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    from repro_torch.train.tree import map_tree
    cfg = dataclasses.replace(get_arch(arch).reduced(), sliding_window=8,
                              num_layers=6 if arch == "gemma3-12b" else 2)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = map_tree(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 8, 13)]
    runs, steps = [], 0
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        b = ContinuousBatcher(params, cfg, num_slots=2, max_seq=32,
                              device=dev)
        for i, p in enumerate(prompts):
            b.submit(Request(i, p, max_new_tokens=12))
        before = flash_decode_cuda.launches
        while b.pending or any(a is not None for a in b.active):
            if b.step() and dev != "cpu":
                steps += 1
        runs.append({c.request_id: c.tokens for c in b.done})
    assert runs[0] == runs[1]
    assert flash_decode_cuda.launches - before == cfg.num_layers * steps


def test_lm_batcher_on_card_matches_cpu(cuda):
    """The reduced qwen3 config served on the card goes through the
    flash-decode kernel once per layer and step, and completes the same
    tokens as on the CPU."""
    from repro_torch.common.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    cfg = get_arch("qwen3-1.7b").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = {"blocks": {"attention": {
        k: v.to(cuda) for k, v in cpu["blocks"]["attention"].items()}},
        **{k: v.to(cuda) for k, v in cpu.items() if k != "blocks"}}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 7)]
    runs, steps = [], 0
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        b = ContinuousBatcher(params, cfg, num_slots=2, max_seq=32,
                              device=dev)
        for i, p in enumerate(prompts):
            b.submit(Request(i, p, max_new_tokens=6))
        before = flash_decode_cuda.launches
        while b.pending or any(a is not None for a in b.active):
            if b.step() and dev != "cpu":
                steps += 1      # one decode step of every slot
        runs.append({c.request_id: c.tokens for c in b.done})
    assert runs[0] == runs[1]
    assert flash_decode_cuda.launches - before == cfg.num_layers * steps


# B x n x d: one query (eight splits), the k-means sample of the index
# build, a ragged n at a narrow d, the LM datastore's key width
# (qwen3-1.7b's hidden size), run K's shape (four splits), the LM
# datastores' k-means (400 keys against 32 centres at qwen3-1.7b's and
# mamba2-780m's widths; k is cut to n there), and the LSH baseline's
# rerank (one query against its largest candidate list, and against
# short ones) and a shard split's k-means (k = 2)
TOPK_SHAPES = [(1, 1000, 128), (20_000, 1000, 128), (512, 333, 8),
               (256, 1000, 2048), (4096, 1000, 128), (400, 32, 2048),
               (400, 32, 1536), (1, 2048, 128), (1, 1, 128), (1, 7, 128),
               (135, 2, 128)]


@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
@pytest.mark.parametrize("k", (1, 16, 20, 256))
@pytest.mark.parametrize("shape", TOPK_SHAPES, ids=str)
def test_topk_kernel_matches_plain(cuda, shape, k, metric):
    b, n, d = shape
    k = min(k, n)
    g = torch.Generator(device=cuda).manual_seed(b + n + d + k)
    q = torch.randn(b, d, device=cuda, generator=g)
    x = torch.randn(n, d, device=cuda, generator=g)
    before = topk_similarity_cuda.launches
    k_s, k_i = topk_similarity_cuda(q, x, k=k, metric=metric)
    torch.cuda.synchronize()
    assert topk_similarity_cuda.launches == before + 1
    assert k_s.shape == k_i.shape == (b, k) and k_i.dtype == torch.int32
    r_s, r_i = topk_similarity_ref(q, x, k=k, metric=metric)
    _close(k_i, r_i, k_s, r_s)


@pytest.mark.parametrize("k", (1, 16, 20, 256))
@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_topk_kernel_ties_across_splits_go_to_the_lower_id(cuda, metric, k):
    """Integer rows (exact scores, d = 13, which the wrapper pads to 16)
    with copies of the best row on both sides of the tile boundaries
    127 | 128 and 255 | 256; six queries give one query tile, so every
    tile is a split of its own and the copies meet in the merge."""
    g = torch.Generator(device=cuda).manual_seed(k)
    lo = 1 if metric == "ip" else -4
    q = torch.randint(lo, 5, (6, 13), device=cuda, generator=g).float()
    x = torch.randint(lo, 5, (400, 13), device=cuda, generator=g).float()
    best = torch.full((13,), 4.0, device=cuda) if metric == "ip" else q[0]
    x[[127, 128, 255, 256]] = best
    k_s, k_i = topk_similarity_cuda(q, x, k=k, metric=metric)
    r_s, r_i = topk_similarity_ref(q, x, k=k, metric=metric)
    assert k_i[0, :min(k, 4)].tolist() == [127, 128, 255, 256][:min(k, 4)]
    assert torch.equal(k_i, r_i)
    torch.testing.assert_close(k_s, r_s, rtol=0, atol=0)


@pytest.mark.parametrize("k", (1, 16))
@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_topk_kernel_ties_with_d_sliced_go_to_the_lower_id(cuda, metric, k):
    """One database tile (n = 100) at d = 2,048, which the wrapper cuts
    into slices of d: integer rows (exact dot products in every slice)
    with copies of the best row at 3, 40 and 99."""
    g = torch.Generator(device=cuda).manual_seed(k + 1)
    lo = 1 if metric == "ip" else -4
    q = torch.randint(lo, 5, (6, 2048), device=cuda, generator=g).float()
    x = torch.randint(lo, 5, (100, 2048), device=cuda, generator=g).float()
    best = torch.full((2048,), 4.0, device=cuda) if metric == "ip" else q[0]
    x[[3, 40, 99]] = best
    k_s, k_i = topk_similarity_cuda(q, x, k=k, metric=metric)
    r_s, r_i = topk_similarity_ref(q, x, k=k, metric=metric)
    assert k_i[0, :min(k, 3)].tolist() == [3, 40, 99][:min(k, 3)]
    assert torch.equal(k_i, r_i)
    torch.testing.assert_close(k_s, r_s, rtol=0, atol=0)


# (B, S, H, P, N, chunk): the reference kernel test's shapes, aligned,
# ragged (S not a multiple of the chunk or of the 64-row tile), S below
# one chunk, and the full width (H 48, P 64, N 128, chunk 256); then one
# row, a chunk and one row, a batch of long prompts at full width, a
# narrow head (P 16, N 32), and zamba2-7b's width (H 112, N 64)
SSD_SHAPES = [(1, 64, 4, 8, 16, 16), (2, 96, 8, 16, 8, 32),
              (1, 128, 2, 8, 32, 64), (1, 50, 4, 8, 16, 16),
              (2, 33, 2, 8, 8, 32), (1, 16, 2, 4, 8, 16),
              (2, 300, 16, 16, 16, 32), (1, 100, 3, 5, 7, 256),
              (1, 513, 48, 64, 128, 256), (2, 700, 4, 64, 128, 256),
              (1, 1, 48, 64, 128, 256), (1, 257, 48, 64, 128, 256),
              (4, 4096, 48, 64, 128, 256), (2, 300, 4, 16, 32, 64),
              (1, 513, 112, 64, 64, 256), (2, 300, 112, 64, 64, 256)]


def _ssd_inputs(shape, dtype, cuda, initial):
    b, s, h, p, n, _ = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(b, s, h, p, device=cuda, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, device=cuda, generator=g))
    a = -torch.linspace(1.0, 16.0, h, device=cuda)
    bc = torch.randn(b, s, 2 * n, device=cuda, generator=g).to(dtype)
    init = torch.randn(b, h, n, p, device=cuda, generator=g) \
        if initial else None
    return x, dt, a, bc[..., :n], bc[..., n:], init


@pytest.mark.parametrize("initial", (False, True), ids=("zero", "init"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_kernel_matches_plain(cuda, shape, dtype, initial):
    x, dt, a, bm, cm, init = _ssd_inputs(shape, dtype, cuda, initial)
    before = ssd_cuda.launches
    y, st = ssd_cuda(x, dt, a, bm, cm, chunk=shape[-1], initial_state=init)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    assert y.dtype == st.dtype == torch.float32
    y_r, st_r = ssd_ref(x.float(), dt, a, bm.float(), cm.float(),
                        chunk=shape[-1], initial_state=init)
    for got, want in ((y, y_r), (st, st_r)):
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err


def test_ssd_refuses_what_it_is_not_built_for(cuda):
    for p, n, chunk in ((65, 16, 32), (16, 129, 32), (16, 16, 257)):
        x, dt, a, bm, cm, _ = _ssd_inputs((1, 40, 2, p, n, chunk),
                                          torch.float32, cuda, False)
        with pytest.raises(ValueError):
            ssd_cuda(x, dt, a, bm, cm, chunk=chunk)


def test_mamba2_batcher_on_card_matches_cpu(cuda):
    """The reduced mamba2 config served on the card runs the SSD kernel
    once per layer and prefill, and completes the same tokens as on the
    CPU."""
    from repro_torch.common.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    cfg = get_arch("mamba2-780m").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = {"blocks": {"mamba2": {
        k: v.to(cuda) for k, v in cpu["blocks"]["mamba2"].items()}},
        **{k: v.to(cuda) for k, v in cpu.items() if k != "blocks"}}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (20, 45, 80)]
    runs = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        b = ContinuousBatcher(params, cfg, num_slots=2, max_seq=128,
                              device=dev)
        for i, p in enumerate(prompts):
            b.submit(Request(i, p, max_new_tokens=6))
        before = ssd_cuda.launches
        b.run_until_drained()
        runs.append({c.request_id: c.tokens for c in b.done})
    assert runs[0] == runs[1]
    assert ssd_cuda.launches - before == cfg.num_layers * len(prompts)


@pytest.mark.parametrize("retrieval", (False, True),
                         ids=("plain", "retrieval"))
@pytest.mark.parametrize("arch", ("qwen3-1.7b", "mamba2-780m"))
def test_serve_entry_point_runs_on_card(cuda, arch, retrieval):
    """The launcher on the card (reduced config): qwen3 decodes through
    flash-decode, mamba2 prefills through the SSD kernel."""
    from repro_torch.launch import serve
    reset_launch_counts()
    argv = ["--arch", arch, "--tokens", "4"]
    gen = serve.main(argv + (["--retrieval", "--quantize"] if retrieval
                             else []))
    assert gen.shape == (2, 4) and ((gen >= 0) & (gen < 512)).all()
    counts = launch_counts()
    kernel, absent = (("ssd", "decode_attention") if arch == "mamba2-780m"
                      else ("decode_attention", "ssd"))
    assert counts[kernel] > 0 and counts[absent] == 0, counts
    assert (counts["beam_search"] > 0) == retrieval, counts


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "mamba2-780m"))
def test_stream_engine_on_card_launches_its_kernels(cuda, arch):
    """``StreamEngine`` on the card (reduced config): flash-decode once a
    layer in every dispatched step (qwen3), the SSD kernel once a layer in
    every prefill and never in a step (mamba2), the beam kernel in the
    lookups; LM-only tokens equal to the CPU's."""
    from repro_torch.common.registry import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batcher import Request
    from repro_torch.serving.retrieval import build_datastore
    from repro_torch.serving.stream import StreamEngine
    from repro_torch.train.tree import map_tree
    cfg = get_arch(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = map_tree(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(1)
    corpus = rng.integers(0, cfg.vocab_size, (8, 24))
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 30, 7, 12)]
    pyr = PyramidConfig(metric="l2", num_shards=2, meta_size=16,
                        sample_size=100, branching_factor=2, max_degree=8,
                        max_degree_upper=4, ef_construction=20,
                        ef_search=30)
    tokens = {}
    for params, dev in ((cpu, torch.device("cpu")), (card, cuda)):
        for retrieval in (False, True):
            ds = build_datastore(params, cfg, [corpus], pyr, device=dev) \
                if retrieval else None
            reset_launch_counts()
            with StreamEngine(params, cfg, num_slots=4, max_seq=64,
                              datastore=ds, knn_k=4, lam=0.3,
                              device=dev) as eng:
                for i, p in enumerate(prompts):
                    eng.submit(Request(i, p, max_new_tokens=6))
                done = eng.run_until_drained()
                steps = eng.stats()["steps"]
            n = launch_counts()
            tokens[dev.type, retrieval] = {c.request_id: c.tokens
                                           for c in done}
            assert len(done) == len(prompts)
            if dev.type == "cpu":
                assert not any(n.values()), n
                continue
            attn = cfg.num_layers * steps if arch == "qwen3-1.7b" else 0
            ssd = cfg.num_layers * len(prompts) \
                if arch == "mamba2-780m" else 0
            assert n["decode_attention"] == attn, n
            assert n["ssd"] == ssd, n
            assert (n["beam_search"] > 0) == retrieval, n
    assert tokens["cuda", False] == tokens["cpu", False]


# ---------------------------------------------------------------------------
# online maintenance and the LSH baseline on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spherical", (False, True))
def test_kmeanspp_on_card_picks_the_cpu_rows(cuda, spherical):
    """k-means++ draws with a CPU generator on float64 sums: the card and
    the CPU pick the same rows, and the k-means that follows (the top-k
    kernel's assignment on the card) ends on the same clusters."""
    from repro_torch.core.kmeans import _init_centers, kmeans
    x = clustered_vectors(4000, 32, 40, seed=7)
    for seed in range(3):
        xt = torch.as_tensor(x)
        if spherical:
            xt = xt / (torch.linalg.vector_norm(xt, dim=-1, keepdim=True)
                       + 1e-12)
        on_card = _init_centers(xt.to(cuda), 64, seed, method="kmeans++")
        on_cpu = _init_centers(xt, 64, seed, method="kmeans++")
        assert torch.equal(on_card.cpu(), on_cpu)
        before = topk_similarity_cuda.launches
        c_card, n_card = kmeans(x, 64, iters=4, spherical=spherical,
                                seed=seed, init="kmeans++", device=cuda)
        assert topk_similarity_cuda.launches == before + 4
        c_cpu, n_cpu = kmeans(x, 64, iters=4, spherical=spherical,
                              seed=seed, init="kmeans++", device="cpu")
        np.testing.assert_array_equal(n_card, n_cpu)
        np.testing.assert_allclose(c_card, c_cpu, rtol=1e-5, atol=1e-5)


def test_compactor_cycle_on_card_matches_cpu_twin(cuda, tmp_path):
    """One Compactor cycle on a card index and on its CPU twin, over the
    same records, with a split of the largest shard (k-means++ through
    the top-k kernel) and a centroid refresh (k-means++ again, and every
    row routed through the beam kernel): the published versions' segment
    checksums are equal."""
    from repro_torch.store import Compactor, IndexStore
    x, cpu, card = _card_and_cpu_twin()
    sums = {}
    for name, index in (("cpu", cpu), ("cuda", card)):
        store = IndexStore(str(tmp_path / name))
        store.publish(index)
        sizes = [g.n for g in index.subs]
        comp = Compactor(store, index, split_factor=0.99 * max(sizes)
                         / np.mean(sizes), refresh_every=1)
        comp.add_items(x[np.sort(index.subs[0].ids)[:16]] + 0.01)
        comp.remove_items(index.subs[1].ids[:4])
        reset_launch_counts()
        comp.run_once(force=True)
        counts = launch_counts()
        assert comp.rebalance_ops[0][0] == "split"
        assert comp.refreshes == 1
        assert comp.index.device.type == name
        if name == "cuda":
            assert counts["topk_distance"] > 0 and counts["beam_search"] > 0
        else:
            assert not any(counts.values())
        sums[name] = _checksums(IndexStore(str(tmp_path / name)).load(
            device="cpu"))
        assert sums[name] == _checksums(comp.index)
    assert sums["cuda"] == sums["cpu"]


def test_lsh_on_card_matches_cpu_twin(cuda):
    """``search_lsh`` reranks on the card through the top-k kernel, one
    launch a query with candidates, with the CPU twin's ids."""
    from repro_torch.core.lsh import build_lsh, search_lsh
    x = clustered_vectors(6000, 32, 30, seed=5)
    q = query_set(x, 64, seed=6)
    for metric in ("l2", "angular"):
        idx = build_lsh(x, metric=metric, num_shards=4, num_tables=8,
                        num_bits=8, width=3.0)
        before = topk_similarity_cuda.launches
        ids_card, s_card = search_lsh(idx, q, 10)
        assert topk_similarity_cuda.launches - before == \
            int((ids_card[:, 0] >= 0).sum())
        ids_cpu, s_cpu = search_lsh(idx, q, 10, device="cpu")
        _close(torch.as_tensor(ids_card), torch.as_tensor(ids_cpu),
               torch.as_tensor(s_card), torch.as_tensor(s_cpu))


# ---------------------------------------------------------------------------
# the multi-device path: NCCL at world size 1 on the card
# ---------------------------------------------------------------------------


def _on_one_rank(device, run):
    """``run(mesh)`` on a (1, 1) mesh of ``device`` -- NCCL on the card,
    gloo on the CPU -- whose process group starts and ends here."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    try:
        mesh = make_local_mesh(device)
        assert dist.get_backend() == {"cuda": "nccl", "cpu": "gloo"}[device]
        return run(mesh)
    finally:
        dist.destroy_process_group()


def _numpy(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("quantize", (False, True), ids=("f32", "int8"))
def test_spmd_search_on_nccl_matches_gloo_cpu(cuda, quantize):
    """``make_pyramid_search_fn`` on the card (the beam and merge kernels,
    the partials gathered by NCCL) returns the ids of its CPU twin over
    gloo, float32 and int8 (rerank 4)."""
    x, cpu, card = _card_and_cpu_twin()
    q = query_set(x, 64, seed=9)
    kw = dict(quantize=True, rerank_factor=4) if quantize else {}

    def search(index):
        def run(mesh):
            fn = TD.make_pyramid_search_fn(
                mesh, index.config, k=10, batch=len(q),
                index=index if quantize else None, **kw)
            arena = TD.local_arena(index, mesh, quantize=quantize)
            ids, scores = fn(arena, index.meta_arrays(),
                             index.part_of_center_tensor(), q)
            return _numpy(ids), _numpy(scores)
        return run
    reset_launch_counts()
    ids_card, s_card = _on_one_rank("cuda", search(card))
    counts = launch_counts()
    assert counts["beam_search"] > 0 and counts["merge_topk"] > 0, counts
    ids_cpu, s_cpu = _on_one_rank("cpu", search(cpu))
    np.testing.assert_array_equal(ids_card, ids_cpu)
    np.testing.assert_allclose(s_card, s_cpu, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("spherical", (False, True))
def test_kmeans_distributed_on_nccl_matches_kmeans(cuda, spherical):
    """``kmeans_distributed`` on the card's one rank assigns through the
    top-k kernel and sums through NCCL: from the same initial centres it
    ends on ``kmeans``'s centres and counts."""
    from repro_torch.core.kmeans import kmeans, kmeans_distributed
    x = clustered_vectors(4000, 32, 40, seed=7)
    init = x[np.random.default_rng(1).choice(len(x), 64, replace=False)]
    before = topk_similarity_cuda.launches
    c_dist, n_dist = _on_one_rank("cuda", lambda mesh: kmeans_distributed(
        x, 64, mesh, iters=4, spherical=spherical, init_centers=init))
    assert topk_similarity_cuda.launches == before + 4
    c_one, n_one = kmeans(x, 64, iters=4, spherical=spherical,
                          init_centers=init, device=cuda)
    np.testing.assert_array_equal(n_dist, n_one)
    np.testing.assert_allclose(c_dist, c_one, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("init", ("uniform", "kmeans++"))
def test_kmeans_distributed_seeded_on_nccl_matches_kmeans(cuda, init):
    """Seeded from ``seed`` on the card's one rank (the chosen rows, and
    k-means++'s D² totals, sent through NCCL), ``kmeans_distributed``
    starts from ``kmeans``'s centres and ends on its centres and
    counts."""
    from repro_torch.core.kmeans import kmeans, kmeans_distributed
    x = clustered_vectors(4000, 32, 40, seed=7)
    c_dist, n_dist = _on_one_rank("cuda", lambda mesh: kmeans_distributed(
        x, 64, mesh, iters=4, seed=5, init=init))
    c_one, n_one = kmeans(x, 64, iters=4, seed=5, init=init, device=cuda)
    np.testing.assert_array_equal(n_dist, n_one)
    np.testing.assert_allclose(c_dist, c_one, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# training: the SSD scan's backward kernel and the train step on the card
# ---------------------------------------------------------------------------

# (B, S, H, P, N, chunk): ragged last chunks, one row short of a chunk,
# mamba2-780m's layer shape at a corpus row, at the train step's batch
# (phase 11a), with a last chunk of one row, and zamba2-7b's layer at its
# train step's batch (phase 14c: H 112, N 64)
SSD_BWD_SHAPES = [(2, 80, 3, 16, 16, 32), (1, 40, 2, 5, 7, 16),
                  (2, 7, 2, 3, 4, 32), (2, 300, 4, 64, 128, 64),
                  (1, 513, 48, 64, 128, 256), (4, 640, 48, 64, 128, 256),
                  (1, 257, 4, 64, 128, 256), (4, 256, 112, 64, 64, 256)]


@pytest.mark.parametrize("final", (False, True), ids=("y", "y_final"))
@pytest.mark.parametrize("initial", (False, True), ids=("zero", "init"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES, ids=str)
def test_ssd_backward_kernel_matches_float64(cuda, shape, dtype, initial,
                                             final):
    """The backward kernel against autograd through the plain scan on
    float64 copies of the same inputs: within 1e-4 of each output's
    largest |value| for its float32 outputs (ddt, da, d_initial_state;
    and dx, dB, dC on float32 inputs), 2^-8 for bf16 outputs (their own
    rounding); a second call is equal bit for bit (no atomics)."""
    from repro_torch.kernels.ssd import (SSD_BWD_TOL, SSD_BWD_TOL_BF16,
                                         ssd_backward_cuda, ssd_backward_ref)
    x, dt, a, bm, cm, init = _ssd_inputs(shape, dtype, cuda, initial)
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn(x.shape, device=cuda, generator=g)
    dfin = torch.randn(init.shape if initial else
                       (shape[0], shape[2], shape[4], shape[3]),
                       device=cuda, generator=g) if final else None
    before = ssd_backward_cuda.launches
    out = ssd_backward_cuda(x, dt, a, bm, cm, dy, chunk=shape[-1],
                            initial_state=init, d_final=dfin)
    torch.cuda.synchronize()
    assert ssd_backward_cuda.launches == before + 1

    def d(t):
        return None if t is None else t.double()
    truth = ssd_backward_ref(x.double(), dt.double(), a.double(),
                             bm.double(), cm.double(), dy.double(),
                             chunk=shape[-1], initial_state=d(init),
                             d_final=d(dfin))
    dtypes = (dtype, torch.float32, torch.float32, dtype, dtype,
              torch.float32)
    for name, got, want, dt_ in zip(("dx", "ddt", "da", "db", "dc",
                                     "dinit"), out, truth, dtypes):
        assert got.dtype == dt_ and got.shape == want.shape, name
        assert torch.isfinite(got).all(), name
        tol = SSD_BWD_TOL_BF16 if got.dtype == torch.bfloat16 \
            else SSD_BWD_TOL
        err = float((got.double() - want).abs().max())
        assert err <= tol * float(want.abs().max()), (name, err)
    again = ssd_backward_cuda(x, dt, a, bm, cm, dy, chunk=shape[-1],
                              initial_state=init, d_final=dfin)
    assert all(torch.equal(u, v) for u, v in zip(out, again))


def test_ssd_backward_smem_fits_the_card(cuda):
    """The dynamic shared memory of the backward's staged kernels as the
    library reports it (``ssd_backward_smem_bytes``, the sizes it passes
    to ``cudaFuncSetAttribute``), on the float32 and the bf16 path: each
    fits a block's 227 KB, and the blocks a SM that each kernel's launch
    bounds ask for (two of the outer, s and dB/dC stages, which
    ``backward_plan`` counts on, three of the head stage) fit the SM's
    228 KB with the 1 KB the card keeps a block."""
    from repro_torch.kernels.ssd.ops import _backward_library
    lib = _backward_library()
    for bf16 in (0, 1):
        for stage, blocks in enumerate((2, 2, 3, 2)):
            smem = lib.ssd_backward_smem_bytes(stage, bf16)
            assert 0 < smem <= 227 * 1024, (stage, bf16, smem)
            assert blocks * (smem + 1024) <= 228 * 1024, (stage, bf16, smem)
        assert lib.ssd_backward_smem_bytes(4, bf16) == -1


def test_ssd_scan_carries_the_gradient_on_card(cuda):
    """``ssd_scan`` with inputs that require grad runs through the
    backward kernel, and its gradients are autograd's through the plain
    scan; ``ssd_cuda`` refuses such inputs."""
    from repro_torch.kernels.ssd import ssd_backward_cuda, ssd_scan
    shape = (2, 80, 3, 16, 16, 32)
    x, dt, a, bm, cm, init = _ssd_inputs(shape, torch.float32, cuda, True)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm, init)]
    with pytest.raises(RuntimeError, match="ssd_scan"):
        ssd_cuda(*ins[:5], chunk=32, initial_state=ins[5])
    g = torch.Generator(device=cuda).manual_seed(3)
    dy = torch.randn(x.shape, device=cuda, generator=g)
    dfin = torch.randn(init.shape, device=cuda, generator=g)
    before = (ssd_cuda.launches, ssd_backward_cuda.launches)
    y, final = ssd_scan(*ins[:5], chunk=32, initial_state=ins[5])
    grads = torch.autograd.grad((y * dy).sum() + (final * dfin).sum(), ins)
    assert (ssd_cuda.launches, ssd_backward_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    refs = [t.detach().double().requires_grad_(True) for t in ins]
    y_r, f_r = ssd_ref(*refs[:5], chunk=32, initial_state=refs[5])
    want = torch.autograd.grad((y_r * dy.double()).sum()
                               + (f_r * dfin.double()).sum(), refs)
    for got, w in zip(grads, want):
        err = float((got.double() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


def _loss_grads(params, cfg, b, dev):
    from repro_torch.train import tree as TT
    from repro_torch.train.train_step import loss_fn
    flat = TT.items(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    live = TT.unflatten({k: v for (k, _), v in zip(flat, leaves)})
    batch = {"inputs": torch.from_numpy(b.inputs).to(dev),
             "targets": torch.from_numpy(b.targets).to(dev),
             "mask": torch.from_numpy(b.mask).to(dev)}
    total, (loss, _) = loss_fn(live, cfg, batch)
    grads = torch.autograd.grad(total, leaves)
    return float(loss.detach()), {k: g for (k, _), g in zip(flat, grads)}


@pytest.mark.parametrize("arch", ("qwen3-1.7b", "mamba2-780m"))
def test_train_step_on_card_matches_cpu(cuda, arch):
    """The reduced config's train step on the card (the SSD kernels for
    mamba2, no kernel of the port for qwen3) against the CPU's (plain
    versions) from the same parameters and batches: the first step's
    gradients within 1e-4 of each leaf's largest |g|, every leaf's
    gradient non-zero on the card, and three steps' losses within 1e-4;
    under remat a Mamba2 layer runs the forward scan twice a step and its
    backward once."""
    from repro_torch.common.registry import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.ssd import ssd_backward_cuda
    from repro_torch.models.transformer import init_params
    from repro_torch.train import tree as TT
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import train_step
    cfg = get_arch(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = TT.map_tree(lambda t: t.to(cuda), cpu)
    data = iter(SyntheticLM(cfg, batch=8, seq_len=80, seed=0))
    batches = [next(data) for _ in range(3)]
    loss_c, g_cpu = _loss_grads(cpu, cfg, batches[0], "cpu")
    loss_g, g_card = _loss_grads(card, cfg, batches[0], cuda)
    assert abs(loss_c - loss_g) <= 1e-4
    for key, g in g_card.items():
        assert float(g.abs().max()) > 0, key
        err = float((g.cpu() - g_cpu[key]).abs().max())
        assert err <= 1e-4 * float(g_cpu[key].abs().max()), (key, err)
    opt = AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=120,
                      weight_decay=0.0)
    runs = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        state = init_opt_state(params)
        reset_launch_counts()
        losses = []
        for b in batches:
            batch = {"inputs": torch.from_numpy(b.inputs).to(dev),
                     "targets": torch.from_numpy(b.targets).to(dev),
                     "mask": torch.from_numpy(b.mask).to(dev)}
            params, state, m = train_step(params, state, batch, cfg=cfg,
                                          opt_cfg=opt)
            losses.append(float(m["loss"]))
        runs.append(losses)
    np.testing.assert_allclose(runs[1], runs[0], rtol=0, atol=1e-4)
    counts = launch_counts()
    mamba = cfg.num_layers if arch == "mamba2-780m" else 0
    assert counts["ssd"] == 2 * mamba * 3, counts
    assert counts["ssd_backward"] == ssd_backward_cuda.launches \
        == mamba * 3, counts
    assert sum(counts.values()) == 3 * mamba * 3, counts
