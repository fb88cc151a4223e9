"""The algorithms of the port's flash-decode and merge kernels
(``csrc/decode_attention.cu``, ``csrc/merge_topk.cu``), mirrored in plain
PyTorch or numpy and held against the JAX package on the CPU.

``flash_decode_tiled_ref`` runs the decode kernel's cut of the cache:
each (batch row, kv head)'s valid rows lo..pos (lo = pos - window + 1
with a window, else 0) in spans of ``tiles_per_span`` tiles of
``tile_rows`` rows (a span outside the valid rows does nothing), an
online softmax from tile to tile, and the spans' partial (max, sum, acc)
merged in span order; ``decode_plan`` picks the cut, its tiles sized by
a row's bytes as the kernel's lanes read it. With a window, and on a ring (pos_eff = min(pos, R - 1)), the
mirror is held against the reference's ``decode_attention_block`` reduced
to its attention, so that it meets the block's own masks.
``merge_packed_mirror`` runs the merge kernel's rounds: one 64-bit key an
entry (an order-preserving map of the score, -0.0 folded onto +0.0 with a
bit that remembers it, over the complement of the position), entries
dealt to lanes by position, each lane's local best, the largest key of
the lanes' bests as the round's winner, its id retired in every lane,
and a lane's best recomputed only when one of its entries was retired.
Both are test-only mirrors, not used by the port.

Tolerances: the tiled decode agrees with the jnp oracle and with the
Pallas kernel (interpret mode) to rtol = atol = 1e-5 (float32 sums in
another order); the merge's ids and scores are equal, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ArchConfig as RefArchConfig
from repro.common.config import RoPEKind as RefRoPEKind
from repro.kernels.decode_attention.kernel import flash_decode_pallas
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as ref_decode
from repro.kernels.merge_topk.kernel import NEG_INF, merge_topk_pallas
from repro.kernels.merge_topk.ref import merge_topk_np as ref_merge_np
from repro.models.attention import AttnSpec as RefAttnSpec
from repro.models.attention import \
    decode_attention_block as ref_decode_block
from repro_torch.kernels.decode_attention.ops import (MAX_SPANS,
                                                      DecodePlan, Layout,
                                                      decode_plan)
from repro_torch.kernels.merge_topk import merge_topk

H100_SMS = 132


# ---------------------------------------------------------------------------
# flash-decode: tiles, spans and the merge in span order
# ---------------------------------------------------------------------------


def flash_decode_tiled_ref(q, k, v, pos, *, tile_rows, tiles_per_span,
                           window=0):
    """q [B, H, hd], k and v [B, S, KV, hd], pos [B] -> [B, H, hd]
    float32, as the kernel computes it."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd).float()
    kf, vf = k.float(), v.float()
    scale = 1.0 / float(np.sqrt(np.float32(hd)))
    hi = (pos.long() + 1).clamp(0, s)
    lo = (pos.long() - window + 1).clamp(min=0) if window else \
        torch.zeros_like(hi)
    span_rows = tile_rows * tiles_per_span
    empty = hi <= lo                    # span 0 alone runs, with no row
    first = torch.where(empty, 0, lo // span_rows)
    n_spans = torch.where(empty, 1, (hi - 1) // span_rows - first + 1)
    parts = []                          # per span: (m, l, acc, ran)
    for start in range(0, s, span_rows):
        m = torch.full((b, kvh, g), -torch.inf)
        l = torch.zeros(b, kvh, g)
        acc = torch.zeros(b, kvh, g, hd)
        for t0 in range(start, min(start + span_rows, s), tile_rows):
            rows = torch.arange(t0, min(t0 + tile_rows, s))
            valid = (rows[None, :] < hi[:, None]) \
                & (rows[None, :] >= lo[:, None])                 # [B, T]
            sc = torch.einsum("bkgh,btkh->bkgt", qg, kf[:, rows]) * scale
            sc = sc.masked_fill(~valid[:, None, None, :], -torch.inf)
            m_new = torch.maximum(m, sc.amax(-1))
            c = torch.where(m == -torch.inf, torch.zeros(()),
                            torch.exp(m - m_new))
            p = torch.where(valid[:, None, None, :],
                            torch.exp(sc - m_new[..., None]),
                            torch.zeros(()))
            l = l * c + p.sum(-1)
            acc = acc * c[..., None] + torch.einsum("bkgt,btkh->bkgh", p,
                                                    vf[:, rows])
            m = m_new
        parts.append((m, l, acc, (start < hi) & (start + span_rows > lo)))
    out = torch.zeros(b, kvh, g, hd)
    for bi in range(b):
        f, ns = int(first[bi]), int(n_spans[bi])
        if ns == 1:                     # written directly by its one span
            m, l, acc, _ = parts[f]
            out[bi] = acc[bi] / l[bi].clamp(min=1e-30)[..., None]
            continue
        spans = range(f, f + ns)
        assert all(bool(parts[j][3][bi]) for j in spans)
        assert not any(bool(p[3][bi]) for j, p in enumerate(parts)
                       if j not in spans)
        mx = torch.stack([parts[j][0][bi] for j in spans]).amax(0)
        num = torch.zeros(kvh, g, hd)
        den = torch.zeros(kvh, g)
        for j in spans:                 # span order
            m, l, acc, _ = parts[j]
            c = torch.exp(m[bi] - mx)
            num = num + c[..., None] * acc[bi]
            den = den + c * l[bi]
        out[bi] = num / den.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, hd)


def _decode_case(b, s, h, kvh, hd, pos, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


def _check_tiled(case, tile_rows, tiles_per_span, pallas=True):
    ours = flash_decode_tiled_ref(*(torch.as_tensor(a) for a in case),
                                  tile_rows=tile_rows,
                                  tiles_per_span=tiles_per_span).numpy()
    jcase = [jnp.asarray(a) for a in case]
    np.testing.assert_allclose(ours, np.asarray(ref_decode(*jcase)),
                               rtol=1e-5, atol=1e-5)
    if pallas:
        np.testing.assert_allclose(
            ours, np.asarray(flash_decode_pallas(*jcase, block_s=64,
                                                 interpret=True)),
            rtol=1e-5, atol=1e-5)


# (B, S, H, KV, hd, tile_rows, tiles_per_span, pos): pos 0 and S - 1,
# ragged rows, S not a multiple of T, T larger than S, spans of one and
# of several tiles; G = 1, 2, 4, 8 and hd from 16 to 128
TILED_CASES = [
    (2, 128, 8, 8, 32, 32, 1, [0, 127]),
    (3, 300, 16, 8, 128, 64, 1, [299, 0, 130]),
    (2, 200, 8, 4, 64, 32, 3, [199, 95]),
    (2, 97, 8, 2, 16, 32, 2, [96, 33]),
    (1, 70, 8, 1, 16, 128, 1, [69]),
    (4, 256, 16, 2, 32, 32, 4, [255, 0, 31, 32]),
    (2, 130, 8, 8, 64, 64, 1, [129, 64]),
    (3, 520, 4, 1, 16, 32, 5, [519, 160, 161]),
]


@pytest.mark.parametrize("case", TILED_CASES, ids=str)
def test_tiled_decode_matches_reference(case):
    b, s, h, kvh, hd, t, per, pos = case
    _check_tiled(_decode_case(b, s, h, kvh, hd, pos, seed=s + h),
                 t, per)


def test_tiled_decode_reads_bf16_caches_in_float32():
    q, k, v, pos = _decode_case(2, 300, 8, 4, 32, [299, 77], seed=5)
    kb = torch.as_tensor(k).to(torch.bfloat16)
    vb = torch.as_tensor(v).to(torch.bfloat16)
    ours = flash_decode_tiled_ref(torch.as_tensor(q), kb, vb,
                                  torch.as_tensor(pos), tile_rows=64,
                                  tiles_per_span=2)
    ref = ref_decode(jnp.asarray(q), jnp.asarray(kb.float()),
                     jnp.asarray(vb.float()), jnp.asarray(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_decode_plan_cuts_by_tiles_then_by_spans():
    """Short caches: one tile a block while every tile's block fits on the
    card at once. Long caches: one wave of spans of several tiles; every
    plan covers the cache."""
    # phase 5's step: 8 slots x 8 kv heads x 16 tiles of 64 bf16 rows
    # (hd = 128) do not fit at 2 blocks an SM, so 4 spans of 4 tiles
    assert decode_plan(64, 1024, 256, H100_SMS, 2) == DecodePlan(64, 4, 4)
    # the same cache fits when the card holds 8 blocks an SM
    assert decode_plan(64, 1024, 256, H100_SMS, 8) == DecodePlan(64, 1, 16)
    # float32 rows: tiles of 32 rows
    assert decode_plan(2, 300, 512, H100_SMS, 2) == DecodePlan(32, 1, 10)
    for groups, s, hd, elem in ((64, 32_768, 128, 2), (1, 32_768, 16, 2),
                                (1, 32_768, 128, 2), (512, 1024, 128, 4),
                                (2, 5000, 64, 4)):
        p = decode_plan(groups, s, hd * elem, H100_SMS, 2)
        assert p.spans * p.tiles_per_span * p.tile_rows >= s
        assert p.spans <= MAX_SPANS
        if p.tiles_per_span > 1:     # one wave, or one span a pair
            assert groups * p.spans <= max(H100_SMS * 2, groups)
    # --tile overrides the tile
    assert decode_plan(64, 1024, 256, H100_SMS, 8, tile_rows=128) \
        == DecodePlan(128, 1, 8)


@pytest.mark.parametrize("sms", (4, 8))
def test_tiled_decode_under_the_plan(sms):
    """The mirror under the plans the wrapper picks at a small width, on
    a card of a few SMs: one tile a block, and spans of several tiles."""
    for s, pos in ((1024, [1023, 0, 500, 64]), (2000, [1999, 17, 64, 1024])):
        b, h, kvh, hd = 4, 8, 4, 32
        plan = decode_plan(b * kvh, s, hd * 2, sms, 8)
        _check_tiled(_decode_case(b, s, h, kvh, hd, pos, seed=s),
                     plan.tile_rows, plan.tiles_per_span, pallas=False)


def _ref_block_attention(q, k, v, pos, window):
    """The reference's ``decode_attention_block`` reduced to its
    attention: identity query and output projections, zero key and value
    projections, no rope. Returns (out [B, H, hd], the caches with the
    token's zero row written where the block writes it)."""
    b, h, hd = q.shape
    kvh, d = k.shape[2], h * hd
    cfg = RefArchConfig(name="attention-only", family="dense",
                        num_layers=1, d_model=d, num_heads=h,
                        num_kv_heads=kvh, d_ff=1, vocab_size=1, head_dim=hd,
                        rope=RefRoPEKind.NONE, dtype="float32")
    eye = jnp.eye(d, dtype=jnp.float32)
    zero = jnp.zeros((d, kvh * hd), jnp.float32)
    y, kc, vc = ref_decode_block(
        {"w_q": eye, "w_k": zero, "w_v": zero, "w_o": eye}, cfg,
        jnp.asarray(q.reshape(b, 1, d)), jnp.asarray(pos), jnp.asarray(k),
        jnp.asarray(v), RefAttnSpec(window > 0, window))
    return np.array(y).reshape(b, h, hd), np.array(kc), np.array(vc)


# (B, S, H, KV, hd, tile_rows, tiles_per_span, window, pos). Full-size
# caches on a sliding layer (S > window): a window past pos, a window's
# lower bound inside a tile and inside a span, spans before it skipped;
# G = 2, 5, 16 and hd = 16 to 240. Rings (S <= window): positions before
# and past a wrap, read as pos_eff = min(pos, S - 1) with no window.
WINDOW_CASES = [
    (4, 300, 8, 4, 16, 32, 1, 40, [0, 39, 40, 299]),
    (3, 520, 16, 1, 16, 32, 3, 100, [519, 250, 60]),
    (2, 200, 10, 2, 80, 16, 2, 33, [199, 32]),
    (2, 130, 4, 2, 240, 16, 1, 64, [129, 64]),
]
RING_CASES = [
    (3, 8, 8, 2, 16, 4, 1, 8, [3, 7, 20]),
    (2, 64, 16, 1, 32, 16, 2, 64, [100, 30]),
    (2, 48, 4, 2, 80, 16, 1, 64, [47, 1000]),
]


@pytest.mark.parametrize("case", WINDOW_CASES + RING_CASES, ids=str)
def test_windowed_tiled_decode_matches_reference_block(case):
    b, s, h, kvh, hd, t, per, window, pos = case
    q, k, v, pos = _decode_case(b, s, h, kvh, hd, pos, seed=s + window)
    want, kc, vc = _ref_block_attention(q, k, v, pos, window)
    ring = s <= window
    ours = flash_decode_tiled_ref(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(np.minimum(pos, s - 1) if ring else pos),
        tile_rows=t, tiles_per_span=per, window=0 if ring else window)
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lanes,pieces", [(2, 1), (4, 1), (8, 1), (16, 1),
                                          (32, 1), (32, 2)])
def test_decode_plan_tiles_are_one_pass_of_a_block(lanes, pieces):
    """A tile is one pass of the block at G <= 4: 8 warps x 32 / lanes
    rows x 4 / pieces row loads a lane, for every lane layout the kernel
    has (one piece a lane at hd = 16 to 128; 16 and 32 lanes with idle
    ones at hd = 80 and 240; two pieces a lane at hd = 240 in float32).
    A bf16 row of hd = 240 (480 bytes) is read as 512, so its tiles are
    32 rows."""
    row = Layout(lanes, pieces, 1, 1).row_bytes
    assert row == 16 * lanes * pieces
    tile = decode_plan(1, 10_000, row, H100_SMS, 2).tile_rows
    assert tile == 8 * (32 // lanes) * (4 // pieces)
    if (lanes, pieces) == (32, 1):
        assert decode_plan(64, 1024, row, H100_SMS, 2).tile_rows == 32


# ---------------------------------------------------------------------------
# merge_topk: packed keys, lanes, retires
# ---------------------------------------------------------------------------

NEG_ZERO_BIT = np.uint64(1)


def pack_keys(scores: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """The kernel's key of (score, position): larger is better, ties to
    the lower position, -0.0 ranked as +0.0."""
    u = np.asarray(scores, np.float32).view(np.uint32).astype(np.uint64)
    neg_zero = u == 0x80000000
    u = np.where(neg_zero, 0, u)
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    lo = ((0x7FFFFFFF - np.asarray(positions, np.uint64)) << np.uint64(1)) \
        | neg_zero.astype(np.uint64)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo


def score_of(keys: np.ndarray) -> np.ndarray:
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    u = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(np.uint32)
    s = u.view(np.float32)
    return np.where((keys & NEG_ZERO_BIT) != 0, np.float32(-0.0), s)


def position_of(keys: np.ndarray) -> np.ndarray:
    return (0x7FFFFFFF - ((keys & np.uint64(0xFFFFFFFF)) >> np.uint64(1))
            ).astype(np.int64)


def alive(key) -> bool:
    return int(key) >> 32 > 0x007FFFFF          # above every -inf key


def merge_packed_mirror(scores, ids, *, k, lanes=32):
    """The merge kernel's rounds on [B, m] scores and ids (k <= m):
    (scores [B, k] f32, ids [B, k] i32), (-inf, -1) padded."""
    scores = np.asarray(scores, np.float32)
    ids = np.asarray(ids, np.int32)
    b, m = scores.shape
    out_s = np.full((b, k), -np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    owner = np.arange(m) % lanes
    for row in range(b):
        keys = np.where(ids[row] >= 0, pack_keys(scores[row], np.arange(m)),
                        np.uint64(0))
        best = np.zeros(lanes, np.uint64)
        best_id = np.full(lanes, -1, np.int64)

        def refresh(lane):
            mine = np.flatnonzero(owner == lane)
            j = mine[np.argmax(keys[mine])] if len(mine) else None
            if j is None or keys[j] == 0:
                best[lane], best_id[lane] = 0, -1
            else:
                best[lane], best_id[lane] = keys[j], ids[row, j]
        for lane in range(lanes):
            refresh(lane)
        for r in range(k):
            top = best.max()
            if not alive(top):
                break
            j = int(position_of(top))
            bid = int(best_id[j % lanes])
            out_s[row, r] = score_of(np.array([top], np.uint64))[0]
            out_i[row, r] = bid
            hit = (ids[row] == bid) & (keys != 0)
            keys[hit] = 0
            for lane in np.unique(owner[hit]):
                refresh(lane)
    return out_s, out_i


def _pallas_merge(scores, ids, k):
    s, i = merge_topk_pallas(jnp.asarray(scores), jnp.asarray(ids), k=k,
                             interpret=True)
    s = np.asarray(s)
    return np.where(s <= NEG_INF / 2, -np.inf, s).astype(np.float32), \
        np.asarray(i)


def _merge_case(b, m, mode, seed):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, m)).astype(np.float32)
    ids = rng.integers(-1, max(2, m // 3), size=(b, m)).astype(np.int32)
    if mode == "zeros":
        scores[:, 1::2] = -0.0
        scores[:, ::2] = 0.0
        scores[:, ::9] = rng.normal(size=scores[:, ::9].shape)
    elif mode == "empty":
        ids[0] = -1
    elif mode == "spread":
        # each id at every 7th position (its copies in many lanes), or on
        # 5 neighbouring positions (in 5 neighbouring lanes)
        ids = (np.arange(m)[None, :] % 7).repeat(b, 0).astype(np.int32)
        ids[1::2] = (np.arange(m) // 5).astype(np.int32)
    return scores, ids


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


# (B, m, k, mode): ±0.0 ties, an all-empty row, duplicates spread over
# the lanes, k = m, m not a multiple of 32, the path's m = 160 and the
# block path's lanes
MERGE_CASES = [(3, 40, 10, "zeros"), (4, 33, 33, "empty"),
               (4, 100, 20, "spread"), (2, 160, 10, "dups"),
               (3, 37, 37, "zeros"), (2, 31, 5, "empty")]


@pytest.mark.parametrize("case", MERGE_CASES, ids=str)
def test_packed_merge_matches_pallas_and_numpy(case):
    b, m, k, mode = case
    scores, ids = _merge_case(b, m, mode, seed=m + k)
    mirror = merge_packed_mirror(scores, ids, k=k)
    _assert_same(mirror, _pallas_merge(scores, ids, k))
    n_s, n_i = ref_merge_np(scores, ids, k=k)
    _assert_same(mirror, (n_s, n_i.astype(np.int32)))
    # the port's dispatch on the CPU gives the same
    t_s, t_i = merge_topk(torch.as_tensor(scores), torch.as_tensor(ids), k=k)
    _assert_same(mirror, (t_s.numpy(), t_i.numpy()))
    if mode == "empty":
        assert (mirror[1][0] == -1).all() and np.isneginf(mirror[0][0]).all()


@pytest.mark.parametrize("m,k", ((1281, 80), (2000, 2000)))
def test_packed_merge_with_the_block_paths_lanes(m, k):
    """Above 1,280 entries a block of 256 threads takes a row: the same
    rounds over 256 lanes."""
    scores, ids = _merge_case(2, m, "dups", seed=m)
    mirror = merge_packed_mirror(scores, ids, k=k, lanes=256)
    n_s, n_i = ref_merge_np(scores, ids, k=k)
    _assert_same(mirror, (n_s, n_i.astype(np.int32)))


def test_signed_zero_comes_back_as_it_went_in():
    scores = np.array([[-0.0, 0.0, -0.0, -1.0]], np.float32)
    ids = np.array([[3, 4, 5, 6]], np.int32)
    s, i = merge_packed_mirror(scores, ids, k=4)
    np.testing.assert_array_equal(i, [[3, 4, 5, 6]])
    assert list(np.signbit(s[0])) == [True, False, True, True]


def test_key_order_is_score_then_lowest_position():
    """For every pair: key a > key b iff score a > score b, or the scores
    are equal (-0.0 == +0.0) and a's position is lower; the key gives the
    score back bit for bit, and the position."""
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.0,
                        -1.0, 3.4e38, -3.4e38, 1.1754944e-38], np.float32)
    pool = np.concatenate([
        special, rng.normal(size=150).astype(np.float32),
        (rng.normal(size=150) * 10.0 ** rng.integers(-30, 30, 150)
         ).astype(np.float32),
        rng.choice(special, 100)])
    pos = rng.choice(5120, len(pool), replace=False)   # distinct, as in a row
    keys = pack_keys(pool, pos)
    greater = keys[:, None] > keys[None, :]
    s_a, s_b = pool[:, None].astype(np.float64), pool[None, :]
    want = (s_a > s_b) | ((s_a == s_b) & (pos[:, None] < pos[None, :]))
    np.testing.assert_array_equal(greater, want)
    np.testing.assert_array_equal(score_of(keys).view(np.uint32),
                                  pool.view(np.uint32))
    np.testing.assert_array_equal(position_of(keys), pos)
    # every score's key is above the empty key 0; alive() is false
    # exactly for -inf
    assert (keys > 0).all()
    np.testing.assert_array_equal([alive(x) for x in keys],
                                  pool > -np.inf)
