"""The decompositions of the port's two redesigned CUDA kernels, mirrored
in plain PyTorch and held against the JAX package on the CPU.

``ssd_staged_ref`` runs the five stages of ``csrc/ssd.cu`` (prefix sums,
C B^T once per chunk, chunk states [N, P], state passing, outputs
as exp(cum_i) C_i S_prev plus the masked score product), and
``topk_similarity_split_ref`` the walk of ``csrc/topk_distance.cu``: the
database cut into splits of 128-row tiles by ``split_plan``, a running
top-k per query that admits only scores above its k-th (a running argmax
at k = 1; for 1 < k <= 32 the tile's candidates first cut at the k-th
best of the 32 lanes' maxima),
and the splits' partial lists merged with ties to the lowest id;
``topk_similarity_sliced_ref`` its cut of d for a database of one tile
(dot products of slices of d added in slice order, then the top k). All
are test-only mirrors of the kernels' algorithms, not used by the port.

Tolerances: the SSD stages agree with the reference to rtol = atol =
1e-5 (float32 sums in another order; decays as differences of prefix
sums); the top-k ids are equal and the scores agree to rtol = atol =
1e-5 (l2 to atol 1e-4, for the cancellation in 2 q.x - |q|^2 - |x|^2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd.ref import ssd_ref as ref_ssd
from repro.kernels.topk_distance import topk_similarity_ref as ref_topk
from repro_torch.kernels.topk_distance.ops import (TILE, slice_plan,
                                                   split_plan)
from repro_torch.kernels.topk_distance.ref import similarities


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ssd_staged_ref(x, dt, a, b_mat, c_mat, *, chunk, initial_state=None):
    """The SSD scan in the five stages of ``csrc/ssd.cu``, float32.
    x [B, S, H, P], dt [B, S, H], a [H], b/c [B, S, N] ->
    (y [B, S, H, P], final_state [B, H, N, P])."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s                  # rows past S act as dt = 0
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, q, h, p)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(bsz, nc, q, h)
    bc = F.pad(b_mat.float(), (0, 0, 0, pad)).reshape(bsz, nc, q, n)
    cc = F.pad(c_mat.float(), (0, 0, 0, pad)).reshape(bsz, nc, q, n)
    # 1. per (b, chunk, h): inclusive prefix sums of dt * a
    cum = torch.cumsum(dtc * a.float(), dim=2)            # [B, nc, Q, H]
    # 2. per (b, chunk): C B^T, lower triangle, shared by every head
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    cb = (cc @ bc.transpose(-1, -2)) * causal              # [B, nc, Q, Q]
    # 3. per (b, chunk, h): the chunk's state contribution, [N, P]
    w = dtc * torch.exp(cum[:, :, -1:, :] - cum)           # [B, nc, Q, H]
    contrib = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, w, xc)
    # 4. per (b, h): state passing, sequential over chunks
    st = torch.zeros(bsz, h, n, p) if initial_state is None \
        else initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(cum[:, c, -1, :])[..., None, None] + contrib[:, c]
    prev = torch.stack(prev, dim=1)                        # [B, nc, H, N, P]
    # 5. per (b, chunk, h): exp(cum_i) C_i S_prev + (C B^T o L o dt) x
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B, nc, i, j, H]
    decay = torch.exp(torch.where(causal[..., None], seg, -torch.inf))
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)
    y = y + torch.einsum("bcin,bchnp->bcihp", cc, prev) \
        * torch.exp(cum)[..., None]
    return y.reshape(bsz, nc * q, h, p)[:, :s], st


def _merge(ls, li, cs, ci, k):
    """The k best of two lists by (score descending, id ascending)."""
    s, i = torch.cat([ls, cs], 1), torch.cat([li, ci], 1)
    order = torch.argsort(i, dim=1, stable=True)
    s, i = s.gather(1, order), i.gather(1, order)
    order = torch.argsort(s, dim=1, descending=True, stable=True)
    return s.gather(1, order)[:, :k], i.gather(1, order)[:, :k]


def topk_similarity_split_ref(queries, database, *, k, metric, splits,
                              tiles_per_split):
    """The top-k scan as ``csrc/topk_distance.cu`` walks it: per split, a
    thresholded running list over 128-row tiles; then the merge of the
    splits' partial lists. Returns (scores [B, k], ids [B, k] int32)."""
    b, n = queries.shape[0], database.shape[0]
    parts_s, parts_i = [], []
    for sp in range(splits):
        ls = torch.full((b, k), -torch.inf)
        li = torch.full((b, k), -1, dtype=torch.int64)
        end = min(n, (sp + 1) * tiles_per_split * TILE)
        for n0 in range(sp * tiles_per_split * TILE, end, TILE):
            sims = torch.full((b, TILE), -torch.inf)
            sims[:, :min(TILE, end - n0)] = similarities(
                queries, database[n0:min(n0 + TILE, end)], metric)
            ids = (n0 + torch.arange(TILE)).expand(b, TILE)
            cand = sims > ls[:, -1:]
            # k = 1 is a running argmax: the merge below with every column
            if 1 < k <= 32:
                # lane l holds columns l, l + 32, l + 64, l + 96
                lanes = torch.where(cand, sims, -torch.inf).reshape(b, 4, 32)
                lb = torch.topk(lanes.amax(dim=1), k, dim=1).values[:, -1:]
                many = cand.sum(dim=1, keepdim=True) > k
                cand &= ~many | (sims >= lb)
            ls, li = _merge(ls, li, torch.where(cand, sims, -torch.inf),
                            torch.where(cand, ids, -1), k)
        parts_s.append(ls)
        parts_i.append(li)
    s, i = _merge(torch.cat(parts_s, 1), torch.cat(parts_i, 1),
                  torch.empty(b, 0), torch.empty(b, 0, dtype=torch.int64), k)
    return s, i.to(torch.int32)


def topk_similarity_sliced_ref(queries, database, *, k, metric, slices,
                               cols):
    """The top-k scan as ``csrc/topk_distance.cu`` runs it on a database
    of one tile: the dot products of ``slices`` slices of ``cols`` columns
    of d, added in slice order, the metric from the rows' norms, then the
    k best, ties to the lowest id. Returns (scores [B, k], ids [B, k]
    int32)."""
    q, x = queries.float(), database.float()
    dot = torch.zeros(q.shape[0], x.shape[0])
    for sl in range(slices):
        cut = slice(sl * cols, (sl + 1) * cols)
        dot = dot + q[:, cut] @ x[:, cut].T
    qq, xx = (q * q).sum(1, keepdim=True), (x * x).sum(1)[None, :]
    if metric == "l2":
        sims = (2.0 * dot - qq) - xx
    elif metric == "angular":
        sims = dot / ((qq.sqrt() + 1e-12) * (xx.sqrt() + 1e-12))
    else:
        sims = dot
    s, i = _merge(sims, torch.arange(x.shape[0]).expand_as(sims),
                  torch.empty(q.shape[0], 0),
                  torch.empty(q.shape[0], 0, dtype=torch.int64), k)
    return s, i.to(torch.int32)


# ---------------------------------------------------------------------------
# the SSD stages
# ---------------------------------------------------------------------------

SSD_Q = 8


def _ssd_case(s, seed, initial):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 3, 4, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    init = rng.normal(size=(b, h, n, p)).astype(np.float32) if initial \
        else None
    return (x, dt, a, bm, cm), init


@pytest.mark.parametrize("initial", (False, True), ids=("zero", "init"))
@pytest.mark.parametrize("s", (1, SSD_Q, SSD_Q + 1, 3 * SSD_Q + 5))
def test_ssd_stages_match_reference(s, initial):
    """One row, one whole chunk, a chunk and one row, and three chunks
    and a ragged fourth; with and without a carried initial state."""
    case, init = _ssd_case(s, seed=s + 100 * initial, initial=initial)
    y, st = ssd_staged_ref(*(torch.as_tensor(v) for v in case), chunk=SSD_Q,
                           initial_state=None if init is None
                           else torch.as_tensor(init))
    y_r, st_r = ref_ssd(*(jnp.asarray(v) for v in case), chunk=SSD_Q,
                        initial_state=None if init is None
                        else jnp.asarray(init))
    assert y.shape == np.asarray(y_r).shape and st.shape == st_r.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the top-k walk and its split merge
# ---------------------------------------------------------------------------


def _topk_tol(metric):
    return dict(rtol=1e-5, atol=1e-4 if metric == "l2" else 1e-5)


def test_split_plan_fills_the_card():
    """The wrapper's rule at the build's shapes on 132 SMs: four splits of
    two tiles at B = 4,096 (128 CTAs) and at B = 20,000 (5 waves of 2
    tiles instead of 2 of 8), every tile of n = 1,000 in one split each
    for a single query, and the split count never above the tiles."""
    assert split_plan(4096, 1000, 132) == (4, 2)
    assert split_plan(20_000, 1000, 132) == (4, 2)
    assert split_plan(1, 1000, 132) == (8, 1)
    assert split_plan(33_792, 1000, 132) == (1, 8)   # 264 query tiles
    for b, n in ((1, 1), (130, 129), (5000, 70_000), (256, 2000)):
        splits, per = split_plan(b, n, 132)
        tiles = -(-n // TILE)
        assert 1 <= splits <= min(tiles, 128)
        assert (splits - 1) * per < tiles <= splits * per


@pytest.mark.parametrize("plan", ((1, 6), (2, 3), (3, 2), (6, 1)), ids=str)
@pytest.mark.parametrize("metric,k", (("l2", 1), ("ip", 16), ("l2", 20),
                                      ("angular", 16)))
def test_topk_split_walk_matches_reference(metric, k, plan):
    rng = np.random.default_rng(k + 7 * plan[0])
    q = rng.normal(size=(20, 12)).astype(np.float32)
    x = rng.normal(size=(700, 12)).astype(np.float32)      # 6 tiles, ragged
    s, i = topk_similarity_split_ref(torch.as_tensor(q), torch.as_tensor(x),
                                     k=k, metric=metric, splits=plan[0],
                                     tiles_per_split=plan[1])
    r_s, r_i = ref_topk(jnp.asarray(q), jnp.asarray(x), k=k, metric=metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(r_s),
                               **_topk_tol(metric))


@pytest.mark.parametrize("k", (1, 16, 20))
@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_topk_ties_across_a_split_boundary_go_to_the_lower_id(metric, k):
    """Integer rows (exact scores) with copies of the best row on both
    sides of each tile boundary, 127 | 128 and 255 | 256, which are split
    boundaries at one tile a split: equal scores keep the lower id."""
    rng = np.random.default_rng(k)
    lo = 1 if metric == "ip" else -4        # ip: no zero, so no signed zero
    q = rng.integers(lo, 5, size=(6, 12)).astype(np.float32)
    x = rng.integers(lo, 5, size=(400, 12)).astype(np.float32)
    best = 4.0 * np.ones(12, np.float32) if metric == "ip" else q[0]
    for row in (127, 128, 255, 256):
        x[row] = best
    r_s, r_i = ref_topk(jnp.asarray(q), jnp.asarray(x), k=k, metric=metric)
    r_i = np.asarray(r_i)
    assert list(r_i[0, :min(k, 4)]) == [127, 128, 255, 256][:min(k, 4)]
    for plan in ((1, 4), (4, 1), (2, 2)):
        s, i = topk_similarity_split_ref(
            torch.as_tensor(q), torch.as_tensor(x), k=k, metric=metric,
            splits=plan[0], tiles_per_split=plan[1])
        np.testing.assert_array_equal(i.numpy(), r_i)
        np.testing.assert_allclose(s.numpy(), np.asarray(r_s),
                                   **_topk_tol(metric))


def test_slice_plan_cuts_d_only_for_one_tile():
    """The LM datastores' k-means (400 keys against 32 centres) on 132
    SMs: 32 slices of 64 columns at d = 2,048 (128 CTAs), 24 at d = 1,536;
    no cut with more than one database tile, with the query tiles on half
    the SMs or more, or with fewer than eight slabs of d."""
    assert slice_plan(400, 32, 2048, 132) == (32, 64)
    assert slice_plan(400, 32, 1536, 132) == (24, 64)
    assert slice_plan(4096, 1000, 128, 132) == (1, 128)
    assert slice_plan(20_000, 32, 2048, 132) == (1, 2048)
    assert slice_plan(1, 100, 16, 132) == (1, 16)
    for b, n, d in ((1, 128, 4), (1, 1, 2052), (300, 100, 1000),
                    (8448, 128, 64)):
        slices, cols = slice_plan(b, n, d, 132)
        assert cols % 16 == 0 or slices == 1
        assert (slices - 1) * cols < d <= slices * cols


@pytest.mark.parametrize("plan", ((1, 64), (2, 32), (4, 16)), ids=str)
@pytest.mark.parametrize("metric,k", (("l2", 1), ("ip", 16), ("l2", 20),
                                      ("angular", 16), ("ip", 32)))
def test_topk_sliced_d_matches_reference(metric, k, plan):
    """d = 60: the last slice of every cut is ragged."""
    rng = np.random.default_rng(k + 5 * plan[0])
    q = rng.normal(size=(20, 60)).astype(np.float32)
    x = rng.normal(size=(32, 60)).astype(np.float32)
    s, i = topk_similarity_sliced_ref(torch.as_tensor(q), torch.as_tensor(x),
                                      k=k, metric=metric, slices=plan[0],
                                      cols=plan[1])
    r_s, r_i = ref_topk(jnp.asarray(q), jnp.asarray(x), k=k, metric=metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(r_s),
                               **_topk_tol(metric))


@pytest.mark.parametrize("k", (1, 16))
@pytest.mark.parametrize("metric", ("l2", "ip"))
def test_topk_sliced_d_ties_go_to_the_lower_id(metric, k):
    """Integer rows (exact dot products in every slice) with copies of
    the best row at 3, 40 and 99: equal scores keep the lower id."""
    rng = np.random.default_rng(k + 1)
    lo = 1 if metric == "ip" else -4
    q = rng.integers(lo, 5, size=(6, 64)).astype(np.float32)
    x = rng.integers(lo, 5, size=(100, 64)).astype(np.float32)
    best = 4.0 * np.ones(64, np.float32) if metric == "ip" else q[0]
    for row in (3, 40, 99):
        x[row] = best
    r_s, r_i = ref_topk(jnp.asarray(q), jnp.asarray(x), k=k, metric=metric)
    r_i = np.asarray(r_i)
    assert list(r_i[0, :min(k, 3)]) == [3, 40, 99][:min(k, 3)]
    s, i = topk_similarity_sliced_ref(torch.as_tensor(q), torch.as_tensor(x),
                                      k=k, metric=metric, slices=4, cols=16)
    np.testing.assert_array_equal(i.numpy(), r_i)
    np.testing.assert_allclose(s.numpy(), np.asarray(r_s),
                               **_topk_tol(metric))
