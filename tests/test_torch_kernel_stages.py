"""The decompositions of the port's redesigned CUDA kernels, mirrored
in plain PyTorch or numpy and held against the JAX package on the CPU.

``ssd_staged_ref`` runs the five stages of ``csrc/ssd.cu`` (prefix sums,
C B^T once per chunk, chunk states [N, P], state passing, outputs
as exp(cum_i) C_i S_prev plus the masked score product);
``ssd_backward_staged_ref`` the stages of ``csrc/ssd_backward.cu``
(float64 prefix sums, each chunk's state and state-gradient terms, the
forward and reverse recurrences, C B^T and s = dy x^T once a causal tile
pair with the tile pairs' sums of the decay gradient and G summed over
groups of heads, the per-head dx, the decay gradient's reverse prefix
sum, then dB and dC over parts of heads), in float64 or in the kernel's
split pieces; ``backward_plan``'s grid; and
``topk_similarity_split_ref`` the walk of ``csrc/topk_distance.cu``: the
database cut into splits of 128-row tiles by ``split_plan``, a running
top-k per query that admits only scores above its k-th (a running argmax
at k = 1; for 1 < k <= 32 the tile's candidates first cut at the k-th
best of the 32 lanes' maxima),
and the splits' partial lists merged with ties to the lowest id;
``topk_similarity_sliced_ref`` its cut of d for a database of one tile
(dot products of slices of d added in slice order, then the top k);
``beam_search_staged_ref`` the walk of ``csrc/beam_search.cu``: rows
scored in the staging passes of ``walk_plan`` (rows a pass, slices of d
added in slice order), the new candidates cut at the beam's ef-th score,
sorted on (score desc, slot asc) in batches of 32, inserted in place with
the beam first on ties, the next expansion found from a pointer below
which every entry is expanded, and entry -1 slots left unwalked. All are
test-only mirrors of the kernels' algorithms, not used by the port.

Tolerances: the SSD stages agree with the reference to rtol = atol =
1e-5 (float32 sums in another order; decays as differences of prefix
sums); the backward stages agree with float64 autograd through the
port's ``ssd_chunked`` to 1e-10 of each gradient's largest |value| and
with ``jax.vjp`` of the reference's float32 scan to 1e-4 of it, and in
the kernel's split pieces to ``SSD_BWD_TOL``, 1e-4 (``SSD_BWD_TOL_BF16``,
2^-8, for bf16 outputs), the bounds ``chip_smoke.py`` holds the card to; the top-k ids are equal and the scores agree to rtol = atol =
1e-5 (l2 to atol 1e-4, for the cancellation in 2 q.x - |q|^2 - |x|^2).
The staged walk's ids equal the reference's (normal rows do not tie;
integer rows tie exactly, and are held against the numpy twin, which
breaks ties as the kernel does, -0.0 == +0.0), its scores to the same
tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.quant import QuantParams
from repro.kernels.beam_search import beam_search_np as ref_beam_np
from repro.kernels.beam_search import beam_search_ref as ref_beam
from repro.kernels.ssd.ref import ssd_ref as ref_ssd
from repro.kernels.topk_distance import topk_similarity_ref as ref_topk
from repro_torch.kernels.beam_search import beam_search
from repro_torch.kernels.beam_search.ops import (MAX_M0, SMEM_MAX_BYTES,
                                                 WalkPlan, layout_bytes,
                                                 resident_blocks, walk_plan)
from repro_torch.kernels.ssd import SSD_BWD_TOL, SSD_BWD_TOL_BF16
from repro_torch.kernels.ssd.ops import BWD_TILE, backward_plan
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


def _pieces(v, f16):
    """The hi and lo pieces (fp16 or bf16) of float32 values, as float64:
    hi = round(v), lo = round(v - hi)."""
    t = torch.float16 if f16 else torch.bfloat16
    v = v.float()
    hi = v.to(t)
    return hi.double(), (v - hi.float()).to(t).double()


def ssd_backward_staged_ref(x, dt, a, bm, cm, dy, *, chunk,
                            initial_state=None, d_final=None, tile=BWD_TILE,
                            hpg=1, hpp=1, pieces=None):
    """The gradients of the SSD scan as ``csrc/ssd_backward.cu`` computes
    them, stage by stage: on the float32 path sigma, the power of two that
    brings max |dy|, |d_final| into [1/2, 1), scales the cotangents; C B^T and s = dy x^T
    once per causal tile pair (``tile`` rows), the row and column sums of
    M and of s (C.B) L a tile pair, G summed over groups of ``hpg`` heads;
    per head dx = w (B Sb) + (dt (C B^T o L))^T dy and the rows' parts of
    the decay gradient; the tile pairs' sums added in order in float64,
    the reverse prefix sum; dB and dC in parts of ``hpp`` heads and a part
    for G (summed over the groups in order), the parts added in order.
    Rows past S act as dt = 0 and their gradients are dropped.

    ``pieces`` None: everything in float64. "bf16" or "fp16": the kernel's
    numbers, each product's operands rounded to hi + lo pieces (bf16
    inputs of the "bf16" path as they are), the three pass products
    (lo x lo dropped) taken exactly and summed in float32, G times the
    power of two that brings its largest |value| into [2^13, 2^14), dx
    as dt (exp(cum_end - cum) B Sb + (C B^T o L)^T dy),
    the elementwise work in float32 (L below the diagonal tile as the
    product exp(cum_i - ref) exp(ref - cum_j), ref the cum of the j tile's
    last row) and the decay gradient's sums (the tile pairs' row and
    column sums too) in float64. Returns (dx, ddt, da, dB, dC, d_initial_state)."""
    f = torch.float64
    wt = f if pieces is None else torch.float32      # the working type
    f16, exact_in = pieces == "fp16", pieces == "bf16"
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    qt = -(-q // tile) * tile
    heads = range(h)

    def mm(u, v, u_in=False, v_in=False):
        """u @ v, as the tensor cores take it (u_in, v_in: the operand is
        an input, exact on the bf16 path)."""
        if pieces is None:
            return u.to(f) @ v.to(f)
        uh, ul = (u.double(), None) if u_in and exact_in else \
            _pieces(u, f16)
        vh, vl = (v.double(), None) if v_in and exact_in else \
            _pieces(v, f16)
        out = (uh @ vh).float()
        if ul is not None:
            out = out + (ul @ vh).float()
        if vl is not None:
            out = out + (uh @ vl).float()
        return out

    def chunked(t, c):                   # [B, S, ...] -> [B, qt, ...]
        part = t[:, c * q:min(s, (c + 1) * q)]
        return F.pad(part, (0, 0) * (t.dim() - 2)
                     + (0, qt - part.shape[1]))
    amax = dy.abs().max()
    if d_final is not None:
        amax = torch.maximum(amax, d_final.abs().max())
    e2 = int(torch.frexp(amax.float())[1]) \
        if f16 and 0 < float(amax) < np.inf else 0
    sig, inv = 2.0 ** -e2, 2.0 ** e2
    xs = [chunked(x, c).to(wt) for c in range(nc)]        # [B, qt, H, P]
    ys = [chunked(dy, c).to(wt) * sig for c in range(nc)]
    bs_ = [chunked(bm, c).to(wt) for c in range(nc)]      # [B, qt, N]
    cs_ = [chunked(cm, c).to(wt) for c in range(nc)]
    dts = [chunked(dt, c).to(wt) for c in range(nc)]      # [B, qt, H]
    rows = [min(q, s - c * q) for c in range(nc)]
    # 1. prefix sums in float64; the rows' weights in the working type
    cums = [torch.cumsum(d.to(f) * a.to(f), dim=1) for d in dts]
    cend = [cu[:, q - 1] for cu in cums]                   # [B, H]
    dend = [torch.exp((ce[:, None] - cu).to(wt)) for ce, cu in
            zip(cend, cums)]
    ws = [d * de for d, de in zip(dts, dend)]
    es = [torch.exp(cu.to(wt)) for cu in cums]
    # 3. each chunk's state term and gradient term, [B, H, N, P]
    st = [torch.stack([mm(bs_[c].transpose(1, 2),
                          ws[c][:, :, k, None] * xs[c][:, :, k], True)
                       for k in heads], 1) for c in range(nc)]
    sb = [torch.stack([mm(cs_[c].transpose(1, 2),
                          ys[c][:, :, k] * es[c][:, :, k, None], True)
                       for k in heads], 1) for c in range(nc)]
    # 4. the forward and the reverse recurrences
    s_in, s_bar = [None] * nc, [None] * nc
    run = torch.zeros(bsz, h, n, p, dtype=wt) if initial_state is None \
        else initial_state.to(wt)
    for c in range(nc):
        s_in[c] = run
        run = run * torch.exp(cend[c].to(wt))[..., None, None] + st[c]
    run = torch.zeros(bsz, h, n, p, dtype=wt) if d_final is None \
        else d_final.to(wt) * sig
    for c in reversed(range(nc)):
        s_bar[c] = run
        run = run * torch.exp(cend[c].to(wt))[..., None, None] + sb[c]
    d_init = run * inv
    dx = torch.zeros(bsz, nc * qt, h, p, dtype=wt)
    ddt = torch.zeros(bsz, nc * qt, h, dtype=f)
    db = torch.zeros(bsz, nc * qt, n, dtype=wt)
    dc = torch.zeros(bsz, nc * qt, n, dtype=wt)
    da = torch.zeros(h, dtype=f)
    for c in range(nc):
        ntr = -(-rows[c] // tile)
        cu = cums[c]
        # 5. per causal tile pair: C B^T once, then per head s = dy x^T
        xcb = torch.zeros(bsz, qt, qt, dtype=wt)           # [j][i]
        gparts = []
        rowm = torch.zeros(bsz, h, ntr, qt, dtype=f)
        colm = torch.zeros(bsz, h, ntr, qt, dtype=f)
        colt = torch.zeros(bsz, h, ntr, qt, dtype=f)
        for g0 in range(0, h, hpg):
            gp = torch.zeros(bsz, qt, qt, dtype=wt)
            for it in range(ntr):
                ri = slice(it * tile, (it + 1) * tile)
                for jt in range(it + 1):
                    rj = slice(jt * tile, (jt + 1) * tile)
                    cb = mm(cs_[c][:, ri], bs_[c][:, rj].transpose(1, 2),
                            True, True)                    # [B, i, j]
                    xcb[:, rj, ri] = cb.transpose(1, 2)
                    low = torch.ones(tile, tile, dtype=torch.bool)
                    if it == jt:
                        low = low.tril()
                    gacc = torch.zeros(bsz, tile, tile, dtype=wt)
                    for k in range(g0, min(h, g0 + hpg)):
                        sv = mm(ys[c][:, ri, k],
                                xs[c][:, rj, k].transpose(1, 2), False, True)
                        diff = cu[:, ri, k, None] - cu[:, None, rj, k]
                        lv = torch.where(low, torch.exp(
                            torch.where(low, diff, 0.0).to(wt)), 0.0)
                        if it > jt:     # exp(cum_i - ref) exp(ref - cum_j)
                            ref = cu[:, rj, k][:, -1, None]
                            lv = torch.exp((cu[:, ri, k] - ref).to(wt))[
                                ..., None] * torch.exp(
                                (ref - cu[:, rj, k]).to(wt))[:, None, :]
                        sl = sv * lv
                        tt = sl * cb
                        m = tt * dts[c][:, None, rj, k]
                        rowm[:, k, jt, ri] = m.to(f).sum(-1)
                        colm[:, k, it, rj] = m.to(f).sum(-2)
                        colt[:, k, it, rj] = tt.to(f).sum(-2)
                        gacc = gacc + sl * dts[c][:, None, rj, k]
                    gp[:, ri, rj] = gacc
            gparts.append(gp)
        # 6. per head: dx and the rows' parts of the decay gradient
        r = torch.arange(qt)
        causal = r[None, :] >= r[:, None]                  # [j, i]: i >= j
        hrow = torch.zeros(3, bsz, qt, h, dtype=f)
        dot = torch.zeros(bsz, h, dtype=f)
        for k in heads:
            bsb = mm(bs_[c], s_bar[c][:, k], True)         # [B, qt, P]
            u = (bsb * xs[c][:, :, k]).sum(-1)             # [B, qt]
            diff = cu[:, None, :, k] - cu[:, :, None, k]   # cum_i - cum_j
            lv = torch.where(causal, torch.exp(
                torch.where(causal, diff, 0.0).to(wt)), 0.0)
            amat = xcb * lv                                # [B, j, i]
            acc = dend[c][:, :, k, None] * bsb + mm(amat, ys[c][:, :, k])
            dx[:, c * qt:(c + 1) * qt, k] = dts[c][:, :, k, None] * acc * inv
            csc = mm(cs_[c], s_in[c][:, k], True)
            v = (csc * ys[c][:, :, k]).sum(-1)
            wu = ws[c][:, :, k].to(f) * u.to(f)
            hrow[0, :, :, k] = es[c][:, :, k].to(f) * v.to(f) - wu
            hrow[1, :, :, k] = dend[c][:, :, k].to(f) * u.to(f)
            hrow[2, :, :, k] = wu
            dot[:, k] = (s_bar[c][:, k].to(f) * s_in[c][:, k].to(f)).sum(
                (-1, -2)) * torch.exp(cend[c][:, k].to(wt)).to(f)
        # 7. the decay gradient: the tile pairs' sums in order, in float64
        valid = (r < rows[c]).to(f)[None, :, None]
        dcum = hrow[0] * valid
        dd = hrow[1] * valid
        for i in range(rows[c]):
            ti = i // tile
            for jt in range(ti + 1):
                dcum[:, i] += rowm[:, :, jt, i].to(f)
            for it in range(ti, ntr):
                dcum[:, i] -= colm[:, :, it, i].to(f)
                dd[:, i] += colt[:, :, it, i].to(f)
        dcum[:, q - 1] += (hrow[2] * valid).sum(1) + dot
        dda = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt[:, c * qt:(c + 1) * qt] = (dd + a.to(f) * dda) * inv
        da = da + (dda * dts[c].to(f) * valid).sum((0, 1))
        # 8., 9. dB and dC: parts of hpp heads, then the G part
        g = gparts[0]
        for gp in gparts[1:]:
            g = g + gp
        gmax = float(g.abs().max())
        ge = int(np.frexp(gmax)[1]) if 0 < gmax < np.inf else 0
        gscale = 2.0 ** (14 - ge) if pieces is not None else 1.0
        gs = g * gscale
        for out, parts, gterm in (
                (db, [mm(ws[c][:, :, k, None] * xs[c][:, :, k],
                         s_bar[c][:, k].transpose(1, 2)) for k in heads],
                 mm(gs.transpose(1, 2), cs_[c], False, True)),
                (dc, [mm(ys[c][:, :, k] * es[c][:, :, k, None],
                         s_in[c][:, k].transpose(1, 2)) for k in heads],
                 mm(gs, bs_[c], False, True))):
            tot = torch.zeros(bsz, qt, n, dtype=wt)
            for k0 in range(0, h, hpp):
                part = parts[k0]
                for k in range(k0 + 1, min(h, k0 + hpp)):
                    part = part + parts[k]
                tot = tot + part
            out[:, c * qt:(c + 1) * qt] = (tot + gterm / gscale) * inv
    da = da * inv

    def cut(v):
        return torch.cat([v[:, c * qt:c * qt + rows[c]] for c in range(nc)],
                         1)
    return cut(dx), cut(ddt), da, cut(db), cut(dc), d_init


@pytest.mark.parametrize("final", (False, True), ids=("y", "y_final"))
@pytest.mark.parametrize("initial", (False, True), ids=("zero", "init"))
@pytest.mark.parametrize("s", (1, SSD_Q + 1, 3 * SSD_Q + 5))
def test_ssd_backward_stages_match_autograd(s, initial, final):
    """The backward kernel's stages against autograd: float64 through the
    port's ``ssd_chunked`` (``ssd_backward_ref``), and ``jax.vjp`` of the
    reference's float32 scan."""
    from repro_torch.kernels.ssd import ssd_backward_ref
    case, init = _ssd_case(s, seed=s + 100 * initial + 7, initial=initial)
    rng = np.random.default_rng(s)
    b, _, h, p = case[0].shape
    n = case[3].shape[-1]
    dy = rng.normal(size=case[0].shape).astype(np.float32)
    dfin = rng.normal(size=(b, h, n, p)).astype(np.float32) if final \
        else None
    t64 = [torch.as_tensor(v).double() for v in case]
    opt = dict(chunk=SSD_Q,
               initial_state=None if init is None
               else torch.as_tensor(init).double(),
               d_final=None if dfin is None else torch.as_tensor(dfin))
    # tiles of 4 rows (two a chunk) and groups and parts of two heads of
    # three, so that the tile pairs' and the groups' sums are exercised
    staged = ssd_backward_staged_ref(*t64, torch.as_tensor(dy), tile=4,
                                     hpg=2, hpp=2, **opt)
    truth = ssd_backward_ref(*t64, torch.as_tensor(dy).double(), **opt)
    init_j = jnp.zeros((b, h, n, p)) if init is None else jnp.asarray(init)
    _, vjp = jax.vjp(lambda *v: ref_ssd(*v[:5], chunk=SSD_Q,
                                        initial_state=v[5]),
                     *(jnp.asarray(v) for v in case), init_j)
    ref = vjp((jnp.asarray(dy), jnp.zeros((b, h, n, p)) if dfin is None
               else jnp.asarray(dfin)))
    for name, got, want, r in zip(("dx", "ddt", "da", "db", "dc", "dinit"),
                                  staged, truth, ref):
        scale = float(want.abs().max()) or 1.0
        assert float((got - want).abs().max()) <= 1e-10 * scale, name
        assert float((got - torch.as_tensor(np.asarray(r)).double())
                     .abs().max()) <= 1e-4 * scale, name


# the split-piece mirror's inputs: mamba2-780m's chunk and widths at four
# heads, two chunks (the second of one row), mamba2's decay rates (a from
# -1 to -16, dt = softplus(normal)), cotangents of the card tests' size
# (~1) or of a train step's (~1e-5); with these (seed 1) float32 sums of
# the tile pairs' rows and columns leave da 3.4e-4 of its largest off
SSD_PIECES_SHAPE = (1, 257, 4, 64, 128, 256)


@pytest.mark.parametrize("states", (False, True), ids=("zero", "init_final"))
@pytest.mark.parametrize("dy_scale", (1.0, 1e-5), ids=("dy1", "dy1e-5"))
@pytest.mark.parametrize("path", ("fp16", "bf16"))
def test_ssd_backward_pieces_within_tolerance(path, dy_scale, states):
    """The kernel's numbers (``pieces``: split operands, three passes,
    float32 sums, sigma and G's scale, float64 tile sums) against float64
    autograd of the same inputs (bf16-rounded x, B and C on the bf16
    path), without or with an initial state and a final-state cotangent:
    every float32 output within ``SSD_BWD_TOL`` of its largest |value|,
    bf16 outputs (dx, dB and dC of the bf16 path, rounded to bf16 as the
    kernel stores them) within ``SSD_BWD_TOL_BF16``."""
    from repro_torch.kernels.ssd import ssd_backward_ref
    b, s, h, p, n, chunk = SSD_PIECES_SHAPE
    rng = np.random.default_rng(1)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
    x = normal(b, s, h, p)
    dt = F.softplus(normal(b, s, h))
    a = -torch.linspace(1.0, 16.0, h)
    bm, cm = normal(b, s, n), normal(b, s, n)
    init = normal(b, h, n, p) if states else None
    dy = normal(b, s, h, p) * dy_scale
    dfin = normal(b, h, n, p) * dy_scale if states else None
    if path == "bf16":
        x, bm, cm = (t.to(torch.bfloat16).float() for t in (x, bm, cm))
    plan = backward_plan(b, s, h, p, n, chunk, 132)
    opt = dict(chunk=chunk, initial_state=init, d_final=dfin)
    got = ssd_backward_staged_ref(x, dt, a, bm, cm, dy, hpg=plan.hpg,
                                  hpp=plan.hpp, pieces=path, **opt)
    truth = ssd_backward_ref(
        *(t.double() for t in (x, dt, a, bm, cm, dy)), chunk=chunk,
        initial_state=None if init is None else init.double(),
        d_final=None if dfin is None else dfin.double())
    for name, g, want in zip(("dx", "ddt", "da", "db", "dc", "dinit"), got,
                             truth):
        tol = SSD_BWD_TOL
        if path == "bf16" and name in ("dx", "db", "dc"):
            g, tol = g.to(torch.bfloat16), SSD_BWD_TOL_BF16
        err = float((g.double() - want).abs().max())
        assert torch.isfinite(g).all() and \
            err <= tol * float(want.abs().max()), (name, err)


def test_backward_plan_fills_the_card():
    """The backward's grid on 132 SMs: at mamba2-780m's layer (B = 4,
    S = 640) and at B = 1, S = 513 every stage that multiplies has at least
    one block with work a SM, at the layer two (264); the s stage's groups
    and the dB/dC stage's parts cover the heads; the smallest shapes of the
    card tests get a valid plan. (The stages' shared memory is the
    library's, held to the card in ``tests/test_torch_cuda.py``.)"""
    for shape, least in (((4, 640, 48, 64, 128, 256), 2 * 132),
                         ((1, 513, 48, 64, 128, 256), 132)):
        plan = backward_plan(*shape, 132)
        assert min(plan.ctas.values()) >= least, (shape, plan)
    # the layer: groups and parts of six heads, 736 and 720 blocks in three
    # waves of two a SM (16 heads a block would leave 276 and 320, two
    # waves with a second of a few blocks)
    plan = backward_plan(4, 640, 48, 64, 128, 256, 132)
    assert (plan.hpg, plan.hpp) == (6, 6)
    assert plan.ctas == {"outer": 1152, "sg": 736, "head": 1152, "bc": 720}
    assert backward_plan(1, 513, 48, 64, 128, 256, 132).ctas["sg"] == 168
    # long prompts: twelve heads a group, one part (the partials' bytes)
    plan = backward_plan(4, 4096, 48, 64, 128, 256, 132)
    assert (plan.hpg, plan.hpp) == (12, 48)
    for b, s, h, p, n, chunk in ((2, 80, 3, 16, 16, 32), (1, 40, 2, 5, 7, 16),
                                 (2, 7, 2, 3, 4, 32), (1, 257, 4, 64, 128,
                                                       256)):
        q = min(chunk, s)
        plan = backward_plan(b, s, h, p, n, q, 132)
        assert 1 <= plan.hpg <= h and 1 <= plan.hpp <= h
        # every (b, chunk, head) of the head stage has a block with work
        assert plan.ctas["head"] >= b * h * -(-s // q)
        assert all(v >= 1 for v in plan.ctas.values())
    assert BWD_TILE == 64


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


# ---------------------------------------------------------------------------
# the beam walk
# ---------------------------------------------------------------------------

H100_SMS = 132


def beam_search_staged_ref(data, bottom, queries, entries, *, metric, ef,
                           max_iters, scale=None, zero=None, plan=None):
    """The walk of ``csrc/beam_search.cu``, one (graph, slot) row at a
    time in float32 numpy, under the block layout ``plan`` (by default
    ``walk_plan``'s for these shapes on an H100). Returns (scores [S, C,
    ef'], nodes [S, C, ef'] int32), (-inf, -1) padded."""
    data, bottom = np.asarray(data), np.asarray(bottom)
    queries, entries = np.asarray(queries, np.float32), np.asarray(entries)
    s, n, d = data.shape
    m0, c = bottom.shape[2], queries.shape[1]
    efp = min(ef, n)
    if plan is None:
        plan = walk_plan(s * c, n, d, efp, m0, scale is not None, H100_SMS)
    out_s = np.full((s, c, efp), -np.inf, np.float32)
    out_i = np.full((s, c, efp), -1, np.int32)
    for g in range(s):
        for slot in range(c):
            entry = int(entries[g, slot])
            if entry < 0:                       # an empty slot: not walked
                continue
            q = queries[g, slot]
            qn = np.float32(np.dot(q, q))

            def score(nodes):
                # staging passes: stage_rows rows x slice_cols columns,
                # the slices' partial sums added in slice order
                dot = np.zeros(len(nodes), np.float32)
                nrm = np.zeros(len(nodes), np.float32)
                for r0 in range(0, len(nodes), plan.stage_rows):
                    rows = nodes[r0:r0 + plan.stage_rows]
                    cut = slice(r0, r0 + len(rows))
                    for c0 in range(0, d, plan.slice_cols):
                        cols = slice(c0, c0 + plan.slice_cols)
                        x = data[g, rows, cols].astype(np.float32)
                        if scale is not None:
                            x = x * scale[cols] + zero[cols]
                        dot[cut] += x @ q[cols]
                        nrm[cut] += np.sum(x * x, axis=1)
                if metric == "l2":
                    return (np.float32(2.0) * dot - qn) - nrm
                if metric == "ip":
                    return dot
                return dot / ((np.sqrt(qn) + np.float32(1e-12))
                              * (np.sqrt(nrm) + np.float32(1e-12)))

            bs = np.full(efp, -np.inf, np.float32)
            bi = np.full(efp, -1, np.int32)
            be = np.zeros(efp, bool)
            vis = np.zeros(n, bool)
            vis[entry] = True
            bs[0], bi[0] = score(np.asarray([entry]))[0], entry
            cnt, ptr = 1, 0         # live entries; all below ptr expanded
            for _ in range(max_iters):
                live = np.flatnonzero(~be[ptr:cnt])
                if live.size == 0:
                    break
                sel = ptr + int(live[0])
                be[sel] = True
                ptr = sel + 1
                nbrs = bottom[g, bi[sel]]
                real = nbrs[nbrs >= 0]
                fresh = real[~vis[real]]        # tested before the marks
                vis[real] = True
                if fresh.size == 0:
                    continue
                sims = score(fresh)
                for b0 in range(0, fresh.size, 32):
                    full = cnt == efp
                    batch = range(b0, min(b0 + 32, fresh.size))
                    surv = [j for j in batch
                            if not full or sims[j] > bs[efp - 1]]
                    if not surv:
                        continue
                    order = sorted(surv, key=lambda j: (-sims[j], j))
                    new_s = sims[order]
                    # a survivor lands at its rank + #(beam >= its score)
                    pos = [t + int(np.count_nonzero(bs[:cnt] >= v))
                           for t, v in enumerate(new_s)]
                    # entries behind the first insertion point move from
                    # the back, each by the survivors that beat it
                    for i in range(cnt - 1, pos[0] - 1, -1):
                        dst = i + int(np.count_nonzero(new_s > bs[i]))
                        if dst < efp:
                            bs[dst], bi[dst], be[dst] = bs[i], bi[i], be[i]
                    for t, j in enumerate(order):
                        if pos[t] < efp:
                            bs[pos[t]], bi[pos[t]] = sims[j], fresh[j]
                            be[pos[t]] = False
                    cnt = min(efp, cnt + len(order))
                    ptr = min(ptr, pos[0])
            out_s[g, slot], out_i[g, slot] = bs, bi
    return out_s, out_i


def test_walk_plan_fills_the_card():
    """On 132 SMs: four warps a walk for an engine batch of 16 and for 528
    walks, two for the routing walk's 1,024, one for 2,112 (more warps
    would hold fewer walks an SM), two for 4,096 float32 walks over
    65,536-row graphs (shared memory holds 8 an SM either way), one for
    int8 rows; every row of an expansion staged at once at d = 128 (M0 =
    32 float32 rows are 16 KB), a quarter of them a pass for ef = 800;
    at the kNN-LM widths every row at once where there are no more walks
    than SMs, else slices of d in two buffers; the visited bitmask in
    shared memory up to n = 786,432."""
    assert walk_plan(16, 3125, 128, 100, 32, False, 132) == WalkPlan(
        4, 32, 128, 1, True, layout_bytes(128, 100, 32, 98, True, False, 32,
                                          128, 1))
    assert walk_plan(528, 1000, 128, 64, 32, False, 132).warps == 4
    assert walk_plan(1024, 1000, 128, 64, 32, False, 132).warps == 2
    assert walk_plan(2112, 1000, 128, 64, 32, False, 132).warps == 1
    assert walk_plan(4096, 65_536, 128, 100, 32, True, 132).warps == 1
    plan = walk_plan(4096, 65_536, 128, 100, 32, False, 132)
    assert plan.warps == 2 and resident_blocks(plan.smem_bytes, 1) == 8
    plan = walk_plan(8192, 16_384, 128, 800, 32, False, 132)
    assert (plan.warps, plan.stage_rows, plan.stage_buffers) == (1, 8, 1)
    plan = walk_plan(8, 2386, 2048, 60, 24, False, 132)
    assert (plan.stage_rows, plan.slice_cols, plan.stage_buffers) == (
        24, 2048, 1)
    assert plan.smem_bytes == layout_bytes(2048, 60, 24, 75, True, False,
                                           24, 2048, 1)
    plan = walk_plan(133, 2386, 2048, 60, 24, False, 132)
    assert (plan.stage_rows, plan.slice_cols, plan.stage_buffers) == (
        24, 320, 2)
    assert plan.smem_bytes == layout_bytes(2048, 60, 24, 75, True, False,
                                           24, 320, 2)
    assert walk_plan(32, 1024, 1536, 60, 24, False, 132).slice_cols == 1536
    assert walk_plan(256, 2000, 1536, 60, 24, False, 132).slice_cols == 320
    assert walk_plan(256, 2000, 2048, 60, 24, True, 132).slice_cols == 1344
    # 32 float32 rows of d = 2,048 (256 KB) fit no block: slices
    assert walk_plan(8, 2000, 2048, 60, 32, False, 132).slice_cols == 512
    assert walk_plan(1, 786_432, 16, 64, 16, False, 132).vis_shared
    assert not walk_plan(1, 786_433, 16, 64, 16, False, 132).vis_shared
    with pytest.raises(ValueError, match="M0"):
        walk_plan(1, 100, 16, 10, MAX_M0 + 1, False, 132)


def test_walk_plan_shrinks_staging_to_fit():
    """A beam of 20,000 entries and an 8,000-node bitmask leave too little
    room for 32 rows of d = 4,096: slices, then rows, are halved until the
    block fits."""
    plan = walk_plan(64, 256_000, 4096, 20_000, 32, False, 132)
    assert plan.smem_bytes <= SMEM_MAX_BYTES
    assert plan.slice_cols % 64 == 0 and plan.slice_cols < 4096
    for walks, n, d, efp, m0, qz in ((1, 10, 13, 10, 4, False),
                                     (4096, 65_536, 128, 800, 48, True),
                                     (8, 500_000, 2048, 800, 64, False)):
        p = walk_plan(walks, n, d, efp, m0, qz, 132)
        assert p.smem_bytes <= SMEM_MAX_BYTES
        assert p.slice_cols == d or p.slice_cols % 64 == 0
        assert 1 <= p.stage_rows <= m0


@pytest.mark.parametrize("walks", (8, 16, 133, 4096))
@pytest.mark.parametrize("quantized", (False, True))
def test_walk_plan_slices_the_gemma3_datastore(walks, quantized):
    """gemma3-12b's kNN-LM keys (d = 3,840, M0 = 24, ef = 60; a shard of
    at most 464 of 1,400 keys): 24 float32 rows of 3,840 (360 KB) fit no
    block, so the plan stages slices of d, multiples of 64 columns, and
    does not raise; int8 rows (90 KB) stage whole while there are no more
    walks than SMs."""
    plan = walk_plan(walks, 464, 3840, 60, 24, quantized, 132)
    assert plan.smem_bytes <= SMEM_MAX_BYTES
    assert 1 <= plan.stage_rows <= 24
    if quantized and walks <= 132:
        assert plan.slice_cols == 3840
    else:
        assert plan.slice_cols % 64 == 0 and plan.slice_cols < 3840
        assert plan.stage_buffers == 2


def _walk_case(s, n, d, c, m0, seed, quantized=False, grid=False):
    rng = np.random.default_rng(seed)
    if grid:
        x = rng.integers(-8, 9, size=(s, n, d)).astype(np.float32)
        q = rng.integers(-8, 9, size=(s, c, d)).astype(np.float32)
    else:
        x = rng.normal(size=(s, n, d)).astype(np.float32)
        q = rng.normal(size=(s, c, d)).astype(np.float32)
    bottom = rng.integers(-1, n, size=(s, n, m0)).astype(np.int32)
    entries = rng.integers(0, n, size=(s, c)).astype(np.int32)
    scale = zero = None
    if quantized:
        params = QuantParams.from_data(x.reshape(s * n, d))
        x = np.stack([params.quantize(x[i]) for i in range(s)])
        scale, zero = params.scale, params.zero
    return x, bottom, q, entries, scale, zero


def _against_reference(case, plan=None, **kw):
    x, b, q, e, sc, zr = case
    s_m, i_m = beam_search_staged_ref(x, b, q, e, scale=sc, zero=zr,
                                      plan=plan, **kw)
    j = jnp.asarray
    sz = {} if sc is None else dict(scale=j(sc), zero=j(zr))
    s_r, i_r = ref_beam(j(x), j(b), j(q), j(e), **kw, **sz)
    np.testing.assert_array_equal(i_m, np.asarray(i_r))
    np.testing.assert_allclose(s_m, np.asarray(s_r), **_topk_tol(kw["metric"]))
    return s_m, i_m


def _against_numpy_twin(case, **kw):
    x, b, q, e, sc, zr = case
    s_m, i_m = beam_search_staged_ref(x, b, q, e, scale=sc, zero=zr, **kw)
    s_n, i_n = ref_beam_np(x, b, q, e, scale=sc, zero=zr, **kw)
    np.testing.assert_array_equal(i_m, i_n)
    np.testing.assert_allclose(s_m, s_n, **_topk_tol(kw["metric"]))
    return s_m, i_m


@pytest.mark.parametrize("plan", (None, (1, 2, 16), (4, 3, 8)),
                         ids=("walk_plan", "rows2_cols16", "rows3_cols8"))
@pytest.mark.parametrize("quantized", (False, True), ids=("f32", "int8"))
@pytest.mark.parametrize("metric", ("l2", "ip", "angular"))
def test_staged_walk_matches_reference(metric, quantized, plan):
    """Random rows, d = 40 (a ragged last slice under the small plans)."""
    case = _walk_case(2, 80, 40, 5, 6, seed=3, quantized=quantized)
    if plan is not None:
        plan = WalkPlan(plan[0], plan[1], plan[2], 2, True, 0)
    _against_reference(case, plan, metric=metric, ef=12, max_iters=400)


@pytest.mark.parametrize("walks,cols", ((3, 2048), (4 * H100_SMS, 1024)))
def test_staged_walk_at_the_kv_width(walks, cols):
    """d = 2,048, the qwen3 datastore's keys: 3 walks stage every row at
    once; a launch of more walks than SMs has 32 KB for 4 rows of M0 = 8,
    so the plan stages slices of 1,024 columns (two buffers)."""
    case = _walk_case(1, 40, 2048, 3, 8, seed=5)
    plan = walk_plan(walks, 40, 2048, 16, 8, False, H100_SMS)
    assert plan.slice_cols == cols
    _against_reference(case, plan, metric="l2", ef=16, max_iters=400)


def test_staged_walk_with_a_large_beam():
    """ef = 600: the plan stages a quarter of an expansion's rows a pass;
    the beam holds hundreds of entries, so survivors land deep in it."""
    case = _walk_case(1, 700, 8, 2, 8, seed=13)
    plan = walk_plan(2, 700, 8, 600, 8, False, H100_SMS)
    assert (plan.stage_rows, plan.stage_buffers) == (2, 1)
    s_m, _ = _against_reference(case, metric="l2", ef=600, max_iters=400)
    assert (np.isfinite(s_m).sum(axis=-1) >= 300).all()


@pytest.mark.parametrize("max_iters,ef", ((0, 6), (1, 6), (3, 6), (400, 64)))
def test_staged_walk_iteration_bound_and_ef_above_n(max_iters, ef):
    """The max_iters cut-off, and ef = 64 above n = 30 (ef' = n)."""
    case = _walk_case(2, 30, 5, 4, 4, seed=23, grid=True)
    s_m, _ = _against_numpy_twin(case, metric="l2", ef=ef,
                                 max_iters=max_iters)
    assert s_m.shape[-1] == min(ef, 30)
    _against_reference(_walk_case(2, 30, 5, 4, 4, seed=24), metric="ip",
                       ef=ef, max_iters=max_iters)


def test_staged_walk_ties_and_duplicate_slots():
    """All rows identical (every score ties: the old beam, then slot
    order), and adjacency rows that list a node twice (it is a candidate
    twice, as the visited test precedes the marks)."""
    n = 8
    x = np.ones((1, n, 4), np.float32)
    bottom = np.random.default_rng(5).integers(
        -1, n, size=(1, n, 3)).astype(np.int32)
    case = (x, bottom, np.ones((1, 4, 4), np.float32),
            np.array([[0, 3, 5, 7]], np.int32), None, None)
    _against_numpy_twin(case, metric="l2", ef=5, max_iters=400)
    bottom = np.full((1, 6, 4), -1, np.int32)
    for i in range(6):
        bottom[0, i] = [(i + 1) % 6, (i + 1) % 6, (i + 2) % 6, -1]
    x = np.arange(6, dtype=np.float32)[None, :, None] * np.ones(
        (1, 6, 3), np.float32)
    case = (x, bottom, np.full((1, 2, 3), 2.0, np.float32),
            np.array([[0, 3]], np.int32), None, None)
    _, i_m = _against_numpy_twin(case, metric="l2", ef=4, max_iters=400)
    assert any(len(set(r[r >= 0])) < (r >= 0).sum() for r in i_m[0])


def test_staged_walk_grid_ties_over_many_batches():
    """Integer rows with M0 = 48 (two candidate batches an expansion):
    exact scores, many ties, held against the numpy twin."""
    case = _walk_case(2, 200, 6, 4, 48, seed=31, grid=True)
    _against_numpy_twin(case, metric="l2", ef=24, max_iters=400)


def test_staged_walk_pinned_signed_zero_case_matches_numpy_twin():
    """The reference's three-way property case (2, 19, 1, 1, 3, 1, 1,
    'ip'): every score of shard 0 is +-0; -0.0 == +0.0, lowest position
    wins, as in the numpy twin."""
    rng = np.random.default_rng(1)
    x = rng.integers(-8, 9, size=(2, 19, 1)).astype(np.float32)
    bottom = rng.integers(-1, 19, size=(2, 19, 3)).astype(np.int32)
    q = rng.integers(-8, 9, size=(2, 1, 1)).astype(np.float32)
    e = rng.integers(0, 19, size=(2, 1)).astype(np.int32)
    _against_numpy_twin((x, bottom, q, e, None, None), metric="ip", ef=1,
                        max_iters=400)


def test_staged_walk_leaves_empty_slots():
    """Entry -1 slots come back (-inf, -1); the other slots answer as the
    reference does without them; the port's plain walk agrees."""
    x, b, q, e, _, _ = _walk_case(2, 60, 8, 6, 6, seed=9)
    e_gap = e.copy()
    e_gap[:, 1::2] = -1
    s_m, i_m = beam_search_staged_ref(x, b, q, e_gap, metric="l2", ef=10,
                                      max_iters=400)
    assert (i_m[:, 1::2] == -1).all() and np.isneginf(s_m[:, 1::2]).all()
    s_r, i_r = ref_beam(jnp.asarray(x), jnp.asarray(b), jnp.asarray(q),
                        jnp.asarray(e), metric="l2", ef=10, max_iters=400)
    np.testing.assert_array_equal(i_m[:, ::2], np.asarray(i_r)[:, ::2])
    np.testing.assert_allclose(s_m[:, ::2], np.asarray(s_r)[:, ::2],
                               **_topk_tol("l2"))
    t = torch.as_tensor
    s_p, i_p = beam_search(t(x), t(b), t(q), t(e_gap), metric="l2", ef=10,
                           max_iters=400)
    np.testing.assert_array_equal(i_p.numpy(), i_m)
    np.testing.assert_allclose(s_p.numpy(), s_m, **_topk_tol("l2"))
