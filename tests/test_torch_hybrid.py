"""The port's weight-tied shared attention (zamba2-7b's hybrid stack)
against the JAX package, on the CPU.

``.reduced()`` sets two layers, which for zamba2's pattern (five Mamba2
layers, then the shared block) are two Mamba2 layers and no shared
block, so both packages' configs are cut to twelve layers here: ten
Mamba2 layers and two invocations of the one shared attention + MLP
block (d_model 128, 4 heads over 4, hd 32, SSM N 16, chunk 32, float32).
The reference initialises the parameters and
``convert.lm_params_from_reference`` carries them across; inputs come
from numpy seeds.

Tolerances. Layer by layer, each layer of the plan fed the reference's
own input to it: outputs, prefill caches (each shared slot's K and V,
each Mamba2 state) and decoded rows within 1e-5 of their largest |value|,
the parameter and input gradients of each layer (the reference's output
cotangent given) within 1e-4 of their largest (float32, sums in another
order). End to end, ten random Mamba2 layers amplify that rounding from
layer to layer, as the port's mamba2 tests and ``chip_smoke.py``'s
float32 checks record (a pure ten-layer mamba2 stack parts by 6.1e-4 in
its logits, a single layer by 2e-5 of 3.6): logits and decode logits
within 1e-3 (``chip_smoke.py``'s LM_LOGITS_ATOL), caches within 1e-3 of
their largest, the train step's first moments within 2e-3 of each
leaf's largest, its loss within 1e-4; greedy, batcher and stream-engine
tokens equal. The shared block's gradient is the sum over its two
invocations (checked against two untied copies).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as ref_get_arch
from repro.data import synthetic as RD
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serving import batcher as RB
from repro.serving import decode as RDec
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import convert
from repro_torch.common.registry import get_arch
from repro_torch.models import transformer as TT
from repro_torch.serving import batcher as TB
from repro_torch.serving import decode as TDec
from repro_torch.serving.stream import StreamEngine
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.train import tree as TTree

ARCH = "zamba2-7b"
LAYERS = 12
CPU = dict(device="cpu")
TOL = dict(rtol=0, atol=1e-3)
LAYER_TOL = 1e-5
LAYER_GRAD_TOL = 1e-4
REF_OPT = dict(lr=5e-3, warmup_steps=5, total_steps=120, weight_decay=0.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _model():
    rcfg = dataclasses.replace(ref_get_arch(ARCH).reduced(),
                               num_layers=LAYERS)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), num_layers=LAYERS)
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, rparams, cfg


def _params() -> dict:
    _, rparams, cfg = _model()
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, **CPU)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _close_rel(ours, ref, rel):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(ours.detach().double()) - ref).max())
    assert err <= rel * scale, (err, scale)


def _layers(pkg, cfg):
    """(segment, j) of each layer of the plan, in order."""
    return [(seg, j) for seg in pkg.build_plan(cfg)[0]
            for j in range(seg.length)]


def _ref_layer_params(rparams, seg, j):
    blocks = rparams["blocks"][seg.group]
    if seg.group == "shared_attention":
        return blocks
    return jax.tree.map(lambda a: a[seg.start + j], blocks)


def _run_layer(pkg, p, cfg, seg, x, state=None, pos=None,
               build_cache=False):
    """One layer of either package: (output, its state or K/V). Prefill
    (``state`` None) over x's rows, else a decode row at ``pos``."""
    if seg.group == "mamba2":
        return pkg._mamba_layer_fwd(p, cfg, x, state,
                                    decode=state is not None)
    positions = None
    if state is None:
        positions = (jnp.arange(x.shape[1]) if pkg is RT else
                     torch.arange(x.shape[1]))[None]
    out, _, kv = pkg._attn_layer_fwd(p, cfg, x, positions, seg.spec,
                                     kv=state, pos=pos,
                                     build_cache=build_cache)
    return out, kv


@functools.lru_cache(maxsize=None)
def _ref_layer_fn(group: str, mode: str):
    """A reference layer of ``group`` under ``jax.jit`` (one compile a
    group and mode): "full" and "prefill" (p, x), "decode" (p, x, state,
    pos), "vjp" (p, x, cotangent) -> (dp, dx)."""
    rcfg = _model()[0]
    seg = next(s for s in RT.build_plan(rcfg)[0] if s.group == group)
    if mode == "vjp":
        def fn(p, x, g):
            return jax.vjp(lambda pp, xx: _run_layer(RT, pp, rcfg, seg,
                                                     xx)[0], p, x)[1](g)
    elif mode == "decode":
        def fn(p, x, state, pos):
            return _run_layer(RT, p, rcfg, seg, x, state, pos)
    else:
        def fn(p, x):
            return _run_layer(RT, p, rcfg, seg, x,
                              build_cache=mode == "prefill")
    return jax.jit(fn)


def test_plan_and_cache_slots_match_reference():
    rcfg, _, cfg = _model()
    ref_segs, ref_slots = RT.build_plan(rcfg)
    segs, slots = TT.build_plan(cfg)
    assert slots == ref_slots == {"mamba2": 10, "shared_attention": 2}
    assert [(s.group, s.start, s.length, s.cache_start, s.cache_group,
             None if s.spec is None else dataclasses.astuple(s.spec))
            for s in segs] == \
        [(s.group, s.start, s.length, s.cache_start, s.cache_group,
          None if s.spec is None else dataclasses.astuple(s.spec))
         for s in ref_segs]
    shared = [s for s in segs if s.group == "shared_attention"]
    assert [(s.start, s.cache_start) for s in shared] == [(0, 0), (0, 1)]


def test_param_tree_matches_reference():
    """Keys and shapes equal, the shared block one unstacked block; the
    reference's values carried over bit for bit."""
    _, rparams, cfg = _model()
    ours = TT.init_params(cfg, torch.Generator().manual_seed(1), **CPU)
    want = jax.tree.map(lambda a: tuple(a.shape), rparams)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == want
    assert set(ours["blocks"]) == {"mamba2", "shared_attention"}
    shared = ours["blocks"]["shared_attention"]
    d, f = cfg.d_model, cfg.d_ff
    assert shared["norm_attn"].shape == (d,)
    assert shared["w_gate"].shape == (d, f)
    assert shared["w_q"].shape == (d, cfg.num_heads * cfg.resolved_head_dim)
    assert abs(float(shared["w_in"].std()) * d ** 0.5 - 1.0) < 0.05
    assert ours["blocks"]["mamba2"]["in_proj"].shape[0] == 10
    carried = _params()
    for key, t in TTree.items(carried):
        ref = dict(TTree.items(jax.tree.map(np.asarray, rparams)))[key]
        assert np.array_equal(t.numpy(), np.asarray(ref)), key


def test_layers_match_reference():
    """Each layer of the plan, shared invocations and Mamba2 layers, fed
    the reference's input to it: the full sequence, the prompt's prefill
    (output and cache) and the decode of the remaining rows one at a
    time from each side's own prefill cache."""
    rcfg, rparams, cfg = _model()
    params = _params()
    seq = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 44))
    plen = 37                              # a chunk of 32 and a part
    x = np.asarray(rparams["embedding"])[seq]
    groups = []
    for (rseg, j), (tseg, _) in zip(_layers(RT, rcfg), _layers(TT, cfg)):
        rp = _ref_layer_params(rparams, rseg, j)
        tp = TT._layer_params(params["blocks"][tseg.group], tseg, j)
        full_r, _ = _ref_layer_fn(rseg.group, "full")(rp, jnp.asarray(x))
        full_t, _ = _run_layer(TT, tp, cfg, tseg, torch.as_tensor(x))
        _close_rel(full_t, full_r, LAYER_TOL)
        pre_r, st_r = _ref_layer_fn(rseg.group, "prefill")(
            rp, jnp.asarray(x[:, :plen]))
        pre_t, st_t = _run_layer(TT, tp, cfg, tseg,
                                 torch.as_tensor(x[:, :plen]),
                                 build_cache=True)
        _close_rel(pre_t, pre_r, LAYER_TOL)
        assert set(st_t) == set(st_r)
        for name in st_r:
            _close_rel(st_t[name], st_r[name], LAYER_TOL)
        if tseg.group == "shared_attention":     # slots of 44 rows
            pad = seq.shape[1] - plen
            st_r = {k: jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
                    for k, v in st_r.items()}
            st_t = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
                    for k, v in st_t.items()}
        for t in range(plen, seq.shape[1]):
            pos = np.full(2, t, np.int32)
            out_r, st_r = _ref_layer_fn(rseg.group, "decode")(
                rp, jnp.asarray(x[:, t:t + 1]), st_r, jnp.asarray(pos))
            out_t, st_t = _run_layer(TT, tp, cfg, tseg,
                                     torch.as_tensor(x[:, t:t + 1]), st_t,
                                     torch.as_tensor(pos))
            _close_rel(out_t, out_r, LAYER_TOL)
        groups.append(tseg.group)
        x = np.asarray(full_r)
    assert groups == (["mamba2"] * 5 + ["shared_attention"]) * 2


def test_layer_gradients_match_reference():
    """Each layer's gradients, fed the reference's input to it and the
    reference's cotangent of its output under the train loss (the
    cross-entropy of a synthetic batch): every parameter's and the
    input's within 1e-4 of its largest |g|. The shared block's two
    invocations are held one at a time; their sum is what both packages'
    train steps take."""
    rcfg, rparams, cfg = _model()
    params = _params()
    b = next(iter(RD.SyntheticLM(rcfg, batch=2, seq_len=40, seed=1)))
    layers = list(zip(_layers(RT, rcfg), _layers(TT, cfg)))
    rps = [_ref_layer_params(rparams, rseg, j) for (rseg, j), _ in layers]

    def loss(eps):
        x = rparams["embedding"][jnp.asarray(b.inputs)]
        inputs = []
        for ((rseg, _), _), rp, e in zip(layers, rps, eps):
            inputs.append(x)
            x = _run_layer(RT, rp, rcfg, rseg, x)[0] + e
        h = RL.rms_norm(x, rparams["final_norm"], rcfg.norm_eps)
        return RTS.chunked_softmax_xent(h, rparams["lm_head"],
                                        jnp.asarray(b.targets),
                                        jnp.asarray(b.mask)), inputs

    zeros = [jnp.zeros((2, 40, cfg.d_model), jnp.float32) for _ in layers]
    cots, inputs = jax.jit(jax.grad(loss, has_aux=True))(zeros)
    for ((rseg, j), (tseg, _)), rp, x, g in zip(layers, rps, inputs, cots):
        dp_r, dx_r = _ref_layer_fn(rseg.group, "vjp")(rp, x, g)
        tp = {k: v.clone().requires_grad_(True) for k, v in
              TT._layer_params(params["blocks"][tseg.group], tseg,
                               j).items()}
        xt = torch.as_tensor(np.asarray(x)).requires_grad_(True)
        out = _run_layer(TT, tp, cfg, tseg, xt)[0]
        grads = torch.autograd.grad(out, list(tp.values()) + [xt],
                                    torch.as_tensor(np.asarray(g)))
        for key, gt in zip(tp, grads):
            assert float(gt.abs().max()) > 0, key
            _close_rel(gt, dp_r[key], LAYER_GRAD_TOL)
        _close_rel(grads[-1], dx_r, LAYER_GRAD_TOL)


def test_forward_matches_reference():
    rcfg, rparams, cfg = _model()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    ref_logits, ref_aux, _ = RT.forward(rparams, rcfg, jnp.asarray(toks))
    logits, aux, none = TT.forward(_params(), cfg, torch.as_tensor(toks))
    assert logits.shape == (2, 40, cfg.vocab_size) and none is None
    assert float(aux) == float(ref_aux) == 0.0
    _close(logits, ref_logits)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(ref_logits).argmax(-1))


def test_prefill_cache_matches_reference():
    """Both shared slots' K and V and every Mamba2 layer's SSM and conv
    state, from a prompt of two chunks and a part."""
    rcfg, rparams, cfg = _model()
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 70))
    r_logits, r_cache = RDec.prefill_step(rparams, jnp.asarray(prompt),
                                          cfg=rcfg)
    t_logits, t_cache = TDec.prefill_step(_params(), torch.as_tensor(prompt),
                                          cfg=cfg)
    _close(t_logits, r_logits)
    assert set(t_cache) == set(r_cache) == {"mamba2", "shared_attention"}
    for g, sub in r_cache.items():
        assert set(t_cache[g]) == set(sub)
        for name, a in sub.items():
            assert tuple(t_cache[g][name].shape) == a.shape, (g, name)
            for i in range(a.shape[0]):
                _close_rel(t_cache[g][name][i], a[i], 1e-3)
    assert t_cache["shared_attention"]["k"].shape[0] == 2


def test_decode_matches_reference():
    """Prefill, then greedy decode steps through both invocations' slots,
    each side feeding back its own tokens; the slots written in place."""
    rcfg, rparams, cfg = _model()
    params = _params()
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 11))
    r_logits, r_cache = RDec.prefill_step(rparams, jnp.asarray(prompt),
                                          cfg=rcfg)
    t_logits, t_cache = TDec.prefill_step(params, torch.as_tensor(prompt),
                                          cfg=cfg)
    r_cache, t_cache = RT.grow_cache(r_cache, 24), TT.grow_cache(t_cache, 24)
    r_tok = jnp.argmax(r_logits[:, -1:], -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits[:, -1:], dim=-1)
    slots = t_cache["shared_attention"]["k"]
    ref_step = jax.jit(functools.partial(RDec.decode_step, cfg=rcfg))
    for i in range(8):
        pos = np.full(2, prompt.shape[1] + i, np.int32)
        r_nxt, r_step, r_cache = ref_step(rparams, r_cache, r_tok,
                                          jnp.asarray(pos))
        t_nxt, t_step, t_cache = TDec.decode_step(
            params, t_cache, t_tok, torch.as_tensor(pos), cfg=cfg)
        _close(t_step, r_step)
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
        r_tok, t_tok = r_nxt[:, None], t_nxt[:, None].long()
    assert t_cache["shared_attention"]["k"] is slots
    for g, sub in r_cache.items():
        for name, a in sub.items():
            for i in range(a.shape[0]):
                _close_rel(t_cache[g][name][i], a[i], 1e-3)
    # the two invocations write different rows into their own slots
    assert not torch.allclose(slots[0, :, 11:19], slots[1, :, 11:19])


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


PROMPTS = (5, 33, 40, 7)               # prompt lengths: up to two chunks
NEW_TOKENS = (8, 6, 5, 9)


@functools.lru_cache(maxsize=None)
def _batcher_run(ref: bool):
    """The four requests through either package's batcher in three slots:
    {request id: tokens}."""
    rcfg, rparams, cfg = _model()
    pkg, params, c = (RB, rparams, rcfg) if ref else (TB, _params(), cfg)
    kw = {} if ref else CPU
    b = pkg.ContinuousBatcher(params, c, num_slots=3, max_seq=48, **kw)
    for i, pr in enumerate(_prompts(cfg, PROMPTS, seed=6)):
        b.submit(pkg.Request(i, pr, max_new_tokens=NEW_TOKENS[i]))
    return {d.request_id: d.tokens for d in b.run_until_drained()}


def test_batcher_tokens_equal_reference():
    """Four requests in three slots, prompts of one to two chunks: the
    shared slots scattered per request and decoded in place."""
    ours = _batcher_run(False)
    assert sorted(ours) == list(range(4))
    assert ours == _batcher_run(True)


def test_stream_engine_equals_batcher():
    """The streaming engine (two slot groups of one) gives the batcher's
    tokens, request by request (and so the reference batcher's)."""
    _, _, cfg = _model()
    with StreamEngine(_params(), cfg, num_slots=2, max_seq=48,
                      **CPU) as eng:
        for i, pr in enumerate(_prompts(cfg, PROMPTS, seed=6)):
            eng.submit(TB.Request(i, pr, max_new_tokens=NEW_TOKENS[i]))
        out = {c.request_id: c.tokens for c in eng.run_until_drained()}
    assert sorted(out) == list(range(4))
    assert out == _batcher_run(False) == _batcher_run(True)


def _jbatch(b):
    return {k: jnp.asarray(getattr(b, k)) for k in ("inputs", "targets",
                                                     "mask")}


def _tbatch(b):
    return {k: torch.from_numpy(getattr(b, k)) for k in ("inputs", "targets",
                                                          "mask")}


def test_train_steps_match_reference():
    """Two steps of the reference's un-sharded step (``mesh=None``; its
    sharded step raises ``ShardingTypeError``), the port taking the
    reference's parameters and optimizer state before each: the loss
    within 1e-4; the gradient norm and every leaf's first moment (the
    clipped gradient, the shared block's included) within 2e-3 of their
    largest, since ten Mamba2 layers amplify the rounding (each layer's
    gradients are held to 1e-4 above); every leaf's gradient non-zero at
    step 1."""
    rcfg, rparams, cfg = _model()
    ropt, opt = RO.AdamWConfig(**REF_OPT), TO.AdamWConfig(**REF_OPT)
    ref_step = jax.jit(functools.partial(RTS.train_step, cfg=rcfg,
                                         opt_cfg=ropt))
    rstate = RO.init_opt_state(rparams)
    it = iter(RD.SyntheticLM(rcfg, batch=2, seq_len=40, seed=0))
    for step in range(2):
        b = next(it)
        host = jax.tree.map(np.asarray, (rparams, rstate))
        params = convert.lm_params_from_reference(host[0], cfg, **CPU)
        state = convert.opt_state_from_reference(
            host[1].step, host[1].mu, host[1].nu, cfg, **CPU)
        rparams, rstate, rm = ref_step(rparams, rstate, _jbatch(b))
        params, state, m = TTS.train_step(params, state, _tbatch(b), cfg=cfg,
                                          opt_cfg=opt)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=2e-3)
        rmu = dict(TTree.items(jax.tree.map(np.asarray, rstate.mu)))
        mus = dict(TTree.items(state.mu))
        assert set(mus) == set(rmu)
        assert "blocks/shared_attention/w_q" in mus
        for key, mu in mus.items():
            if step == 0:
                assert float(mu.abs().max()) > 0, key
            _close_rel(mu, rmu[key], 2e-3)


def test_shared_gradient_is_the_sum_over_invocations():
    """The shared block's gradient under the training forward (each
    invocation under ``checkpoint``) equals the sum of the gradients of
    two copies of the block, one for each invocation (a forward without
    remat, so that no recomputation reads the copies again)."""
    _, _, cfg = _model()
    params = _params()
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)))

    def loss(tree, remat=True):
        logits, _, _ = TT.forward(tree, cfg, toks, remat=remat)
        return logits.float().square().mean()

    shared = {k: v.clone().requires_grad_(True)
              for k, v in params["blocks"]["shared_attention"].items()}
    tied = dict(params, blocks=dict(params["blocks"],
                                    shared_attention=shared))
    grads = torch.autograd.grad(loss(tied), list(shared.values()))

    # the same model with the block untied: invocation i reads copy i
    copies = [{k: v.detach().clone().requires_grad_(True)
               for k, v in shared.items()} for _ in range(2)]
    segs, _ = TT.build_plan(cfg)
    orig = TT._layer_params
    calls = iter(range(2))

    def untied(blocks, seg, j):
        if seg.group == "shared_attention":
            return copies[next(calls)]
        return orig(blocks, seg, j)
    try:
        TT._layer_params = untied
        total = loss(tied, remat=False)
    finally:
        TT._layer_params = orig
    per_copy = [torch.autograd.grad(total, list(c.values()),
                                    retain_graph=True) for c in copies]
    assert sum(s.group == "shared_attention" for s in segs) == 2
    for g, g0, g1 in zip(grads, *per_copy):
        assert float(g0.abs().max()) > 0 and float(g1.abs().max()) > 0
        torch.testing.assert_close(g, g0 + g1, rtol=1e-5, atol=1e-6)
