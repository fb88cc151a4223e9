"""Sliding-window and local-global attention in the port
(``repro_torch.models.attention``, ``repro_torch.models.transformer``),
held against the JAX package on the CPU: h2o-danube-1.8b (every layer
sliding), gemma3-12b (five local layers, then a global one) and
chatglm3-6b (full attention, 2-D rope, 16 query heads a kv head at full
width).

Each family runs its ``.reduced()`` config with the window cut to 8, as
``tests/test_arch_smoke.py`` cuts it, so that a ring of 8 slots wraps
more than twice in a few dozen positions; gemma3's reduced stack keeps
six layers, so that it holds a global layer after its five ring layers.
The reference's parameters are carried across with
``convert.lm_params_from_reference``, and inputs are drawn from a seed
with numpy.

Tolerances: ``test_torch_lm.py``'s TOL (rtol = atol = 1e-4): both
packages compute in float32, summing in other orders; greedy tokens and
cache shapes are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as ref_get_arch
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.serving import batcher as RB
from repro.serving import decode as RDec
from repro_torch import convert
from repro_torch.common.registry import get_arch
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import batcher as TB
from repro_torch.serving import decode as TDec

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("h2o-danube-1.8b", "gemma3-12b", "chatglm3-6b")
WINDOW = 8


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _reduced(get, arch):
    cfg = dataclasses.replace(get(arch).reduced(), sliding_window=WINDOW)
    if arch == "gemma3-12b":
        cfg = dataclasses.replace(cfg, num_layers=6)
    return cfg


_MODELS = {}


def _model(arch):
    """Both packages' reduced model of ``arch``: (rcfg, rparams, cfg,
    params), built once a module."""
    if arch not in _MODELS:
        rcfg, cfg = _reduced(ref_get_arch, arch), _reduced(get_arch, arch)
        rparams = RT.init_params(rcfg, jax.random.PRNGKey(3))
        params = convert.lm_params_from_reference(
            jax.tree.map(np.asarray, rparams), cfg, device="cpu")
        _MODELS[arch] = (rcfg, rparams, cfg, params)
    return _MODELS[arch]


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


def _close_cache(t_cache, r_cache):
    assert set(t_cache) == set(r_cache)
    for g in r_cache:
        for name in r_cache[g]:
            assert tuple(t_cache[g][name].shape) == r_cache[g][name].shape
            _close(t_cache[g][name], r_cache[g][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_plans_match_reference(arch):
    ref, ours = ref_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(ref.reduced())
    rcfg, _, cfg, _ = _model(arch)
    for r, t in ((ref, ours), (rcfg, cfg)):
        r_segs, r_slots = RT.build_plan(r)
        t_segs, t_slots = TT.build_plan(t)
        assert t_slots == r_slots
        assert [(s.group, s.start, s.length, s.cache_start, s.cache_group,
                 s.spec.is_sliding, s.spec.window) for s in t_segs] == \
            [(s.group, s.start, s.length, s.cache_start, s.cache_group,
              s.spec.is_sliding, s.spec.window) for s in r_segs]
    if arch == "gemma3-12b":     # 40 ring layers, 8 global ones
        assert TT.build_plan(ours)[1] == {"attention@swa": 40,
                                          "attention": 8}


@pytest.mark.parametrize("arch", ARCHS)
def test_make_and_grow_cache_match_reference(arch):
    rcfg, rparams, cfg, params = _model(arch)
    for max_seq in (5, WINDOW, 20):
        ref = RT.make_cache(rcfg, 2, max_seq)
        ours = TT.make_cache(cfg, 2, max_seq, device="cpu")
        assert {g: {n: tuple(a.shape) for n, a in sub.items()}
                for g, sub in ours.items()} == \
            {g: {n: a.shape for n, a in sub.items()} for g, sub in ref.items()}
    # a prefill shorter than the window grows to min(window, max_seq); a
    # longer one is a full ring already; without a window a ring stays
    for s in (5, 13):
        toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (1, s))
        _, r_cache = RDec.prefill_step(rparams, jnp.asarray(toks), cfg=rcfg)
        _, t_cache = TDec.prefill_step(params, torch.as_tensor(toks),
                                       cfg=cfg)
        for window in (0, WINDOW):
            _close_cache(TT.grow_cache(t_cache, 20, window=window),
                         RT.grow_cache(r_cache, 20, window=window))


@pytest.mark.parametrize("s", (3, WINDOW, 11, 16, 21))
def test_ring_pack_matches_reference(s):
    kv = np.random.default_rng(s).normal(size=(2, s, 3, 4)).astype(
        np.float32)
    ours = TA.ring_pack(torch.as_tensor(kv), WINDOW)
    ref = RA.ring_pack(jnp.asarray(kv), WINDOW)
    assert tuple(ours.shape) == ref.shape == (2, min(s, WINDOW), 3, 4)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # slot i holds the newest position p with p % R == i
    r = min(s, WINDOW)
    for i in range(r):
        p = max(q for q in range(s) if q % r == i)
        np.testing.assert_array_equal(ours[:, i].numpy(), kv[:, p])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_ring_caches_match_reference(arch):
    rcfg, rparams, cfg, params = _model(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 19))
    r_logits, r_cache = RDec.prefill_step(rparams, jnp.asarray(toks),
                                          cfg=rcfg)
    t_logits, t_cache = TDec.prefill_step(params, torch.as_tensor(toks),
                                          cfg=cfg)
    _close(t_logits, r_logits)
    _close_cache(t_cache, r_cache)
    if arch != "chatglm3-6b":
        assert t_cache["attention@swa"]["k"].shape[2] == WINDOW


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_through_a_wrapping_ring_matches_reference(arch):
    """Prefill 11 positions (a ring packed past one wrap), then 16 greedy
    steps (the 8-slot ring wraps twice more), each package feeding back
    its own tokens: logits, tokens and final caches against the
    reference, and the decoded logits against the port's own full
    forward over the same sequence."""
    rcfg, rparams, cfg, params = _model(arch)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 11))
    steps, max_seq = 16, 32
    r_logits, r_cache = RDec.prefill_step(rparams, jnp.asarray(prompt),
                                          cfg=rcfg)
    t_logits, t_cache = TDec.prefill_step(params, torch.as_tensor(prompt),
                                          cfg=cfg)
    r_cache = RT.grow_cache(r_cache, max_seq, window=rcfg.sliding_window)
    t_cache = TT.grow_cache(t_cache, max_seq, window=cfg.sliding_window)
    r_tok = jnp.argmax(r_logits[:, -1:], -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits[:, -1:], dim=-1)
    toks, step_logits = [t_tok[:, 0]], []
    for i in range(steps):
        pos = np.full(2, prompt.shape[1] + i, np.int32)
        r_nxt, r_step, r_cache = RDec.decode_step(
            rparams, r_cache, r_tok, jnp.asarray(pos), cfg=rcfg)
        t_nxt, t_step, t_cache = TDec.decode_step(
            params, t_cache, t_tok, torch.as_tensor(pos), cfg=cfg)
        _close(t_step, r_step)
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
        step_logits.append(t_step)
        r_tok, t_tok = r_nxt[:, None], t_nxt[:, None].long()
        toks.append(t_nxt.long())
    _close_cache(t_cache, r_cache)
    seq = torch.cat([torch.as_tensor(prompt),
                     torch.stack(toks[:steps], dim=1)], dim=1)
    full, _, _ = TT.forward(params, cfg, seq)
    np.testing.assert_allclose(torch.stack(step_logits, 1).numpy(),
                               full[:, prompt.shape[1]:].numpy(), **TOL)


@pytest.mark.parametrize("cache", ("ring", "full_size_sliding", "full"))
def test_decode_attention_block_matches_reference(cache):
    """The decode block alone on each kind of cache a layer can hold: a
    ring of window slots (positions past it), a full-size cache on a
    sliding layer (the window's lower bound), and a full layer's cache;
    the caches written in place as the reference writes them."""
    rcfg, rparams, cfg, params = _model("h2o-danube-1.8b")
    p_ref = jax.tree.map(lambda a: a[0], rparams["blocks"]["attention"])
    p = {k: v[0] for k, v in params["blocks"]["attention"].items()}
    s = WINDOW if cache == "ring" else 32
    spec = (False, 0) if cache == "full" else (True, WINDOW)
    rng = np.random.default_rng(len(cache))
    b, kvh, hd = 4, cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    vc = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    pos = np.array([0, 5, 17, 29] if s == 32 else [3, 7, 8, 30], np.int32)
    y_ref, k_ref, v_ref = RA.decode_attention_block(
        p_ref, rcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kc),
        jnp.asarray(vc), RA.AttnSpec(*spec))
    k_ours, v_ours = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    y, k2, v2 = TA.decode_attention_block(
        p, cfg, torch.as_tensor(x), torch.as_tensor(pos), k_ours, v_ours,
        TA.AttnSpec(*spec))
    assert k2 is k_ours and v2 is v_ours
    _close(y, y_ref)
    _close(k2, k_ref)
    _close(v2, v_ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_tokens_equal_reference(arch):
    """Prompts shorter than, equal to and longer than the window, in two
    slots of a 32-row cache, decoding past the window: the same
    completions as the reference's batcher."""
    rcfg, rparams, cfg, params = _model(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, WINDOW, 13)]
    n_new = (12, 9, 10)
    runs = []
    for pkg, p, c in ((RB, rparams, rcfg), (TB, params, cfg)):
        kw = {} if pkg is RB else {"device": "cpu"}
        b = pkg.ContinuousBatcher(p, c, num_slots=2, max_seq=32, **kw)
        for i, pr in enumerate(prompts):
            b.submit(pkg.Request(i, pr, max_new_tokens=n_new[i]))
        runs.append({d.request_id: (d.tokens, d.prompt_len, d.steps)
                     for d in b.run_until_drained()})
    assert sorted(runs[1]) == [0, 1, 2]
    assert runs[1] == runs[0]
