"""The port's MoE layer (``repro_torch.models.moe``) and the MoE configs
(phi3.5-moe-42b-a6.6b, grok-1-314b) against the JAX package, on the CPU.

The ``.reduced()`` configs (2 layers, d_model 128, 4 experts, top 2,
float32) are initialised by the reference and carried across with
``convert.lm_params_from_reference``; inputs are drawn from a seed with
numpy. The dispatch is held equal to the reference's (each token's
experts, slots and kept assignments, recomputed from the reference's own
ops: ``lax.top_k``, the per-rank ``cumsum``), including the slots a
first choice and another token's second choice share, groups that drop
assignments and groups that do not, several groups (MAX_GROUP), and an
all-equal gate whose ties go to the lowest experts.

Tolerances: ``moe_block``'s output and the forward's logits to 1e-5
(float32; each token's two expert outputs weighed and summed in float32,
the experts' matmuls in another order), aux to 1e-6, decode logits to
1e-5; batcher and stream-engine tokens equal; the un-sharded train step's
loss, aux and step-1 gradients (each relative to its leaf's largest |g|)
to 1e-4, as ``tests/test_torch_training.py`` holds the dense step.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as ref_get_arch
from repro.data import synthetic as RD
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.serving import batcher as RB
from repro.serving import decode as RDec
from repro.serving import stream as RStream
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import convert
from repro_torch.common.registry import get_arch
from repro_torch.launch import serve
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import batcher as TB
from repro_torch.serving import decode as TDec
from repro_torch.serving.stream import StreamEngine
from repro_torch.train import checkpoint as TC
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.train import tree as TTree

ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
REF_OPT = dict(lr=5e-3, warmup_steps=5, total_steps=120, weight_decay=0.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    rcfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, rparams, cfg


def _params(arch: str) -> dict:
    _, rparams, cfg = _model(arch)
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, **CPU)


def _layer(arch: str, i: int = 0):
    """Layer i's MoE weights in both packages."""
    _, rparams, _ = _model(arch)
    keys = ("router", "e_gate", "e_in", "e_out")
    ref = {k: rparams["blocks"]["attention"][k][i] for k in keys}
    ours = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    return ref, ours


def _ref_dispatch(p, rcfg, x):
    """The reference's assignment, from its own ops (moe.py:51-72):
    (experts, slots, kept) [G, T, k] as numpy."""
    moe = rcfg.moe
    b, s, d = x.shape
    t = b * s
    group = min(RM.MAX_GROUP, t)
    while t % group:
        group //= 2
    cap = max(1, int(group * moe.experts_per_token * moe.capacity_factor
                     / moe.num_experts))
    xt = jnp.asarray(x).reshape(t // group, group, d)
    gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt.astype(jnp.float32),
                                      p["router"]), axis=-1)
    _, top_e = jax.lax.top_k(gates, moe.experts_per_token)
    onehot = jax.nn.one_hot(top_e, moe.num_experts, dtype=jnp.float32)
    before = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.einsum("gtke,gtke->gtk", before, onehot).astype(jnp.int32)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos < cap)


def _hold_block(arch, x, ref_p=None, p=None):
    """moe_block on x [B, S, D] in both packages: the dispatch equal, the
    output within TOL, aux within 1e-6. Returns the dispatch."""
    rcfg, _, cfg = _model(arch)
    if ref_p is None:
        ref_p, p = _layer(arch)
    want = _ref_dispatch(ref_p, rcfg, x)
    xt = torch.from_numpy(x)
    b, s, d = x.shape
    group, _ = TM.group_and_capacity(cfg, b * s)
    _, top_e, slots, kept, _ = TM.route(p, cfg, xt.reshape(-1, group, d))
    for got, ref in zip((top_e, slots, kept), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    ref_out, ref_aux = RM.moe_block(ref_p, rcfg, jnp.asarray(x))
    out, aux = TM.moe_block(p, cfg, xt)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=0,
                               atol=1e-6)
    return want


def _skewed(arch, b, s, seed, skew):
    """Normal tokens; with ``skew`` the router's first column points along
    the tokens' common offset, so that expert 0 is every token's first
    choice and its queue overflows."""
    ref_p, p = _layer(arch)
    rng = np.random.default_rng(seed)
    d = _model(arch)[2].d_model
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    if skew:
        x += 1.0
        router = np.array(ref_p["router"])
        router[:, 0] += 4.0 / np.sqrt(d)
        ref_p = dict(ref_p, router=jnp.asarray(router))
        p = dict(p, router=torch.from_numpy(router))
    return x, ref_p, p


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ("balanced", "overflowing", "decode_8",
                                  "groups_6144"))
def test_moe_block_matches_reference(arch, case):
    b, s, skew = {"balanced": (2, 24, False), "overflowing": (2, 24, True),
                  "decode_8": (8, 1, False),
                  "groups_6144": (3, 2048, False)}[case]
    x, ref_p, p = _skewed(arch, b, s, seed=len(case), skew=skew)
    _, _, kept = _hold_block(arch, x, ref_p, p)
    if case == "overflowing":
        assert not kept.all()
    if case == "balanced":
        assert kept.all()
    if case == "groups_6144":
        assert kept.shape[0] == 3        # 6,144 tokens: groups of 2,048


def test_zero_router_ties_go_to_the_lowest_experts():
    """All gates equal: every token takes experts 0 and 1, in that order;
    past the capacity both of a token's choices drop and it gets no MLP
    output."""
    arch = ARCHS[0]
    ref_p, p = _layer(arch)
    ref_p = dict(ref_p, router=jnp.zeros_like(ref_p["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = np.random.default_rng(2).normal(size=(1, 16, 128)).astype(np.float32)
    top_e, slots, kept = _hold_block(arch, x, ref_p, p)
    assert (top_e[..., 0] == 0).all() and (top_e[..., 1] == 1).all()
    cap = TM.group_and_capacity(_model(arch)[2], 16)[1]
    np.testing.assert_array_equal(slots[0, :, 0], np.arange(16))
    assert kept[0, :cap].all() and not kept[0, cap:].any()
    out, _ = TM.moe_block(p, _model(arch)[2], torch.from_numpy(x))
    assert float(out[0, cap:].abs().max()) == 0.0


def test_first_and_second_choices_share_a_slot():
    """Three tokens choosing experts (0, 1), (1, 0) and (2, 3): slots are
    counted per choice rank, so every assignment takes slot 0, and expert
    0's slot 0 (and expert 1's) holds the sum of two tokens."""
    arch = ARCHS[0]
    ref_p, p = _layer(arch)
    d = 128
    router = np.zeros((d, 4), np.float32)
    router[0, :] = (3, 2, 0, 0)
    router[1, :] = (2, 3, 0, 0)
    router[2, :] = (0, 0, 3, 2)
    x = np.zeros((1, 3, d), np.float32)
    x[0, 0, 0] = x[0, 1, 1] = x[0, 2, 2] = 1.0
    x[0, :, 3:] = np.random.default_rng(3).normal(size=(3, d - 3)) * 0.1
    ref_p = dict(ref_p, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    top_e, slots, kept = _hold_block(arch, x, ref_p, p)
    np.testing.assert_array_equal(top_e[0], [[0, 1], [1, 0], [2, 3]])
    assert (slots == 0).all() and kept.all()
    # the shared slot's input is the sum of tokens 0 and 1
    solo, _ = TM.moe_block(p, _model(arch)[2], torch.from_numpy(x[:, :1]))
    both, _ = TM.moe_block(p, _model(arch)[2], torch.from_numpy(x))
    assert not torch.allclose(solo[0, 0], both[0, 0], atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch):
    rcfg, rparams, cfg = _model(arch)
    params = _params(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    ref_logits, ref_aux, _ = RT.forward(rparams, rcfg, jnp.asarray(toks))
    logits, aux, _ = TT.forward(params, cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_prefill_cache_matches_reference(arch):
    """Prefill two prompts, then greedy decode steps (a decode group of
    the batch's two tokens), each side feeding back its own tokens."""
    rcfg, rparams, cfg = _model(arch)
    params = _params(arch)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
    r_logits, r_cache = RDec.prefill_step(rparams, jnp.asarray(prompt),
                                          cfg=rcfg)
    t_logits, t_cache = TDec.prefill_step(params, torch.as_tensor(prompt),
                                          cfg=cfg)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits), **TOL)
    r_cache, t_cache = RT.grow_cache(r_cache, 24), TT.grow_cache(t_cache, 24)
    r_tok = jnp.argmax(r_logits[:, -1:], -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits[:, -1:], dim=-1)
    for i in range(8):
        pos = np.full(2, prompt.shape[1] + i, np.int32)
        r_nxt, r_step, r_cache = RDec.decode_step(
            rparams, r_cache, r_tok, jnp.asarray(pos), cfg=rcfg)
        t_nxt, t_step, t_cache = TDec.decode_step(
            params, t_cache, t_tok, torch.as_tensor(pos), cfg=cfg)
        np.testing.assert_allclose(t_step.numpy(), np.asarray(r_step), **TOL)
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
        r_tok, t_tok = r_nxt[:, None], t_nxt[:, None].long()


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_tokens_equal_reference(arch):
    """Five requests in four slots (a decode step's group is every slot,
    idle ones included): the same completions as the reference's
    batcher."""
    rcfg, rparams, cfg = _model(arch)
    params = _params(arch)
    prompts = _prompts(cfg, (5, 9, 3, 12, 7), seed=6)
    n_new = (8, 6, 9, 5, 7)
    runs = []
    for pkg, p, c in ((RB, rparams, rcfg), (TB, params, cfg)):
        kw = {} if pkg is RB else CPU
        b = pkg.ContinuousBatcher(p, c, num_slots=4, max_seq=32, **kw)
        for i, pr in enumerate(prompts):
            b.submit(pkg.Request(i, pr, max_new_tokens=n_new[i]))
        runs.append({d.request_id: (d.tokens, d.prompt_len, d.steps)
                     for d in b.run_until_drained()})
    assert sorted(runs[1]) == list(range(5))
    assert runs[1] == runs[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_engine_tokens_equal_reference(arch):
    """The streaming engine (two slot groups of two; each step one group's
    decode, so one MoE dispatch group of two tokens): tokens equal to the
    reference engine's, request by request."""
    rcfg, rparams, cfg = _model(arch)
    params = _params(arch)
    prompts = _prompts(cfg, (6, 4, 11, 8, 5), seed=8)
    out = []
    for ref in (True, False):
        cls = RStream.StreamEngine if ref else StreamEngine
        request = RB.Request if ref else TB.Request
        kw = dict(num_slots=4, max_seq=32, **({} if ref else CPU))
        with cls(rparams if ref else params, rcfg if ref else cfg,
                 **kw) as eng:
            for i, pr in enumerate(prompts):
                eng.submit(request(i, pr, max_new_tokens=6))
            out.append({c.request_id: c.tokens
                        for c in eng.run_until_drained()})
    assert sorted(out[1]) == list(range(5))
    assert out[1] == out[0]


def test_convert_keeps_the_router_float32():
    """A bf16 MoE model's reference parameters carried across: the router
    stays float32, the experts bf16, every value equal bit for bit."""
    rcfg = dataclasses.replace(ref_get_arch(ARCHS[0]).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_arch(ARCHS[0]).reduced(), dtype="bfloat16")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, rparams)
    params = convert.lm_params_from_reference(host, cfg, **CPU)
    blocks = params["blocks"]["attention"]
    assert blocks["router"].dtype == torch.float32
    for key in ("e_gate", "e_in", "e_out", "w_q"):
        assert blocks[key].dtype == torch.bfloat16, key
    ref_blocks = host["blocks"]["attention"]
    for key, t in blocks.items():
        ref = ref_blocks[key]
        if t.dtype == torch.bfloat16:
            ref = torch.from_numpy(ref.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            ref = torch.from_numpy(np.array(ref))
        assert torch.equal(t, ref), key
    shapes = jax.tree.map(lambda a: tuple(a.shape), rparams)
    ours = TT.init_params(cfg, torch.Generator().manual_seed(0), **CPU)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == shapes
    assert ours["blocks"]["attention"]["router"].dtype == torch.float32


def _jbatch(b):
    return {k: jnp.asarray(getattr(b, k)) for k in ("inputs", "targets",
                                                     "mask")}


def _tbatch(b):
    return {k: torch.from_numpy(getattr(b, k)) for k in ("inputs", "targets",
                                                          "mask")}


def _close_rel(ours, ref, rel):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(ours.detach().double().numpy() - ref).max()) \
        <= rel * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Three steps of the reference's un-sharded step (``mesh=None``, as
    ``tests/test_torch_training.py`` holds the dense step; the sharded one
    raises ``ShardingTypeError``). Before each step the port takes the
    reference's parameters and optimizer state: the loss, the aux loss,
    the gradient norm and the new first moments (the clipped step's
    gradients, router included) agree within 1e-4, and at step 1 every
    leaf's gradient is non-zero."""
    rcfg, rparams, cfg = _model(arch)
    ropt, opt = RO.AdamWConfig(**REF_OPT), TO.AdamWConfig(**REF_OPT)
    ref_step = jax.jit(functools.partial(RTS.train_step, cfg=rcfg,
                                         opt_cfg=ropt))
    rstate = RO.init_opt_state(rparams)
    it = iter(RD.SyntheticLM(rcfg, batch=4, seq_len=32, seed=0))
    for step in range(3):
        b = next(it)
        host = jax.tree.map(np.asarray, (rparams, rstate))
        params = convert.lm_params_from_reference(host[0], cfg, **CPU)
        state = convert.opt_state_from_reference(
            host[1].step, host[1].mu, host[1].nu, cfg, **CPU)
        rparams, rstate, rm = ref_step(rparams, rstate, _jbatch(b))
        params, state, m = TTS.train_step(params, state, _tbatch(b), cfg=cfg,
                                          opt_cfg=opt)
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        rmu = dict(TTree.items(jax.tree.map(np.asarray, rstate.mu)))
        for key, mu in TTree.items(state.mu):
            if step == 0:
                assert float(mu.abs().max()) > 0, key
            _close_rel(mu, rmu[key], 1e-4)
    assert float(m["aux_loss"]) > 0


def test_serve_launcher_runs_moe():
    ids = serve.main(["--arch", ARCHS[0], "--device", "cpu", "--tokens", "4",
                      "--prompt-len", "6"])
    assert ids.shape == (2, 4)


def test_train_launcher_trains_moe(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCHS[0], "--reduced", "--steps", "3", "--batch", "4",
         "--seq", "32", "--ckpt", str(tmp_path / "ck")], env=env,
        capture_output=True, text=True, timeout=300)
    text = out.stdout + out.stderr
    assert out.returncode == 0, text[-3000:]
    assert "step    2 loss=" in text
    cfg = get_arch(ARCHS[0]).reduced()
    template = TTS.abstract_params(cfg)
    params, state, step = TC.load_checkpoint(
        str(tmp_path / "ck"), template, TO.init_opt_state(template), **CPU)
    assert step == 3 and int(state.step) == 3
    blocks = params["blocks"]["attention"]
    assert blocks["router"].dtype == torch.float32
    assert all(torch.isfinite(t).all() for t in TTree.leaves(params))
    assert float(state.mu["blocks"]["attention"]["router"].abs().max()) > 0
