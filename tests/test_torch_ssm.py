"""The port's mamba2-780m serving slice against the JAX package, on the CPU.

The ``.reduced()`` mamba2-780m config (2 layers, d_model 128, 16 SSM
heads of P = 16, state N = 16, chunk 32, vocab 512, float32) is
initialised by the reference and its parameters carried across with
``convert.lm_params_from_reference``, so both packages compute the same
model. The Mamba2 block, logits, hidden states and decode states agree to
rtol/atol 1e-4 (the two sum each product in another order; float32),
teacher-forced decode matches the full forward to the 2e-2 of
``tests/test_arch_smoke.py::test_decode_matches_prefill``, and greedy
batcher completions are equal. On CPU tensors the SSD takes the kernel's
plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.registry import get_arch as ref_get_arch
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.serving import batcher as RB
from repro.serving import retrieval as RR
from repro_torch import convert
from repro_torch.common.registry import get_arch
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serving import batcher as TB
from repro_torch.serving import retrieval as TR

ARCH = "mamba2-780m"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    rcfg = ref_get_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return rcfg, rparams, cfg, params


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _shapes_and_dtypes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                   .replace("torch.", "")), tree)


def test_config_is_the_published_width():
    full = get_arch(ARCH)
    s = full.ssm
    assert (full.num_layers, full.d_model, full.vocab_size,
            full.tie_embeddings, s.expand, s.head_dim, s.state_dim,
            s.conv_width, s.chunk_size) == (48, 1536, 50_280, False, 2, 64,
                                            128, 4, 256)
    assert TS.ssm_dims(full) == (3072, 48, 128)
    ref = jax.eval_shape(lambda: RT.init_params(
        ref_get_arch(ARCH), jax.random.PRNGKey(0)))
    assert sum(a.size for a in jax.tree.leaves(ref)) == 857_317_632


def test_init_params_and_convert_match_reference_tree(model):
    rcfg, rparams, cfg, params = model
    ours = TT.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), rparams)
    assert _shapes_and_dtypes(ours) == want
    assert _shapes_and_dtypes(params) == want
    assert set(ours["blocks"]) == {"mamba2"}
    m = ours["blocks"]["mamba2"]
    for key in ("a_log", "dt_bias", "d_skip"):   # log to float32 rounding
        _close(m[key], rparams["blocks"]["mamba2"][key], rtol=1e-6, atol=0)
    w = m["in_proj"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    # a bf16 model keeps the three float32 constants in float32
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    ours = TT.init_params(bf16, device="cpu")["blocks"]["mamba2"]
    assert {k for k, v in ours.items() if v.dtype == torch.float32} == \
        {"a_log", "dt_bias", "d_skip"}
    bad = jax.tree.map(np.asarray, rparams)
    bad["blocks"]["mamba2"]["extra"] = bad["blocks"]["mamba2"]["a_log"]
    with pytest.raises(NotImplementedError, match="extra"):
        convert.lm_params_from_reference(bad, cfg, device="cpu")
    bad["blocks"] = {"shared_attention": {}}
    with pytest.raises(NotImplementedError, match="shared_attention"):
        convert.lm_params_from_reference(bad, cfg, device="cpu")


def test_mamba2_block_prefill_and_decode_match_reference(model):
    rcfg, rparams, cfg, params = model
    p_ref = jax.tree.map(lambda a: a[1], rparams["blocks"]["mamba2"])
    p = {k: v[1] for k, v in params["blocks"]["mamba2"].items()}
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 45, cfg.d_model)).astype(np.float32)
    y_ref, (ssm_ref, conv_ref) = RS.mamba2_block(p_ref, rcfg, jnp.asarray(u))
    y, (ssm, conv) = TS.mamba2_block(p, cfg, torch.as_tensor(u))
    _close(y, y_ref)
    _close(ssm, ssm_ref)
    _close(conv, conv_ref)
    # one decode step from those states; the port updates them in place
    u1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    y1_ref, (ssm1_ref, conv1_ref) = RS.mamba2_block(
        p_ref, rcfg, jnp.asarray(u1), ssm_ref, conv_ref, decode=True)
    ssm_t, conv_t = ssm.clone(), conv.clone()
    y1, (ssm1, conv1) = TS.mamba2_block(p, cfg, torch.as_tensor(u1), ssm_t,
                                        conv_t, decode=True)
    assert ssm1 is ssm_t and conv1 is conv_t
    _close(y1, y1_ref)
    _close(ssm1, ssm1_ref)
    _close(conv1, conv1_ref)


def test_forward_modes_match_reference(model):
    """Train, prefill (build_cache), skip_head and decode from the
    prefill cache."""
    rcfg, rparams, cfg, params = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    ref_logits, _, _ = RT.forward(rparams, rcfg, jnp.asarray(toks))
    ours, aux, none = TT.forward(params, cfg, torch.as_tensor(toks))
    assert ours.shape == (2, 40, cfg.vocab_size) and none is None
    assert float(aux) == 0.0
    _close(ours, ref_logits)
    r_logits, _, r_cache = RT.forward(rparams, rcfg, jnp.asarray(toks),
                                      build_cache=True)
    t_logits, _, t_cache = TT.forward(params, cfg, torch.as_tensor(toks),
                                      build_cache=True)
    _close(t_logits, r_logits)
    assert set(t_cache) == set(r_cache) == {"mamba2"}
    for name in ("ssm", "conv"):
        _close(t_cache["mamba2"][name], r_cache["mamba2"][name])
    ref_hid = RR.hidden_states(rparams, rcfg, jnp.asarray(toks))
    _close(TR.hidden_states(params, cfg, torch.as_tensor(toks)), ref_hid)
    r_cache = RT.grow_cache(r_cache, 64)
    t_cache = TT.grow_cache(t_cache, 64)
    nxt = toks[:, -1:]
    pos = np.full(2, 40, np.int32)
    r_step, _, r_cache = RT.forward(rparams, rcfg, jnp.asarray(nxt),
                                    cache=r_cache, decode_pos=jnp.asarray(pos))
    t_step, _, t_cache = TT.forward(params, cfg, torch.as_tensor(nxt),
                                    cache=t_cache,
                                    decode_pos=torch.as_tensor(pos))
    _close(t_step, r_step)
    for name in ("ssm", "conv"):
        _close(t_cache["mamba2"][name], r_cache["mamba2"][name])


def test_cache_trees_match_reference(model):
    rcfg, rparams, cfg, params = model
    ref = RT.make_cache(rcfg, 3, 48)
    ours = TT.make_cache(cfg, 3, 48, device="cpu")
    assert _shapes_and_dtypes(ours) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), ref)
    assert all(float(t.abs().max()) == 0 for t in jax.tree.leaves(ours))
    grown = TT.grow_cache(ours, 96)
    assert _shapes_and_dtypes(grown) == _shapes_and_dtypes(ours)
    assert _shapes_and_dtypes(grown) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), RT.grow_cache(ref, 96))


def test_teacher_forced_decode_matches_forward(model):
    """As tests/test_arch_smoke.py::test_decode_matches_prefill: one
    token at a time through the recurrent decode reproduces the full
    forward (the SSD over chunks of 32, crossed here)."""
    _, _, cfg, params = model
    s = 40
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, s)))
    full, _, _ = TT.forward(params, cfg, toks)
    cache = TT.make_cache(cfg, 1, s, device="cpu")
    outs = []
    for t in range(s):
        step, _, cache = TT.forward(params, cfg, toks[:, t:t + 1],
                                    cache=cache,
                                    decode_pos=torch.full((1,), t))
        outs.append(step[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-2,
                               atol=2e-2)


def test_batcher_matches_reference(model):
    """Prompts of 20 to 80 tokens (across the reduced chunk of 32) over 2
    slots, more requests than slots."""
    rcfg, rparams, cfg, params = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (20, 80, 33)]
    runs = []
    for pkg, p, c in ((RB, rparams, rcfg), (TB, params, cfg)):
        kw = {} if pkg is RB else {"device": "cpu"}
        b = pkg.ContinuousBatcher(p, c, num_slots=2, max_seq=96, **kw)
        for i, pr in enumerate(prompts):
            b.submit(pkg.Request(i, pr, max_new_tokens=5))
        runs.append({c.request_id: (c.tokens, c.prompt_len, c.steps)
                     for c in b.run_until_drained()})
    assert sorted(runs[1]) == [0, 1, 2]
    assert runs[1] == runs[0]


@pytest.mark.parametrize("retrieval", (False, True),
                         ids=("plain", "retrieval"))
def test_serve_entry_point_runs_mamba2_on_cpu(retrieval):
    before = launch_counts()
    argv = ["--arch", ARCH, "--tokens", "4", "--device", "cpu"]
    gen = serve.main(argv + (["--retrieval"] if retrieval else []))
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < 512)).all()
    assert launch_counts() == before        # plain versions on the CPU
