"""The port's kNN-LM serving slice against the JAX package, on the CPU.

The ``.reduced()`` qwen3-1.7b config (2 layers, d_model 128, vocab 512,
float32) is initialised by the reference and its parameters carried
across with ``convert.lm_params_from_reference``, so both packages
compute the same model. Logits, hidden states and caches agree to
rtol/atol 1e-4 (the two sum each matmul in another order; float32),
greedy tokens and batcher completions are equal, and the retrieval path
over a datastore built by the reference and carried across with
``convert.index_from_arrays`` returns equal ids and probabilities to
1e-6. On CPU tensors the decode attention takes the kernel's plain
version.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import PyramidConfig as RefPyramidConfig
from repro.common.registry import get_arch as ref_get_arch
from repro.common.registry import list_archs as ref_list_archs
from repro.core import distributed as RD
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.serving import batcher as RB
from repro.serving import decode as RDec
from repro.serving import retrieval as RR
from repro.serving import sampler as RS
from repro_torch import convert
from repro_torch.common.config import BlockKind, MoEConfig, PyramidConfig
from repro_torch.common.registry import get_arch, list_archs
from repro_torch.core import distributed as TD
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve
from repro_torch.obs import validate_chrome_trace
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import batcher as TB
from repro_torch.serving import decode as TDec
from repro_torch.serving import retrieval as TR
from repro_torch.serving import sampler as TS

TOL = dict(rtol=1e-4, atol=1e-4)
PYR = dict(metric="l2", num_shards=2, meta_size=16, sample_size=100,
           branching_factor=2, max_degree=8, max_degree_upper=4,
           ef_construction=30, ef_search=40, kmeans_iters=4)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    rcfg = ref_get_arch("qwen3-1.7b").reduced()
    cfg = get_arch("qwen3-1.7b").reduced()
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return rcfg, rparams, cfg, params


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def test_config_and_registry_match_reference():
    assert list_archs() == ["chatglm3-6b", "gemma3-12b", "grok-1-314b",
                            "h2o-danube-1.8b", "internvl2-2b", "mamba2-780m",
                            "musicgen-medium", "phi3.5-moe-42b-a6.6b",
                            "qwen3-1.7b", "zamba2-7b"]
    assert list_archs() == ref_list_archs()
    for arch in list_archs():
        for reduce in (False, True):
            ref, ours = ref_get_arch(arch), get_arch(arch)
            if reduce:
                ref, ours = ref.reduced(), ours.reduced()
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.param_count() == ref.param_count()
            assert ours.layer_kinds() == ref.layer_kinds()
    full = get_arch("qwen3-1.7b")
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab_size, full.qk_norm, full.rope_theta) == (
        28, 2048, 16, 8, 128, 6144, 151_936, True, 1e6)


def test_init_params_match_reference_tree(model):
    rcfg, rparams, cfg, _ = model
    ours = TT.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape), rparams)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == ref_shapes
    total = sum(t.numel() for t in jax.tree.leaves(ours))
    assert total == sum(a.size for a in jax.tree.leaves(rparams))
    w = ours["blocks"]["attention"]["w_gate"]
    assert w.dtype == torch.float32
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert float(ours["final_norm"].abs().max()) == 0.0


def test_unported_families_raise():
    """Every family builds its parameters and caches now: a shared
    attention pattern one unstacked block under ``blocks/shared_attention``
    and a KV slot an invocation, a frontend config ``frontend_proj`` [F, d]
    beside the embedding, an MoE config the MoE keys in place of the
    dense MLP's. None raises."""
    base = get_arch("qwen3-1.7b").reduced()
    d, hd = base.d_model, base.resolved_head_dim
    shared = dataclasses.replace(base, num_layers=3, block_pattern=(
        BlockKind.SHARED_ATTENTION,))
    blocks = TT.init_params(shared, device="cpu")["blocks"]
    assert set(blocks) == {"shared_attention"}
    assert blocks["shared_attention"]["norm_attn"].shape == (d,)
    assert blocks["shared_attention"]["w_gate"].shape == (d, base.d_ff)
    cache = TT.make_cache(shared, 1, 8, device="cpu")
    assert cache["shared_attention"]["k"].shape == (
        3, 1, 8, base.num_kv_heads, hd)
    front = dataclasses.replace(base, frontend="vision", frontend_dim=16)
    params = TT.init_params(front, device="cpu")
    assert params["frontend_proj"].shape == (16, d)
    assert set(TT.make_cache(front, 1, 8, device="cpu")) == {"attention"}
    moe = dataclasses.replace(base, moe=MoEConfig(4, 2))
    blocks = TT.init_params(moe, device="cpu")["blocks"]["attention"]
    assert {"router", "e_gate", "e_in", "e_out"} <= set(blocks)
    assert not {"w_gate", "w_in", "w_out"} & set(blocks)
    assert blocks["router"].shape == (2, moe.d_model, 4)
    cache = TT.make_cache(moe, 1, 8, device="cpu")
    assert cache["attention"]["k"].shape == (
        2, 1, 8, moe.num_kv_heads, moe.resolved_head_dim)


def test_forward_matches_reference(model):
    rcfg, rparams, cfg, params = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    ref_logits, _, _ = RT.forward(rparams, rcfg, jnp.asarray(toks))
    ours, aux, none = TT.forward(params, cfg, torch.as_tensor(toks))
    assert ours.shape == (2, 12, cfg.vocab_size) and none is None
    assert float(aux) == 0.0
    _close(ours, ref_logits)
    ref_hid = RR.hidden_states(rparams, rcfg, jnp.asarray(toks))
    _close(TR.hidden_states(params, cfg, torch.as_tensor(toks)), ref_hid)


def test_decode_attention_block_matches_reference(model):
    """The model's decode block (which calls the flash-decode dispatch)
    against the reference block, caches included."""
    rcfg, rparams, cfg, params = model
    p_ref = jax.tree.map(lambda a: a[0], rparams["blocks"]["attention"])
    p = {k: v[0] for k, v in params["blocks"]["attention"].items()}
    rng = np.random.default_rng(8)
    b, s, kvh, hd = 2, 32, cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    vc = rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
    pos = np.array([5, 17], np.int32)
    y_ref, k_ref, v_ref = RA.decode_attention_block(
        p_ref, rcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kc),
        jnp.asarray(vc), RA.AttnSpec(False, 0))
    k_ours, v_ours = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    y, k2, v2 = TA.decode_attention_block(
        p, cfg, torch.as_tensor(x), torch.as_tensor(pos), k_ours, v_ours,
        TA.AttnSpec(False, 0))
    assert k2 is k_ours and v2 is v_ours      # written in place
    _close(y, y_ref)
    _close(k2, k_ref)
    _close(v2, v_ref)


@pytest.fixture(scope="module")
def decode_runs(model):
    """Prefill a batch of prompts, then 8 greedy decode steps, in both
    packages; each side feeds back its own tokens."""
    rcfg, rparams, cfg, params = model
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
    steps, max_seq = 8, 24
    r_logits, r_cache = RDec.prefill_step(rparams, jnp.asarray(prompt),
                                          cfg=rcfg)
    t_logits, t_cache = TDec.prefill_step(params, torch.as_tensor(prompt),
                                          cfg=cfg)
    out = {"prefill": (t_logits, r_logits),
           "prefill_cache": (t_cache, r_cache)}
    r_cache = RT.grow_cache(r_cache, max_seq)
    t_cache = TT.grow_cache(t_cache, max_seq)
    r_tok = jnp.argmax(r_logits[:, -1:], -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits[:, -1:], dim=-1)
    out["steps"] = []
    for i in range(steps):
        pos = np.full(2, prompt.shape[1] + i, np.int32)
        r_nxt, r_step, r_cache = RDec.decode_step(
            rparams, r_cache, r_tok, jnp.asarray(pos), cfg=rcfg)
        t_nxt, t_step, t_cache = TDec.decode_step(
            params, t_cache, t_tok, torch.as_tensor(pos), cfg=cfg)
        out["steps"].append((t_nxt, r_nxt, t_step, r_step))
        r_tok, t_tok = r_nxt[:, None], t_nxt[:, None].long()
    out["final_cache"] = (t_cache, r_cache)
    return out


def test_prefill_cache_and_decode_logits_match_reference(decode_runs):
    t_logits, r_logits = decode_runs["prefill"]
    _close(t_logits, r_logits)
    for key in ("prefill_cache", "final_cache"):
        t_cache, r_cache = decode_runs[key]
        assert set(t_cache) == set(r_cache) == {"attention"}
        for name in ("k", "v"):
            assert tuple(t_cache["attention"][name].shape) == \
                r_cache["attention"][name].shape
            _close(t_cache["attention"][name], r_cache["attention"][name])
    for _, _, t_step, r_step in decode_runs["steps"]:
        assert t_step.dtype == torch.float32
        _close(t_step, r_step)


def test_greedy_decode_tokens_equal_reference(decode_runs):
    for t_nxt, r_nxt, _, _ in decode_runs["steps"]:
        assert t_nxt.dtype == torch.int32
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))


# staggered prompts over 2 slots (tests/test_batcher.py:41 and :104), more
# requests than slots, and a request stopped by its eos id
BATCHES = {
    "staggered": ([5, 9, 7], [6, 6, 6], 2, None),
    "mixed_lengths": ([3, 11, 5, 9, 4, 7], [2, 6, 3, 5, 2, 4], 2, None),
    "slot_reuse": ([4] * 5, [3] * 5, 2, None),
    "eos": ([6], [10], 1, "first"),
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_batcher_matches_reference(model, case):
    rcfg, rparams, cfg, params = model
    lengths, n_new, slots, eos = BATCHES[case]
    rng = np.random.default_rng(len(case))
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    eos_id = None
    if eos == "first":   # the first greedy token: stops after one token
        logits, _, _ = RT.forward(rparams, rcfg, jnp.asarray(prompts[:1]))
        eos_id = int(jnp.argmax(logits[0, -1]))
    runs = []
    for pkg, p in ((RB, rparams), (TB, params)):
        kw = {} if pkg is RB else {"device": "cpu"}
        b = pkg.ContinuousBatcher(p, cfg if pkg is TB else rcfg,
                                  num_slots=slots, max_seq=32, **kw)
        for i, pr in enumerate(prompts):
            b.submit(pkg.Request(i, pr, max_new_tokens=n_new[i],
                                 eos_id=eos_id))
        done = b.run_until_drained()
        runs.append({c.request_id: (c.tokens, c.prompt_len, c.steps)
                     for c in done})
    assert sorted(runs[1]) == list(range(len(prompts)))
    assert runs[1] == runs[0]
    if eos:
        assert len(runs[1][0][0]) == 1


def test_sampler_matches_reference():
    logits = np.random.default_rng(2).normal(size=(4, 64)).astype(
        np.float32)
    configs = [RS.SamplerConfig(greedy=True),
               RS.SamplerConfig(temperature=0.7),
               RS.SamplerConfig(top_k=5),
               RS.SamplerConfig(top_p=0.8, temperature=1.3)]
    for rc in configs:
        tc = TS.SamplerConfig(**dataclasses.asdict(rc))
        np.testing.assert_array_equal(
            TS.sample_np(logits, np.random.default_rng(3), tc),
            RS.sample_np(logits, np.random.default_rng(3), rc))
    greedy = TS.sample(torch.as_tensor(logits), torch.Generator(),
                       TS.SamplerConfig(greedy=True))
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(RS.sample(
            jnp.asarray(logits), jax.random.PRNGKey(0),
            RS.SamplerConfig(greedy=True))))
    # a draw stays inside the top-k set and follows the generator's seed
    top5 = np.argsort(-logits, axis=1)[:, :5]
    cfg = TS.SamplerConfig(top_k=5)
    draws = [TS.sample(torch.as_tensor(logits),
                       torch.Generator().manual_seed(7), cfg).numpy()
             for _ in range(2)]
    np.testing.assert_array_equal(draws[0], draws[1])
    assert all(t in row for t, row in zip(draws[0], top5))


@pytest.fixture(scope="module")
def datastores(model):
    rcfg, rparams, cfg, params = model
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (8, 24))
    ref = RR.build_datastore(rparams, rcfg, [toks], RefPyramidConfig(**PYR))
    index = ref.index
    arrays = lambda g: {f: getattr(g, f)  # noqa: E731
                        for f in convert.GRAPH_FIELDS}
    port_index = convert.index_from_arrays(
        dataclasses.asdict(index.config), arrays(index.meta),
        index.part_of_center, [arrays(g) for g in index.subs],
        device="cpu")
    ours = TR.Datastore(index=port_index, values=ref.values.copy())
    hid = np.asarray(RR.hidden_states(rparams, rcfg, jnp.asarray(toks)),
                     np.float32)
    queries = hid[:, :-1].reshape(-1, cfg.d_model)[::9]
    return toks, ref, ours, queries


def test_knn_probs_match_reference(model, datastores):
    cfg = model[2]
    _, ref, ours, queries = datastores
    r_ids, r_scores, _ = RD.search_single_host(ref.index, queries, k=4)
    t_ids, t_scores, _ = TD.search_single_host(ours.index, queries, k=4)
    np.testing.assert_array_equal(t_ids, r_ids)
    np.testing.assert_allclose(t_scores, r_scores, rtol=1e-5, atol=1e-4)
    r_p = RR.knn_probs(ref, queries, k=4, vocab_size=cfg.vocab_size)
    t_p = TR.knn_probs(ours, queries, k=4, vocab_size=cfg.vocab_size)
    np.testing.assert_allclose(t_p, r_p, rtol=1e-6, atol=1e-6)
    # the datastore remembers its keys: kNN mass lands on the next token
    assert (t_p.argmax(-1) == ref.values[::9]).mean() > 0.8


@pytest.mark.parametrize("quantize", (False, True), ids=("f32", "int8"))
def test_knn_probs_through_the_engine_equal_single_host(model, datastores,
                                                         quantize):
    """``knn_probs(client=...)`` (one ``search_batch`` through the serving
    engine, resolved by ``gather_arrays``) gives what ``knn_probs()``
    without a client gives, as the reference launcher's lookups do."""
    cfg = model[2]
    _, _, ours, queries = datastores
    kw = dict(quantize=True, rerank_factor=4) if quantize else {}
    want = TR.knn_probs(ours, queries, k=4, vocab_size=cfg.vocab_size)
    with TR.open_datastore_client(ours, **kw) as client:
        got = TR.knn_probs(ours, queries, k=4, vocab_size=cfg.vocab_size,
                           client=client, timeout_s=30.0)
        assert client.stats()["quantized"] == quantize
    assert client._closed
    if not quantize:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_knn_vocab_probs_and_interpolate_match_reference(model, datastores):
    cfg = model[2]
    _, ref, _, queries = datastores
    ids, scores, _ = RD.search_single_host(ref.index, queries, k=4)
    ids[0] = -1                            # a row with no hit: uniform
    for temperature in (1.0, 10.0):
        r = RR.knn_vocab_probs(ref.values, ids, scores,
                               vocab_size=cfg.vocab_size,
                               temperature=temperature)
        t = TR.knn_vocab_probs(ref.values, ids, scores,
                               vocab_size=cfg.vocab_size,
                               temperature=temperature)
        np.testing.assert_allclose(t, r, rtol=1e-6, atol=1e-6)
    lm = np.random.default_rng(4).normal(
        size=(len(queries), cfg.vocab_size)).astype(np.float32)
    for lam in (0.25, 0.5):
        np.testing.assert_allclose(TR.interpolate(lm, t, lam=lam),
                                   RR.interpolate(lm, r, lam=lam),
                                   rtol=1e-6, atol=1e-6)


def test_build_datastore_keys_and_values_match_reference(model, datastores):
    rcfg, rparams, cfg, params = model
    toks, ref, _, _ = datastores
    ours = TR.build_datastore(params, cfg, [toks], PyramidConfig(**PYR),
                              device="cpu")
    np.testing.assert_array_equal(ours.values, ref.values)
    ids_ours = np.sort(np.concatenate([g.ids for g in ours.index.subs]))
    np.testing.assert_array_equal(np.unique(ids_ours),
                                  np.arange(len(ref.values)))
    keys = {int(i): row for g in ours.index.subs
            for i, row in zip(g.ids, g.data)}
    ref_keys = {int(i): row for g in ref.index.subs
                for i, row in zip(np.asarray(g.ids), np.asarray(g.data))}
    for i in range(0, len(ref.values), 17):
        np.testing.assert_allclose(keys[i], ref_keys[i], **TOL)


def test_serve_entry_point_runs_on_cpu():
    before = launch_counts()
    gen = serve.main(["--tokens", "4", "--retrieval", "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < 512)).all()
    assert launch_counts() == before        # plain versions on the CPU


def test_serve_engine_options_run_on_cpu(tmp_path):
    """``--quantize``, ``--rerank-factor``, ``--trace-out`` and
    ``--metrics-port`` run: the trace holds the engine's spans."""
    trace = tmp_path / "trace.json"
    gen = serve.main(["--tokens", "3", "--retrieval", "--quantize",
                      "--rerank-factor", "2", "--trace-out", str(trace),
                      "--metrics-port", "0", "--device", "cpu"])
    assert gen.shape == (2, 3)
    payload = json.loads(trace.read_text())
    validate_chrome_trace(payload)
    names = {e["name"] for e in payload["traceEvents"]}
    assert {"serve.decode_step", "query", "executor.batch", "merge",
            "rerank", "kernel.beam_walk"} <= names
