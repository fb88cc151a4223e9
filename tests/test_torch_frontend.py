"""The port's vision and audio frontends (internvl2-2b, musicgen-medium)
against the JAX package, on the CPU, and a smoke pass over all ten
architectures.

A frontend is a projection, not an encoder: the model takes precomputed
float32 embeddings [B, S, F] in place of token ids, casts them to its
dtype and multiplies them by ``frontend_proj`` [F, d]; decode steps take
[B, 1, F]. The ``.reduced()`` configs (2 layers, d_model 128, F 64,
float32) are initialised by the reference and carried across with
``convert.lm_params_from_reference``; embeddings come from numpy seeds.

Tolerances: logits and decode logits to 1e-5 (float32, sums in another
order), greedy tokens equal; the un-sharded train step's loss, gradient
norm and first moments (each relative to its leaf's largest |g|) to 1e-4.
The smoke pass mirrors the reference's ``tests/test_arch_smoke.py``:
forward and one decode step of each registered architecture at
``.reduced()``, shapes and finiteness.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.common.registry import get_arch as ref_get_arch
from repro.data import synthetic as RD
from repro.models import transformer as RT
from repro.serving import decode as RDec
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import convert
from repro_torch.common.registry import get_arch, list_archs
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.models import transformer as TT
from repro_torch.serving import decode as TDec
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.train import tree as TTree

ARCHS = ("internvl2-2b", "musicgen-medium")
# the reference's tests/test_arch_smoke.py list
ALL_ARCHS = ("h2o-danube-1.8b", "zamba2-7b", "qwen3-1.7b",
             "phi3.5-moe-42b-a6.6b", "internvl2-2b", "grok-1-314b",
             "gemma3-12b", "mamba2-780m", "musicgen-medium", "chatglm3-6b")
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


def _embeds(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.frontend_dim)).astype(np.float32)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_proj_carried_over(arch):
    """``frontend_proj`` [F, d] beside the embedding, in both packages'
    trees; the reference's values carried over bit for bit; the port's
    own draw scaled by fan-in F."""
    _, rparams, cfg = _model(arch)
    assert cfg.frontend and cfg.frontend_dim == 64
    ours = TT.init_params(cfg, torch.Generator().manual_seed(1), **CPU)
    want = jax.tree.map(lambda a: tuple(a.shape), rparams)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == want
    proj = ours["frontend_proj"]
    assert proj.shape == (cfg.frontend_dim, cfg.d_model)
    assert abs(float(proj.std()) * cfg.frontend_dim ** 0.5 - 1.0) < 0.05
    carried = _params(arch)
    assert np.array_equal(carried["frontend_proj"].numpy(),
                          np.asarray(rparams["frontend_proj"]))
    for key, t in TTree.items(carried):
        ref = dict(TTree.items(jax.tree.map(np.asarray, rparams)))[key]
        assert np.array_equal(t.numpy(), np.asarray(ref)), key


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_embeddings_matches_reference(arch):
    rcfg, rparams, cfg = _model(arch)
    x = _embeds(cfg, 2, 24, seed=0)
    ref_logits, ref_aux, _ = RT.forward(rparams, rcfg, jnp.asarray(x))
    logits, aux, none = TT.forward(_params(arch), cfg, torch.as_tensor(x))
    assert logits.shape == (2, 24, cfg.vocab_size) and none is None
    assert float(aux) == float(ref_aux) == 0.0
    _close(logits, ref_logits)
    # the embedding table is not read: the projection is the input
    params = _params(arch)
    params["embedding"] = torch.zeros_like(params["embedding"])
    _close(TT.forward(params, cfg, torch.as_tensor(x))[0], ref_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_on_embeddings_matches_reference(arch):
    """Prefill [B, S, F] embeddings, then decode steps on [B, 1, F]
    stand-ins (the next embeddings of the sequence): caches and step
    logits within 1e-5, greedy tokens equal."""
    rcfg, rparams, cfg = _model(arch)
    params = _params(arch)
    seq = _embeds(cfg, 2, 18, seed=1)
    plen = 12
    r_logits, r_cache = RDec.prefill_step(rparams, jnp.asarray(seq[:, :plen]),
                                          cfg=rcfg)
    t_logits, t_cache = TDec.prefill_step(
        params, torch.as_tensor(seq[:, :plen]), cfg=cfg)
    _close(t_logits, r_logits)
    for name, a in r_cache["attention"].items():
        _close(t_cache["attention"][name], a)
    r_cache, t_cache = RT.grow_cache(r_cache, 24), TT.grow_cache(t_cache, 24)
    ref_step = jax.jit(functools.partial(RDec.decode_step, cfg=rcfg))
    for t in range(plen, seq.shape[1]):
        pos = np.full(2, t, np.int32)
        r_nxt, r_step, r_cache = ref_step(rparams, r_cache,
                                          jnp.asarray(seq[:, t:t + 1]),
                                          jnp.asarray(pos))
        t_nxt, t_step, t_cache = TDec.decode_step(
            params, t_cache, torch.as_tensor(seq[:, t:t + 1]),
            torch.as_tensor(pos), cfg=cfg)
        _close(t_step, r_step)
        np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(r_nxt))
    # decode from the prefill cache is the full forward's last rows
    full, _, _ = TT.forward(params, cfg, torch.as_tensor(seq))
    _close(t_step, full[:, -1], rtol=1e-4, atol=1e-4)


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
def test_train_steps_on_frontend_batches_match_reference(arch):
    """Two steps of the reference's un-sharded step on ``SyntheticLM``'s
    [B, S, F] batches, the port taking the reference's parameters and
    optimizer state before each: loss, gradient norm and every leaf's new
    first moment within 1e-4; at step 1 every leaf has a gradient but the
    embedding table, which a frontend model does not read (zero in both)."""
    rcfg, rparams, cfg = _model(arch)
    ropt, opt = RO.AdamWConfig(**REF_OPT), TO.AdamWConfig(**REF_OPT)
    ref_step = jax.jit(functools.partial(RTS.train_step, cfg=rcfg,
                                         opt_cfg=ropt))
    rstate = RO.init_opt_state(rparams)
    it = iter(RD.SyntheticLM(rcfg, batch=4, seq_len=16, seed=0))
    ours = iter(SyntheticLM(cfg, batch=4, seq_len=16, seed=0))
    for step in range(2):
        b = next(it)
        mine = next(ours)
        assert mine.inputs.shape == (4, 16, cfg.frontend_dim)
        np.testing.assert_array_equal(mine.inputs, b.inputs)
        host = jax.tree.map(np.asarray, (rparams, rstate))
        params = convert.lm_params_from_reference(host[0], cfg, **CPU)
        state = convert.opt_state_from_reference(
            host[1].step, host[1].mu, host[1].nu, cfg, **CPU)
        rparams, rstate, rm = ref_step(rparams, rstate, _jbatch(b))
        params, state, m = TTS.train_step(params, state, _tbatch(mine),
                                          cfg=cfg, opt_cfg=opt)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        rmu = dict(TTree.items(jax.tree.map(np.asarray, rstate.mu)))
        for key, mu in TTree.items(state.mu):
            if step == 0:
                assert (float(mu.abs().max()) > 0) == (key != "embedding"), \
                    key
            _close_rel(mu, rmu[key], 1e-4)


def test_train_launcher_takes_frontend_batches():
    """``launch/train.py`` on a frontend arch: its batches are [B, S, F]
    embeddings, and the losses are finite."""
    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        losses = train.main(["--arch", "musicgen-medium", "--reduced",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_frontend(arch):
    """The serve launcher prefills embedding prompts and decodes over zero
    stand-ins; ``--retrieval`` is refused with the reference's message."""
    ids = serve.main(["--arch", arch, "--device", "cpu", "--tokens", "4",
                      "--prompt-len", "6"])
    assert ids.shape == (2, 4)
    assert ((ids >= 0) & (ids < get_arch(arch).reduced().vocab_size)).all()
    with pytest.raises(SystemExit, match="token-input arch"):
        serve.main(["--arch", arch, "--device", "cpu", "--retrieval"])


def _smoke_inputs(cfg, b, s, rng):
    if cfg.frontend:
        return torch.as_tensor(
            rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32))
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, s)))


def test_all_archs_registered():
    assert set(ALL_ARCHS) == set(list_archs())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_smoke(arch):
    cfg = get_arch(arch).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), **CPU)
    x = _smoke_inputs(cfg, 2, 32, np.random.default_rng(0))
    logits, aux, _ = TT.forward(params, cfg, x)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_smoke(arch):
    cfg = get_arch(arch).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), **CPU)
    cache = TT.make_cache(cfg, batch=2, max_seq=16, **CPU)
    before = {g: {k: v.clone() for k, v in sub.items()}
              for g, sub in cache.items()}
    x = _smoke_inputs(cfg, 2, 1, np.random.default_rng(1))
    logits, _, new_cache = TT.forward(params, cfg, x, cache=cache,
                                      decode_pos=torch.zeros(2, dtype=torch.int32))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert any(not torch.equal(new_cache[g][k], v)
               for g, sub in before.items() for k, v in sub.items())
    # zamba2's cut to twelve layers runs both invocations' slots
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, num_layers=12)
        params = TT.init_params(cfg, torch.Generator().manual_seed(1), **CPU)
        cache = TT.make_cache(cfg, batch=2, max_seq=16, **CPU)
        TT.forward(params, cfg, x, cache=cache,
                   decode_pos=torch.zeros(2, dtype=torch.int32))
        assert bool((cache["shared_attention"]["k"][:, :, 0] != 0).all(
            dim=(1, 2, 3)).all())
