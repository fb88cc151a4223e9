"""The port's training slice against the JAX package, on the CPU.

The ``.reduced()`` qwen3-1.7b and mamba2-780m configs (2 layers, float32)
are initialised by the reference and carried across with
``convert.lm_params_from_reference``; batches come from both packages'
``SyntheticLM`` with the same seed (equal bit for bit). The reference's
step runs as ``train_step(..., mesh=None)`` under ``jax.jit`` (its
sharded step fails, ROADMAP.md section 3). Tolerances: the schedule to
1e-7; cross-entropies, their gradients and the plain SSD's gradients to
1e-5 (1e-4 for the SSD, whose decays are exponentials of differences of
float32 prefix sums), each gradient relative to its leaf's largest |g|;
``loss_fn``'s gradients to 1e-4 of each leaf's largest |g|; five train
steps' losses and gradient norms to 1e-4 (the two packages sum each
product in another order, float32). Checkpoints load across packages
(float32) and a bfloat16 checkpoint round-trips bit for bit.
"""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.common.registry import get_arch as ref_get_arch
from repro.data import synthetic as RD
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import convert
from repro_torch.common.registry import get_arch
from repro_torch.data import synthetic as TD
from repro_torch.kernels.ssd import ssd_backward_cuda, ssd_cuda
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ssm as TS
from repro_torch.train import checkpoint as TC
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.train import tree as TT

ARCHS = ("qwen3-1.7b", "mamba2-780m")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference test's optimizer (tests/test_training.py)
REF_OPT = dict(lr=5e-3, warmup_steps=5, total_steps=120, weight_decay=0.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cpu_mesh():
    """A (1, 1) gloo mesh; the process group is destroyed afterwards."""
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_local_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    rcfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, rparams, cfg


def _params(arch: str) -> dict:
    """A fresh copy of the reference's parameters, carried into the port
    (the port's AdamW writes into its parameters)."""
    _, rparams, cfg = _model(arch)
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu")


def _batches(arch: str, n: int, batch: int = 8, seq: int = 32):
    rcfg = _model(arch)[0]
    it = iter(RD.SyntheticLM(rcfg, batch=batch, seq_len=seq, seed=0))
    return [next(it) for _ in range(n)]


def _jbatch(b):
    return {"inputs": jnp.asarray(b.inputs), "targets": jnp.asarray(b.targets),
            "mask": jnp.asarray(b.mask)}


def _tbatch(b):
    return {"inputs": torch.from_numpy(b.inputs),
            "targets": torch.from_numpy(b.targets),
            "mask": torch.from_numpy(b.mask)}


def _close_rel(ours, ref, rel: float):
    """|ours - ref| <= rel * max |ref| elementwise."""
    ref = np.asarray(ref, np.float64)
    ours = ours.detach().double().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, (err, scale)


def _bf16_tensor(a) -> torch.Tensor:
    """A torch bfloat16 tensor of a numpy (``ml_dtypes``) bfloat16 array."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend", (None, "vision"))
def test_synthetic_lm_batches_equal_bit_for_bit(frontend):
    rcfg = ref_get_arch("qwen3-1.7b").reduced()
    cfg = get_arch("qwen3-1.7b").reduced()
    if frontend:
        rcfg = dataclasses.replace(rcfg, frontend=frontend, frontend_dim=64)
        cfg = dataclasses.replace(cfg, frontend=frontend, frontend_dim=64)
    ref = iter(RD.SyntheticLM(rcfg, batch=4, seq_len=24, seed=3))
    ours = iter(TD.SyntheticLM(cfg, batch=4, seq_len=24, seed=3))
    for _ in range(3):
        r, o = next(ref), next(ours)
        for name in ("inputs", "targets", "mask"):
            a, b = getattr(o, name), getattr(r, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert o.inputs.shape == ((4, 24, 64) if frontend else (4, 24))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", (REF_OPT, {}, dict(warmup_steps=0)),
                         ids=("reference_test", "defaults", "no_warmup"))
def test_schedule_matches_reference(kw):
    rcfg, cfg = RO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    steps = np.arange(121)
    ref = np.asarray(RO.schedule(rcfg, jnp.asarray(steps)))
    ours = TO.schedule(cfg, torch.from_numpy(steps)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)


def test_adamw_update_matches_reference():
    """Three updates of a tree with a float32 and a bfloat16 leaf."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    rcfg, cfg = RO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    v = rng.normal(size=(7,)).astype(np.float32)
    rparams = {"w": jnp.asarray(w), "v": jnp.asarray(v).astype(jnp.bfloat16)}
    params = {"w": torch.from_numpy(w.copy()),
              "v": _bf16_tensor(np.asarray(rparams["v"]))}
    rstate, state = RO.init_opt_state(rparams), TO.init_opt_state(params)
    for _ in range(3):
        gw = rng.normal(size=(3, 5)).astype(np.float32)
        gv = rng.normal(size=(7,)).astype(np.float32)
        rg = {"w": jnp.asarray(gw), "v": jnp.asarray(gv).astype(jnp.bfloat16)}
        g = {"w": torch.from_numpy(gw), "v": _bf16_tensor(np.asarray(rg["v"]))}
        rparams, rstate, rstats = RO.adamw_update(rcfg, rparams, rg, rstate)
        params, state, stats = TO.adamw_update(cfg, params, g, state)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(rstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(stats["lr"]), float(rstats["lr"]),
                                   rtol=1e-7)
        assert int(state.step) == int(rstate.step)
        for k in ("w", "v"):
            np.testing.assert_allclose(state.mu[k].numpy(),
                                       np.asarray(rstate.mu[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(state.nu[k].numpy(),
                                       np.asarray(rstate.nu[k]), rtol=1e-6,
                                       atol=1e-8)
        np.testing.assert_allclose(params["w"].numpy(),
                                   np.asarray(rparams["w"]), rtol=1e-6,
                                   atol=1e-7)
        assert params["v"].dtype == torch.bfloat16
        assert torch.equal(params["v"],
                           _bf16_tensor(np.asarray(rparams["v"])))


def test_adamw_converges_quadratic():
    cfg = TO.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                         total_steps=200, min_lr_frac=1.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    target = torch.tensor([1.0, 1.0])
    state = TO.init_opt_state(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = TO.adamw_update(cfg, params, g, state)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=0.05)


def test_grad_clip_applies():
    cfg = TO.AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0,
                         warmup_steps=0, min_lr_frac=1.0)
    params = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    state = TO.init_opt_state(params)
    new, _, stats = TO.adamw_update(cfg, params, g, state)
    assert float(stats["grad_norm"]) == pytest.approx(200.0)
    assert new["w"].abs().max().item() <= 1.5  # bounded step


# ---------------------------------------------------------------------------
# losses and the SSD's gradient
# ---------------------------------------------------------------------------


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 37, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, size=(2, 37)).astype(np.int32)
    mask = (rng.random((2, 37)) > 0.2).astype(np.float32)
    ref, rg = jax.value_and_grad(RTS.softmax_xent)(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    lt = torch.from_numpy(logits).requires_grad_(True)
    ours = TTS.softmax_xent(lt, torch.from_numpy(targets),
                            torch.from_numpy(mask))
    (g,) = torch.autograd.grad(ours, lt)
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)
    _close_rel(g, rg, 1e-5)


@pytest.mark.parametrize("chunk", (8, 64))
def test_chunked_softmax_xent_matches_reference(chunk):
    """S = 37 is not a multiple of the chunk of 8 (the rows are padded);
    a chunk of 64 covers it at once."""
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(2, 37, 16)).astype(np.float32)
    head = rng.normal(size=(16, 50)).astype(np.float32) * 0.5
    targets = rng.integers(0, 50, size=(2, 37)).astype(np.int32)
    mask = (rng.random((2, 37)) > 0.2).astype(np.float32)
    ref, (rgh, rgw) = jax.value_and_grad(
        lambda h, w: RTS.chunked_softmax_xent(
            h, w, jnp.asarray(targets), jnp.asarray(mask), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(head).requires_grad_(True)
    ours = TTS.chunked_softmax_xent(h, w, torch.from_numpy(targets),
                                    torch.from_numpy(mask), chunk=chunk)
    gh, gw = torch.autograd.grad(ours, (h, w))
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)
    _close_rel(gh, rgh, 1e-5)
    _close_rel(gw, rgw, 1e-5)


@pytest.mark.parametrize("final_cot", (False, True), ids=("y", "y_final"))
@pytest.mark.parametrize("initial", (False, True), ids=("zero", "state"))
def test_ssd_chunked_gradients_match_reference(initial, final_cot):
    """Autograd through the port's ``ssd_chunked`` (the CPU's train path)
    against ``jax.vjp`` of the reference's, for all six inputs, at chunk
    32 and S = 80 (two chunks and a padded third), with the model's
    decay rates."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 80, 4, 8, 6
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    init = rng.normal(size=(b, h, n, p)).astype(np.float32) if initial \
        else np.zeros((b, h, n, p), np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dfin = rng.normal(size=(b, h, n, p)).astype(np.float32) if final_cot \
        else np.zeros((b, h, n, p), np.float32)
    args = (x, dt, a, bm, cm, init)

    def ref_fn(x_, dt_, a_, b_, c_, s0):
        return RS.ssd_chunked(x_, dt_, a_, b_, c_, chunk=32,
                              initial_state=s0 if initial else None)
    _, vjp = jax.vjp(ref_fn, *map(jnp.asarray, args))
    ref_grads = vjp((jnp.asarray(dy), jnp.asarray(dfin)))
    ins = [torch.from_numpy(t.copy()).requires_grad_(True) for t in args]
    y, final = TS.ssd_chunked(*ins[:5], chunk=32,
                              initial_state=ins[5] if initial else None)
    outs, cots = [y], [torch.from_numpy(dy)]
    if final_cot:
        outs.append(final)
        cots.append(torch.from_numpy(dfin))
    grads = torch.autograd.grad(outs, ins[:5] + ins[5:] * initial, cots)
    names = ("x", "dt", "a", "b", "c", "initial_state")
    for name, g, rg in zip(names, grads, ref_grads):
        assert g is not None, name
        _close_rel(g, rg, 1e-4)


def test_ssd_kernels_refuse_inputs_that_need_a_gradient():
    """``ssd_cuda`` returns tensors without a gradient: with grad mode on
    and an input that requires grad it raises before it looks at the
    device, so no call outside ``ssd_scan`` cuts the gradient."""
    x = torch.zeros(1, 4, 2, 3, requires_grad=True)
    dt, a = torch.ones(1, 4, 2), -torch.ones(2)
    bm = cm = torch.zeros(1, 4, 5)
    with pytest.raises(RuntimeError, match="ssd_scan"):
        ssd_cuda(x, dt, a, bm, cm, chunk=4)
    with pytest.raises(RuntimeError, match="ssd_scan"):
        ssd_backward_cuda(x, dt, a, bm, cm, torch.zeros(1, 4, 2, 3), chunk=4)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(x, dt, a, bm, cm, chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(x.detach(), dt, a, bm, cm, chunk=4)


# ---------------------------------------------------------------------------
# loss_fn and train steps
# ---------------------------------------------------------------------------


def _ref_grads(arch: str, b):
    rcfg, rparams, _ = _model(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt: RTS.loss_fn(p, rcfg, bt), has_aux=True))
    (total, (loss, _)), grads = fn(rparams, _jbatch(b))
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_grads(arch: str, b, **kw):
    cfg = _model(arch)[2]
    params = _params(arch)
    flat = TT.items(params)
    leaves = [p.requires_grad_(True) for _, p in flat]
    total, (loss, _) = TTS.loss_fn(params, cfg, _tbatch(b), **kw)
    grads = torch.autograd.grad(total, leaves)
    return float(loss.detach()), dict(zip([k for k, _ in flat], grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_gradients_match_reference(arch):
    b = _batches(arch, 1)[0]
    ref_loss, ref_grads = _ref_grads(arch, b)
    loss, grads = _port_grads(arch, b)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    ref_flat = dict(TT.items(convert.lm_params_from_reference(
        ref_grads, _model(arch)[2], device="cpu")))
    assert set(grads) == set(ref_flat)
    for key, g in grads.items():
        assert g.abs().max() > 0, key
        _close_rel(g, ref_flat[key].numpy(), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_number(arch):
    """Per-layer remat (the default) against per-segment remat: equal
    losses, and gradients equal up to the run-to-run spread of the
    embedding gather's accumulating backward on the CPU threads (about
    1e-7 of the leaf's largest |g|; every other leaf is equal bit for
    bit); and the forward with and without remat, in and out of grad
    mode, equal."""
    b = _batches(arch, 1)[0]
    base_loss, base = _port_grads(arch, b, remat_segments=False)
    loss, grads = _port_grads(arch, b, remat_segments=True)
    assert loss == base_loss
    for key in base:
        if key == "embedding":
            _close_rel(grads[key], base[key].numpy(), 1e-6)
        else:
            assert torch.equal(grads[key], base[key]), key
    cfg = _model(arch)[2]
    params = TT.map_tree(lambda t: t.requires_grad_(True), _params(arch))
    from repro_torch.models.transformer import forward
    tokens = torch.from_numpy(b.inputs)
    on = forward(params, cfg, tokens, remat=True)[0]
    off = forward(params, cfg, tokens, remat=False)[0]
    with torch.no_grad():
        plain = forward(params, cfg, tokens)[0]
    assert on.requires_grad and torch.equal(on, off)
    assert torch.equal(on.detach(), plain)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Five steps of the reference's trajectory. Before each step the
    port takes the reference's parameters and optimizer state (through
    ``convert``), so each step is compared from the same inputs: the
    loss, the gradient norm, the learning rate and the new first moments
    (a tenth of the clipped gradient plus the same carried part) agree.
    Parameters after an AdamW step are not compared: the first steps move
    each weight by about lr times the sign of its gradient, and a
    gradient near zero can take either sign in two summation orders."""
    rcfg, rparams, cfg = _model(arch)
    ropt, opt = RO.AdamWConfig(**REF_OPT), TO.AdamWConfig(**REF_OPT)
    ref_step = jax.jit(functools.partial(RTS.train_step, cfg=rcfg,
                                         opt_cfg=ropt))
    rstate = RO.init_opt_state(rparams)
    for b in _batches(arch, 5):
        host = jax.tree.map(np.asarray, (rparams, rstate))
        params = convert.lm_params_from_reference(host[0], cfg, device="cpu")
        state = convert.opt_state_from_reference(
            host[1].step, host[1].mu, host[1].nu, cfg, device="cpu")
        rparams, rstate, rm = ref_step(rparams, rstate, _jbatch(b))
        params, state, m = TTS.train_step(params, state, _tbatch(b), cfg=cfg,
                                          opt_cfg=opt)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-7)
        assert int(state.step) == int(rstate.step)
        rmu = dict(TT.items(jax.tree.map(np.asarray, rstate.mu)))
        for key, mu in TT.items(state.mu):
            _close_rel(mu, rmu[key], 1e-4)
    assert int(state.step) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_decreases(arch, cpu_mesh):
    """The reference test's criterion, through ``make_train_step`` and
    ``init_sharded`` on a (1, 1) mesh: over 60 steps the mean of the last
    five losses falls below the mean of the first five less 0.1."""
    cfg = get_arch(arch).reduced()
    step_fn, _ = TTS.make_train_step(cpu_mesh, cfg,
                                     TO.AdamWConfig(**REF_OPT))
    params, opt_state = TTS.init_sharded(cpu_mesh, cfg, seed=0)
    data = iter(TD.SyntheticLM(cfg, batch=8, seq_len=32, seed=0))
    losses = []
    for _ in range(60):
        b = next(data)
        params, opt_state, m = step_fn(
            params, opt_state,
            {"inputs": b.inputs, "targets": b.targets, "mask": b.mask})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_match_one_rank(arch, cpu_mesh, tmp_path):
    """``make_train_step`` and ``init_sharded`` on a (2, 2) mesh of four
    gloo ranks (``tests/torch_mesh_ranks.py``) give the losses of the
    same five steps on this process's (1, 1) mesh, within 1e-4."""
    import torch_mesh_ranks as R
    payload = dict(arch=arch, mesh=(2, 2), opt=REF_OPT, batch=8, seq=32,
                   steps=5)
    ranks = R.run_ranks(R.train_losses, payload, tmp_path)
    cfg = get_arch(arch).reduced()
    step_fn, _ = TTS.make_train_step(cpu_mesh, cfg,
                                     TO.AdamWConfig(**REF_OPT))
    params, opt_state = TTS.init_sharded(cpu_mesh, cfg, seed=0)
    data = iter(TD.SyntheticLM(cfg, batch=8, seq_len=32, seed=0))
    one = []
    for _ in range(payload["steps"]):
        b = next(data)
        params, opt_state, m = step_fn(
            params, opt_state,
            {"inputs": b.inputs, "targets": b.targets, "mask": b.mask})
        one.append(float(m["loss"]))
    for losses in ranks:
        np.testing.assert_allclose(losses, one, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------


def _spec(named_sharding) -> tuple:
    return tuple(named_sharding.spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_reference(arch, cpu_mesh):
    rcfg, _, cfg = _model(arch)
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    rshape = RTS.abstract_params(rcfg)
    shape = TTS.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in TT.leaves(shape))
    rps = dict(TT.items(jax.tree.map(_spec, RTS.param_shardings(
        rmesh, rcfg, rshape))))
    ps = dict(TT.items(TTS.param_shardings(cpu_mesh, cfg, shape)))
    assert set(ps) == set(rps)
    for key, sh in ps.items():
        assert sh.spec == rps[key], key
    ros = RTS.opt_shardings(rmesh, rcfg, rshape)
    ost = TTS.opt_shardings(cpu_mesh, cfg, shape)
    assert ost.step.spec == _spec(ros.step)
    for tree, rtree in ((ost.mu, ros.mu), (ost.nu, ros.nu)):
        rflat = dict(TT.items(jax.tree.map(_spec, rtree)))
        assert {k: v.spec for k, v in TT.items(tree)} == rflat
    for frontend in (None, "vision"):
        rb = RTS.batch_shardings(rmesh, dataclasses.replace(
            rcfg, frontend=frontend))
        tb = TTS.batch_shardings(cpu_mesh, dataclasses.replace(
            cfg, frontend=frontend))
        assert {k: v.spec for k, v in tb.items()} == \
            {k: _spec(v) for k, v in rb.items()}


def test_spec_rules_match_reference():
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    assert TL._RULES == RL._RULES
    for name in RL._RULES:
        for ndim in (1, 2, 3, 4):
            for stacked in (False, True):
                assert TL.spec_for(name, ndim, stacked) == \
                    RL.spec_for(name, ndim, stacked)


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------


def _moments(arch: str, seed: int):
    rng = np.random.default_rng(seed)
    _, rparams, cfg = _model(arch)
    mu = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                      rparams)
    nu = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                      rparams)
    return mu, nu


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_load_across_packages(arch, tmp_path):
    rcfg, rparams, cfg = _model(arch)
    mu, nu = _moments(arch, 5)
    rstate = RO.OptState(step=jnp.asarray(0, jnp.int32),
                         mu=jax.tree.map(jnp.asarray, mu),
                         nu=jax.tree.map(jnp.asarray, nu))
    params = _params(arch)
    state = convert.opt_state_from_reference(0, mu, nu, cfg, device="cpu")
    # port -> reference
    TC.save_checkpoint(str(tmp_path / "ours"), params, state, step=11,
                       meta={"arch": cfg.name})
    rp, rs, step = RC.load_checkpoint(str(tmp_path / "ours"), rparams,
                                      rstate)
    assert step == 11 and int(rs.step) == 11
    for ours, ref in ((params, rp), (state.mu, rs.mu), (state.nu, rs.nu)):
        rflat = dict(TT.items(jax.tree.map(np.asarray, ref)))
        for key, t in TT.items(ours):
            assert np.array_equal(t.numpy(), rflat[key]), key
    # reference -> port
    RC.save_checkpoint(str(tmp_path / "ref"), rparams, rstate, step=13)
    p2, s2, step = TC.load_checkpoint(str(tmp_path / "ref"), params, state)
    assert step == 13 and int(s2.step) == 13
    for ours, ref in ((p2, rparams), (s2.mu, rstate.mu), (s2.nu, rstate.nu)):
        rflat = dict(TT.items(jax.tree.map(np.asarray, ref)))
        for key, t in TT.items(ours):
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy(), rflat[key]), key


def test_bfloat16_checkpoint_round_trip(tmp_path):
    """bf16 leaves are stored as numpy stores the reference's (raw |V2
    values) and read back bit for bit, from the port's file and from the
    reference's."""
    rcfg = dataclasses.replace(ref_get_arch("mamba2-780m").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("mamba2-780m").reduced(),
                              dtype="bfloat16")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(1))
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    assert params["embedding"].dtype == torch.bfloat16
    TC.save_checkpoint(str(tmp_path / "ours"), params, step=2)
    RC.save_checkpoint(str(tmp_path / "ref"), rparams, step=2)
    for name in ("ours", "ref"):
        with np.load(str(tmp_path / name / "params.npz")) as z:
            assert z["embedding"].dtype == np.dtype("V2")
            assert z["blocks/mamba2/a_log"].dtype == np.float32
        back, state, step = TC.load_checkpoint(str(tmp_path / name), params)
        assert state is None and step == 2
        for (key, t), (_, u) in zip(TT.items(back), TT.items(params)):
            assert t.dtype == u.dtype and torch.equal(t, u), key


def test_launcher_trains_and_checkpoints(tmp_path):
    """The launcher in a subprocess: its checkpoint loads back to the
    parameters and moments it held, bit for bit (the digests it logs),
    with the step of its manifest."""
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "mamba2-780m", "--reduced", "--steps", "3", "--ckpt",
         str(ck)], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "step    2 loss=" in out.stderr + out.stdout
    cfg = get_arch("mamba2-780m").reduced()
    template = TTS.abstract_params(cfg)
    params, state, step = TC.load_checkpoint(
        str(ck), template, TO.init_opt_state(template), device="cpu")
    assert step == 3 and int(state.step) == 3
    for t in TT.leaves(params) + TT.leaves(state.nu):
        assert t.device.type == "cpu" and torch.isfinite(t).all()
    assert any(t.abs().max() > 0 for t in TT.leaves(state.mu))
    logged = re.search(r"params digest (\w+), mu (\w+), nu (\w+)",
                       out.stderr + out.stdout).groups()
    assert logged == (TC.tree_digest(params), TC.tree_digest(state.mu),
                      TC.tree_digest(state.nu))


def _launch(tmp_path, name: str, env: dict, *extra: str):
    """The launcher (reduced qwen3, 5 steps, with a checkpoint) started in
    a subprocess of one CPU thread; returns the process and the path of
    its checkpoint."""
    ck = tmp_path / f"ck_{name}"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **env)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "5", "--ckpt", str(ck), *extra], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, ck


def _logged_losses(out: str) -> list:
    return json.loads(re.search(r"\] losses (\[.*\])", out).group(1))


def test_launcher_across_ranks(tmp_path):
    """The launcher as four gloo ranks (``RANK`` and ``WORLD_SIZE`` in the
    environment, ``--dist-init`` a file in the test's tmp dir) beside the
    one-rank launcher: the same five losses within 1e-4; one checkpoint,
    written by rank 0, that loads back to the digests the run logged,
    with the keys, shapes and dtypes of the one-rank checkpoint and its
    values within 1e-4 of each leaf's largest |value| but for under a
    thousandth of the elements (the four ranks sum their products in
    another order, so five chained AdamW steps part the two runs where a
    gradient's sign is not determined in float32: the files are not equal
    bit for bit)."""
    one = _launch(tmp_path, "one", {"WORLD_SIZE": "1"})
    rdv = f"file://{tmp_path / 'rendezvous'}"
    ranks = [_launch(tmp_path, "four", {"RANK": str(r), "WORLD_SIZE": "4"},
                     "--dist-init", rdv) for r in range(4)]
    outs = []
    for proc, _ in [one] + ranks:
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out[-3000:]
        outs.append(out)
    losses_four = _logged_losses(outs[1])
    assert len(losses_four) == 5
    np.testing.assert_allclose(losses_four, _logged_losses(outs[0]), rtol=0,
                               atol=1e-4)
    logged = re.search(r"params digest (\w+), mu (\w+), nu (\w+)",
                       outs[1]).groups()
    assert all("params digest" not in out and "losses" not in out
               for out in outs[2:])
    cfg = get_arch("qwen3-1.7b").reduced()
    template = TTS.abstract_params(cfg)
    loaded = {}
    for name, ck in (("one", one[1]), ("four", ranks[0][1])):
        params, state, step = TC.load_checkpoint(
            str(ck), template, TO.init_opt_state(template), device="cpu")
        assert step == 5 and int(state.step) == 5
        loaded[name] = (params, state.mu, state.nu)
    assert logged == tuple(TC.tree_digest(t) for t in loaded["four"])
    off = total = 0
    for ours, ref in zip(loaded["four"], loaded["one"]):
        for (key, t), (_, u) in zip(TT.items(ours), TT.items(ref)):
            assert t.dtype == u.dtype and t.shape == u.shape, key
            scale = max(float(u.abs().max()), 1e-30)
            off += int(((t - u).abs() > 1e-4 * scale).sum())
            total += u.numel()
    assert off < 1e-3 * total, (off, total)


def test_checkpoint_refuses_another_model(tmp_path):
    """A checkpoint loads only into a template of its own keys and
    shapes."""
    cfg = get_arch("qwen3-1.7b").reduced()
    TC.save_checkpoint(str(tmp_path), _params("qwen3-1.7b"), step=1)
    wider = TTS.abstract_params(dataclasses.replace(cfg, d_model=64))
    with pytest.raises(ValueError, match="the checkpoint holds"):
        TC.load_checkpoint(str(tmp_path), wider, device="cpu")
    other = TTS.abstract_params(get_arch("mamba2-780m").reduced())
    with pytest.raises(KeyError, match="mamba2"):
        TC.load_checkpoint(str(tmp_path), other, device="cpu")
