"""The port's mesh serving steps (``cache_shardings``, ``token_shardings``,
``make_prefill_step``, ``make_decode_step``) against the JAX package, on
four gloo ranks on the CPU.

Specs: the reference's ``cache_shardings`` and ``token_shardings`` are
computed in one subprocess with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``src/repro/launch/dryrun.py`` sets it) and held equal, element for
element, to the port's on the same meshes: (2, 2) and (1, 4), batches 4,
3 and 1. The reference's own sharded steps do not run (ROADMAP.md section
3), so the steps are held to its un-sharded jitted ``prefill_step`` and
``decode_step``: a prefill of 12 tokens, the cache grown to 24 positions,
then 8 greedy decode steps, each package feeding its own tokens back. The
greedy tokens must be equal and the logits (prefill and every step)
within 1e-5 of the reference's largest |logit|, and within 1e-5 of the
port's own one-device steps (``prefill_step``, ``decode_step`` on whole
tensors). zamba2's six layers are held within 1e-4 in both: five random
Mamba2 layers amplify the float32 rounding of any other order of sums
(2.3e-5 of the largest logit from the reference, 3.1e-5 from the
one-device steps, whose products are summed unsplit;
``tests/test_torch_hybrid.py`` holds its stack end to end at 1e-3).
Every rank's cache shard must be its chunk of the whole cache, shaped by
its ``MeshSharding``.

Configs (reduced, float32, as the reference builds them): qwen3-1.7b;
mamba2-780m at depth 2 (random Mamba2 stacks amplify float32 rounding,
ROADMAP.md section 3); gemma3-12b at six layers with a window of 8 (five
local layers on rings that wrap, one global layer); zamba2-7b at six
layers (five Mamba2 layers and its shared attention block); qwen3-1.7b
with 6 query heads over 2 at hd 16, whose query heads a model axis of 4
cannot split on whole heads (replicated for the kernel, as musicgen's 24
heads would be over 16) and one of 2 splits with one kv head a rank.
Runs: (2, 2)
at batch 4 (the cache split over ``data`` by batch), (2, 2) at batch 1
(the cache's sequence split over ``model``) and (1, 4) at batch 4.

The ranks are spawned as ``tests/test_torch_spmd.py`` spawns them
(``tests/torch_mesh_ranks.py``); this module imports JAX and ``repro``
only inside the parent's functions, so a rank loads neither.
"""
import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import convert
from repro_torch.common.registry import get_arch
from repro_torch.models.transformer import grow_cache
from repro_torch.serving import decode as SD
from repro_torch.train import tree as TT

import torch_mesh_ranks as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each case: its arch and the changes to the reduced config
CASES = {"qwen3-1.7b": ("qwen3-1.7b", {}),
         "mamba2-780m": ("mamba2-780m", {}),
         "gemma3-12b": ("gemma3-12b", {"num_layers": 6, "sliding_window": 8}),
         "zamba2-7b": ("zamba2-7b", {"num_layers": 6}),
         # 6 query heads over 2 at hd 16: w_q's 96 columns split over a
         # model axis of 4 fall mid-head (musicgen's 24 heads over 16 at
         # full size), so the heads are replicated for the kernel there;
         # over 2 they split into whole heads of one kv head each
         "qwen3-6-heads": ("qwen3-1.7b", {"num_heads": 6, "num_kv_heads": 2,
                                          "head_dim": 16})}
SPEC_MESHES, SPEC_BATCHES = ((2, 2), (1, 4)), (4, 3, 1)
RUNS = (((2, 2), 4), ((2, 2), 1), ((1, 4), 4))
PROMPT, MAX_SEQ, STEPS = 12, 24, 8
TOL = 1e-5
TOL_OF = {"zamba2-7b": 1e-4}


def _config(name: str, get):
    arch, changes = CASES[name]
    return dataclasses.replace(get(arch).reduced(), **changes)


def _prompt(name: str, batch: int) -> np.ndarray:
    cfg = _config(name, get_arch)
    rng = np.random.default_rng(batch)
    return rng.integers(0, cfg.vocab_size, size=(batch, PROMPT)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# rank side: no JAX, no repro
# ---------------------------------------------------------------------------


def _specs(mesh, cfg, batch) -> dict:
    cache = {f"{g}/{n}": sh.spec for g, sub in
             SD.cache_shardings(mesh, cfg, batch).items()
             for n, sh in sub.items()}
    return cache, {r: SD.token_shardings(mesh, cfg, batch, r).spec
                   for r in (1, 2, 3)}


def _serve(rank, mesh, name, batch, params_np) -> dict:
    """Prefill, growth and greedy decode on ``mesh``; whole tokens and
    logits (rank 0), and this rank's faulty cache shards."""
    cfg = _config(name, get_arch)
    params = convert.lm_params_from_reference(params_np, cfg, device="cpu")
    prefill, _ = SD.make_prefill_step(mesh, cfg, batch=batch,
                                      seq_len=PROMPT)
    decode, (_, cs, _, _) = SD.make_decode_step(mesh, cfg, batch=batch,
                                                max_seq=MAX_SEQ)
    logits, cache = prefill(params, _prompt(name, batch))
    cache = grow_cache(cache, MAX_SEQ, window=cfg.sliding_window)
    whole = logits.full_tensor()
    tok = whole[:, -1].argmax(-1).to(torch.int32)
    tokens, step_logits = [tok], []
    for i in range(STEPS):
        pos = torch.full((batch,), PROMPT + i, dtype=torch.int32)
        nxt, lg, cache = decode(params, cache, tok[:, None], pos)
        tok = nxt.full_tensor()
        tokens.append(tok)
        step_logits.append(lg.full_tensor())
    out = {"faults": R.shard_faults(cache, cs, TT.items),
           "split": R.split_leaves(cache, TT.items),
           "tokens": torch.stack(tokens, 1).numpy()}
    if rank == 0:
        out["prefill"] = whole.numpy()
        out["steps"] = torch.stack(step_logits, 1).numpy()
        out["plain"] = _serve_plain(cfg, params, name, batch, out["tokens"])
    return out


@torch.no_grad()
def _serve_plain(cfg, params, name, batch, tokens) -> dict:
    """The one-device steps on whole tensors, fed the mesh run's tokens:
    their prefill and step logits."""
    logits, cache = SD.prefill_step(params, torch.from_numpy(
        _prompt(name, batch)), cfg=cfg)
    cache = grow_cache(cache, MAX_SEQ, window=cfg.sliding_window)
    steps = []
    for i in range(STEPS):
        pos = torch.full((batch,), PROMPT + i, dtype=torch.int32)
        _, lg, cache = SD.decode_step(params, cache, torch.from_numpy(
            tokens[:, i:i + 1]), pos, cfg=cfg)
        steps.append(lg)
    return {"prefill": logits.numpy(), "steps": torch.stack(steps, 1).numpy()}


def _rank_main(rank, payload):
    meshes = {shape: init_device_mesh("cpu", shape, mesh_dim_names=R.AXES)
              for shape in SPEC_MESHES}
    out = {}
    for name in CASES:
        cfg = _config(name, get_arch)
        for shape in SPEC_MESHES:
            for batch in SPEC_BATCHES:
                out["specs", name, shape, batch] = _specs(meshes[shape],
                                                          cfg, batch)
        for shape, batch in RUNS:
            out[name, shape, batch] = _serve(rank, meshes[shape], name,
                                             batch, payload[name])
    return out


# ---------------------------------------------------------------------------
# parent side: the reference and the ranks' results
# ---------------------------------------------------------------------------

REF_SPECS = """
import ast, dataclasses, json, sys
import jax
from repro.common.registry import get_arch
from repro.serving import decode as D
out = {}
for name, (arch, changes) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    for shape in ast.literal_eval(sys.argv[2]):
        mesh = jax.make_mesh(shape, ("data", "model"))
        for batch in ast.literal_eval(sys.argv[3]):
            flat = jax.tree_util.tree_flatten_with_path(
                D.cache_shardings(mesh, cfg, batch))[0]
            cache = {"/".join(str(getattr(k, "key", k)) for k in path):
                     tuple(leaf.spec) for path, leaf in flat}
            tok = {r: tuple(D.token_shardings(mesh, cfg, batch, r).spec)
                   for r in (1, 2, 3)}
            out[repr((name, shape, batch))] = repr((cache, tok))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, "-c", REF_SPECS, json.dumps(CASES),
         repr(SPEC_MESHES), repr(SPEC_BATCHES)], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {ast.literal_eval(k): ast.literal_eval(v) for k, v in
            json.loads(out.stdout.strip().splitlines()[-1]).items()}


def _reference_run(name: str, batch: int) -> dict:
    """The reference's un-sharded jitted prefill and greedy decode."""
    import jax
    import jax.numpy as jnp
    from repro.common.registry import get_arch as ref_get_arch
    from repro.models import transformer as RT
    from repro.serving import decode as RSD
    rcfg = _config(name, ref_get_arch)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    prefill = jax.jit(functools.partial(RSD.prefill_step, cfg=rcfg))
    decode = jax.jit(functools.partial(RSD.decode_step, cfg=rcfg))
    logits, cache = prefill(params, jnp.asarray(_prompt(name, batch)))
    cache = RT.grow_cache(cache, MAX_SEQ, window=rcfg.sliding_window)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    tokens, steps = [tok], []
    for i in range(STEPS):
        pos = jnp.full((batch,), PROMPT + i, jnp.int32)
        tok, lg, cache = decode(params, cache, tok[:, None], pos)
        tokens.append(tok)
        steps.append(lg)
    return {"params": R.np_tree(params), "prefill": np.asarray(logits),
            "steps": np.stack([np.asarray(s) for s in steps], 1),
            "tokens": np.stack([np.asarray(t) for t in tokens], 1)}


@pytest.fixture(scope="module")
def reference():
    return {(name, batch): _reference_run(name, batch)
            for name in CASES for batch in sorted({b for _, b in RUNS})}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    payload = {name: reference[name, 4]["params"] for name in CASES}
    return R.run_ranks(_rank_main, payload, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("batch", SPEC_BATCHES)
@pytest.mark.parametrize("shape", SPEC_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", tuple(CASES))
def test_shardings_match_reference(reference_specs, ranks, name, shape,
                                   batch):
    """``cache_shardings`` (every cache group, ``@swa`` rings and
    ``shared_attention`` included) and ``token_shardings`` (ranks 1 to 3)
    equal the reference's spec for spec, on every rank."""
    want_cache, want_tok = reference_specs[name, shape, batch]
    for res in ranks:
        cache, tok = res["specs", name, shape, batch]
        assert cache == want_cache
        assert tok == want_tok
    if name == "gemma3-12b":
        assert {"attention/k", "attention@swa/k"} <= set(want_cache)
    if name == "zamba2-7b":
        assert {"mamba2/ssm", "shared_attention/k"} <= set(want_cache)


def test_head_split_names_the_replicated_case():
    """Query heads split over ``model`` on whole heads, each rank with the
    kv heads its heads read; where they do not (musicgen-medium's 24
    heads at hd 64 over a model axis of 16, this module's 6 over 4), the
    heads are replicated for the kernel."""
    from repro_torch.models.attention import _head_split
    assert _head_split(24, 24, 16) is None          # musicgen at full size
    assert _head_split(6, 2, 4) is None             # "qwen3-6-heads", (1, 4)
    assert _head_split(6, 2, 2) == (3, 1)           # ... at (2, 2)
    assert _head_split(16, 8, 16) == (1, 1)         # qwen3 at full size
    assert _head_split(32, 8, 4) == (8, 2)          # phi3.5-moe over 4
    assert _head_split(48, 8, 16) == (3, 1)         # grok-1: G = 6
    assert _head_split(4, 4, 1) is None             # one model rank


def test_policy_cases_are_covered(reference_specs):
    """The cases exercise what the module docstring names: at (2, 2) batch
    4 splits over ``data``, batch 3 and batch 1 split the kv sequence over
    ``model``; at (1, 4) every batch splits over ``data``; the Mamba2
    states split over ``model``."""
    qwen = {(shape, b): reference_specs["qwen3-1.7b", shape, b][0]
            ["attention/k"] for shape in SPEC_MESHES for b in SPEC_BATCHES}
    assert qwen[(2, 2), 4] == (None, "data", None, None, None)
    assert qwen[(2, 2), 3] == qwen[(2, 2), 1] == (None, None, "model", None,
                                                  None)
    assert all(qwen[(1, 4), b][1] == "data" for b in SPEC_BATCHES)
    mamba = reference_specs["mamba2-780m", (2, 2), 1][0]
    assert mamba["mamba2/ssm"][2] == "model"
    assert mamba["mamba2/conv"][3] == "model"


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0][0]}x{r[0][1]}"
                         f"-batch{r[1]}")
@pytest.mark.parametrize("name", tuple(CASES))
def test_steps_match_reference(reference, ranks, name, run):
    """Greedy tokens equal to the reference's on every rank; prefill and
    step logits within 1e-5 (zamba2 1e-4) of the reference's largest
    |logit|, from the reference's and from the one-device steps'."""
    shape, batch = run
    want = reference[name, batch]
    for res in ranks:
        np.testing.assert_array_equal(res[name, shape, batch]["tokens"],
                                      want["tokens"])
    ours = ranks[0][name, shape, batch]
    tol = TOL_OF.get(name, TOL)
    for key in ("prefill", "steps"):
        scale = float(np.abs(want[key]).max())
        for other in (want[key], ours["plain"][key]):
            err = float(np.abs(ours[key] - other).max())
            assert err <= tol * scale, (key, err, scale)


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0][0]}x{r[0][1]}"
                         f"-batch{r[1]}")
@pytest.mark.parametrize("name", tuple(CASES))
def test_each_rank_holds_its_cache_rows(ranks, name, run):
    """After the decode steps every cache leaf on every rank is a DTensor
    whose local tensor is the rank's chunk of the whole cache, shaped by
    its ``MeshSharding``: by batch rows at (2, 2) batch 4, by sequence
    rows at (2, 2) batch 1, the Mamba2 states by heads and channels over
    ``model`` (at (1, 4) the kv caches are whole: one data rank holds the
    batch, and kv heads stay replicated)."""
    shape, batch = run
    splits = shape == (2, 2) or name in ("mamba2-780m", "zamba2-7b")
    for res in ranks:
        assert res[name, shape, batch]["faults"] == []
        assert (res[name, shape, batch]["split"] > 0) == splits
