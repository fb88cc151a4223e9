"""The train step: loss, gradients and the AdamW update (port of
``repro.train.train_step``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves;
on the card the Mamba2 scan's gradient runs in the SSD backward kernel
(``kernels/ssd``). The LM head's product and the cross-entropy run one
sequence chunk at a time, each chunk under ``checkpoint``, so the
[B, S, V] logits are never held whole.

The sharding helpers give the reference's specs, element for element, as
``MeshSharding``s over the port's mesh. ``make_train_step`` and
``init_sharded`` run on a mesh of any world size, one code path at every
size (a (1, 1) mesh included): parameters and both AdamW moments are
DTensors of those shardings (a rank holds its shards), the batch is split
over the batch axes, DTensor's sharding propagation places every product
and inserts the collectives (FSDP gathers of weights, tensor-parallel
partial sums, the gradients' reductions), and the kernels run on local
tensors under ``local_map`` (``models/ssm``, ``models/attention``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.common import sharding as S
from repro_torch.common.config import ArchConfig
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import forward, init_params
from repro_torch.train import tree as T
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         init_opt_state)

def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The target's logit, picked by an iota == target select summed over
    the vocab (the reference's choice): on a vocab sharded over ``model``
    each rank sums its own columns and only [B, S] partials are reduced,
    where a gather would need the whole row. Adding zeros is exact, so
    the value is the gathered one."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    hit = iota == targets.long()[..., None]
    return torch.sum(torch.where(hit, logits, 0.0), dim=-1)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean masked cross-entropy, in float32."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - _gold(logits, targets)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, t: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    logits = (h @ head).float()
    return torch.sum((torch.logsumexp(logits, dim=-1) - _gold(logits, t))
                     * m)


def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Cross-entropy with the LM-head product taken one sequence chunk at
    a time (the last one short where S is not a multiple of the chunk:
    the reference pads it with masked rows, which add nothing), each
    chunk under ``checkpoint`` when grad mode is on: the live logits are
    [B, chunk, V], and the backward recomputes each chunk's. The chunks'
    sums are added in order, as the reference's scan adds them."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        args = (hidden[:, sl], lm_head, targets[:, sl], mask[:, sl])
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_nll(*args))
    return total / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict,
            aux_weight: float = 0.01, remat_segments: bool = False,
            mesh: Optional[DeviceMesh] = None):
    """(total loss, (cross-entropy, aux loss)) of ``batch``'s ``inputs``,
    ``targets`` and ``mask``; ``mesh`` goes to ``forward``."""
    hidden, aux, _ = forward(params, cfg, batch["inputs"], skip_head=True,
                             remat_segments=remat_segments, mesh=mesh)
    head = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    loss = chunked_softmax_xent(hidden, head, batch["targets"],
                                batch["mask"])
    return loss + aux_weight * aux, (loss, aux)


def _replicated_value(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain 0-d tensor that every rank holds alike (a
    DTensor's value reduced and replicated)."""
    if isinstance(t, DTensor):
        t = t.redistribute(t.device_mesh,
                           (Replicate(),) * t.device_mesh.ndim).to_local()
    return t.detach()


def train_step(params: dict, opt_state: OptState, batch: dict, *,
               cfg: ArchConfig, opt_cfg: AdamWConfig,
               remat_segments: bool = False,
               mesh: Optional[DeviceMesh] = None):
    """One step: the loss and its gradients over every parameter leaf,
    then AdamW (which writes the new parameters and moments into the given
    tensors). Returns (params, opt_state, metrics of ``loss``,
    ``aux_loss``, ``total_loss``, ``grad_norm`` and ``lr`` as 0-d
    tensors on the device). With DTensor parameters and batch (the mesh
    step) the gradients come back as DTensors, AdamW brings each to its
    parameter's placements, and the metrics are replicated: every rank
    holds their whole value. ``mesh`` goes to ``forward``."""
    flat = T.items(params)
    spread = isinstance(flat[0][1], DTensor)
    with torch.enable_grad(), (S.plain_tensors_replicated() if spread
                               else contextlib.nullcontext()):
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        live = T.unflatten({k: v for (k, _), v in zip(flat, leaves)})
        total, (loss, aux) = loss_fn(live, cfg, batch,
                                     remat_segments=remat_segments,
                                     mesh=mesh)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = T.unflatten({k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(flat, grads)})
    new_params, new_state, stats = adamw_update(opt_cfg, params, grads,
                                                opt_state)
    metrics = {name: _replicated_value(t) for name, t in (
        ("loss", loss), ("aux_loss", aux), ("total_loss", total),
        *stats.items())}
    return new_params, new_state, metrics


# ---------------------------------------------------------------------------
# sharding plumbing
# ---------------------------------------------------------------------------


def param_shardings(mesh: DeviceMesh, cfg: ArchConfig, params_shape: dict):
    """``MeshSharding``s mirroring an (abstract) param tree. Dims that do
    not divide their mesh axes fall back to replicated (e.g. odd
    vocabs)."""
    return T.map_tree(
        lambda spec, leaf: S.logical_to_sharding_shaped(mesh, spec,
                                                        leaf.shape),
        L.tree_specs(params_shape), params_shape)


def opt_shardings(mesh: DeviceMesh, cfg: ArchConfig,
                  params_shape: dict) -> OptState:
    ps = param_shardings(mesh, cfg, params_shape)
    return OptState(step=S.replicated(mesh), mu=ps, nu=ps)


def batch_shardings(mesh: DeviceMesh, cfg: ArchConfig) -> dict:
    bax = S.batch_axes(mesh)
    spec = bax if len(bax) > 1 else bax[0]
    tok = S.ns(mesh, spec, None)
    tok_in = S.ns(mesh, spec, None, None) if cfg.frontend else tok
    return {"inputs": tok_in, "targets": tok, "mask": tok}


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree's shapes and dtypes, on ``torch.device("meta")``."""
    return init_params(cfg, device="meta")


def shard_tree(tree: dict, shardings: dict, device: torch.device) -> dict:
    """``tree``'s leaves as DTensors of ``shardings`` (a tree of
    ``MeshSharding``s of the same keys). A DTensor leaf is brought to its
    placements; a whole tensor or numpy array, which every rank holds
    alike, is moved to ``device`` and each rank keeps its own chunk."""
    def place(leaf, sh):
        if isinstance(leaf, DTensor):
            return leaf.redistribute(sh.mesh, sh.placements)
        if not torch.is_tensor(leaf):
            leaf = torch.as_tensor(np.asarray(leaf))
        return S.shard_local(leaf.to(device), sh.mesh, sh.placements)
    return T.map_tree(place, tree, shardings)


def shard_opt_state(opt_state: OptState, shardings: OptState,
                    device: torch.device) -> OptState:
    """An optimizer state with its moments placed by :func:`shard_tree`
    and its step a plain tensor on ``device``."""
    return OptState(step=torch.as_tensor(opt_state.step).to(device),
                    mu=shard_tree(opt_state.mu, shardings.mu, device),
                    nu=shard_tree(opt_state.nu, shardings.nu, device))


def make_train_step(mesh: DeviceMesh, cfg: ArchConfig, opt_cfg: AdamWConfig,
                    remat_segments: Optional[bool] = None):
    """The train step on ``mesh``, and the (param, optimizer, batch)
    shardings. The step takes the global batch (numpy arrays or tensors,
    the same on every rank) and splits it over the batch axes; parameters
    and optimizer state that are not already DTensors of their shardings
    are placed as :func:`shard_tree` places them (the reference's jitted
    step reshards its inputs so). It returns sharded parameters and state
    (written in place where they came in sharded) and replicated metrics.
    The same code runs at every world size.

    remat_segments=None reads REPRO_REMAT_SEGMENTS (hierarchical remat:
    one saved residual per segment instead of per layer, +1 forward
    recompute).
    """
    dev = mesh_device(mesh)
    if remat_segments is None:
        remat_segments = bool(int(os.environ.get("REPRO_REMAT_SEGMENTS",
                                                 "0")))
    pshape = abstract_params(cfg)
    ps, os_, bs = (param_shardings(mesh, cfg, pshape),
                   opt_shardings(mesh, cfg, pshape),
                   batch_shardings(mesh, cfg))

    def step(params: dict, opt_state: OptState, batch: dict):
        batch = shard_tree(batch, {k: bs[k] for k in batch}, dev)
        params = shard_tree(params, ps, dev)
        opt_state = shard_opt_state(opt_state, os_, dev)
        return train_step(params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg,
                          remat_segments=remat_segments, mesh=mesh)

    return step, (ps, os_, bs)


def init_sharded(mesh: DeviceMesh, cfg: ArchConfig, seed: int = 0):
    """Parameters of ``cfg`` drawn from a generator seeded ``seed`` on the
    mesh's device, each leaf kept as a DTensor of its ``param_shardings``
    entry as soon as it is drawn (a rank holds one whole leaf at a time,
    then only its chunk), and their zero optimizer state of the same
    placements. The values are ``init_params(cfg, generator seeded
    seed)``'s at every world size."""
    dev = mesh_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shardings = dict(T.items(param_shardings(mesh, cfg,
                                             abstract_params(cfg))))
    params = init_params(cfg, gen, device=dev,
                         place=lambda path, t: S.shard_local(
                             t, mesh, shardings[path].placements))
    return params, init_opt_state(params)
