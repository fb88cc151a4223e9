"""The train step: loss, gradients and the AdamW update (port of
``repro.train.train_step``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves;
on the card the Mamba2 scan's gradient runs in the SSD backward kernel
(``kernels/ssd``). The LM head's product and the cross-entropy run one
sequence chunk at a time, each chunk under ``checkpoint``, so the
[B, S, V] logits are never held whole.

The sharding helpers give the reference's specs, element for element, as
``MeshSharding``s over the port's mesh. The step itself runs at world
size 1, on the mesh's device: ``make_train_step`` and ``init_sharded``
refuse a larger world rather than run a replicated step.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from repro_torch.common import sharding as S
from repro_torch.common.config import ArchConfig
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import forward, init_params
from repro_torch.train import tree as T
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         init_opt_state)

MULTI_RANK_TODO = ("training across several ranks (FSDP and tensor "
                   "parallelism over DTensor) is not ported yet (ROADMAP.md "
                   "section 1, item 5: multi-rank training); use a mesh of "
                   "world size 1")


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean masked cross-entropy, in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, t: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    logits = (h @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t.long()[..., None])[..., 0]
    return torch.sum((logz - gold) * m)


def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Cross-entropy with the LM-head product taken one sequence chunk at
    a time (S padded with masked rows to a multiple of the chunk), each
    chunk under ``checkpoint`` when grad mode is on: the live logits are
    [B, chunk, V], and the backward recomputes each chunk's. The chunks'
    sums are added in order, as the reference's scan adds them."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (hidden[:, sl], lm_head, targets[:, sl], mask[:, sl])
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_nll(*args))
    return total / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict,
            aux_weight: float = 0.01, remat_segments: bool = False):
    """(total loss, (cross-entropy, aux loss)) of ``batch``'s ``inputs``,
    ``targets`` and ``mask``."""
    hidden, aux, _ = forward(params, cfg, batch["inputs"], skip_head=True,
                             remat_segments=remat_segments)
    head = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    loss = chunked_softmax_xent(hidden, head, batch["targets"],
                                batch["mask"])
    return loss + aux_weight * aux, (loss, aux)


def train_step(params: dict, opt_state: OptState, batch: dict, *,
               cfg: ArchConfig, opt_cfg: AdamWConfig,
               remat_segments: bool = False):
    """One step: the loss and its gradients over every parameter leaf,
    then AdamW (which writes the new parameters and moments into the given
    tensors). Returns (params, opt_state, metrics of ``loss``,
    ``aux_loss``, ``total_loss``, ``grad_norm`` and ``lr`` as 0-d
    tensors on the device)."""
    flat = T.items(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        live = T.unflatten({k: v for (k, _), v in zip(flat, leaves)})
        total, (loss, aux) = loss_fn(live, cfg, batch,
                                     remat_segments=remat_segments)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = T.unflatten({k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(flat, grads)})
    new_params, new_state, stats = adamw_update(opt_cfg, params, grads,
                                                opt_state)
    metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
               "total_loss": total.detach(), **stats}
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


def _one_rank(mesh: DeviceMesh) -> torch.device:
    if mesh.size() != 1:
        raise NotImplementedError(MULTI_RANK_TODO)
    return mesh_device(mesh)


def make_train_step(mesh: DeviceMesh, cfg: ArchConfig, opt_cfg: AdamWConfig,
                    remat_segments: Optional[bool] = None):
    """The train step on ``mesh``'s device, and the (param, optimizer,
    batch) shardings. The step takes a batch of numpy arrays or tensors
    and moves it to the device.

    remat_segments=None reads REPRO_REMAT_SEGMENTS (hierarchical remat:
    one saved residual per segment instead of per layer, +1 forward
    recompute). Raises ``NotImplementedError`` at a world size above 1.
    """
    dev = _one_rank(mesh)
    if remat_segments is None:
        remat_segments = bool(int(os.environ.get("REPRO_REMAT_SEGMENTS",
                                                 "0")))
    pshape = abstract_params(cfg)
    shardings = (param_shardings(mesh, cfg, pshape),
                 opt_shardings(mesh, cfg, pshape), batch_shardings(mesh, cfg))

    def step(params: dict, opt_state: OptState, batch: dict):
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                    else v).to(dev)
                 for k, v in batch.items()}
        return train_step(params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg,
                          remat_segments=remat_segments)

    return step, shardings


def init_sharded(mesh: DeviceMesh, cfg: ArchConfig, seed: int = 0):
    """Parameters of ``cfg`` drawn from a generator seeded ``seed`` on the
    mesh's device, and their zero optimizer state. Raises
    ``NotImplementedError`` at a world size above 1."""
    dev = _one_rank(mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    return params, init_opt_state(params)
