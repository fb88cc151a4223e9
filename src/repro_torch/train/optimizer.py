"""AdamW with a warmup-cosine schedule (port of ``repro.train.optimizer``).

Parameters, gradients and moments are nested dicts of tensors. The
moments and all of the update's arithmetic are float32, in the
reference's order of operations; the result is cast back to each
parameter's dtype. Unlike the reference, which returns new trees,
:func:`adamw_update` writes the new parameters and moments into the given
tensors (a model's parameters and two float32 moments are most of a
train step's device memory) and returns those same trees.

Parameters and moments may be DTensors (the mesh step): each gradient is
brought to its parameter's placements, the clip's norm is taken over the
whole tree across ranks, and the update writes each rank's local shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.train import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    mu: dict
    nu: dict


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then a cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict) -> OptState:
    """Zero float32 moments shaped like ``params``, on their devices (with
    their placements for DTensor parameters; the step is a plain 0-d
    tensor, the same on every rank)."""
    first = T.leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=T.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        nu=T.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's value as a plain tensor (summed where partial)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree``; for DTensor leaves over
    every rank's shard (each leaf's sum of squares reduced across
    ranks)."""
    return torch.sqrt(sum(_whole(torch.sum(torch.square(g.float())))
                          for g in T.leaves(tree)))


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: OptState):
    """One AdamW step with global-norm clipping. Writes the new parameters
    into ``params``' tensors and the new moments into ``state``'s, and
    returns (params, new state, stats dict of ``grad_norm`` and ``lr``)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    with torch.no_grad():
        for (_, p), g, m, v in zip(T.items(params), T.leaves(grads),
                                   T.leaves(state.mu), T.leaves(state.nu)):
            if isinstance(p, DTensor):
                g = g.redistribute(p.device_mesh, p.placements)
                p, g, m, v = (t.to_local() for t in (p, g, m, v))
            upd(p, g, m, v)
    return params, OptState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}
