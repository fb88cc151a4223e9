"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch
(port of ``repro.models.moe``).

A router scores T tokens against E experts, each token takes its top-k
experts, and tokens move to per-expert slots bounded by a capacity
factor, in groups of at most ``MAX_GROUP`` tokens. The reference builds
[G, T, E, C] one-hot dispatch and combine tensors and contracts them with
einsums; here the same assignment is computed and applied by index: the
kept tokens are scatter-added into [G, E, C, D] expert inputs, the
experts run as batched matmuls, and each token gathers its kept slots'
outputs back, weighted by its gates. Both give the same numbers,
including the reference's behaviours:

- the router runs in float32 whatever the model's dtype, softmax too;
- top-k ties go to the lowest expert index (``lax.top_k``'s order; a
  stable descending sort here), the k gates renormalised with ``+ 1e-9``;
- slots are counted per choice rank: the running count over tokens is
  taken separately for each of the k ranks, so a token's first choice and
  another token's second choice can take the same slot of one expert,
  whose input is then the sum of both tokens;
- an assignment at or past the capacity is dropped and adds nothing;
- the gates are cast to the model's dtype before the combine;
- the load-balancing aux loss counts every assignment, kept or dropped.

On a mesh (DTensor inputs) the block runs on every rank over the whole
batch's tokens and the gathered experts (``local_map`` with every input
replicated): the groups span the data ranks, so a rank-local dispatch
would change capacities and drops, and this keeps the un-sharded step's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.common.config import ArchConfig
from repro_torch.models import layers as L

MAX_GROUP = 4096  # tokens per dispatch group


def init_moe_params(cfg: ArchConfig, dtype: torch.dtype,
                    generator: torch.Generator, device: torch.device,
                    *, layers: Optional[int] = None,
                    place=L.keep) -> dict:
    """The router (float32 [d, E]) and the experts' SwiGLU weights
    (``e_gate``, ``e_in`` [E, d, f] and ``e_out`` [E, f, d] in ``dtype``),
    ``normal / sqrt(fan_in)``; with ``layers`` each is stacked on a
    leading axis of that many layers, drawn a layer at a time (a stack of
    experts is drawn in float32 first: 16 of phi3.5-moe's layers would
    need 27 GB for it at once). Each leaf goes through ``place(name,
    leaf)`` as soon as it is drawn."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def dense(shape, fan_in, dt):
        if layers is None or device.type == "meta":
            lead = () if layers is None else (layers,)
            return L.dense_init(lead + shape, fan_in, dt, generator, device)
        out = torch.empty((layers,) + shape, dtype=dt, device=device)
        for i in range(layers):
            out[i] = L.dense_init(shape, fan_in, dt, generator, device)
        return out

    make = {"router": lambda: dense((d, e), d, torch.float32),
            "e_gate": lambda: dense((e, d, f), d, dtype),
            "e_in": lambda: dense((e, d, f), d, dtype),
            "e_out": lambda: dense((e, f, d), f, dtype)}
    return {name: place(name, fn()) for name, fn in make.items()}


def group_and_capacity(cfg: ArchConfig, tokens: int) -> Tuple[int, int]:
    """(tokens a group, slots an expert a group): the group is the largest
    of MAX_GROUP, MAX_GROUP / 2, ... (or ``tokens``) that tiles the tokens
    exactly; the capacity is ``max(1, int(group k capacity_factor / E))``."""
    moe = cfg.moe
    group = min(MAX_GROUP, tokens)
    while tokens % group:
        group //= 2
    cap = max(1, int(group * moe.experts_per_token * moe.capacity_factor
                     / moe.num_experts))
    return group, cap


def route(p: dict, cfg: ArchConfig, xt: torch.Tensor):
    """The router on grouped tokens xt [G, T, D]: (gates [G, T, E] float32,
    experts [G, T, k] int64, slots [G, T, k] int64, kept [G, T, k] bool,
    renormalised top-k gates [G, T, k] float32)."""
    moe = cfg.moe
    e, k = moe.num_experts, moe.experts_per_token
    _, cap = group_and_capacity(cfg, xt.shape[0] * xt.shape[1])
    logits = xt.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_e = top_g[..., :k], top_e[..., :k]
    top_g = top_g / (top_g.sum(dim=-1, keepdim=True) + 1e-9)
    onehot = F.one_hot(top_e, e)                                # [G,T,k,E]
    # each rank's running count of earlier tokens sent to that expert
    before = torch.cumsum(onehot, dim=1) - onehot
    slots = (before * onehot).sum(dim=-1)
    return gates, top_e, slots, slots < cap, top_g


MOE_KEYS = ("router", "e_gate", "e_in", "e_out")


def moe_block(p: dict, cfg: ArchConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux float32 scalar).
    DTensor inputs run the block replicated on every rank (the module's
    docstring); out and aux come back replicated."""
    if isinstance(x, DTensor):
        rep = (Replicate(),) * x.device_mesh.ndim
        fn = local_map(
            lambda xl, *ws: _moe_local(dict(zip(MOE_KEYS, ws)), cfg, xl),
            out_placements=(rep, rep), in_placements=(rep,) * 5,
            device_mesh=x.device_mesh, redistribute_inputs=True)
        return fn(x, *(p[k] for k in MOE_KEYS))
    return _moe_local(p, cfg, x)


def _moe_local(p: dict, cfg: ArchConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.experts_per_token
    group, cap = group_and_capacity(cfg, b * s)
    ng = b * s // group
    xt = x.reshape(ng, group, d)
    gates, top_e, slots, kept, top_g = route(p, cfg, xt)

    # every kept (group, token, rank) adds its token to slot (expert, slot)
    # of its group: [G * E * C] rows of D
    g_idx = torch.arange(ng, device=x.device)[:, None, None]
    flat = (g_idx * e + top_e) * cap + slots.clamp(max=cap - 1)
    tok = xt[:, :, None, :].expand(ng, group, k, d)
    kept_f = kept.reshape(-1)
    ex_in = x.new_zeros((ng * e * cap, d)).index_add(
        0, flat.reshape(-1)[kept_f], tok.reshape(-1, d)[kept_f])

    # the experts: per expert, its slots of every group
    ex_in = ex_in.reshape(ng, e, cap, d).transpose(0, 1).reshape(
        e, ng * cap, d)
    h = F.silu(torch.bmm(ex_in, p["e_gate"])) * torch.bmm(ex_in, p["e_in"])
    ex_out = torch.bmm(h, p["e_out"]).reshape(e, ng, cap, d).transpose(
        0, 1).reshape(ng * e * cap, d)

    # each token gathers its kept slots' outputs, weighted by its gates in
    # the model's dtype (dropped ranks weigh 0)
    weight = torch.where(kept, top_g, torch.zeros_like(top_g)).to(x.dtype)
    picked = ex_out[flat.reshape(-1)].reshape(ng, group, k, d)
    out = (weight[..., None].float() * picked.float()).sum(dim=2)

    # the load-balancing loss over all tokens
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(top_e, e).sum(dim=2).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return out.to(x.dtype).reshape(b, s, d), aux
