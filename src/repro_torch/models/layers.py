"""Core layers: RMSNorm, SwiGLU MLP, parameter initialisation and the
name-based sharding rules (port of ``repro.models.layers``).

Parameters are plain nested dicts. Sharding is name-based: ``spec_for``
maps (name, ndim) to a logical partition tuple; stacked layer params get a
leading ``None`` (layer) axis. Logical names resolve through
``repro_torch.common.sharding.logical_to_sharding_shaped``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm computed in float32, scaled by ``1 + scale``, cast back to
    the input's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W_g) * (x W_i)) W_o."""
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


def split_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """t [..., n * k] as [..., n, k]. A DTensor whose last dim is split
    over a mesh dim that does not divide n (a split that would cut a
    head, as musicgen's 24 heads over 16 ranks) is gathered on that dim
    first: the view cannot cut a head."""
    if isinstance(t, DTensor):
        last, mesh = t.ndim - 1, t.device_mesh
        placements = tuple(
            Replicate() if isinstance(p, Shard) and p.dim == last
            and n % mesh.size(i) else p for i, p in enumerate(t.placements))
        if placements != t.placements:
            t = t.redistribute(mesh, placements)
    return t.reshape(*t.shape[:-1], n, t.shape[-1] // n)


def keep(name: str, t: torch.Tensor) -> torch.Tensor:
    """The ``place`` of the ``init_*`` functions that keeps each leaf
    whole."""
    return t


def dense_init(shape: Sequence[int], in_axis_size: int, dtype: torch.dtype,
               generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """``normal * 1/sqrt(fan_in)`` drawn in float32 from ``generator`` (on
    the generator's own device), then cast to ``dtype`` on ``device``. On
    the ``meta`` device only the shape and dtype are made."""
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(scale).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# name-based sharding rules
# ---------------------------------------------------------------------------

_RULES: Dict[str, Tuple] = {
    # attention
    "w_q": ("fsdp", "model"),
    "w_k": ("fsdp", None),
    "w_v": ("fsdp", None),
    "w_o": ("model", "fsdp"),
    "q_norm": (None,),
    "k_norm": (None,),
    # dense mlp
    "w_gate": ("fsdp", "model"),
    "w_in": ("fsdp", "model"),
    "w_out": ("model", "fsdp"),
    # moe -- 'moe_ff' resolves to the model axis when the expert dim does
    # NOT divide it (e.g. grok's 8 experts on a 16-way model axis), so the
    # d_ff dim carries the tensor parallelism instead; otherwise replicated
    "router": ("fsdp", None),
    "e_gate": ("expert", "fsdp", "moe_ff"),
    "e_in": ("expert", "fsdp", "moe_ff"),
    "e_out": ("expert", "moe_ff", "fsdp"),
    # mamba2
    "in_proj": ("fsdp", "model"),
    "dt_w": ("fsdp", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "dt_bias": ("model",),
    "a_log": ("model",),
    "d_skip": ("model",),
    "ssm_norm": ("model",),
    "out_proj": ("model", "fsdp"),
    "bc_proj": ("fsdp", None),
    # embeddings / head / norms: vocab-dim params have V over model and D
    # replicated (D over the data axis would conflict with the batch
    # sharding in the lm_head contraction)
    "embedding": ("model", None),
    "frontend_proj": (None, None),
    "lm_head": (None, "model"),
    "final_norm": (None,),
    "norm_attn": (None,),
    "norm_mlp": (None,),
    "norm_in": (None,),
}


def spec_for(name: str, ndim: int, stacked: bool) -> Tuple:
    """Logical partition tuple for parameter ``name`` with ``ndim`` dims."""
    base = _RULES.get(name)
    if base is None:
        raise KeyError(f"no sharding rule for param {name!r}")
    if stacked:
        base = (None,) + tuple(base)
    if len(base) != ndim:
        # rank mismatch (e.g. scalar bias): replicate trailing dims
        base = tuple(base[:ndim]) if len(base) > ndim else \
            tuple(base) + (None,) * (ndim - len(base))
    return tuple(base)


def tree_specs(params, stacked_keys=("attention", "mamba2")):
    """Mirror a param tree with logical partition tuples.

    Subtrees under blocks/attention and blocks/mamba2 are stacked (leading
    layer axis); blocks/shared_attention is a SINGLE weight-tied block and
    must NOT be treated as stacked (a leading-None spec on an unstacked
    2-D weight silently truncates to the wrong axes).
    """

    def leafify(node, path, stacked):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = leafify(v, path + (k,),
                                 stacked or (path and path[-1] == "blocks"
                                             and k in stacked_keys))
            else:
                out[k] = spec_for(k, v.ndim if hasattr(v, "ndim")
                                  else len(v.shape), stacked)
        return out

    return leafify(params, (), False)
