"""Core layers: RMSNorm, SwiGLU MLP and parameter initialisation (port of
``repro.models.layers``; the name-based sharding rules wait for the
``torch.distributed`` port)."""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


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


def dense_init(shape: Sequence[int], in_axis_size: int, dtype: torch.dtype,
               generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """``normal * 1/sqrt(fan_in)`` drawn in float32 from ``generator`` (on
    the generator's own device), then cast to ``dtype`` on ``device``."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(scale).to(device=device, dtype=dtype)
