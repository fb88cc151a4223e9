"""Rotary position embeddings: standard and 2d-style (port of
``repro.models.rope``).

chatglm3 applies rotary to only the first half of each head dim ("2d
RoPE" lineage from GLM); the second half passes through unrotated.
"""
from __future__ import annotations

import torch

from repro_torch.common.config import RoPEKind


def _rotate(x: torch.Tensor, positions: torch.Tensor,
            theta: float) -> torch.Tensor:
    """Rotary over the whole last dim. x: [B, S, H, D]; positions [B, S]
    (or [1, S]). The angles are computed in float32."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freq     # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]                     # [B, S, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, kind: RoPEKind,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, S, H, D] query or key heads; positions: [B, S] integers."""
    if kind == RoPEKind.NONE:
        return x
    if kind == RoPEKind.STANDARD:
        return _rotate(x, positions, theta)
    if kind == RoPEKind.TWO_D:
        d = x.shape[-1]
        rot, keep = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([_rotate(rot, positions, theta), keep], dim=-1)
    raise ValueError(kind)
