"""Plain PyTorch version of the flash-decode kernel (port of
``repro.kernels.decode_attention.ref``, with the lower bound of a
sliding window that ``repro.models.attention.decode_attention_block``
applies to a full-size cache on a sliding layer)."""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Single-token GQA attention against a KV cache.

    Args:
      q:   [B, H, hd] query heads for the current token.
      k,v: [B, S, KV, hd] cache (positions > pos are invalid).
      pos: [B] current position (cache rows 0..pos inclusive are valid).
      window: 0 for none; else only the rows max(0, pos - window + 1)
        ..pos are valid.

    Returns [B, H, hd] attention output in float32.
    """
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    qg = q.reshape(b, kvh, groups, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * (hd ** -0.5)
    rows = torch.arange(s, device=k.device)[None, :]
    pos = pos.to(k.device)[:, None]
    valid = rows <= pos                                         # [B, S]
    if window:
        valid &= rows > pos - window
    logits = logits.masked_fill(~valid[:, None, None, :], -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    return out.reshape(b, h, hd)
