"""Plain PyTorch version of the flash-decode kernel (port of
``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention against a KV cache.

    Args:
      q:   [B, H, hd] query heads for the current token.
      k,v: [B, S, KV, hd] cache (positions > pos are invalid).
      pos: [B] current position (cache rows 0..pos inclusive are valid).

    Returns [B, H, hd] attention output in float32.
    """
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    qg = q.reshape(b, kvh, groups, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * (hd ** -0.5)
    valid = (torch.arange(s, device=k.device)[None, :]
             <= pos.to(k.device)[:, None])                      # [B, S]
    logits = logits.masked_fill(~valid[:, None, None, :], -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    return out.reshape(b, h, hd)
