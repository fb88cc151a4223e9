"""Serving steps on one device: prefill and single-token greedy decode
(port of ``repro.serving.decode``; the mesh shardings and the
``make_*_step`` builders wait for the ``torch.distributed`` port)."""
from __future__ import annotations

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.models.transformer import forward


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, *, cfg: ArchConfig):
    """One greedy decode step. tokens [B, 1] (or [B, 1, F] embeddings for
    a frontend arch); pos [B]. Returns (next_token [B] int32, logits
    [B, V] float32, cache), the cache updated in place."""
    logits, _, cache = forward(params, cfg, tokens, cache=cache,
                               decode_pos=pos)
    step_logits = logits[:, 0].float()
    nxt = torch.argmax(step_logits, dim=-1).to(torch.int32)
    return nxt, step_logits, cache


def prefill_step(params: dict, inputs: torch.Tensor, *, cfg: ArchConfig):
    """Prefill of inputs [B, S] tokens (or [B, S, F] embeddings for a
    frontend arch): returns (logits [B, S, V], cache covering S
    positions)."""
    logits, _, cache = forward(params, cfg, inputs, build_cache=True)
    return logits, cache
