"""Token samplers for the decode loop: greedy, temperature, top-k, top-p
(port of ``repro.serving.sampler``).

:func:`sample` works on [B, V] logit tensors and draws from an explicit
``torch.Generator``; :func:`sample_np` is the numpy twin for host-side
loops. Both draw the categorical by the Gumbel-max trick, so they mask
alike; their random streams differ, and greedy is exactly argmax in both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1.0 = off
    greedy: bool = False


def sample(logits: torch.Tensor, generator: torch.Generator,
           cfg: SamplerConfig) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32 (``generator`` lives on the
    logits' device)."""
    logits = logits.float()
    if cfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    logits = logits / max(cfg.temperature, 1e-6)

    if 0 < cfg.top_k < logits.shape[-1]:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)

    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative mass >= top_p (always keep best)
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)

    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(
        torch.finfo(torch.float32).tiny)))
    masked = torch.where(torch.isfinite(logits), logits + gumbel, -torch.inf)
    return torch.argmax(masked, dim=-1).to(torch.int32)


def sample_np(logits: np.ndarray, rng: np.random.Generator,
              cfg: SamplerConfig) -> np.ndarray:
    """Numpy twin of :func:`sample` for host-side decode loops.

    Identical temperature / top-k / top-p masking; the categorical draw
    uses the Gumbel-max trick on ``rng``. logits [B, V] -> token ids [B]
    int64.
    """
    logits = np.asarray(logits, np.float32)
    if cfg.greedy:
        return np.argmax(logits, axis=-1)

    logits = logits / max(cfg.temperature, 1e-6)

    if cfg.top_k > 0 and cfg.top_k < logits.shape[-1]:
        kth = np.sort(logits, axis=-1)[..., -cfg.top_k][..., None]
        logits = np.where(logits < kth, -np.inf, logits)

    if cfg.top_p < 1.0:
        sorted_logits = np.sort(logits, axis=-1)[..., ::-1]
        x = np.exp(sorted_logits - sorted_logits[..., :1])
        probs = x / x.sum(-1, keepdims=True)
        cum = np.cumsum(probs, axis=-1)
        # smallest set with cumulative mass >= top_p (always keep best)
        cutoff_idx = np.sum(cum < cfg.top_p, axis=-1, keepdims=True)
        cutoff = np.take_along_axis(sorted_logits, cutoff_idx, axis=-1)
        logits = np.where(logits < cutoff, -np.inf, logits)

    gumbel = -np.log(-np.log(
        rng.uniform(low=np.finfo(np.float32).tiny, size=logits.shape)))
    masked = np.where(np.isfinite(logits), logits + gumbel, -np.inf)
    return np.argmax(masked, axis=-1)
