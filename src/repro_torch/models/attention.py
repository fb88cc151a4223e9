"""GQA attention for train, prefill and decode (port of
``repro.models.attention``).

Train and prefill attention runs over query chunks, so the score block
it holds is [B, H, chunk, S] and never [B, H, S, S]; each chunk sees its
whole key row, so the softmax per chunk is exact. Decode attends one
token against the cache through the flash-decode kernel, which reads the
layer's cache slice in place.

Sliding-window layers (h2o-danube, and the local layers of gemma3's
local-global stack) attend to the last ``window`` positions. In decode
they keep a ring cache of R <= window slots, slot i holding the newest
position p with p % R == i (``ring_pack`` lays a prefill out so); the
kernel reads its valid slots 0..min(pos, R - 1) in any order, since the
softmax does not care. A full-size cache on a sliding layer is read with
the window's lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.common.config import ArchConfig, AttentionKind
from repro_torch.kernels.decode_attention.ops import flash_decode
from repro_torch.models import layers as L
from repro_torch.models.rope import apply_rope

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static per-layer attention behaviour."""
    is_sliding: bool
    window: int


def init_attention_params(cfg: ArchConfig, dtype: torch.dtype,
                          generator: torch.Generator, device: torch.device,
                          *, layers: Optional[int] = None) -> dict:
    """Projection weights (``normal / sqrt(fan_in)``) and, with qk-norm,
    zero norm scales; with ``layers`` each is stacked on a leading axis
    of that many layers."""
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lead = () if layers is None else (layers,)

    def dense(shape, fan_in):
        return L.dense_init(lead + shape, fan_in, dtype, generator, device)

    p = {"w_q": dense((d, h * hd), d), "w_k": dense((d, kv * hd), d),
         "w_v": dense((d, kv * hd), d), "w_o": dense((h * hd, d), h * hd)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(lead + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros(lead + (hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """q [B, S, H, hd], k and v [B, S, KV, hd]: projections, then qk-norm,
    then rope."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["w_q"]).reshape(b, s, h, hd)
    k = (x @ p["w_k"]).reshape(b, s, kv, hd)
    v = (x @ p["w_v"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, kind=cfg.rope, theta=cfg.rope_theta)
    k = apply_rope(k, positions, kind=cfg.rope, theta=cfg.rope_theta)
    return q, k, v


def _chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              window: Optional[int] = None,
                              chunk: int = 1024) -> torch.Tensor:
    """Exact causal attention (with ``window``, over the last ``window``
    positions only), one query chunk at a time. q: [B, S, H, hd];
    k, v: [B, S, KV, hd]. Returns [B, S, H, hd]."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    scale = hd ** -0.5
    chunk = min(chunk, s)
    if groups > 1:      # GQA: repeat each kv head for its query heads
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, s, chunk):
        qi = q[:, start:start + chunk]                  # [B, c, H, hd]
        qpos = torch.arange(start, start + qi.shape[1], device=q.device)
        logits = torch.einsum("bchd,bshd->bhcs", qi, k) * scale
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        bias = torch.zeros(mask.shape, dtype=torch.float32,
                           device=q.device).masked_fill_(~mask, -1e30)
        probs = torch.softmax(logits.float() + bias, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhcs,bshd->bchd", probs, v))
    return torch.cat(outs, dim=1)


def attention_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, spec: AttnSpec,
                    q_chunk: int = 1024):
    """Training / prefill self-attention.

    x: [B, S, D] -> (out [B, S, D], k [B, S, KV, hd], v [B, S, KV, hd]);
    k and v are returned so that prefill can fill the decode cache.
    """
    b, s, d = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = spec.window if spec.is_sliding else None
    out = _chunked_causal_attention(q, k, v, window=window, chunk=q_chunk)
    return out.reshape(b, s, -1) @ p["w_o"], k, v


def decode_attention_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                           pos: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, spec: AttnSpec
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One-token decode. x: [B, 1, D]; caches [B, S, KV, hd] (one layer's
    contiguous slice of the stacked cache); pos [B] is the position of
    this token (rows 0..pos-1 hold the context).

    A sliding layer's cache of S <= window slots is a ring: the token
    goes to slot pos % S, and the valid slots are 0..min(pos, S - 1). A
    larger cache on a sliding layer holds position p at row p, and only
    the rows after pos - window are read.

    Unlike the reference, which returns new caches, this writes k and v
    into the caches in place and returns them as they are:
    (out [B, 1, D], k_cache, v_cache). The attention is the flash-decode
    kernel on a CUDA cache and its plain version on a CPU cache.
    """
    b, _, d = x.shape
    s_cache = k_cache.shape[1]
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    is_ring = spec.is_sliding and s_cache <= spec.window
    write_pos = pos % s_cache if is_ring else pos
    rows = torch.arange(b, device=x.device)
    k_cache[rows, write_pos] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, write_pos] = v[:, 0].to(v_cache.dtype)
    if is_ring:         # out: [B, H, hd] float32
        out = flash_decode(q[:, 0], k_cache, v_cache,
                           pos.clamp(max=s_cache - 1))
    else:
        out = flash_decode(q[:, 0], k_cache, v_cache, pos,
                           spec.window if spec.is_sliding else 0)
    y = out.to(x.dtype).reshape(b, 1, -1) @ p["w_o"]
    return y, k_cache, v_cache


def ring_pack(kv: torch.Tensor, window: int, seq_axis: int = 1
              ) -> torch.Tensor:
    """Pack full-sequence prefill kv into ring layout (slot = pos mod R).

    kv: [..., S, ...]; returns the last R = min(window, S) positions rolled
    so slot i holds the position with p % R == i.
    """
    s = kv.shape[seq_axis]
    r = min(window, s)
    tail = kv.narrow(seq_axis, s - r, r)
    return torch.roll(tail, shifts=(s - r) % r, dims=seq_axis)


def layer_attn_spec(cfg: ArchConfig, layer_idx: int) -> AttnSpec:
    """Static attention behaviour of layer ``layer_idx``."""
    if cfg.attention_kind == AttentionKind.FULL:
        return AttnSpec(False, 0)
    if cfg.attention_kind == AttentionKind.SLIDING:
        return AttnSpec(True, cfg.sliding_window)
    if cfg.attention_kind == AttentionKind.LOCAL_GLOBAL:
        r = cfg.local_to_global_ratio
        is_global = (layer_idx % (r + 1)) == r
        return AttnSpec(not is_global, cfg.sliding_window)
    raise ValueError(cfg.attention_kind)
