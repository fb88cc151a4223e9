"""Model assembly: the layer plan, parameters, caches and the forward pass
(port of ``repro.models.transformer`` for the ``attention`` and ``mamba2``
groups).

The layer stack of an ArchConfig is cut into *segments*: maximal runs of
layers with the same (parameter group, static behaviour). Each group's
parameters are stacked on a leading layer axis, and a segment runs as a
Python loop over its layers (the reference's ``lax.scan``).

Ported: the ``attention`` group with full, sliding-window and
local-global attention, dense MLPs, the decode caches (a sliding layer's
in a ring of at most ``window`` slots, cache group ``attention@swa``)
and prefill; the ``mamba2`` group (Mamba2 blocks, whose prefill runs the
SSD kernel) with its recurrent decode state. Not ported yet (ROADMAP.md,
section 1): the ``shared_attention`` group (zamba2) and MoE MLPs; each
raises ``NotImplementedError``. Remat is per-layer (or per-segment)
``torch.utils.checkpoint``; mesh sharding of the activations is not
ported (the train step runs at world size 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ArchConfig, BlockKind
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import (AttnSpec, attention_block,
                                          decode_attention_block,
                                          init_attention_params,
                                          layer_attn_spec, ring_pack)
from repro_torch.models.ssm import init_mamba2_params, init_ssm_state, \
    mamba2_block

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHARED_TODO = ("weight-tied shared attention (zamba2) is not ported yet "
               "(ROADMAP.md section 1: shared attention)")
MOE_TODO = "MoE layers are not ported yet (ROADMAP.md section 1: MoE)"
FRONTEND_TODO = ("vision and audio frontends are not ported yet (ROADMAP.md "
                 "section 1: they come with their families)")


@dataclasses.dataclass(frozen=True)
class Segment:
    group: str            # param stack name
    start: int            # offset into the group's stacked params
    length: int
    spec: Optional[AttnSpec]  # static attention behaviour (attention groups)
    cache_start: int      # offset into the cache group's stack
    cache_group: str = ""  # cache stack name ('<group>@swa' = ring buffer)


def cache_group_of(group: str, spec: Optional[AttnSpec]) -> str:
    """Sliding-window layers keep a ring cache of window size, full
    attention layers a max_seq cache."""
    if spec is not None and spec.is_sliding:
        return group + "@swa"
    return group


def build_plan(cfg: ArchConfig) -> Tuple[List[Segment], Dict[str, int]]:
    """Segment the layer stack; returns (segments, cache_group -> #slots)."""
    per_layer = []
    attn_idx = 0
    for kind in cfg.layer_kinds():
        if kind == BlockKind.ATTENTION:
            per_layer.append(("attention", layer_attn_spec(cfg, attn_idx)))
            attn_idx += 1
        elif kind == BlockKind.SHARED_ATTENTION:
            per_layer.append(("shared_attention", layer_attn_spec(cfg, 0)))
        elif kind == BlockKind.MAMBA2:
            per_layer.append(("mamba2", None))
        else:
            raise ValueError(kind)

    segments: List[Segment] = []
    offsets = {"attention": 0, "mamba2": 0, "shared_attention": 0}
    cache_off: Dict[str, int] = {}
    i = 0
    while i < len(per_layer):
        g, spec = per_layer[i]
        j = i
        while j < len(per_layer) and per_layer[j] == (g, spec):
            j += 1
        length = j - i
        cg = cache_group_of(g, spec)
        segments.append(Segment(g, offsets[g], length, spec,
                                cache_off.get(cg, 0), cg))
        offsets[g] += length if g != "shared_attention" else 0
        cache_off[cg] = cache_off.get(cg, 0) + length
        i = j
    return segments, cache_off


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)
    if cfg.frontend:
        raise NotImplementedError(FRONTEND_TODO)
    for seg in build_plan(cfg)[0]:
        if seg.group == "shared_attention":
            raise NotImplementedError(SHARED_TODO)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = "cuda") -> dict:
    """Synthetic parameters of ``cfg`` on ``device``: dense weights are
    ``normal / sqrt(fan_in)`` drawn from ``generator`` (on its own device;
    a generator seeded 0 on ``device`` when none is given), norm scales
    zero, and the Mamba2 constants of the reference. Keys follow the
    reference's tree: the layers of each group in the plan are stacked on
    a leading axis under ``blocks/attention`` and ``blocks/mamba2``."""
    dev = resolve_device(device)
    _check_ported(cfg)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = DTYPES[cfg.dtype]
    d, f = cfg.d_model, cfg.d_ff
    kinds = cfg.layer_kinds()
    n_attn = sum(k == BlockKind.ATTENTION for k in kinds)
    n_mamba = sum(k == BlockKind.MAMBA2 for k in kinds)

    def dense(shape, fan_in):
        return L.dense_init(shape, fan_in, dtype, generator, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params: dict = {"blocks": {}}
    params["embedding"] = dense((cfg.vocab_size, d), d)
    params["final_norm"] = zeros(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), d)
    if n_attn:
        n = n_attn
        blocks = {"norm_attn": zeros(n, d), "norm_mlp": zeros(n, d)}
        blocks.update(init_attention_params(cfg, dtype, generator, dev,
                                            layers=n))
        blocks["w_gate"] = dense((n, d, f), d)
        blocks["w_in"] = dense((n, d, f), d)
        blocks["w_out"] = dense((n, f, d), f)
        params["blocks"]["attention"] = blocks
    if n_mamba:
        blocks = {"norm_in": zeros(n_mamba, d)}
        blocks.update(init_mamba2_params(cfg, dtype, generator, dev,
                                         layers=n_mamba))
        params["blocks"]["mamba2"] = blocks
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def make_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device: DeviceLike = "cuda") -> dict:
    """Zeroed decode caches per cache group: ``{"attention": {"k", "v"}}``
    of [layers, batch, max_seq, KV, hd] in the model's dtype, rings of
    min(window, max_seq) rows for sliding layers (``"attention@swa"``: a
    gemma3 keeps 1,024-slot rings for its 40 local layers and full caches
    only for the 8 global ones), and
    ``{"mamba2": {"ssm", "conv"}}`` of [layers, batch, H, N, P] float32
    and [layers, batch, W-1, d_inner] in the model's dtype. One layer's
    slice (``cache["attention"]["k"][i]``) is contiguous, and decode
    writes into it in place."""
    dev = resolve_device(device)
    _check_ported(cfg)
    _, cache_slots = build_plan(cfg)
    dtype = DTYPES[cfg.dtype]
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache: dict = {}
    for g, slots in cache_slots.items():
        if g == "mamba2":
            states = init_ssm_state(cfg, batch, device=dev)
            cache[g] = {name: st.new_zeros((slots,) + st.shape)
                        for name, st in zip(("ssm", "conv"), states)}
            continue
        seq = min(cfg.sliding_window, max_seq) if g.endswith("@swa") \
            else max_seq
        cache[g] = {name: torch.zeros((slots, batch, seq, kvh, hd),
                                      dtype=dtype, device=dev)
                    for name in ("k", "v")}
    return cache


def grow_cache(cache: dict, max_seq: int, window: int = 0) -> dict:
    """Pad the kv seq dim of a prefill-built cache with zeros to
    ``max_seq``; the Mamba2 states have no seq dim and stay as they
    are. Ring (``@swa``) groups grow only to min(window, max_seq), and not
    at all without a ``window``; padding a ring that prefilled fewer than
    ``window`` positions keeps slot i == position i."""
    out = {}
    for g, sub in cache.items():
        if g == "mamba2":
            out[g] = sub
            continue
        target = max_seq
        if g.endswith("@swa"):
            target = min(window, max_seq) if window else sub["k"].shape[2]
        out[g] = {name: a if a.shape[2] >= target else
                  F.pad(a, (0, 0, 0, 0, 0, target - a.shape[2]))
                  for name, a in sub.items()}
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _attn_layer_fwd(p: dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: Optional[torch.Tensor], spec: AttnSpec,
                    kv: Optional[dict] = None,
                    pos: Optional[torch.Tensor] = None,
                    build_cache: bool = False):
    """One attention + MLP layer. Returns (x, new_kv).

    Train/prefill: new_kv is the full-sequence {k, v} when build_cache,
    else None. Decode: new_kv is ``kv``, written in place at ``pos``.
    """
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    if kv is None:
        attn, k_full, v_full = attention_block(p, cfg, h, positions, spec)
        new_kv = {"k": k_full, "v": v_full} if build_cache else None
    else:
        attn, k_new, v_new = decode_attention_block(
            p, cfg, h, pos, kv["k"], kv["v"], spec)
        new_kv = {"k": k_new, "v": v_new}
    x = x + attn
    h = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    return x + L.swiglu(h, p["w_gate"], p["w_in"], p["w_out"]), new_kv


def _mamba_layer_fwd(p: dict, cfg: ArchConfig, x: torch.Tensor,
                     state: Optional[dict] = None, decode: bool = False):
    """One Mamba2 layer. Returns (x, {"ssm", "conv"}); in decode the
    states are ``state``'s tensors, updated in place."""
    h = L.rms_norm(x, p["norm_in"], cfg.norm_eps)
    ssm_state = state["ssm"] if state is not None else None
    conv_state = state["conv"] if state is not None else None
    out, (new_ssm, new_conv) = mamba2_block(
        p, cfg, h, ssm_state, conv_state, decode=decode)
    return x + out, {"ssm": new_ssm, "conv": new_conv}


def _requires_grad(tree: dict) -> bool:
    return any(_requires_grad(v) if isinstance(v, dict) else v.requires_grad
               for v in tree.values())


def _train_segment(blocks: dict, seg: Segment, cfg: ArchConfig,
                   x: torch.Tensor, positions: torch.Tensor, remat: bool,
                   remat_segments: bool) -> torch.Tensor:
    """A segment's layers on a training forward: each layer under
    ``checkpoint`` with ``remat`` (its activations recomputed in the
    backward), and the whole segment under one more with
    ``remat_segments`` (one saved residual per segment)."""

    def layer(j: int, xx: torch.Tensor) -> torch.Tensor:
        p = {key: w[seg.start + j] for key, w in blocks.items()}
        if seg.group == "mamba2":
            return _mamba_layer_fwd(p, cfg, xx)[0]
        return _attn_layer_fwd(p, cfg, xx, positions, seg.spec)[0]

    def run(xx: torch.Tensor) -> torch.Tensor:
        for j in range(seg.length):
            xx = checkpoint(layer, j, xx, use_reentrant=False) if remat \
                else layer(j, xx)
        return xx

    if remat_segments:
        return checkpoint(run, x, use_reentrant=False)
    return run(x)


def forward(params: dict, cfg: ArchConfig, inputs: torch.Tensor, *,
            cache: Optional[dict] = None,
            decode_pos: Optional[torch.Tensor] = None,
            remat: bool = True,
            build_cache: bool = False,
            skip_head: bool = False,
            remat_segments: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Run the model.

    Train: inputs [B, S] int tokens, cache None -> (logits [B, S, V],
      aux, None).
    Prefill: as train with build_cache=True -> the third output is a
      cache whose kv seq dim covers the prefill length (pad it with
      ``grow_cache`` before decoding), its ring groups packed by
      ``ring_pack`` to the last min(window, S) positions, and, for
      Mamba2 layers, the final SSM and conv states.
    Decode: inputs [B, 1], cache from ``make_cache``, decode_pos [B] ->
      (logits [B, 1, V], aux, cache), the cache updated in place.
    skip_head=True returns the final-norm hidden states [B, S, D] in
    place of the logits. aux is the MoE load-balancing loss, zero here.
    A training forward (no cache, grad mode on and a parameter that
    requires grad) recomputes each layer's activations in the backward
    with ``remat`` and each segment's with ``remat_segments``, as the
    reference's ``jax.checkpoint`` does; neither changes a number.
    """
    _check_ported(cfg)
    decode = cache is not None
    x = params["embedding"][inputs]
    positions = decode_pos[:, None] if decode else \
        torch.arange(x.shape[1], device=x.device)[None]
    train = not decode and not build_cache and torch.is_grad_enabled() \
        and _requires_grad(params)

    new_states: Dict[str, list] = {}
    for seg in build_plan(cfg)[0]:
        blocks = params["blocks"][seg.group]
        if train:
            x = _train_segment(blocks, seg, cfg, x, positions, remat,
                               remat_segments)
            continue
        for j in range(seg.length):
            p = {key: w[seg.start + j] for key, w in blocks.items()}
            state = None
            if decode:
                layer = seg.cache_start + j
                state = {name: a[layer]
                         for name, a in cache[seg.cache_group].items()}
            if seg.group == "mamba2":
                x, new_state = _mamba_layer_fwd(p, cfg, x, state,
                                                decode=decode)
            else:
                x, new_state = _attn_layer_fwd(
                    p, cfg, x, positions, seg.spec, kv=state,
                    pos=decode_pos, build_cache=build_cache)
            if build_cache:
                if seg.cache_group.endswith("@swa"):
                    new_state = {name: ring_pack(a, cfg.sliding_window)
                                 for name, a in new_state.items()}
                new_states.setdefault(seg.cache_group, []).append(new_state)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if skip_head:
        logits = x  # normed hidden states; the caller applies a head
    elif cfg.tie_embeddings:
        logits = x @ params["embedding"].T
    else:
        logits = x @ params["lm_head"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if decode:
        return logits, aux, cache
    if build_cache:
        prefill_cache = {g: {name: torch.stack([st[name] for st in sts])
                             for name in sts[0]}
                         for g, sts in new_states.items()}
        return logits, aux, prefill_cache
    return logits, aux, None
