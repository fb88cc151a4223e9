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

On a mesh (DTensor caches) a decode step writes each new row into the
local shard that holds it, and calls the kernel under ``local_map`` on
each rank's rows and query heads (:func:`_mesh_decode_attention`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.common import sharding as S
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
                          *, layers: Optional[int] = None,
                          place=L.keep) -> dict:
    """Projection weights (``normal / sqrt(fan_in)``) and, with qk-norm,
    zero norm scales; with ``layers`` each is stacked on a leading axis
    of that many layers. Each leaf goes through ``place(name, leaf)`` as
    soon as it is drawn."""
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lead = () if layers is None else (layers,)

    def dense(name, shape, fan_in):
        return place(name, L.dense_init(lead + shape, fan_in, dtype,
                                        generator, device))

    p = {"w_q": dense("w_q", (d, h * hd), d),
         "w_k": dense("w_k", (d, kv * hd), d),
         "w_v": dense("w_v", (d, kv * hd), d),
         "w_o": dense("w_o", (h * hd, d), h * hd)}
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = place(name, torch.zeros(lead + (hd,), dtype=dtype,
                                              device=device))
    return p


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """q [B, S, H, hd], k and v [B, S, KV, hd]: projections, then qk-norm,
    then rope."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q = L.split_heads(x @ p["w_q"], h)
    k = L.split_heads(x @ p["w_k"], kv)
    v = L.split_heads(x @ p["w_v"], kv)
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
    attend = _mesh_causal_attention if isinstance(q, DTensor) else \
        _chunked_causal_attention
    out = attend(q, k, v, window=window, chunk=q_chunk)
    return out.reshape(b, s, -1) @ p["w_o"], k, v


def _mesh_causal_attention(q: DTensor, k: DTensor, v: DTensor, *,
                           window: Optional[int], chunk: int) -> DTensor:
    """``_chunked_causal_attention`` on DTensors, on each rank's local
    tensors (``local_map``): its batch rows where the batch splits over
    the batch axes, its query heads where the model axis splits them on
    whole heads (:func:`_head_split`) and the kv heads those read. The
    attention is exact on such a shard; a rank's gradient of k and v sums
    its query heads only, so it comes back as a partial sum over
    ``model``."""
    mesh = q.device_mesh
    b, _, h, _ = q.shape
    bs = S.batch_split(mesh, b)
    split = _head_split(h, k.shape[2], mesh.size(
        mesh.mesh_dim_names.index(S.MODEL_AXIS)))
    q_pl = S.ns(mesh, bs, None, S.MODEL_AXIS if split else None,
                None).placements
    kv_pl = S.ns(mesh, bs, None, None, None).placements
    kv_grad = tuple(Partial() if split and name == S.MODEL_AXIS else pl
                    for name, pl in zip(mesh.mesh_dim_names, kv_pl))
    lo, hi = _kv_heads(mesh, h, k.shape[2], split)

    def attend(ql, kl, vl):
        return _chunked_causal_attention(ql, kl[:, :, lo:hi], vl[:, :, lo:hi],
                                         window=window, chunk=chunk)

    fn = local_map(attend, out_placements=list(q_pl),
                   in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


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
    read_pos = pos.clamp(max=s_cache - 1) if is_ring else pos
    window = spec.window if spec.is_sliding and not is_ring else 0
    if isinstance(k_cache, DTensor):
        for cache, new in ((k_cache, k), (v_cache, v)):
            _write_local_rows(cache, new[:, 0], write_pos)
        out = _mesh_decode_attention(q[:, 0], k_cache, v_cache, read_pos,
                                     window)
    else:
        rows = torch.arange(b, device=x.device)
        k_cache[rows, write_pos] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, write_pos] = v[:, 0].to(v_cache.dtype)
        out = flash_decode(q[:, 0], k_cache, v_cache, read_pos, window)
    y = out.to(x.dtype).reshape(b, 1, -1) @ p["w_o"]   # out: [B, H, hd]
    return y, k_cache, v_cache


def _rows_placements(cache: DTensor) -> tuple:
    """The placements of a [B, ...] tensor split over batch as ``cache``
    splits its rows (dim 0), replicated elsewhere."""
    return tuple(pl if pl == Shard(0) else Replicate()
                 for pl in cache.placements)


def _local_rows(t, cache: DTensor, offset: int, n: int) -> torch.Tensor:
    """This rank's rows of ``t`` (a DTensor or a whole tensor) for the
    cache rows ``offset``..``offset + n - 1``."""
    if isinstance(t, DTensor):
        return t.redistribute(cache.device_mesh,
                              _rows_placements(cache)).to_local()
    return t[offset:offset + n]


def _write_local_rows(cache: DTensor, new, pos) -> None:
    """Write ``new`` [B, KV, hd] at row ``pos[b]`` of cache slot b, into
    the local shard of a DTensor cache [B, S, KV, hd]: a rank writes the
    batch rows it holds, and where the sequence is split, only the
    positions that fall in its part (the others' owners write them)."""
    local = cache.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    val = _local_rows(new, cache, offset[0], shape[0]).to(local.dtype)
    at = _local_rows(pos, cache, offset[0], shape[0]).long()
    rows = torch.arange(local.shape[0], device=local.device)
    if shape[1] == cache.shape[1]:
        local[rows, at] = val
        return
    hit = (at >= offset[1]) & (at < offset[1] + shape[1])
    local[rows[hit], at[hit] - offset[1]] = val[hit]


def _head_split(h: int, kvh: int, m: int):
    """(query heads a model rank, kv heads it reads) when the model axis's
    m ranks split the h query heads on whole heads and each rank's heads
    read whole kv heads (h / m a multiple of G = h / kvh, or G a multiple
    of h / m); None where the heads are replicated for the call."""
    g = h // kvh
    if m == 1 or h % m:
        return None
    per = h // m
    if per % g == 0:
        return per, per // g
    if g % per == 0:
        return per, 1
    return None


def _kv_heads(mesh, h: int, kvh: int, split) -> Tuple[int, int]:
    """The kv heads [lo, hi) that this rank's query heads read: all of
    them where the heads are not split."""
    if split is None:
        return 0, kvh
    per, kv_per = split
    lo = mesh.get_local_rank(S.MODEL_AXIS) * per // (h // kvh)
    return lo, lo + kv_per


def _mesh_decode_attention(q: DTensor, k_cache: DTensor, v_cache: DTensor,
                           pos, window: int) -> DTensor:
    """Flash-decode on DTensors: q [B, H, hd], caches [B, S, KV, hd]
    (written already), pos [B] -> [B, H, hd] float32. Each rank calls the
    kernel on local tensors (``local_map``): the batch rows of its cache
    shard, its query heads where the model axis splits them on whole
    heads (:func:`_head_split`), and only the kv heads those read. A
    cache whose sequence is split over ``model`` is gathered for the call,
    one layer at a time."""
    mesh = k_cache.device_mesh
    model = mesh.mesh_dim_names.index(S.MODEL_AXIS)
    rows = _rows_placements(k_cache)
    kv_pl = tuple(Replicate() if pl == Shard(1) else pl
                  for pl in k_cache.placements)
    if kv_pl != k_cache.placements:
        k_cache = k_cache.redistribute(mesh, kv_pl)
        v_cache = v_cache.redistribute(mesh, kv_pl)
    h, kvh = q.shape[1], k_cache.shape[2]
    split = _head_split(h, kvh, mesh.size(model))
    q_pl = list(rows)
    if split is not None:
        q_pl[model] = Shard(1)
    lo, hi = _kv_heads(mesh, h, kvh, split)

    def attend(ql, kl, vl, pl):
        if hi - lo < kl.shape[2]:       # the kernel reads whole rows
            kl = kl[:, :, lo:hi].contiguous()
            vl = vl[:, :, lo:hi].contiguous()
        return flash_decode(ql, kl, vl, pl, window)

    fn = local_map(attend, out_placements=list(q_pl),
                   in_placements=(tuple(q_pl), kv_pl, kv_pl, rows),
                   device_mesh=mesh, redistribute_inputs=True)
    if not isinstance(pos, DTensor):
        pos = DTensor.from_local(pos, mesh, (Replicate(),) * mesh.ndim
                                 ).redistribute(mesh, rows)
    return fn(q, k_cache, v_cache, pos)


def ring_pack(kv: torch.Tensor, window: int, seq_axis: int = 1
              ) -> torch.Tensor:
    """Pack full-sequence prefill kv into ring layout (slot = pos mod R).

    kv: [..., S, ...]; returns the last R = min(window, S) positions rolled
    so slot i holds the position with p % R == i.
    """
    s = kv.shape[seq_axis]
    r = min(window, s)
    tail = kv.narrow(seq_axis, s - r, r)
    shift = (s - r) % r
    if not shift:
        return tail
    # torch.roll(tail, shift) as two slices (DTensor has no roll rule)
    return torch.cat([tail.narrow(seq_axis, r - shift, shift),
                      tail.narrow(seq_axis, 0, r - shift)], dim=seq_axis)


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
