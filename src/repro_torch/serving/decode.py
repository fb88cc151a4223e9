"""Serving steps: prefill and single-token greedy decode, on one device or
sharded over a mesh (port of ``repro.serving.decode``).

Cache sharding policy, the reference's (adaptive to shape):
  * batch dim   -> data axes when divisible,
  * kv seq dim  -> model axis when the batch cannot shard (a batch of one
                   splits its cache across ranks), else replicated,
  * kv heads    -> replicated,
  * Mamba2 ``ssm`` heads and ``conv`` d_inner -> model axis when divisible.
Like the reference, the policy reads the sequence length of an abstract
cache of ``max(8, sliding_window)`` positions, not the ``max_seq`` it is
applied to: where the model axis does not divide ``max_seq``, DTensor
splits the sequence unevenly (JAX would refuse the sharding).

The mesh steps (``make_prefill_step``, ``make_decode_step``) take the
global inputs and place parameters, caches and inputs as DTensors of
these shardings; the kernels run on each rank's local tensors
(``models/attention``, ``models/ssm``). The decode step writes the cache
in place, each new row into the shard that holds it.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.common import sharding as S
from repro_torch.common.config import ArchConfig
from repro_torch.launch.mesh import axis_size, mesh_device
from repro_torch.models.transformer import forward, make_cache
from repro_torch.train.train_step import (abstract_params, param_shardings,
                                          shard_tree)


def cache_shardings(mesh: DeviceMesh, cfg: ArchConfig, batch: int) -> dict:
    """``MeshSharding``s for a ``make_cache``-shaped tree, spec for spec
    the reference's."""
    bspec = S.batch_split(mesh, batch)
    model = S.MODEL_AXIS
    m = axis_size(mesh, model)
    seq_spec = None if bspec is not None else model
    abstract = make_cache(cfg, batch, max(8, cfg.sliding_window),
                          device="meta")

    def spec_of(name: str, arr: torch.Tensor) -> S.MeshSharding:
        if name in ("k", "v"):      # [slots, B, S, KV, hd]
            ss = seq_spec if seq_spec is not None and \
                arr.shape[2] % m == 0 else None
            return S.ns(mesh, None, bspec, ss, None, None)
        if name == "ssm":           # [slots, B, H, N, P]: heads over model
            hs = model if arr.shape[2] % m == 0 else None
            return S.ns(mesh, None, bspec, hs, None, None)
        if name == "conv":          # [slots, B, W-1, d_inner]
            ds = model if arr.shape[3] % m == 0 else None
            return S.ns(mesh, None, bspec, None, ds)
        raise KeyError(name)

    return {g: {name: spec_of(name, a) for name, a in sub.items()}
            for g, sub in abstract.items()}


def token_shardings(mesh: DeviceMesh, cfg: ArchConfig, batch: int,
                    rank: int) -> S.MeshSharding:
    """Tokens (or positions) of ``rank`` dims: batch over the data axes
    when divisible, else replicated."""
    return S.ns(mesh, S.batch_split(mesh, batch), *([None] * (rank - 1)))


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, *, cfg: ArchConfig,
                mesh: DeviceMesh = None):
    """One greedy decode step. tokens [B, 1] (or [B, 1, F] embeddings for
    a frontend arch); pos [B]. Returns (next_token [B] int32, logits
    [B, V] float32, cache), the cache updated in place. ``mesh`` goes to
    ``forward``."""
    logits, _, cache = forward(params, cfg, tokens, cache=cache,
                               decode_pos=pos, mesh=mesh)
    step_logits = logits[:, 0].float()
    rows = step_logits
    if isinstance(rows, DTensor):   # each rank's rows whole: the first
        rows = rows.redistribute(   # maximum wins, as on one device
            rows.device_mesh, tuple(p if p == Shard(0) else Replicate()
                                    for p in rows.placements))
    nxt = torch.argmax(rows, dim=-1).to(torch.int32)
    return nxt, step_logits, cache


def prefill_step(params: dict, inputs: torch.Tensor, *, cfg: ArchConfig,
                 mesh: DeviceMesh = None):
    """Prefill of inputs [B, S] tokens (or [B, S, F] embeddings for a
    frontend arch): returns (logits [B, S, V], cache covering S
    positions). ``mesh`` goes to ``forward``."""
    logits, _, cache = forward(params, cfg, inputs, build_cache=True,
                               mesh=mesh)
    return logits, cache


def _logits_sharding(mesh: DeviceMesh, cfg: ArchConfig, batch: int,
                     rank: int) -> S.MeshSharding:
    """Logits of ``rank`` dims: batch as the tokens, the vocab over
    ``model`` when divisible."""
    vshard = S.MODEL_AXIS if cfg.vocab_size % axis_size(
        mesh, S.MODEL_AXIS) == 0 else None
    return S.ns(mesh, S.batch_split(mesh, batch), *([None] * (rank - 2)),
                vshard)


def _placed(t, sharding: S.MeshSharding, dev: torch.device):
    return shard_tree({"t": t}, {"t": sharding}, dev)["t"]


def make_decode_step(mesh: DeviceMesh, cfg: ArchConfig, *, batch: int,
                     max_seq: int):
    """The decode step on ``mesh`` and its (param, cache, token, position)
    shardings. The step takes the global tokens and positions (numpy
    arrays or tensors, the same on every rank) and parameters and a cache
    (of ``max_seq`` positions) that are placed as ``shard_tree`` places
    them where they are not DTensors of these shardings already; it
    returns (next tokens sharded as the positions, logits [B, V] with the
    vocab over ``model`` when divisible, the cache written in place). As
    in the reference, ``mesh`` reaches ``forward`` only when the batch
    splits over the data axes."""
    dev = mesh_device(mesh)
    ps = param_shardings(mesh, cfg, abstract_params(cfg))
    cs = cache_shardings(mesh, cfg, batch)
    ts = token_shardings(mesh, cfg, batch, 3 if cfg.frontend else 2)
    pos_s = token_shardings(mesh, cfg, batch, 1)
    logits_s = _logits_sharding(mesh, cfg, batch, 2)
    fmesh = mesh if S.batch_split(mesh, batch) is not None else None

    @torch.no_grad()
    def step(params: dict, cache: dict, tokens, pos):
        nxt, logits, cache = decode_step(
            shard_tree(params, ps, dev), shard_tree(cache, cs, dev),
            _placed(tokens, ts, dev), _placed(pos, pos_s, dev), cfg=cfg,
            mesh=fmesh)
        return (nxt.redistribute(mesh, pos_s.placements),
                logits.redistribute(mesh, logits_s.placements), cache)

    return step, (ps, cs, ts, pos_s)


def make_prefill_step(mesh: DeviceMesh, cfg: ArchConfig, *, batch: int,
                      seq_len: int):
    """The prefill step on ``mesh`` and its (param, token) shardings. The
    step takes the global inputs [B, S] (or [B, S, F]) and returns
    (logits [B, S, V] with the vocab over ``model`` when divisible, the
    cache of S positions placed by ``cache_shardings``)."""
    dev = mesh_device(mesh)
    ps = param_shardings(mesh, cfg, abstract_params(cfg))
    ts = token_shardings(mesh, cfg, batch, 3 if cfg.frontend else 2)
    cs = cache_shardings(mesh, cfg, batch)
    logits_s = _logits_sharding(mesh, cfg, batch, 3)
    fmesh = mesh if S.batch_split(mesh, batch) is not None else None

    @torch.no_grad()
    def step(params: dict, inputs):
        logits, cache = prefill_step(shard_tree(params, ps, dev),
                                     _placed(inputs, ts, dev), cfg=cfg,
                                     mesh=fmesh)
        return (logits.redistribute(mesh, logits_s.placements),
                shard_tree(cache, cs, dev))

    return step, (ps, ts)
