"""Mamba2 block via state-space duality (SSD), arXiv:2405.21060 (port of
``repro.models.ssm``).

Train and prefill use the SSD *chunked* form: the selective-scan
recurrence re-expressed as dense intra-chunk products plus a light
inter-chunk state recurrence. :func:`ssd_chunked` is that form in plain
PyTorch; it is the plain version of the SSD kernel, and the block runs
the scan through the kernel's dispatch (``kernels/ssd/ops.py``), which
launches the CUDA kernel for tensors on the card. Decode is the O(1)
recurrent state update, in plain PyTorch.

B and C are ngroups=1 (shared across heads). On a mesh (DTensor
inputs) the scan runs under ``local_map`` on each rank's batch rows and
heads (:func:`_mesh_ssd_scan`), and decode's state copies land in each
rank's own shard of the cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.common import sharding as S
from repro_torch.common.config import ArchConfig, SSMConfig
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.models import layers as L


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, num_heads, state_dim)."""
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.state_dim


def init_mamba2_params(cfg: ArchConfig, dtype: torch.dtype,
                       generator: torch.Generator, device: torch.device,
                       *, layers: Optional[int] = None,
                       place=L.keep) -> dict:
    """The reference's Mamba2 parameters: dense weights ``normal /
    sqrt(fan_in)``, ``dt_bias`` zero, ``a_log = log(linspace(1, 16, H))``
    and ``d_skip`` one (these three float32 in any model dtype), conv
    bias and norm scale zero. With ``layers`` each is stacked on a
    leading axis of that many layers. Each leaf goes through
    ``place(name, leaf)`` as soon as it is made."""
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in, h, n = ssm_dims(cfg)
    lead = () if layers is None else (layers,)

    def dense(shape, fan_in):
        return L.dense_init(lead + shape, fan_in, dtype, generator, device)

    def per_layer(v: torch.Tensor) -> torch.Tensor:
        return v.expand(lead + tuple(v.shape)).clone()

    f32 = dict(dtype=torch.float32, device=device)
    make = {    # in the order of the draws
        "in_proj": lambda: dense((d, 2 * d_in), d),          # z, x
        "bc_proj": lambda: dense((d, 2 * n), d),             # B, C
        "dt_w": lambda: dense((d, h), d),
        "dt_bias": lambda: per_layer(torch.zeros(h, **f32)),
        "a_log": lambda: per_layer(torch.log(
            torch.linspace(1.0, 16.0, h, **f32))),
        "d_skip": lambda: per_layer(torch.ones(h, **f32)),
        "conv_w": lambda: dense((s.conv_width, d_in), s.conv_width),
        "conv_b": lambda: torch.zeros(lead + (d_in,), dtype=dtype,
                                      device=device),
        "ssm_norm": lambda: torch.zeros(lead + (d_in,), dtype=dtype,
                                        device=device),
        "out_proj": lambda: dense((d_in, d), d_in),
    }
    return {name: place(name, fn()) for name, fn in make.items()}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]; w: [W, C]. The sum of W
    shifted products, in the reference's order (no ``F.conv1d``: a
    float32 convolution on the card would go through cuDNN in TF32).
    DTensor inputs run it on each rank's local tensors
    (:func:`_mesh_causal_conv`)."""
    if isinstance(x, DTensor):
        return _mesh_causal_conv(x, w, b)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _mesh_causal_conv(x: DTensor, w, b) -> DTensor:
    """The causal conv under ``local_map``: each rank's batch rows (over
    the batch axes) and channels (over ``model``), where those divide; a
    channel's conv reads only its own channel, so the shard's is exact. A
    rank's gradients of w and b sum its batch rows only, partial sums
    over the batch axes."""
    mesh = x.device_mesh
    bs = S.batch_split(mesh, x.shape[0])
    cs = S.MODEL_AXIS if x.shape[2] % mesh.size(
        mesh.mesh_dim_names.index(S.MODEL_AXIS)) == 0 else None

    def pl(*spec):
        return S.ns(mesh, *spec).placements

    def over_batch(placements):
        return tuple(Partial() if bs is not None and name in S.batch_axes(
            mesh) else p for name, p in zip(mesh.mesh_dim_names, placements))

    x_pl, w_pl, b_pl = pl(bs, None, cs), pl(None, cs), pl(cs)
    fn = local_map(
        lambda xl, wl, bl: _causal_conv(*(_ContiguousGrad.apply(t)
                                          for t in (xl, wl, bl))),
        out_placements=list(x_pl), in_placements=(x_pl, w_pl, b_pl),
        in_grad_placements=(x_pl, over_batch(w_pl), over_batch(b_pl)),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(x, w, b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums.

    a: [..., Q] -> out[..., i, j] = sum_{t=j+1..i} a[..., t]  (i >= j),
    -inf above the diagonal.
    """
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """SSD scan (Mamba2 Alg. 1 'chunked' form), the plain version of the
    SSD kernel.

    Args:
      x:     [B, S, H, P]  input heads
      dt:    [B, S, H]     positive step sizes
      a:     [H]           negative decay rates (A)
      b_mat: [B, S, N]     input projection (ngroups=1)
      c_mat: [B, S, N]     output projection
      chunk: chunk length Q (S padded with dt = 0 to a multiple of
             ``min(chunk, S)``)
      initial_state: [B, H, N, P] or None (zero)

    Returns: (y [B, S, H, P] in x's dtype, final_state [B, H, N, P]
    float32, or float64 for float64 inputs). The scores, the weighted
    inputs and the carried states are cast to the inputs' dtype before
    their products, as in the reference.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = x.shape[1] // q

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).to(acc)
    bc = b_mat.reshape(bsz, nc, q, n)
    cc = c_mat.reshape(bsz, nc, q, n)

    da = dtc * a.to(acc)[None, None, None, :]            # [B, C, Q, H] (<0)
    da_h = da.movedim(-1, -2)                            # [B, C, H, Q]
    decay_in = torch.exp(_segsum(da_h))                  # [B, C, H, Q, Q]

    # intra-chunk (diagonal blocks): y_d = (C B^T ∘ L ∘ dt) x
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)         # [B, C, Q, Q]
    scores = cb[:, :, None] * decay_in * \
        dtc.movedim(-1, -2)[..., None, :]                # [B, C, H, Q, Q]
    ydt = torch.einsum("bchij,bcjhp->bcihp",
                       scores.to(xc.dtype), xc)          # [B, C, Q, H, P]

    # chunk states: S_c = sum_j B_j dt_j exp(sum_{t>j} da) x_j
    cum = torch.cumsum(da_h, dim=-1)                     # [B, C, H, Q]
    decay_to_end = torch.exp(cum[..., -1:] - cum)        # [B, C, H, Q]
    xw = xc * (dtc * decay_to_end.movedim(-2, -1)
               )[..., None].to(xc.dtype)                 # [B, C, Q, H, P]
    states = torch.einsum("bcjn,bcjhp->bchnp", bc, xw)   # [B, C, H, N, P]

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(da_h.sum(dim=-1))            # [B, C, H]
    st = torch.zeros((bsz, h, n, p), dtype=acc, device=x.device) \
        if initial_state is None else initial_state.to(acc)
    states = states.to(acc)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # [B, C, H, N, P]

    # inter-chunk contribution: y_off = C exp(cum) state_prev
    state_decay = torch.exp(cum)                         # [B, C, H, Q]
    yoff = torch.einsum("bcin,bchnp->bcihp",
                        cc, prev_states.to(cc.dtype))    # [B, C, Q, H, P]
    yoff = yoff * state_decay.movedim(-2, -1)[..., None].to(yoff.dtype)
    y = (ydt + yoff).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), st


def mamba2_block(p: dict, cfg: ArchConfig, u: torch.Tensor,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None, *,
                 decode: bool = False):
    """Full Mamba2 block.

    Train/prefill: u [B, S, D] -> (y [B, S, D], (ssm_state, conv_state)),
    the SSD through ``ssd_scan`` (the CUDA kernel on the card).
    Decode: u [B, 1, D] with states -> the same signature. Unlike the
    reference, which returns new states, decode writes the new states
    into ``ssm_state`` and ``conv_state`` in place (a layer's slices of
    the stacked cache) and returns them.
    """
    s_cfg = cfg.ssm or SSMConfig()
    bsz, s, d = u.shape
    d_in, h, n = ssm_dims(cfg)
    width = s_cfg.conv_width

    z, x = torch.split(u @ p["in_proj"], d_in, dim=-1)
    dt = F.softplus((u @ p["dt_w"]).float() + p["dt_bias"])
    b_mat, c_mat = torch.split(u @ p["bc_proj"], n, dim=-1)
    a = -torch.exp(p["a_log"])                            # [H], negative

    if decode:
        # causal conv via the rolling state [B, W-1, d_in]
        window = torch.cat([conv_state, x], dim=1)        # [B, W, d_in]
        xconv = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
        xh = L.split_heads(F.silu(xconv), h)              # [B, H, P]
        dt1 = dt[:, 0]                                    # [B, H]
        g = torch.exp(dt1 * a[None, :])                   # [B, H]
        outer = torch.einsum("bh,bn,bhp->bhnp", dt1, b_mat[:, 0].float(),
                             xh.float())
        new_state = ssm_state * g[..., None, None] + outer
        y = torch.einsum("bn,bhnp->bhp", c_mat[:, 0],
                         new_state.to(c_mat.dtype))
        y = y + xh * p["d_skip"].to(y.dtype)[None, :, None]
        y = y.reshape(bsz, 1, d_in)
        conv_state.copy_(window[:, 1:])
        ssm_state.copy_(new_state)
        states = (ssm_state, conv_state)
    else:
        xconv = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
        new_conv_state = x[:, -(width - 1):]              # raw pre-conv tail
        xh = L.split_heads(xconv, h)
        scan = _mesh_ssd_scan if isinstance(xh, DTensor) else ssd_scan
        y, final_state = scan(xh, dt, a, b_mat, c_mat,
                              chunk=s_cfg.chunk_size,
                              initial_state=ssm_state)
        y = y.to(x.dtype)
        y = y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]
        y = y.reshape(bsz, s, d_in)
        states = (final_state, new_conv_state)

    # gated RMSNorm then output projection (Mamba2)
    y = L.rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return y @ p["out_proj"], states


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    local gradient that leaves ``local_map`` becomes a DTensor's local
    shard, and DTensor's views of it (the backward of the projections)
    need the contiguous layout that the plain scan's transposes do not
    give."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _mesh_ssd_scan(x: DTensor, dt, a, b_mat, c_mat, *, chunk: int,
                   initial_state=None):
    """``ssd_scan`` on DTensors, the kernel on each rank's local tensors
    (``local_map``): x [B, S, H, P] and dt [B, S, H] split on batch over
    the batch axes and on heads over ``model`` (each where it divides), a
    [H] on heads, B and C [B, S, N] on batch (ngroups = 1: every head
    reads them). The scan is exact on such a shard. Its gradient follows
    through ``local_map`` (on the card ``SSDScan``'s backward kernel): a
    rank's dB and dC sum its heads only, and its da its batch rows only,
    so those come back as partial sums over ``model`` and over the batch
    axes."""
    mesh = x.device_mesh
    b, _, h, _ = x.shape
    bs = S.batch_split(mesh, b)
    hs = S.MODEL_AXIS if h % mesh.size(
        mesh.mesh_dim_names.index(S.MODEL_AXIS)) == 0 else None

    def pl(*spec):
        return S.ns(mesh, *spec).placements

    def partial_over(placements, axes):
        return tuple(Partial() if name in axes else p for name, p in
                     zip(mesh.mesh_dim_names, placements))

    batch_axes = S.batch_axes(mesh) if bs is not None else ()
    ins = [pl(bs, None, hs, None), pl(bs, None, hs), pl(hs),
           pl(bs, None, None), pl(bs, None, None)]
    grads = [ins[0], ins[1], partial_over(ins[2], batch_axes),
             partial_over(ins[3], (hs,)), partial_over(ins[4], (hs,))]
    args = [x, dt, a, b_mat, c_mat]
    if initial_state is not None:
        ins.append(pl(bs, hs, None, None))
        grads.append(ins[-1])
        args.append(initial_state)

    def scan(*local):
        return ssd_scan(*(_ContiguousGrad.apply(t) for t in local[:5]),
                        chunk=chunk, initial_state=local[5] if len(local) > 5
                        else None)

    fn = local_map(scan, out_placements=(ins[0], pl(bs, hs, None, None)),
                   in_placements=tuple(ins), in_grad_placements=tuple(grads),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)


def init_ssm_state(cfg: ArchConfig, batch: int, *,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero decode states: ssm [B, H, N, P] float32 and conv
    [B, W-1, d_inner] in the model's dtype."""
    s_cfg = cfg.ssm or SSMConfig()
    d_in, h, n = ssm_dims(cfg)
    return (torch.zeros((batch, h, n, s_cfg.head_dim), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, s_cfg.conv_width - 1, d_in),
                        dtype=getattr(torch, cfg.dtype), device=device))
