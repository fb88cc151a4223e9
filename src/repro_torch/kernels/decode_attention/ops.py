"""Dispatch for flash-decode attention: the CUDA kernel for tensors on
the card (``flash_decode_cuda``, ``csrc/decode_attention.cu``), the plain
PyTorch version for tensors on the CPU. Port of
``repro.kernels.decode_attention.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.device import sm_count
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUPS = 8
# split the valid rows over blocks until about this many blocks per SM
# are in flight, keeping at least MIN_SPLIT_ROWS cache rows per split
BLOCKS_PER_SM = 4
MIN_SPLIT_ROWS = 256
MAX_SPLITS = 64

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode_launch.argtypes = [p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, p]
        lib.flash_decode_launch.restype = i
        _lib = lib
    return _lib


def num_splits(b: int, kvh: int, s: int, sms: int) -> int:
    """How many blocks share one (batch row, kv head)'s cache rows."""
    want = -(-BLOCKS_PER_SM * sms // max(b * kvh, 1))
    return max(1, min(want, MAX_SPLITS, -(-s // MIN_SPLIT_ROWS)))


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/decode_attention.cu``; same contract as
    :func:`decode_attention_ref`. q [B, H, hd] float32, k and v
    [B, S, KV, hd] float32 or bfloat16 (contiguous, read in place), pos
    [B] int32 -> [B, H, hd] float32."""
    dev = k.device
    if dev.type != "cuda":
        raise ValueError("flash_decode_cuda takes CUDA tensors")
    for name, t, dtypes in (("q", q, (torch.float32,)),
                            ("k", k, (torch.float32, torch.bfloat16)),
                            ("v", v, (k.dtype,)),
                            ("pos", pos, (torch.int32,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kvh, hd) or v.shape != k.shape \
            or pos.shape != (b,):
        raise ValueError(f"inconsistent flash_decode shapes: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} pos "
                         f"{tuple(pos.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if kvh == 0 or h % kvh or not 1 <= h // kvh <= MAX_GROUPS:
        raise ValueError(f"flash_decode: {h} query heads over {kvh} kv heads;"
                         f" the kernel takes 1 to {MAX_GROUPS} per kv head")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    if b == 0 or s == 0:
        return out.zero_()
    splits = num_splits(b, kvh, s, sm_count(dev))
    part_m = part_l = part_acc = None
    if splits > 1:
        g = h // kvh
        part_m = torch.empty((b * kvh, splits, g), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((b * kvh, splits, g, hd), dtype=torch.float32,
                               device=dev)
    err = _library().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(),
        None if part_m is None else part_m.data_ptr(),
        None if part_l is None else part_l.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        b, s, h, kvh, hd, int(k.dtype == torch.bfloat16), splits,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention over a KV cache: q [B, H, hd], k and v
    [B, S, KV, hd], pos [B] -> [B, H, hd] float32. The kernel reads a CUDA
    cache in place; a CPU cache takes the plain version."""
    if k.device.type == "cuda":
        return flash_decode_cuda(q.to(torch.float32).contiguous(), k, v,
                                 pos.to(torch.int32).contiguous())
    if k.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos)
    raise ValueError(f"flash_decode: unsupported device {k.device}")
