"""Dispatch for the asymmetric int8 distance scan: the CUDA kernel for
tensors on the card (``quant_scores_cuda``, ``csrc/quant_distance.cu``),
the plain PyTorch version (``quant_scores_ref``) for tensors on the CPU.
Port of ``repro.kernels.quant_distance.ops``.

As in the reference, nothing on the search path calls it: the int8 walk
scores its rows inside the beam kernel. It is the primitive of
standalone scans over a quantized shard (brute-force baselines,
candidate scoring).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.common.device import DeviceLike
from repro_torch.kernels.quant_distance.ref import quant_scores_ref

METRIC_CODES = {"l2": 0, "ip": 1, "angular": 2}

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("quant_distance")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_distance_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.quant_distance_launch.restype = i
        _lib = lib
    return _lib


def quant_scores_cuda(q: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor, zero: torch.Tensor, *,
                      metric: str) -> torch.Tensor:
    """Launch ``csrc/quant_distance.cu`` (bf16 tensor cores, the query
    side split in three pieces; a persistent grid of warp-specialized
    blocks of 128 queries that walk tiles of 64 rows); same contract as
    :func:`quant_scores_ref`. q
    [B, d] float32, codes [n, d] int8, scale and zero [d] float32, all
    contiguous on one CUDA device; any B, n, d >= 1. Returns [B, n]
    float32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("quant_scores_cuda takes CUDA tensors")
    for name, t, dtype in (("q", q, torch.float32),
                           ("codes", codes, torch.int8),
                           ("scale", scale, torch.float32),
                           ("zero", zero, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    b, d = q.shape
    n = codes.shape[0]
    if codes.shape != (n, d) or scale.shape != (d,) or zero.shape != (d,):
        raise ValueError(
            f"inconsistent quant_scores shapes: q {tuple(q.shape)} codes "
            f"{tuple(codes.shape)} scale {tuple(scale.shape)} zero "
            f"{tuple(zero.shape)}")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    if d == 0:
        raise ValueError("quant_scores: d must be >= 1")
    err = _library().quant_distance_launch(
        q.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), b, n, d, METRIC_CODES[metric],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_distance kernel launch failed: error "
                           f"{err}")
    quant_scores_cuda.launches += 1
    return out


quant_scores_cuda.launches = 0


def quant_impl(device: Optional[DeviceLike] = None) -> str:
    """Which implementation :func:`quant_scores` takes for tensors on
    ``device`` (default: the card when there is one, else the CPU):
    ``"cuda-kernel"`` or ``"torch-plain"``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda-kernel"
    if kind == "cpu":
        return "torch-plain"
    raise ValueError(f"quant_scores: unsupported device {device}")


def quant_scores(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, *, metric: str) -> torch.Tensor:
    """Similarity of float32 queries [B, d] against int8 database codes
    [n, d] on the ``(scale, zero)`` grid -> [B, n] float32 (larger = more
    similar): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if quant_impl(q.device) == "cuda-kernel":
        return quant_scores_cuda(q, codes, scale, zero, metric=metric)
    return quant_scores_ref(q, codes, scale, zero, metric=metric)
