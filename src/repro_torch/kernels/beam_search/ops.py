"""Dispatch for the fused beam walk: the CUDA kernel for tensors on the
card (``beam_search_cuda``), the plain PyTorch walk for tensors on the
CPU. Port of ``repro.kernels.beam_search.ops``, including the post-walk
tag alive-mask ``_apply_filter``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.beam_search.ref import beam_search_ref

METRIC_CODES = {"l2": 0, "ip": 1, "angular": 2}
# a row's visited bitmask stays in shared memory up to this size
# (n = 786,432 nodes); larger graphs use a zeroed global scratch tensor
VISITED_SHARED_MAX_BYTES = 96 * 1024
SMEM_MAX_BYTES = 227 * 1024

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("beam_search")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.beam_search_launch.argtypes = [
            p, i, p, p, p, p, p, p, p, p,
            i, i, i, i, i, i, i, i, i, p]
        lib.beam_search_launch.restype = i
        lib.beam_search_smem_bytes.argtypes = [i, i, i, i, i, i, i]
        lib.beam_search_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def load_kernel() -> None:
    """Build (if needed) and load ``csrc/beam_search.cu`` now, in the
    calling thread; raises if nvcc or the load fails. A multi-threaded
    caller (the serving engine) does this once before it starts threads
    that would otherwise all wait on the first launch's build."""
    _library()


def _check(t: torch.Tensor, name: str, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def beam_search_cuda(data: torch.Tensor, bottom: torch.Tensor,
                     queries: torch.Tensor, entries: torch.Tensor, *,
                     metric: str, ef: int, max_iters: int,
                     scale: Optional[torch.Tensor] = None,
                     zero: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/beam_search.cu`` (one warp per (graph, slot) row);
    same contract as :func:`beam_search_ref`."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError("beam_search_cuda takes CUDA tensors")
    quantized = data.dtype == torch.int8
    _check(data, "data", (torch.float32, torch.int8), dev)
    _check(bottom, "bottom", (torch.int32,), dev)
    _check(queries, "queries", (torch.float32,), dev)
    _check(entries, "entries", (torch.int32,), dev)
    if quantized:
        if scale is None or zero is None:
            raise ValueError("int8 data needs scale and zero")
        _check(scale, "scale", (torch.float32,), dev)
        _check(zero, "zero", (torch.float32,), dev)
    s, n, d = data.shape
    m0 = bottom.shape[2]
    c = queries.shape[1]
    if bottom.shape[:2] != (s, n) or queries.shape != (s, c, d) \
            or entries.shape != (s, c):
        raise ValueError("inconsistent beam_search shapes")
    efp = min(ef, n)
    out_s = torch.empty((s, c, efp), dtype=torch.float32, device=dev)
    out_i = torch.empty((s, c, efp), dtype=torch.int32, device=dev)
    if s * c == 0 or efp == 0:
        return out_s, out_i
    lib = _library()
    words = (n + 31) // 32
    vis_shared = words * 4 <= VISITED_SHARED_MAX_BYTES
    for warps in (4, 2, 1):
        smem = lib.beam_search_smem_bytes(d, efp, m0, words, int(vis_shared),
                                          int(quantized), warps)
        if smem <= SMEM_MAX_BYTES:
            break
    else:
        raise ValueError(f"beam_search: one row needs {smem} bytes of "
                         f"shared memory (d={d}, ef={efp}, M0={m0})")
    vis = None if vis_shared else torch.zeros(
        (s * c, words), dtype=torch.int32, device=dev)
    err = lib.beam_search_launch(
        data.data_ptr(), int(quantized),
        scale.data_ptr() if quantized else None,
        zero.data_ptr() if quantized else None,
        bottom.data_ptr(), queries.data_ptr(), entries.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        None if vis is None else vis.data_ptr(),
        s, n, d, m0, c, efp, int(max_iters), METRIC_CODES[metric], warps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"beam_search kernel launch failed: CUDA error "
                           f"{err}")
    beam_search_cuda.launches += 1
    return out_s, out_i


beam_search_cuda.launches = 0


def _apply_filter(scores: torch.Tensor, nodes: torch.Tensor,
                  tag_words: torch.Tensor, filter_words: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Metadata alive-mask on the walk's emitted candidates: candidates
    whose tag bitset misses the slot's filter become (-inf, -1).

    tag_words: [S, n, 2] i32; filter_words: [S, C, 2] i32 (zero words ==
    no filtering)."""
    from repro_torch.core.filters import alive_words
    s, c, e = nodes.shape
    idx = nodes.clamp(min=0).long().reshape(s, c * e, 1).expand(-1, -1, 2)
    cand = tag_words.gather(1, idx).reshape(s, c, e, 2)
    alive = alive_words(cand, filter_words[:, :, None, :])
    return (torch.where(alive, scores, -torch.inf),
            torch.where(alive, nodes, -1))


def beam_search(data: torch.Tensor, bottom: torch.Tensor,
                queries: torch.Tensor, entries: torch.Tensor, *,
                metric: str, ef: int, max_iters: int,
                scale: Optional[torch.Tensor] = None,
                zero: Optional[torch.Tensor] = None,
                tag_words: Optional[torch.Tensor] = None,
                filter_words: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused bottom-layer beam walk over a stack of graphs.

    data [S, n, d] (f32, or int8 with scale/zero), bottom [S, n, M0],
    queries [S, C, d], entries [S, C] -> (scores [S, C, ef'], local nodes
    [S, C, ef'] i32) best-first, (-inf, -1) padded. ``tag_words`` ([S, n,
    2] i32) + ``filter_words`` ([S, C, 2] i32) apply the alive-mask to
    the emitted candidates.
    """
    if data.device.type == "cuda":
        out_s, out_i = beam_search_cuda(
            data.contiguous(), bottom.to(torch.int32).contiguous(),
            queries.to(torch.float32).contiguous(),
            entries.to(torch.int32).contiguous(), metric=metric, ef=ef,
            max_iters=max_iters,
            scale=None if scale is None else
            scale.to(torch.float32).reshape(-1).contiguous(),
            zero=None if zero is None else
            zero.to(torch.float32).reshape(-1).contiguous())
    elif data.device.type == "cpu":
        out_s, out_i = beam_search_ref(
            data, bottom, queries, entries, metric=metric, ef=ef,
            max_iters=max_iters, scale=scale, zero=zero)
    else:
        raise ValueError(f"beam_search: unsupported device {data.device}")
    if tag_words is not None and filter_words is not None:
        out_s, out_i = _apply_filter(out_s, out_i, tag_words, filter_words)
    return out_s, out_i
