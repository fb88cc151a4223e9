"""Dedup-top-k merge: the CUDA kernel for tensors on the card
(``merge_topk_cuda``, ``csrc/merge_topk.cu``: one warp a row, one packed
key an entry), the plain PyTorch rounds for tensors on the CPU. Port of
``repro.kernels.merge_topk.ops`` (``alive`` mask, padding when k > m).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.merge_topk.ref import merge_topk_ref

# entries of a row the kernel takes: up to 1,280 a warp in registers,
# above that a block with the row in shared memory (12 bytes an entry)
MAX_M = 16_384

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("merge_topk")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.merge_topk_launch.argtypes = [p, p, p, p, i, i, i, p]
        lib.merge_topk_launch.restype = i
        _lib = lib
    return _lib


def merge_topk_cuda(scores: torch.Tensor, ids: torch.Tensor, *, k: int):
    """Launch ``csrc/merge_topk.cu`` on [B, m] CUDA tensors (float32
    scores, int32 ids, 0 < k <= m <= MAX_M). Returns (scores [B, k]
    float32 descending, ids [B, k] int32), (-inf, -1) padded."""
    if scores.device.type != "cuda" or ids.device != scores.device:
        raise ValueError("merge_topk_cuda takes CUDA tensors")
    if scores.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("merge_topk_cuda takes float32 scores, int32 ids")
    if not (scores.is_contiguous() and ids.is_contiguous()):
        raise ValueError("merge_topk_cuda takes contiguous tensors")
    b, m = scores.shape
    if ids.shape != (b, m) or not 0 < k <= m:
        raise ValueError(f"merge_topk_cuda: bad shapes {scores.shape}, "
                         f"{ids.shape}, k={k}")
    if m > MAX_M:
        raise ValueError(f"merge_topk_cuda: rows of {m} entries; the kernel "
                         f"takes at most {MAX_M}")
    out_s = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    if b == 0:
        return out_s, out_i
    err = _library().merge_topk_launch(
        scores.data_ptr(), ids.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), b, m, k,
        torch.cuda.current_stream(scores.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merge_topk kernel launch failed: CUDA error "
                           f"{err}")
    merge_topk_cuda.launches += 1
    return out_s, out_i


merge_topk_cuda.launches = 0


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, *, k: int,
               alive=None):
    """k best entries per row with duplicate ids removed.

    scores [B, m] f32 (-inf empty), ids [B, m] int (-1 empty); ``alive``
    ([B, m] bool) demotes dead entries to (-inf, -1) before the merge; if
    k > m the inputs are padded up. Returns (scores [B, k] f32
    descending, ids [B, k] i32), (-inf, -1) padded.
    """
    ids = ids.to(torch.int32)
    scores = scores.to(torch.float32)
    if alive is not None:
        scores = torch.where(alive, scores, -torch.inf)
        ids = torch.where(alive, ids, -1)
    m = scores.shape[1]
    if k > m:
        pad = k - m
        scores = torch.nn.functional.pad(scores, (0, pad),
                                         value=-torch.inf)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    if scores.device.type == "cuda":
        return merge_topk_cuda(scores.contiguous(), ids.contiguous(), k=k)
    if scores.device.type == "cpu":
        return merge_topk_ref(scores, ids, k=k)
    raise ValueError(f"merge_topk: unsupported device {scores.device}")
