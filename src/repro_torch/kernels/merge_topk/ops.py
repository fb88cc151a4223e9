"""Dedup-top-k merge: a Triton kernel for tensors on the card
(``merge_topk_cuda``), the plain PyTorch rounds for tensors on the CPU.
Port of ``repro.kernels.merge_topk.ops`` (``alive`` mask, padding when
k > m).

The Triton kernel replaces the Pallas TPU kernel ``merge_topk_pallas``
(src/repro/kernels/merge_topk/kernel.py). It is a row-wise reduction:
one program holds one row of m = w * k_search partials in registers and
runs k rounds of (max, lowest position of the max, id-match retire).
What bounds it on the H100: it reads 8 bytes and writes at most 8 bytes
per entry, so its floor is memory traffic, but k dependent reductions
over the row make it latency-bound at the path's sizes (m of 160 to
5,120); the design keeps the whole row on chip so that every round
touches registers only, and launches one program per row so that the
1,024 rows of a batch spread over all SMs.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.merge_topk.ref import merge_topk_ref

triton = None
tl = None


@functools.lru_cache(maxsize=None)
def _kernel():
    global triton, tl
    import triton as _triton
    import triton.language as _tl
    triton, tl = _triton, _tl

    @triton.jit
    def merge_kernel(s_ptr, i_ptr, os_ptr, oi_ptr, m, k,
                     BLOCK_M: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_M)
        inb = cols < m
        s = tl.load(s_ptr + row * m + cols, mask=inb, other=-float("inf"))
        ids = tl.load(i_ptr + row * m + cols, mask=inb, other=-1)
        s = tl.where(ids >= 0, s, -float("inf"))
        for r in range(k):
            best = tl.max(s, axis=0)
            # lowest position among the maxima (-0.0 == +0.0)
            j = tl.min(tl.where(s == best, cols, BLOCK_M), axis=0)
            bid = tl.sum(tl.where(cols == j, ids, 0), axis=0)
            alive = best > -float("inf")
            bid = tl.where(alive, bid, -1)
            tl.store(os_ptr + row * k + r, best)
            tl.store(oi_ptr + row * k + r, bid)
            retire = (cols == j) | ((ids == bid) & (bid >= 0))
            s = tl.where(retire, -float("inf"), s)

    return merge_kernel


def merge_topk_cuda(scores: torch.Tensor, ids: torch.Tensor, *, k: int):
    """Launch the Triton merge on [B, m] CUDA tensors (k <= m)."""
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
    out_s = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    if b == 0:
        return out_s, out_i
    block_m = max(16, 1 << (m - 1).bit_length())
    warps = 4 if block_m <= 1024 else (8 if block_m <= 4096 else 16)
    _kernel()[(b,)](scores, ids, out_s, out_i, m, k, BLOCK_M=block_m,
                    num_warps=warps)
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
