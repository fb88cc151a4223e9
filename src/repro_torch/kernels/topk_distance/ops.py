"""Top-k similarity scan: a Triton kernel for tensors on the card
(``topk_similarity_cuda``), the plain PyTorch version for the CPU.

The Triton kernel replaces the Pallas TPU kernel ``topk_similarity_pallas``
(src/repro/kernels/topk_distance/kernel.py). One program owns BQ query
rows and streams the database in BN-row tiles: each tile's similarities
are a tiled ``tl.dot`` over d in full float32 (``input_precision=
"ieee"``, no TF32, so that ids match the reference), and a running top-k
of width KP = next_pow2(k) stays in registers across the loop over n; a
tile is merged in k rounds of (max, lowest position) over the running
list and the tile, the running list winning ties, so equal scores keep
the lowest database id. With k = 1 (k-means assignment) that is a running
argmax.

What bounds it on the H100: 2 * B * n * d float32 operations at the
card's non-tensor fp32 rate against (B + n) * d * 4 bytes read, so at
the build's shapes (B = 4,096 or 20,000 rows, n = 1,000 centres, d = 128)
it is bound by operations; with k > 1 the k merge rounds per tile add
reductions that grow with k.

Angular: the TPU kernel scales by ``rsqrt(|x|^2 + 1e-12)``, the ref
divides by ``|x| + 1e-12``; this kernel follows the ref form
(``dot / ((|q| + 1e-12) * (|x| + 1e-12))``). The main path uses only l2
and ip.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.topk_distance.ref import topk_similarity_ref

METRIC_CODES = {"l2": 0, "ip": 1, "angular": 2}
MAX_K = 256

triton = None
tl = None


@functools.lru_cache(maxsize=None)
def _kernel():
    global triton, tl
    import triton as _triton
    import triton.language as _tl
    triton, tl = _triton, _tl

    @triton.jit
    def topk_kernel(q_ptr, x_ptr, os_ptr, oi_ptr, B, n, d, k,
                    METRIC: tl.constexpr, KP: tl.constexpr,
                    BQ: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        pid = tl.program_id(0)
        rq = (pid * BQ + tl.arange(0, BQ)).to(tl.int64)
        qmask = rq < B
        kcols = tl.arange(0, KP)
        ncols = tl.arange(0, BN)
        qn = tl.zeros([BQ], dtype=tl.float32)
        for k0 in range(0, d, BK):
            rk = k0 + tl.arange(0, BK)
            qt = tl.load(q_ptr + rq[:, None] * d + rk[None, :],
                         mask=qmask[:, None] & (rk[None, :] < d), other=0.0)
            qn += tl.sum(qt * qt, axis=1)
        acc_s = tl.full([BQ, KP], -float("inf"), tl.float32)
        acc_i = tl.full([BQ, KP], -1, tl.int32)
        for n0 in range(0, n, BN):
            rn = (n0 + ncols).to(tl.int64)
            nmask = rn < n
            dot = tl.zeros([BQ, BN], dtype=tl.float32)
            xn = tl.zeros([BN], dtype=tl.float32)
            for k0 in range(0, d, BK):
                rk = k0 + tl.arange(0, BK)
                kmask = rk < d
                qt = tl.load(q_ptr + rq[:, None] * d + rk[None, :],
                             mask=qmask[:, None] & kmask[None, :], other=0.0)
                xt = tl.load(x_ptr + rn[None, :] * d + rk[:, None],
                             mask=nmask[None, :] & kmask[:, None], other=0.0)
                dot += tl.dot(qt, xt, input_precision="ieee")
                xn += tl.sum(xt * xt, axis=0)
            if METRIC == 0:
                sims = 2.0 * dot - qn[:, None] - xn[None, :]
            elif METRIC == 1:
                sims = dot
            else:
                sims = dot / ((tl.sqrt(qn) + 1e-12)[:, None]
                              * (tl.sqrt(xn) + 1e-12)[None, :])
            sims = tl.where(nmask[None, :], sims, -float("inf"))
            new_s = tl.full([BQ, KP], -float("inf"), tl.float32)
            new_i = tl.full([BQ, KP], -1, tl.int32)
            for r in range(k):
                m1 = tl.max(acc_s, axis=1)
                j1 = tl.min(tl.where(acc_s == m1[:, None], kcols[None, :],
                                     KP), axis=1)
                m2 = tl.max(sims, axis=1)
                j2 = tl.min(tl.where(sims == m2[:, None], ncols[None, :],
                                     BN), axis=1)
                take_acc = m1 >= m2
                i1 = tl.sum(tl.where(kcols[None, :] == j1[:, None], acc_i,
                                     0), axis=1)
                best = tl.where(take_acc, m1, m2)
                bid = tl.where(take_acc, i1, (n0 + j2).to(tl.int32))
                new_s = tl.where(kcols[None, :] == r, best[:, None], new_s)
                new_i = tl.where(kcols[None, :] == r, bid[:, None], new_i)
                acc_s = tl.where((kcols[None, :] == j1[:, None])
                                 & take_acc[:, None], -float("inf"), acc_s)
                sims = tl.where((ncols[None, :] == j2[:, None])
                                & (m1 < m2)[:, None], -float("inf"), sims)
            acc_s = new_s
            acc_i = new_i
        omask = qmask[:, None] & (kcols[None, :] < k)
        optr = rq[:, None] * k + kcols[None, :]
        tl.store(os_ptr + optr, acc_s, mask=omask)
        tl.store(oi_ptr + optr, acc_i, mask=omask)

    return topk_kernel


def topk_similarity_cuda(queries: torch.Tensor, database: torch.Tensor, *,
                         k: int, metric: str = "l2"):
    """Launch the Triton scan on CUDA tensors (1 <= k <= min(n, MAX_K))."""
    dev = queries.device
    if dev.type != "cuda" or database.device != dev:
        raise ValueError("topk_similarity_cuda takes CUDA tensors")
    if queries.dtype != torch.float32 or database.dtype != torch.float32:
        raise TypeError("topk_similarity_cuda takes float32 tensors")
    if not (queries.is_contiguous() and database.is_contiguous()):
        raise ValueError("topk_similarity_cuda takes contiguous tensors")
    b, d = queries.shape
    n, d2 = database.shape
    if d != d2 or not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"topk_similarity_cuda: d={d}/{d2}, k={k}, n={n}")
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    kp = max(16, 1 << (k - 1).bit_length())
    bq = 64 if kp <= 64 else 32
    _kernel()[(triton.cdiv(b, bq),)](
        queries, database, out_s, out_i, b, n, d, k,
        METRIC=METRIC_CODES[metric], KP=kp, BQ=bq, BN=64, BK=32,
        num_warps=4)
    topk_similarity_cuda.launches += 1
    return out_s, out_i


topk_similarity_cuda.launches = 0


def topk_similarity(queries: torch.Tensor, database: torch.Tensor, *,
                    k: int, metric: str = "l2"):
    """Top-k most similar database rows per query: (scores [B, k] f32
    descending, ids [B, k] i32), ties to the lowest row."""
    if queries.device.type == "cuda":
        return topk_similarity_cuda(
            queries.to(torch.float32).contiguous(),
            database.to(torch.float32).contiguous(), k=k, metric=metric)
    if queries.device.type == "cpu":
        return topk_similarity_ref(queries, database, k=k, metric=metric)
    raise ValueError(f"topk_similarity: unsupported device {queries.device}")
