"""Top-k similarity scan: a CUDA kernel for tensors on the card
(``topk_similarity_cuda``, ``csrc/topk_distance.cu``), the plain PyTorch
version for the CPU.

The kernel replaces the Pallas TPU kernel ``topk_similarity_pallas``
(src/repro/kernels/topk_distance/kernel.py): a register-tiled float32
product over tiles of 128 queries x 128 database rows, with a running
top-k per query that only admits scores above its current k-th, and the
database cut into splits whose partial lists a second kernel merges
(``split_plan`` says how many). A database of one tile (n <= 128) is cut
along d instead, into slices whose dot products a second kernel adds
before it takes the top k (``slice_plan``). Full float32, no TF32, so
that ids match the plain version's; ties go to the lowest database id.

Angular: the TPU kernel scales by ``rsqrt(|x|^2 + 1e-12)``, the plain
version divides by ``|x| + 1e-12``; the kernel follows the plain version
(``dot / ((|q| + 1e-12) * (|x| + 1e-12))``). The main path uses only l2
and ip.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.common.device import sm_count
from repro_torch.kernels.topk_distance.ref import topk_similarity_ref

METRIC_CODES = {"l2": 0, "ip": 1, "angular": 2}
MAX_K = 256
TILE = 128          # query rows of a CTA, and database rows of a tile
SLAB = 16           # columns of d a pipeline stage
MAX_SPLITS = 128

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("topk_distance")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                    i, i, i, i, p]
        lib.topk_launch.restype = i
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=1024)
def split_plan(b: int, n: int, sms: int):
    """(splits, tiles_per_split) of the database for B queries against n
    rows on a card of ``sms`` SMs, one CTA each: the count of splits that
    minimises (waves of CTAs) x (tiles a CTA walks), ties to fewer splits.
    One split when the query tiles alone fill whole waves."""
    q_tiles, n_tiles = -(-b // TILE), -(-n // TILE)
    best = None
    for s in range(1, min(n_tiles, MAX_SPLITS) + 1):
        per = -(-n_tiles // s)
        s_eff = -(-n_tiles // per)
        cost = -(-(q_tiles * s_eff) // sms) * per
        if best is None or cost < best[0]:
            best = (cost, s_eff, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=1024)
def slice_plan(b: int, n: int, d: int, sms: int):
    """(slices, columns a slice) of d for B queries against n rows of
    width d (a multiple of 4): with one database tile (n <= TILE) and the
    query tiles on under half of ``sms`` SMs, as many slices of at least
    four slabs as fill the SMs; else (1, d), no cut."""
    q_tiles, slabs = -(-b // TILE), -(-d // SLAB)
    if n > TILE or 2 * q_tiles > sms:
        return 1, d
    slices = min(sms // q_tiles, slabs // 4)
    if slices <= 1:
        return 1, d
    cols = -(-slabs // slices) * SLAB
    return -(-d // cols), cols


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t with d padded by zeros to a multiple of 4 and a 16-byte aligned
    start, as the kernel's 16-byte copies need (zeros change no dot
    product and no norm); t itself when it already is."""
    pad = (-t.shape[1]) % 4
    if pad:
        return F.pad(t, (0, pad))
    return t.clone() if t.data_ptr() % 16 else t


def topk_similarity_cuda(queries: torch.Tensor, database: torch.Tensor, *,
                         k: int, metric: str = "l2"):
    """Launch ``csrc/topk_distance.cu`` on CUDA tensors (float32,
    contiguous, 1 <= k <= min(n, MAX_K)). Returns (scores [B, k] float32
    descending, ids [B, k] int32)."""
    dev = queries.device
    if dev.type != "cuda" or database.device != dev:
        raise ValueError("topk_similarity_cuda takes CUDA tensors")
    if queries.dtype != torch.float32 or database.dtype != torch.float32:
        raise TypeError("topk_similarity_cuda takes float32 tensors")
    if not (queries.is_contiguous() and database.is_contiguous()):
        raise ValueError("topk_similarity_cuda takes contiguous tensors")
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    b, d = queries.shape
    n, d2 = database.shape
    if d != d2 or d < 1 or not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"topk_similarity_cuda: d={d}/{d2}, k={k}, n={n}")
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    q, x = _aligned(queries), _aligned(database)
    sms = sm_count(dev)
    splits, per = split_plan(b, n, sms)
    slices, cols = slice_plan(b, n, q.shape[1], sms)
    # one scratch buffer: query norms [B], row norms [n], and with several
    # splits the partial lists' scores and ids [B, splits, k] (4 bytes
    # each), or with several slices of d their dot products [slices, B, n],
    # every part starting on a 16-byte boundary
    parts = [b, n]
    if slices > 1:
        parts.append(slices * b * n)
    elif splits > 1:
        parts += [b * splits * k] * 2
    offsets = [0]
    for size in parts:
        offsets.append(offsets[-1] + -(-size // 4) * 4)
    scratch = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    ptr = [scratch.data_ptr() + 4 * o for o in offsets[:-1]] + [None, None]
    err = _library().topk_launch(
        q.data_ptr(), x.data_ptr(), ptr[0], ptr[1], ptr[2], ptr[3],
        out_s.data_ptr(), out_i.data_ptr(), b, n, q.shape[1], k,
        METRIC_CODES[metric], splits, per, slices, cols,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_distance kernel launch failed: CUDA error "
                           f"{err}")
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
