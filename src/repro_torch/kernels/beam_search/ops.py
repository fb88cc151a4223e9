"""Dispatch for the fused beam walk: the CUDA kernel for tensors on the
card (``beam_search_cuda``), the plain PyTorch walk for tensors on the
CPU. Port of ``repro.kernels.beam_search.ops``, including the post-walk
tag alive-mask ``_apply_filter``.

``walk_plan`` chooses the kernel's block layout per shape: the rows and
columns of d a staging pass holds in shared memory, where the visited
bitmask lives, and the warps that walk one (graph, slot) row (more than
one where that keeps as many walks resident on an SM).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.common.device import sm_count
from repro_torch.kernels.beam_search.ref import beam_search_ref

METRIC_CODES = {"l2": 0, "ip": 1, "angular": 2}
# a row's visited bitmask stays in shared memory up to this size
# (n = 786,432 nodes); larger graphs use a zeroed global scratch tensor
VISITED_SHARED_MAX_BYTES = 96 * 1024
SMEM_MAX_BYTES = 227 * 1024
# one staging buffer: all M0 rows of an expansion at once where they fit
# (M0 = 32 rows of d = 128 float32 take 16 KB), or wherever the launch
# leaves at most one walk an SM (faster than slices for the kNN-LM
# lookups' 32 walks of d = 2,048 and 1,536: scripts/beam_variants.py
# --plans); else slices of d, two buffers, the next slice in flight while
# one is scored
STAGE_MAX_BYTES = 32 * 1024
SLICE_COLS = 64          # slices of d are multiples of this many columns
MAX_M0 = 64              # adjacency slots the kernel takes (two a lane)
MAX_WARPS = 4
# what bounds the blocks resident on an SM: its shared memory (1 KB of it
# reserved a block), registers (the kernel's launch bounds hold it to 128
# a thread), threads and blocks
SM_SMEM_BYTES = 228 * 1024
SM_REGISTERS = 65_536
REGS_PER_THREAD = 128
SM_THREADS = 2048
SM_BLOCKS = 32
# a beam this large makes ranking most of an expansion, so a quarter of the
# rows is staged a pass and more walks share an SM (NVIDIA H100 80GB HBM3,
# 700 W, ef = 800: 18.1 ms against 22.2 for whole expansions;
# scripts/beam_variants.py --plans)
LARGE_BEAM = 512

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("beam_search")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.beam_search_launch.argtypes = [
            p, i, p, p, p, p, p, p, p, p,
            i, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
        lib.beam_search_launch.restype = i
        lib.beam_search_smem_bytes.argtypes = [i, i, i, i, i, i, i, i, i]
        lib.beam_search_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def load_kernel() -> None:
    """Build (if needed) and load ``csrc/beam_search.cu`` now, in the
    calling thread; raises if nvcc or the load fails. A multi-threaded
    caller (the serving engine) does this once before it starts threads
    that would otherwise all wait on the first launch's build."""
    _library()


def layout_bytes(d: int, efp: int, m0: int, words: int, vis_shared: bool,
                 quantized: bool, stage_rows: int, slice_cols: int,
                 stage_buffers: int) -> int:
    """Shared-memory bytes of one block, region by region as the kernel's
    ``Layout`` lays them out (each region 16-byte aligned): the query,
    the int8 grid, the beam (8-byte entries), the new candidates (nodes,
    and their float64 dot products and norms), the prefetched adjacency
    row, 32 sorted
    survivors, control words, the visited bitmask, and the staging
    buffers."""
    elem = 1 if quantized else 4
    stage = elem * stage_rows * slice_cols
    sizes = (4 * d, 4 * d if quantized else 0, 4 * d if quantized else 0,
             8 * efp, 4 * m0, 8 * m0, 8 * m0, 4 * m0, 8 * 32, 16,
             4 * words if vis_shared else 0, stage,
             stage if stage_buffers == 2 else 0)
    off = 0
    for size in sizes:
        off = (off + size + 15) // 16 * 16
    return off


class WalkPlan(NamedTuple):
    warps: int           # warps that walk one (graph, slot) row
    stage_rows: int      # rows of an expansion a staging pass holds
    slice_cols: int      # columns of d a staging pass holds
    stage_buffers: int   # 2: a pass is copied while the previous is scored
    vis_shared: bool     # visited bitmask in shared memory
    smem_bytes: int      # shared memory of one block


def resident_blocks(smem_bytes: int, warps: int) -> int:
    """Blocks of ``warps`` warps and ``smem_bytes`` of shared memory that
    an H100 SM holds at once."""
    threads = 32 * warps
    return min(SM_SMEM_BYTES // (smem_bytes + 1024),
               SM_REGISTERS // (threads * REGS_PER_THREAD),
               SM_THREADS // threads, SM_BLOCKS)


@functools.lru_cache(maxsize=1024)
def walk_plan(walks: int, n: int, d: int, efp: int, m0: int,
              quantized: bool, sms: int) -> WalkPlan:
    """Block layout of one launch over ``walks`` (graph, slot) rows on a
    card of ``sms`` SMs, one block a row.

    Staging: every row of an expansion at once, slice = d, in one buffer,
    where M0 rows fit ``STAGE_MAX_BYTES`` (a quarter of them a pass for a
    beam of ``LARGE_BEAM`` or more) or there are no more walks than SMs;
    else the widest multiple of
    ``SLICE_COLS`` columns that does, in two buffers; halved (columns,
    then rows) while the block exceeds the shared memory a block may have.
    Warps: the most of 1, 2 and 4 that keep as many walks resident on an
    SM as one warp a walk would (as many as shared memory allows, or as
    there are walks for each SM): an engine batch of 16 walks gets 4,
    4,096 float32 walks over graphs of 65,536 rows 2 (shared memory holds
    8 of them an SM either way), 4,096 int8 walks 1."""
    if m0 > MAX_M0:
        raise ValueError(f"beam_search: M0 = {m0} adjacency slots, the "
                         f"kernel takes at most {MAX_M0}")
    elem = 1 if quantized else 4
    words = (n + 31) // 32
    vis_shared = words * 4 <= VISITED_SHARED_MAX_BYTES
    slice_cols = d
    stage_rows = m0
    if m0 * d * elem > STAGE_MAX_BYTES and walks > sms:
        slice_cols = max(SLICE_COLS, STAGE_MAX_BYTES // (m0 * elem)
                         // SLICE_COLS * SLICE_COLS)
    elif efp >= LARGE_BEAM:
        stage_rows = -(-m0 // 4)

    def buffers():
        return 1 if slice_cols == d else 2

    def size():
        return layout_bytes(d, efp, m0, words, vis_shared, quantized,
                            stage_rows, slice_cols, buffers())
    while size() > SMEM_MAX_BYTES:
        if slice_cols > SLICE_COLS:
            slice_cols = max(SLICE_COLS, slice_cols // 2 // SLICE_COLS
                             * SLICE_COLS)
        elif stage_rows > 1:
            stage_rows = (stage_rows + 1) // 2
        else:
            raise ValueError(f"beam_search: one walk needs {size()} bytes "
                             f"of shared memory (d={d}, ef={efp}, M0={m0})")
    smem = size()
    want = min(resident_blocks(smem, 1), -(-walks // sms))
    warps = 1
    while warps < MAX_WARPS and resident_blocks(smem, 2 * warps) >= want:
        warps *= 2
    return WalkPlan(warps, stage_rows, slice_cols, buffers(), vis_shared,
                    smem)


def copy_units(d: int, slice_cols: int, m0: int, quantized: bool,
               data_ptr: int, bottom_ptr: int) -> Tuple[int, int]:
    """Bytes one copy instruction moves for a data row (16 where rows,
    slices and the tensor are 16-byte aligned, else 4, else 1: int8 rows
    of d % 4 != 0) and for an adjacency row (16 or 4)."""
    elem = 1 if quantized else 4
    row = 1
    for unit in (16, 4):
        if (d * elem) % unit == 0 and (slice_cols * elem) % unit == 0 \
                and data_ptr % unit == 0:
            row = unit
            break
    adj = 16 if m0 % 4 == 0 and bottom_ptr % 16 == 0 else 4
    return row, adj


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
    """Launch ``csrc/beam_search.cu`` (one block per (graph, slot) row,
    laid out by :func:`walk_plan`); same contract as
    :func:`beam_search_ref`: a slot whose entry is -1 is not walked."""
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
    plan = walk_plan(s * c, n, d, efp, m0, quantized, sm_count(dev))
    lib = _library()
    words = (n + 31) // 32
    smem = lib.beam_search_smem_bytes(d, efp, m0, words,
                                      int(plan.vis_shared), int(quantized),
                                      plan.stage_rows, plan.slice_cols,
                                      plan.stage_buffers)
    if smem != plan.smem_bytes:
        raise RuntimeError(f"beam_search: the kernel lays out {smem} bytes "
                           f"of shared memory, walk_plan {plan.smem_bytes}")
    row_unit, adj_unit = copy_units(d, plan.slice_cols, m0, quantized,
                                    data.data_ptr(), bottom.data_ptr())
    vis = None if plan.vis_shared else torch.zeros(
        (s * c, words), dtype=torch.int32, device=dev)
    err = lib.beam_search_launch(
        data.data_ptr(), int(quantized),
        scale.data_ptr() if quantized else None,
        zero.data_ptr() if quantized else None,
        bottom.data_ptr(), queries.data_ptr(), entries.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        None if vis is None else vis.data_ptr(),
        s, n, d, m0, c, efp, int(max_iters), METRIC_CODES[metric],
        plan.warps, plan.stage_rows, plan.slice_cols, plan.stage_buffers,
        row_unit, adj_unit,
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
    [S, C, ef'] i32) best-first, (-inf, -1) padded; a slot whose entry is
    -1 is not walked and returns (-inf, -1) only. ``tag_words`` ([S, n,
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
