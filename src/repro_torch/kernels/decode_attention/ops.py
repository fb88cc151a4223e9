"""Dispatch for flash-decode attention: the CUDA kernel for tensors on
the card (``flash_decode_cuda``, ``csrc/decode_attention.cu``), the plain
PyTorch version for tensors on the CPU. Port of
``repro.kernels.decode_attention.ops``, with the optional lower bound of
a sliding window (``window``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.common.device import sm_count
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128, 240)
MAX_GROUPS = 16
# a tile: the cache rows of one pass of a block, 32 KB of K and V (8 warps
# with four 16-byte row loads a lane in flight, at G <= 4), rows counted
# at the width their lanes read (:class:`Layout`)
TILE_BYTES = 32 * 1024
# the spans of one (batch row, kv head): the kernel merges at most this
# many partial states
MAX_SPANS = 256

_lib = None
# (device index, stream) -> (partial states, per-(b, kv head) counters)
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def bind(lib):
    """Declare the C interface of a loaded ``csrc/decode_attention.cu``
    library on ``lib``; returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.flash_decode_launch.restype = i
    lib.flash_decode_blocks_per_sm.argtypes = [i] * 4
    lib.flash_decode_blocks_per_sm.restype = i
    lib.flash_decode_layout.argtypes = [i] * 4 + [p]
    lib.flash_decode_layout.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        _lib = bind(cuda_lib.load("decode_attention"))
    return _lib


def load_kernel() -> None:
    """Build (if needed) and load ``csrc/decode_attention.cu`` now, in the
    calling thread; raises if nvcc or the load fails. A caller that starts
    threads (the streaming engine's datastore client) does this first, so
    that no first-use build runs while those threads launch kernels."""
    _library()


class Layout(NamedTuple):
    lanes: int     # lanes that read a cache row, a power of two
    pieces: int    # 16-byte pieces of the row a lane holds
    slices: int    # blocks over one kv head's query heads
    heads: int     # query heads a block holds, a power of two

    @property
    def row_bytes(self) -> int:
        """A cache row's bytes as its lanes read it (idle lanes count)."""
        return 16 * self.lanes * self.pieces


@functools.lru_cache(maxsize=None)
def _layout(lib, h: int, kvh: int, hd: int, bf16: int) -> Layout:
    out = (ctypes.c_int * 4)()
    if lib.flash_decode_layout(h, kvh, hd, bf16, out) != 0:
        raise ValueError(f"flash_decode: no kernel for {h} query heads over "
                         f"{kvh} kv heads at head_dim {hd}")
    return Layout(*out)


def kernel_layout(h: int, kvh: int, hd: int, bf16: bool) -> Layout:
    """How the compiled kernel reads a row and cuts a kv head's query
    heads at these shapes (``flash_decode_layout``; builds the library)."""
    return _layout(_library(), h, kvh, hd, int(bf16))


class DecodePlan(NamedTuple):
    tile_rows: int        # cache rows of a tile
    tiles_per_span: int   # tiles one block walks
    spans: int            # blocks over one (batch row, kv head)


def decode_plan(groups: int, s: int, row_bytes: int, sms: int,
                resident: int, *, tile_rows: int = 0) -> DecodePlan:
    """How the kernel cuts a cache of ``s`` rows for ``groups`` (batch
    row, kv head, slice of its query heads) units, a row ``row_bytes``
    wide as its lanes read it (:attr:`Layout.row_bytes`: 512 bytes for a
    bf16 row of hd = 240, whose 480 bytes take 32 lanes), on ``sms`` SMs
    that hold ``resident`` blocks each: tiles of TILE_BYTES of K and V
    (or ``tile_rows`` rows), one tile a block while every tile's block
    fits on the card at once; else as many spans of several tiles as make
    one wave of blocks. Blocks outside a row's valid rows exit at once, so
    a plan sized for the whole cache costs the short rows (and the rows
    before a window) nothing."""
    t = tile_rows or max(1, TILE_BYTES // (2 * row_bytes))
    tiles = -(-s // t)
    cap = sms * max(resident, 1)
    if groups * tiles <= cap and tiles <= MAX_SPANS:
        return DecodePlan(t, 1, tiles)
    spans = max(1, min(MAX_SPANS, cap // groups))
    per = -(-tiles // spans)
    return DecodePlan(t, per, -(-tiles // per))


@functools.lru_cache(maxsize=None)
def _resident(lib, h: int, kvh: int, hd: int, bf16: int) -> int:
    """Blocks of the kernel an SM holds at once (the CUDA occupancy API)."""
    n = lib.flash_decode_blocks_per_sm(h, kvh, hd, bf16)
    if n < 0:
        raise RuntimeError(f"flash_decode: the occupancy query failed "
                           f"({n})")
    return n


def plan_for(q: torch.Tensor, k: torch.Tensor) -> DecodePlan:
    """The plan :func:`flash_decode_cuda` launches for ``q`` and ``k``."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    bf16 = int(k.dtype == torch.bfloat16)
    lay = kernel_layout(h, kvh, hd, bf16)
    return decode_plan(b * kvh * lay.slices, s, lay.row_bytes,
                       sm_count(k.device),
                       _resident(_library(), h, kvh, hd, bf16))


def _workspace(dev: torch.device, stream: int, floats: int, units: int):
    """The partial-state buffer and the counters of ``stream``, kept from
    call to call and grown when a call needs more; the counters are
    zeroed once, when allocated (the kernel leaves them 0)."""
    key = (dev.index, stream)
    part, counters = _workspaces.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < units:
        counters = torch.zeros(units, dtype=torch.int32, device=dev)
    _workspaces[key] = (part, counters)
    return part, counters


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Launch ``csrc/decode_attention.cu``; same contract as
    :func:`decode_attention_ref`. q [B, H, hd] float32, k and v
    [B, S, KV, hd] float32 or bfloat16 (contiguous, read in place), pos
    [B] int32, ``window`` >= 0 (0: none) -> [B, H, hd] float32. One
    launch; the call allocates only its output."""
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
    if window < 0:
        raise ValueError(f"flash_decode: window {window} < 0")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    if b == 0 or s == 0:
        return out.zero_()
    lay = kernel_layout(h, kvh, hd, k.dtype == torch.bfloat16)
    units = b * kvh * lay.slices
    plan = plan_for(q, k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, counters = _workspace(
        dev, stream, units * plan.spans * lay.heads * (hd + 2), units)
    err = _library().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        b, s, h, kvh, hd, int(k.dtype == torch.bfloat16),
        plan.tile_rows * plan.tiles_per_span, plan.spans, int(window),
        stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Single-token GQA attention over a KV cache: q [B, H, hd], k and v
    [B, S, KV, hd], pos [B], the rows max(0, pos - window + 1)..pos valid
    (0..pos without a window) -> [B, H, hd] float32. The kernel reads a
    CUDA cache in place; a CPU cache takes the plain version."""
    if k.device.type == "cuda":
        return flash_decode_cuda(q.to(torch.float32).contiguous(), k, v,
                                 pos.to(torch.int32).contiguous(), window)
    if k.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos, window)
    raise ValueError(f"flash_decode: unsupported device {k.device}")
