"""Dispatch for the Mamba2 SSD chunk scan: the CUDA kernels for tensors on
the card (``ssd_cuda``, ``csrc/ssd.cu``), the plain PyTorch version
(``ssd_ref``) for tensors on the CPU. Port of ``repro.kernels.ssd.ops``.

Unlike the reference dispatch, a sequence shorter than one chunk is not
sent to the plain version: the kernel takes any S >= 1, with one chunk
of ``min(chunk, S)`` rows, as the plain version does.

One call of ``ssd_cuda`` runs the chunked form in five CUDA kernels
(prefix sums, C B^T once per chunk, chunk states, state passing,
outputs; see ``csrc/ssd.cu``) and counts one launch. Their scratch, one
float32 buffer, comes from PyTorch's caching allocator on the current
stream.

Gradients: ``ssd_cuda``'s outputs carry none, so on the card ``ssd_scan``
runs the scan through :class:`SSDScan`, a ``torch.autograd.Function``
whose backward is ``ssd_backward_cuda`` (``csrc/ssd_backward.cu``,
eleven CUDA kernels with their products on the tensor cores, one launch
counted, their grid from :func:`backward_plan`), whenever grad mode is
on and an input requires grad. ``ssd_cuda`` itself refuses such inputs,
so that no call cuts the gradient silently.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.common.device import sm_count
from repro_torch.kernels.ssd.ref import ssd_ref

MAX_P = 64        # head dim P
MAX_N = 128       # state dim N
MAX_CHUNK = 256   # chunk length Q
BWD_TILE = 64     # rows and columns of the backward's tiles

# ``ssd_backward_cuda`` against autograd through the plain scan on float64
# copies of the same inputs (the truth), as a share of each output's
# largest |value|: float32 outputs (ddt, da, d_initial_state, and dx, dB,
# dC on float32 inputs) within 1e-4, the kernel's sums being float32 in
# another order over float64 prefix sums; bf16 outputs (dx, dB, dC on
# bf16 inputs) within 2^-8, their own rounding to bf16 of values up to
# the largest.
SSD_BWD_TOL = 1e-4
SSD_BWD_TOL_BF16 = 2.0 ** -8

_lib = None
_blib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("ssd")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                   i, ll, ll, ll, ll, i, p]
        lib.ssd_launch.restype = i
        lib.ssd_scratch_floats.argtypes = [i, i, i, i, i, i]
        lib.ssd_scratch_floats.restype = ll
        _lib = lib
    return _lib


def load_kernel() -> None:
    """Build (if needed) and load ``csrc/ssd.cu`` (the forward scan) now,
    in the calling thread; raises if nvcc or the load fails. See
    ``repro_torch.kernels.beam_search.load_kernel``."""
    _library()


def _backward_library():
    global _blib
    if _blib is None:
        from repro_torch.kernels import cuda_lib
        lib = cuda_lib.load("ssd_backward")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_backward_launch.argtypes = [p] * 15 + [i] * 6 + [ll] * 4 \
            + [i] * 3 + [p]
        lib.ssd_backward_launch.restype = i
        lib.ssd_backward_scratch_bytes.argtypes = [i] * 8
        lib.ssd_backward_scratch_bytes.restype = ll
        lib.ssd_backward_smem_bytes.argtypes = [i, i]
        lib.ssd_backward_smem_bytes.restype = ll
        _blib = lib
    return _blib


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors) -> None:
    """A kernel's outputs carry no gradient: refuse inputs that would need
    one, so that a call outside :class:`SSDScan` cannot cut it."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{name} returns tensors without a gradient, and grad mode is "
            f"on with an input that requires grad: call ssd_scan, which "
            f"runs the scan through SSDScan and its backward kernel")


def _check_inputs(name: str, x, dt, a, b_mat, c_mat, initial_state,
                  chunk: int) -> None:
    """Device, dtype, shape and layout checks shared by both kernels."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    named = [("x", x, (torch.float32, torch.bfloat16)),
             ("dt", dt, (torch.float32,)), ("a", a, (torch.float32,)),
             ("b_mat", b_mat, (x.dtype,)), ("c_mat", c_mat, (x.dtype,))]
    if initial_state is not None:
        named.append(("initial_state", initial_state, (torch.float32,)))
    for nm, t, dtypes in named:
        if t.device != dev:
            raise ValueError(f"{nm} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{nm} has dtype {t.dtype}, expected {dtypes}")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if bsz < 1 or h < 1 or dt.shape != (bsz, s, h) or a.shape != (h,) \
            or b_mat.shape != (bsz, s, n) or c_mat.shape != (bsz, s, n) \
            or (initial_state is not None
                and initial_state.shape != (bsz, h, n, p)):
        raise ValueError(
            f"inconsistent ssd shapes: x {tuple(x.shape)} dt "
            f"{tuple(dt.shape)} a {tuple(a.shape)} b {tuple(b_mat.shape)} "
            f"c {tuple(c_mat.shape)}")
    if not 1 <= p <= MAX_P or not 1 <= n <= MAX_N \
            or not 1 <= chunk <= MAX_CHUNK or s < 1:
        raise ValueError(f"ssd: P={p}, N={n}, chunk={chunk}, S={s}; the "
                         f"kernel takes P <= {MAX_P}, N <= {MAX_N}, chunk "
                         f"<= {MAX_CHUNK} and S >= 1")
    for nm, t in (("x", x), ("dt", dt), ("a", a),
                  ("initial_state", initial_state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    for nm, t in (("b_mat", b_mat), ("c_mat", c_mat)):
        if t.stride(2) != 1 and n > 1:
            raise ValueError(f"{nm} needs a unit stride over N")


@functools.lru_cache(maxsize=1024)
def _scratch_floats(*shape: int) -> int:
    """float32 scratch of one call at (B, S, H, P, N, Q)."""
    return _library().ssd_scratch_floats(*shape)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None):
    """Run ``csrc/ssd.cu``; same contract as :func:`ssd_ref`, all sums
    in float32. x [B, S, H, P] float32 or bfloat16 (contiguous); dt
    [B, S, H] and a [H] float32 (contiguous); b_mat and c_mat [B, S, N]
    in x's dtype, each with a unit stride over N (read in place with
    their own row and batch strides, so the two halves of one [B, S, 2N]
    projection need no copy); initial_state [B, H, N, P] float32 or None.
    Returns (y [B, S, H, P] float32, final_state [B, H, N, P] float32).
    Takes P <= 64, N <= 128 and chunk <= 256. Raises when grad mode is
    on and an input requires grad (its outputs carry no gradient; call
    :func:`ssd_scan`)."""
    _refuse_grad("ssd_cuda", x, dt, a, b_mat, c_mat, initial_state)
    _check_inputs("ssd_cuda", x, dt, a, b_mat, c_mat, initial_state, chunk)
    dev = x.device
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=dev)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    q = min(chunk, s)
    scratch = torch.empty(_scratch_floats(bsz, s, h, p, n, q),
                          dtype=torch.float32, device=dev)
    err = _library().ssd_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        bsz, s, h, p, n, q, b_mat.stride(0), b_mat.stride(1),
        c_mat.stride(0), c_mat.stride(1), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    ssd_cuda.launches += 1
    return y, state


ssd_cuda.launches = 0


class BackwardPlan(NamedTuple):
    """The grid of ``csrc/ssd_backward.cu`` for one call's shapes."""
    hpg: int                # heads a group of the s stage (G summed over them)
    hpp: int                # heads a part of the dB/dC stage
    ctas: Dict[str, int]    # blocks with work, of each stage that multiplies


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def backward_plan(b: int, s: int, h: int, p: int, n: int, q: int,
                  sms: int) -> BackwardPlan:
    """The backward's grid at B = ``b``, S = ``s``, H = ``h``, P, N and
    chunk rows ``q`` (``min(chunk, S)``) on a card of ``sms`` SMs. Two
    stages walk heads inside a block: the s stage (a block a causal 64 x 64
    tile pair, b and chunk, and a group of ``hpg`` heads, whose part of G
    it leaves in scratch) and the dB/dC stage (a block a 64-row tile, dB
    or dC, b and chunk, and a part of ``hpp`` heads, plus one part for the
    G term). Both hold two blocks a SM, so a stage takes about
    ceil(blocks / (2 SMs)) x heads a block: each takes the heads a block
    that make that least (ties to more heads a block), with at most eight
    groups or parts, and the dB/dC stage at most four waves of blocks
    unless it has one part, since each part is a [B, S, N] pair of
    partials to write and read. The head stage (a block a (b, chunk,
    head)) splits a chunk's 16-row tiles over ceil(Q / 128) blocks of
    four warps, a pair of tiles a warp, as the kernel works out from Q.
    The dynamic shared memory of each stage is the library's
    (``ssd_backward_smem_bytes``) and does not depend on the plan."""
    nc = _cdiv(s, q)
    rows = [min(q, s - c * q) for c in range(nc)]
    tiles = [_cdiv(r, BWD_TILE) for r in rows]
    slots = 2 * sms
    tile_pairs = b * sum(t * (t + 1) // 2 for t in tiles)
    options = []
    for hpg in sorted({min(v, h) for v in (16, 12, 8, 6, 4, 3, 2, 1)},
                      reverse=True):
        ng = _cdiv(h, hpg)
        if ng <= 8:
            options.append((_cdiv(tile_pairs * ng, slots) * hpg, -hpg))
    hpg = -min(options)[1]
    row_jobs = 2 * b * sum(tiles)
    options = []
    for parts in range(1, min(h, 8) + 1):
        hpp = _cdiv(h, parts)
        ctas = row_jobs * (_cdiv(h, hpp) + 1)
        if parts == 1 or ctas <= max(4 * slots, 2 * row_jobs):
            options.append((_cdiv(ctas, slots) * hpp, _cdiv(h, hpp), hpp))
    hpp = min(options)[2]
    hsplit = _cdiv(q, 128)
    ctas = {"outer": 2 * b * nc * h,
            "sg": tile_pairs * _cdiv(h, hpg),
            "head": b * h * sum(min(hsplit, _cdiv(_cdiv(r, 16), 2))
                                for r in rows),
            "bc": row_jobs * (_cdiv(h, hpp) + 1)}
    return BackwardPlan(hpg, hpp, ctas)


def ssd_backward_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_mat: torch.Tensor, c_mat: torch.Tensor,
                      dy: torch.Tensor, *, chunk: int,
                      initial_state: Optional[torch.Tensor] = None,
                      d_final: Optional[torch.Tensor] = None):
    """Run ``csrc/ssd_backward.cu``: the gradients of ``ssd_cuda``'s
    (y, final_state) for the cotangents dy [B, S, H, P] float32 and
    d_final [B, H, N, P] float32 (None: zero). Inputs as for
    :func:`ssd_cuda` (B and C read in place through their strides).
    Returns (dx, ddt, da, db, dc, d_initial_state): dx [B, S, H, P], db and
    dc [B, S, N] (contiguous) in x's dtype; ddt [B, S, H], da [H] and
    d_initial_state [B, H, N, P] in float32 (the gradient with respect to
    a zero initial state when there is none). What autograd through the
    plain ``ssd_chunked`` gives (:func:`ssd_backward_ref`); float64 prefix
    sums, products on the tensor cores in split pieces, float32 sums, no
    atomics; the grid from :func:`backward_plan`."""
    _refuse_grad("ssd_backward_cuda", x, dt, a, b_mat, c_mat, dy,
                 initial_state, d_final)
    _check_inputs("ssd_backward_cuda", x, dt, a, b_mat, c_mat,
                  initial_state, chunk)
    dev = x.device
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    for nm, t, shape in (("dy", dy, (bsz, s, h, p)),
                         ("d_final", d_final, (bsz, h, n, p))):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{nm} must be a contiguous float32 {shape} "
                             f"tensor on {dev}")
    q = min(chunk, s)
    dx = torch.empty_like(x)
    ddt = torch.empty((bsz, s, h), dtype=torch.float32, device=dev)
    da = torch.empty((h,), dtype=torch.float32, device=dev)
    db = torch.empty((bsz, s, n), dtype=x.dtype, device=dev)
    dc = torch.empty((bsz, s, n), dtype=x.dtype, device=dev)
    dinit = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    lib = _backward_library()
    plan = backward_plan(bsz, s, h, p, n, q, sm_count(dev))
    scratch = torch.empty(lib.ssd_backward_scratch_bytes(
        bsz, s, h, p, n, q, plan.hpg, plan.hpp), dtype=torch.uint8,
        device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = lib.ssd_backward_launch(
        ptr(x), ptr(dt), ptr(a), ptr(b_mat), ptr(c_mat), ptr(initial_state),
        ptr(dy), ptr(d_final), ptr(dx), ptr(ddt), ptr(da), ptr(db), ptr(dc),
        ptr(dinit), ptr(scratch), bsz, s, h, p, n, q, b_mat.stride(0),
        b_mat.stride(1), c_mat.stride(0), c_mat.stride(1),
        int(x.dtype == torch.bfloat16), plan.hpg, plan.hpp,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd backward kernel launch failed: CUDA error "
                           f"{err}")
    ssd_backward_cuda.launches += 1
    return dx, ddt, da, db, dc, dinit


ssd_backward_cuda.launches = 0


class SSDScan(torch.autograd.Function):
    """The SSD scan on the card with its gradient: the forward is
    ``ssd_cuda`` (y float32, final_state float32), the backward
    ``ssd_backward_cuda``. Saves the inputs only; the backward recomputes
    the chunk states it needs (the forward's are float32 decays; see
    ``csrc/ssd_backward.cu``)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, initial_state, chunk: int):
        y, final = ssd_cuda(x, dt, a, b_mat, c_mat, chunk=chunk,
                            initial_state=initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, initial_state)
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a, b_mat, c_mat, initial_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, da, db, dc, dinit = ssd_backward_cuda(
            x, dt, a, b_mat, c_mat, dy.float().contiguous(), chunk=ctx.chunk,
            initial_state=initial_state,
            d_final=None if d_final is None else d_final.float().contiguous())
        return (dx, ddt, da, db, dc,
                dinit if initial_state is not None else None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD scan. Returns (y [B,S,H,P], final_state [B,H,N,P]): the
    kernel (y float32) for CUDA tensors, through :class:`SSDScan` (the
    backward kernel) when grad mode is on and an input requires grad; the
    plain version (y in x's dtype, under autograd) for CPU tensors."""
    if x.device.type == "cuda":
        if _needs_grad(x, dt, a, b_mat, c_mat, initial_state):
            return SSDScan.apply(x, dt, a, b_mat, c_mat, initial_state,
                                 chunk)
        return ssd_cuda(x, dt, a, b_mat, c_mat, chunk=chunk,
                        initial_state=initial_state)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a, b_mat, c_mat, chunk=chunk,
                       initial_state=initial_state)
    raise ValueError(f"ssd_scan: unsupported device {x.device}")
