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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.ssd.ref import ssd_ref

MAX_P = 64        # head dim P
MAX_N = 128       # state dim N
MAX_CHUNK = 256   # chunk length Q

_lib = None


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
    Takes P <= 64, N <= 128 and chunk <= 256."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("ssd_cuda takes CUDA tensors")
    named = [("x", x, (torch.float32, torch.bfloat16)),
             ("dt", dt, (torch.float32,)), ("a", a, (torch.float32,)),
             ("b_mat", b_mat, (x.dtype,)), ("c_mat", c_mat, (x.dtype,))]
    if initial_state is not None:
        named.append(("initial_state", initial_state, (torch.float32,)))
    for name, t, dtypes in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtypes}")
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
    for name, t in (("x", x), ("dt", dt), ("a", a),
                    ("initial_state", initial_state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("b_mat", b_mat), ("c_mat", c_mat)):
        if t.stride(2) != 1 and n > 1:
            raise ValueError(f"{name} needs a unit stride over N")
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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD scan. Returns (y [B,S,H,P], final_state [B,H,N,P]): the
    kernel (y float32) for CUDA tensors, the plain version (y in x's
    dtype) for CPU tensors."""
    if x.device.type == "cuda":
        return ssd_cuda(x, dt, a, b_mat, c_mat, chunk=chunk,
                        initial_state=initial_state)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a, b_mat, c_mat, chunk=chunk,
                       initial_state=initial_state)
    raise ValueError(f"ssd_scan: unsupported device {x.device}")
