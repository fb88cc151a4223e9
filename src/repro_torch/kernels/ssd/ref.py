"""Plain PyTorch version of the SSD chunk-scan kernel: re-exports the
model's chunked implementation (port of ``repro.kernels.ssd.ref``)."""
from __future__ import annotations

from typing import Optional

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int,
            initial_state: Optional[torch.Tensor] = None):
    """x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N] ->
    (y [B,S,H,P], final_state [B,H,N,P])."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk,
                       initial_state=initial_state)


def ssd_backward_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b_mat: torch.Tensor, c_mat: torch.Tensor,
                     dy: torch.Tensor, *, chunk: int,
                     initial_state: Optional[torch.Tensor] = None,
                     d_final: Optional[torch.Tensor] = None):
    """Plain version of the SSD scan's backward: ``torch.autograd.grad``
    through ``ssd_chunked`` for the cotangents dy of y and d_final of the
    final state (None: zero). Returns (dx, ddt, da, db, dc,
    d_initial_state), each in its input's dtype (d_initial_state that of
    the final state; with no initial state, the gradient with respect to
    a zero one). Float64 inputs give float64 gradients."""
    from repro_torch.models.ssm import ssd_chunked
    bsz, _, h, p = x.shape
    n = b_mat.shape[-1]
    if initial_state is None:
        initial_state = torch.zeros(
            (bsz, h, n, p), device=x.device,
            dtype=torch.promote_types(x.dtype, torch.float32))
    ins = [t.detach().requires_grad_(True)
           for t in (x, dt, a, b_mat, c_mat, initial_state)]
    with torch.enable_grad():
        y, final = ssd_chunked(*ins[:5], chunk=chunk, initial_state=ins[5])
        outs, cots = [y], [dy.to(y.dtype)]
        if d_final is not None:
            outs.append(final)
            cots.append(d_final.to(final.dtype))
        return tuple(torch.autograd.grad(outs, ins, cots))
