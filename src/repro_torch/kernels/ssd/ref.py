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
