"""Asymmetric int8 distance, plain versions (port of
``repro.kernels.quant_distance.ref``).

The query stays float32 and the database row is an int8 code vector on a
per-dimension affine grid: every implementation computes exactly
``similarity(q, codes * scale + zero)`` with the metric formulas of
``repro_torch.core.metrics``, including the angular ``+1e-12``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import metrics as M


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor) -> torch.Tensor:
    """[*, d] int8 codes -> [*, d] float32 rows (``c * scale + zero``)."""
    return codes.to(torch.float32) * scale + zero


def quant_scores_ref(q: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor, *,
                     metric: str) -> torch.Tensor:
    """q [B, d] f32 against codes [n, d] int8 -> [B, n] f32."""
    return M.similarity_matrix(q, dequantize(codes, scale, zero), metric)


def quant_scores_np(q: np.ndarray, codes: np.ndarray, scale: np.ndarray,
                    zero: np.ndarray, *, metric: str) -> np.ndarray:
    """Numpy twin of :func:`quant_scores_ref`."""
    x_hat = (np.asarray(codes, np.float32) * np.asarray(scale, np.float32)
             + np.asarray(zero, np.float32))
    return M.similarity_matrix_np(np.asarray(q, np.float32), x_hat, metric)
