"""Lloyd's k-means and spherical k-means (Alg. 3 line 4 / Alg. 5 line 5).

Port of ``repro.core.kmeans.kmeans``. Assignment goes through the top-k
scan with k = 1 (``repro_torch.kernels.topk_distance``, the CUDA kernel
on the card), as the reference's ``_assign`` does. The reference seeds
with ``jax.random``, which torch cannot reproduce: the port takes
``init_centers=`` or draws distinct rows with a ``torch.Generator``
seeded from ``seed``. From the same initial centres the iterations are
the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels.topk_distance import topk_similarity


def _init_centers(x: torch.Tensor, m: int, seed: int) -> torch.Tensor:
    """m distinct random rows (all rows, topped up with replacement, when
    m > n), drawn on the CPU so the choice does not depend on the device."""
    n = x.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    idx = torch.randperm(n, generator=gen)
    if m > n:
        idx = torch.cat([idx, torch.randint(n, (m - n,), generator=gen)])
    return x[idx[:m].to(x.device)]


def _assign(x: torch.Tensor, centers: torch.Tensor,
            metric: str) -> torch.Tensor:
    """Nearest center per row ([n] int64), ties to the lowest center."""
    _, ids = topk_similarity(x, centers, k=1, metric=metric)
    return ids[:, 0].long()


def _update(x: torch.Tensor, assign: torch.Tensor, m: int):
    one_hot = torch.nn.functional.one_hot(assign, m).to(x.dtype)  # [n, m]
    return one_hot.T @ x, one_hot.sum(dim=0)


def _finish_update(centers, sums, counts, spherical: bool):
    new = sums / torch.clamp(counts[:, None], min=1.0)
    new = torch.where(counts[:, None] > 0, new, centers)  # keep empty centers
    if spherical:
        new = new / (torch.linalg.vector_norm(new, dim=-1, keepdim=True)
                     + 1e-12)
    return new


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def kmeans(x: np.ndarray, m: int, *, iters: int = 12,
           spherical: bool = False, seed: int = 0,
           init_centers: Optional[np.ndarray] = None,
           device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Returns (centers [m, d] f32, counts [m] -- the cluster sizes of the
    last assignment), as numpy arrays.

    ``init_centers`` ([m, d]) fixes the initial centres; otherwise m
    distinct rows are drawn from ``seed``.
    """
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    if spherical:
        xt = _normalize(xt)
    if init_centers is None:
        centers = _init_centers(xt, m, seed)
    else:
        centers = torch.as_tensor(np.asarray(init_centers, np.float32)
                                  ).to(dev)
    if spherical:
        centers = _normalize(centers)
    metric = "ip" if spherical else "l2"
    counts = torch.zeros(m, dtype=xt.dtype, device=dev)
    for _ in range(iters):
        a = _assign(xt, centers, metric)
        sums, counts = _update(xt, a, m)
        centers = _finish_update(centers, sums, counts, spherical)
    return centers.cpu().numpy(), counts.cpu().numpy()
