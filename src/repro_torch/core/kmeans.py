"""Lloyd's k-means and spherical k-means (Alg. 3 line 4 / Alg. 5 line 5).

Port of ``repro.core.kmeans.kmeans``. Assignment goes through the top-k
scan with k = 1 (``repro_torch.kernels.topk_distance``, the CUDA kernel
on the card), as the reference's ``_assign`` does. Seeding is the
reference's choice of ``init="uniform"`` (distinct random rows) or
``init="kmeans++"`` (D² sampling). The reference draws with
``jax.random``, which torch cannot reproduce: the port draws with a CPU
``torch.Generator`` seeded from ``seed``, and ``init_centers=`` fixes the
starting centres outright. From the same initial centres the iterations
are the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels.topk_distance import topk_similarity


INITS = ("uniform", "kmeans++")


def _init_centers(x: torch.Tensor, m: int, seed: int, *,
                  method: str = "uniform") -> torch.Tensor:
    """Initial centres, drawn with a CPU generator so that the choice does
    not depend on the device. ``"uniform"``: m distinct random rows (all
    rows, topped up with replacement, when m > n). ``"kmeans++"``: D²
    seeding (:func:`_kmeanspp_init`)."""
    n = x.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    if method == "kmeans++":
        return _kmeanspp_init(x, m, gen)
    idx = torch.randperm(n, generator=gen)
    if m > n:
        idx = torch.cat([idx, torch.randint(n, (m - n,), generator=gen)])
    return x[idx[:m].to(x.device)]


def _kmeanspp_init(x: torch.Tensor, m: int,
                   gen: torch.Generator) -> torch.Tensor:
    """k-means++ (Arthur and Vassilvitskii 2007): each next centre is a row
    drawn with probability proportional to its squared distance from the
    nearest centre so far (uniform when every distance is 0).

    The distances and their running sum are float64 on ``x``'s device, and
    each draw is a float64 uniform from the CPU generator placed on that
    sum: a float32 sum taken in another order on the card and on the CPU
    would move the bucket edges by far more than float64 does, and could
    pick another row at a near tie."""
    n = x.shape[0]
    x64 = x.to(torch.float64)
    first = int(torch.randint(n, (), generator=gen))
    idx = [first]
    d2 = ((x64 - x64[first]) ** 2).sum(dim=1)
    for _ in range(1, m):
        u = torch.rand((), generator=gen, dtype=torch.float64)
        cum = torch.cumsum(d2, dim=0)
        total = float(cum[-1])
        if total > 0:
            target = torch.full((1,), float(u) * total, dtype=torch.float64,
                                device=x.device)
            i = min(int(torch.searchsorted(cum, target, right=True)), n - 1)
        else:
            i = min(int(float(u) * n), n - 1)
        idx.append(i)
        d2 = torch.minimum(d2, ((x64 - x64[i]) ** 2).sum(dim=1))
    return x[torch.as_tensor(idx, device=x.device)]


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
           init: str = "uniform",
           init_centers: Optional[np.ndarray] = None,
           device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Returns (centers [m, d] f32, counts [m] -- the cluster sizes of the
    last assignment), as numpy arrays.

    ``init`` selects the seeding from ``seed``: ``"uniform"`` (distinct
    random rows) or ``"kmeans++"`` (D² sampling); ``init_centers`` ([m,
    d]) overrides it with fixed initial centres.
    """
    if init not in INITS:
        raise ValueError(f"unknown init method {init!r}; one of {INITS}")
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    if spherical:
        xt = _normalize(xt)
    if init_centers is None:
        centers = _init_centers(xt, m, seed, method=init)
    else:
        centers = torch.as_tensor(np.array(init_centers, np.float32)
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
