"""Lloyd's k-means and spherical k-means (Alg. 3 line 4 / Alg. 5 line 5).

Port of ``repro.core.kmeans``. Two execution paths:
  * ``kmeans`` -- one process on one device;
  * ``kmeans_distributed`` -- every rank of a mesh's ``data`` axis holds
    its own rows (as a worker reads them, ``repro_torch.data.vectors``),
    assigns them and adds its per-centre sums and counts into the others'
    with ``all_reduce`` -- the paper's "workers conduct distributed kmeans
    together" (Sec. III-A).

Assignment goes through the top-k
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
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.kernels.topk_distance import topk_similarity
from repro_torch.launch.mesh import mesh_device


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
    xt = _rows(x, resolve_device(device), spherical)
    centers = _start(xt, m, seed, init, init_centers, spherical)
    metric = "ip" if spherical else "l2"
    counts = torch.zeros(m, dtype=xt.dtype, device=xt.device)
    for _ in range(iters):
        a = _assign(xt, centers, metric)
        sums, counts = _update(xt, a, m)
        centers = _finish_update(centers, sums, counts, spherical)
    return centers.cpu().numpy(), counts.cpu().numpy()


def _rows(x, dev: torch.device, spherical: bool) -> torch.Tensor:
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    return _normalize(xt) if spherical else xt


def _start(xt: torch.Tensor, m: int, seed: int, init: str,
           init_centers: Optional[np.ndarray],
           spherical: bool) -> torch.Tensor:
    """The initial centres on ``xt``'s device: drawn from ``xt`` with
    ``seed``, or ``init_centers``; unit norm when spherical."""
    if init_centers is None:
        centers = _init_centers(xt, m, seed, method=init)
    else:
        centers = torch.as_tensor(np.array(init_centers, np.float32)
                                  ).to(xt.device)
    return _normalize(centers) if spherical else centers


def _gather_scalars(v, dtype, group, dev) -> list:
    """Every rank's number ``v`` of ``group``, in rank order."""
    t = torch.tensor([v], dtype=dtype, device=dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return [p.item() for p in parts]


def _owned_rows(xt: torch.Tensor, idx: torch.Tensor, lo: int,
                group) -> torch.Tensor:
    """The rows at global indices ``idx`` of the ranks' rows in rank order,
    on every rank: each row is filled in by the rank that holds it (rows
    ``lo`` to ``lo + n_r`` here) and summed over ``group`` with zeros
    from the others, so only len(idx) rows cross ranks."""
    out = torch.zeros((len(idx), xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    local = idx - lo
    mine = torch.nonzero((local >= 0) & (local < xt.shape[0])).squeeze(1)
    out[mine.to(xt.device)] = xt[local[mine].to(xt.device)]
    dist.all_reduce(out, group=group)
    return out


def _init_centers_distributed(xt: torch.Tensor, m: int, seed: int,
                              method: str, group) -> torch.Tensor:
    """:func:`_init_centers` of the ranks' rows concatenated in rank order,
    equal on every rank, without gathering those rows: every rank draws
    the same global choices from the CPU generator, and only the chosen
    rows (and, for k-means++, one D² total per rank a round) cross
    ranks."""
    sizes = _gather_scalars(xt.shape[0], torch.int64, group, xt.device)
    me = dist.get_rank(group)
    lo, n = sum(sizes[:me]), sum(sizes)
    gen = torch.Generator().manual_seed(int(seed))
    if method == "kmeans++":
        return _kmeanspp_distributed(xt, m, gen, lo, n, group)
    idx = torch.randperm(n, generator=gen)
    if m > n:
        idx = torch.cat([idx, torch.randint(n, (m - n,), generator=gen)])
    return _owned_rows(xt, idx[:m], lo, group)


def _kmeanspp_distributed(xt: torch.Tensor, m: int, gen: torch.Generator,
                          lo: int, n: int, group) -> torch.Tensor:
    """:func:`_kmeanspp_init` over the ranks' rows in rank order: each rank
    keeps the float64 D² of its own rows; a draw's target on the global
    running sum falls in the block of the first rank whose running total
    passes it, and that rank's row is the next centre."""
    me = dist.get_rank(group)
    x64 = xt.to(torch.float64)
    first = int(torch.randint(n, (), generator=gen))
    rows = [_owned_rows(xt, torch.tensor([first]), lo, group)]
    d2 = ((x64 - rows[0].to(torch.float64)) ** 2).sum(dim=1)
    for _ in range(1, m):
        u = float(torch.rand((), generator=gen, dtype=torch.float64))
        cum = torch.cumsum(d2, dim=0)
        totals = _gather_scalars(float(cum[-1]) if len(cum) else 0.0,
                                 torch.float64, group, xt.device)
        total = sum(totals)
        if total > 0:
            target, before, owner = u * total, 0.0, None
            for r, t in enumerate(totals):
                if t > 0 and before + t > target:
                    owner = r
                    break
                before += t
            if owner is None:    # past every running total: the last row
                idx = torch.tensor([n - 1])
            elif owner == me:
                j = int(torch.searchsorted(
                    cum, torch.full((1,), target - before,
                                    dtype=torch.float64, device=xt.device),
                    right=True))
                idx = torch.tensor([lo + min(j, len(cum) - 1)])
            else:                # another rank's row: it fills it in
                idx = torch.tensor([-1])
        else:
            idx = torch.tensor([min(int(u * n), n - 1)])
        row = _owned_rows(xt, idx, lo, group)
        rows.append(row)
        d2 = torch.minimum(d2, ((x64 - row.to(torch.float64)) ** 2).sum(
            dim=1))
    return torch.cat(rows)


def kmeans_distributed(x_local: np.ndarray, m: int, mesh, *,
                       data_axis: str = "data", iters: int = 12,
                       spherical: bool = False, seed: int = 0,
                       init: str = "uniform",
                       init_centers: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Distributed k-means over the ranks of ``mesh``'s ``data_axis``,
    called on every one of them.

    ``x_local`` is this rank's own rows ([n_r, d]; the ranks' counts may
    differ, and may be 0). Each iteration assigns them through the top-k
    scan (the CUDA kernel on the card), then sums the per-centre sums and
    counts over the axis with ``all_reduce`` -- the arithmetic of
    :func:`kmeans` on the concatenated rows. Centres drawn from ``seed``
    are those :func:`kmeans` would draw from every rank's rows in rank
    order, and every rank starts from the same ones; only the chosen rows
    cross ranks, never the rows themselves. ``init_centers`` fixes them
    outright.

    Returns (centers [m, d] f32, counts [m]) as numpy arrays, equal on
    every rank of the axis.
    """
    if init not in INITS:
        raise ValueError(f"unknown init method {init!r}; one of {INITS}")
    group = mesh.get_group(data_axis)
    xt = _rows(x_local, mesh_device(mesh), spherical)
    if init_centers is None:
        centers = _init_centers_distributed(xt, m, seed, init, group)
        if spherical:
            centers = _normalize(centers)
    else:
        centers = _start(xt, m, seed, init, init_centers, spherical)
    metric = "ip" if spherical else "l2"
    counts = torch.zeros(m, dtype=xt.dtype, device=xt.device)
    for _ in range(iters):
        if xt.shape[0]:
            sums, counts = _update(xt, _assign(xt, centers, metric), m)
        else:   # a rank that read no rows adds nothing
            sums, counts = torch.zeros_like(centers), torch.zeros_like(counts)
        dist.all_reduce(sums, group=group)
        dist.all_reduce(counts, group=group)
        centers = _finish_update(centers, sums, counts, spherical)
    return centers.cpu().numpy(), counts.cpu().numpy()
