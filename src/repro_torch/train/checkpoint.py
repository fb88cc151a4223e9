"""Checkpoints as ``.npz`` files (port of ``repro.train.checkpoint``).

Layout, as the reference writes it: ``params.npz`` (and ``opt_mu.npz``,
``opt_nu.npz`` with an optimizer state) keyed by ``/``-joined parameter
paths, and ``manifest.json`` with the step and metadata. Float32
checkpoints load in both packages. A bfloat16 leaf is stored as numpy
stores the reference's: raw 2-byte values of dtype ``|V2`` (numpy has no
bfloat16), read back by viewing those bytes as ``torch.bfloat16``.

A tree of DTensors (the mesh train step's) is saved as one checkpoint,
the same as world size 1's: every rank gathers it leaf by leaf (a
collective, so every rank calls ``save_checkpoint``) and rank 0 writes
each leaf as it comes. Loading into a DTensor template gives each rank
its own chunk of every leaf.
"""
from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.common import sharding as S
from repro_torch.common.device import DeviceLike
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptState


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf's whole value on the host (a DTensor's gathered: a
    collective)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _savez(path: str, tree: dict, write: bool) -> None:
    """``np.savez``'s format (an uncompressed zip of ``.npy`` members),
    one leaf in memory at a time; ``write`` False takes part in the
    gathers only."""
    leaves: Iterator = ((k, _to_numpy(v)) for k, v in T.items(tree))
    if not write:
        for _ in leaves:
            pass
        return
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in leaves:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)


def tree_digest(tree: dict) -> str:
    """SHA-256 over every leaf's path, dtype, shape and bytes, in path
    order: two trees with equal digests hold the same values bit for
    bit. A DTensor tree's digest is its whole value's (every rank takes
    part and gets it)."""
    h = hashlib.sha256()
    for key, t in T.items(tree):
        a = _to_numpy(t)
        h.update(f"{key}:{a.dtype.str}:{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, params: dict,
                    opt_state: Optional[OptState] = None, *, step: int = 0,
                    meta: Optional[dict] = None) -> None:
    """Write ``params`` (and the moments of ``opt_state``) and the
    manifest. With a process group of several ranks every rank calls it
    (DTensor leaves are gathered) and rank 0 writes; the call returns on
    every rank once the files are complete."""
    write = _rank() == 0
    if write:
        os.makedirs(path, exist_ok=True)
    _savez(os.path.join(path, "params.npz"), params, write)
    if opt_state is not None:
        _savez(os.path.join(path, "opt_mu.npz"), opt_state.mu, write)
        _savez(os.path.join(path, "opt_nu.npz"), opt_state.nu, write)
    if write:
        manifest = {"step": int(step), "meta": meta or {}}
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _tensor(arr: np.ndarray, like: torch.Tensor,
            device: Optional[DeviceLike]) -> torch.Tensor:
    """A leaf of the template ``like``'s dtype, on ``device`` (the
    template's when None); for a DTensor template, this rank's chunk of
    it in the template's placements."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    t = t.to(device=like.device if device is None else device,
             dtype=like.dtype)
    if isinstance(like, DTensor):
        return S.shard_local(t, like.device_mesh, like.placements)
    return t


def _unflatten_into(template: dict, flat: Dict[str, np.ndarray],
                    device: Optional[DeviceLike]) -> dict:
    out = {}
    for key, leaf in T.items(template):
        if key not in flat:
            raise KeyError(f"the checkpoint has no {key!r}")
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: the checkpoint holds {arr.shape}, "
                             f"the template {tuple(leaf.shape)}")
        out[key] = _tensor(arr, leaf, device)
    return T.unflatten(out)


def load_checkpoint(path: str, params_template: dict,
                    opt_state_template: Optional[OptState] = None, *,
                    device: Optional[DeviceLike] = None) -> Tuple:
    """Returns (params, opt_state | None, step): each leaf in its
    template's dtype, on ``device`` (the template leaf's device when
    None); a DTensor template leaf gives a DTensor of its placements,
    each rank holding its own chunk."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten_into(params_template, dict(z), device)
    opt_state = None
    if opt_state_template is not None and \
            os.path.exists(os.path.join(path, "opt_mu.npz")):
        with np.load(os.path.join(path, "opt_mu.npz")) as z:
            mu = _unflatten_into(opt_state_template.mu, dict(z), device)
        with np.load(os.path.join(path, "opt_nu.npz")) as z:
            nu = _unflatten_into(opt_state_template.nu, dict(z), device)
        step_dev = opt_state_template.step.device if device is None \
            else device
        opt_state = OptState(
            step=torch.tensor(manifest["step"], dtype=torch.int32,
                              device=step_dev), mu=mu, nu=nu)
    return params, opt_state, manifest["step"]
