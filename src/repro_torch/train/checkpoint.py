"""Checkpoints as ``.npz`` files (port of ``repro.train.checkpoint``).

Layout, as the reference writes it: ``params.npz`` (and ``opt_mu.npz``,
``opt_nu.npz`` with an optimizer state) keyed by ``/``-joined parameter
paths, and ``manifest.json`` with the step and metadata. Float32
checkpoints load in both packages. A bfloat16 leaf is stored as numpy
stores the reference's: raw 2-byte values of dtype ``|V2`` (numpy has no
bfloat16), read back by viewing those bytes as ``torch.bfloat16``.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike
from repro_torch.train import tree as T
from repro_torch.train.optimizer import OptState


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree: dict) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in T.items(tree)}


def tree_digest(tree: dict) -> str:
    """SHA-256 over every leaf's path, dtype, shape and bytes, in path
    order: two trees with equal digests hold the same values bit for
    bit."""
    h = hashlib.sha256()
    for key, t in T.items(tree):
        a = _to_numpy(t)
        h.update(f"{key}:{a.dtype.str}:{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, params: dict,
                    opt_state: Optional[OptState] = None, *, step: int = 0,
                    meta: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_mu.npz"), **_flatten(opt_state.mu))
        np.savez(os.path.join(path, "opt_nu.npz"), **_flatten(opt_state.nu))
    manifest = {"step": int(step), "meta": meta or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _tensor(arr: np.ndarray, like: torch.Tensor,
            device: Optional[DeviceLike]) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


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
    None)."""
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
