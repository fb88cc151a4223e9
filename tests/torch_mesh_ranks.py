"""Gloo ranks for the port's mesh tests, and what a rank checks of its own
shards. A helper module, not a test file: spawned ranks import it, so it
imports neither JAX nor ``repro``.

``run_ranks(fn, payload, tmp)`` writes ``payload`` to a file in ``tmp``,
starts ``WORLD`` processes (``torch.multiprocessing``, spawn) that meet
through a ``FileStore`` there (never a TCP port), runs ``fn(rank,
payload)`` on each with one CPU thread, and returns their results in rank
order. ``fn`` must be a module-level function of a module that a rank can
import without JAX (this one, or a test module that imports JAX only
inside its functions).
"""
import math
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

WORLD = 4
AXES = ("data", "model")


def run_ranks(fn, payload, tmp, world: int = WORLD) -> list:
    tmp = str(tmp)
    path = os.path.join(tmp, "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    mp.spawn(_entry, args=(world, os.path.join(tmp, "store"), fn, path, tmp),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, world, store, fn, payload_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        out = fn(rank, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def expected_local(shape, sharding):
    """(shape, offset) of this rank's chunk of a tensor of ``shape`` under
    ``sharding`` (a ``MeshSharding``), worked out from its spec alone: a
    dim split over axes of n ranks in all is cut into n chunks of
    ceil(size / n) (``torch.chunk``'s split, DTensor's; the last ones
    short or empty where n does not divide), the rank's chunk indexed by
    its coordinates along those axes, major to minor."""
    mesh = sharding.mesh
    local, offset = [], []
    for size, entry in zip(shape, tuple(sharding.spec) + (None,) * len(
            shape)):
        n, idx = 1, 0
        for ax in _axes(entry):
            k = mesh.shape[mesh.mesh_dim_names.index(ax)]
            idx = idx * k + mesh.get_local_rank(ax)
            n *= k
        chunk = math.ceil(size / n) if n > 1 else size
        start = min(idx * chunk, size)
        local.append(min(chunk, size - start))
        offset.append(start)
    return tuple(local), tuple(offset)


def shard_faults(tree, shardings, items) -> list:
    """Leaves of a DTensor tree (``items`` the tree module's ``items``)
    whose local tensor is not this rank's chunk of the whole value: its
    shape, from the spec (:func:`expected_local`), or its values. Every
    rank must call it (the whole values are gathered)."""
    faults = []
    specs = dict(items(shardings))
    for key, t in items(tree):
        if not isinstance(t, DTensor):
            faults.append((key, "not a DTensor"))
            continue
        shape, offset = expected_local(tuple(t.shape), specs[key])
        whole = t.full_tensor()
        local = t.to_local()
        if tuple(local.shape) != shape:
            faults.append((key, tuple(local.shape), shape))
            continue
        part = whole[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        if not torch.equal(local, part):
            faults.append((key, "values"))
    return faults


def whole(tree, items) -> dict:
    """Every leaf's whole value as numpy (gathered: every rank calls it)."""
    return {k: (t.full_tensor() if isinstance(t, DTensor) else t)
            .detach().float().numpy() for k, t in items(tree)}


def split_leaves(tree, items) -> int:
    """How many leaves of a DTensor tree a rank holds less than whole."""
    return sum(t.to_local().numel() < t.numel() for _, t in items(tree))


def np_tree(tree: dict) -> dict:
    return {k: np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def train_losses(rank, payload) -> list:
    """``payload["steps"]`` steps of ``make_train_step`` from
    ``init_sharded(seed=0)`` on a ``payload["mesh"]`` mesh over the ranks,
    on ``SyntheticLM`` batches of seed 0: the losses."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.common.registry import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_sharded, make_train_step
    mesh = init_device_mesh("cpu", payload["mesh"], mesh_dim_names=AXES)
    cfg = get_arch(payload["arch"]).reduced()
    step_fn, _ = make_train_step(mesh, cfg, AdamWConfig(**payload["opt"]))
    params, opt_state = init_sharded(mesh, cfg, seed=0)
    data = iter(SyntheticLM(cfg, batch=payload["batch"],
                            seq_len=payload["seq"], seed=0))
    losses = []
    for _ in range(payload["steps"]):
        b = next(data)
        params, opt_state, m = step_fn(params, opt_state, {
            "inputs": b.inputs, "targets": b.targets, "mask": b.mask})
        losses.append(float(m["loss"]))
    return losses
