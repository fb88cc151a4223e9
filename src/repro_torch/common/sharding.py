"""Sharding helpers over a ``DeviceMesh`` (port of
``repro.common.sharding``).

Axis conventions, as in the reference:
  data  -- batch / FSDP axis (16 per pod)
  model -- tensor / expert / shard axis (16)
  pod   -- optional leading data-parallel axis across pods (2)

Each helper returns a :class:`MeshSharding`: the reference's per-tensor-dim
``spec`` (a mesh-axis name, a tuple of them, or ``None`` for each tensor
dim, element for element what the reference's ``PartitionSpec`` holds) and
the DTensor ``placements`` it means on the mesh (one ``Shard(dim)`` or
``Replicate()`` per mesh dim).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.mesh import axis_size

DATA_AXIS = "data"
MODEL_AXIS = "model"
POD_AXIS = "pod"


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    mesh: DeviceMesh
    spec: Tuple

    @property
    def placements(self) -> Tuple:
        """One placement per mesh dim: ``Shard(i)`` where tensor dim i is
        split over that mesh axis (in the spec's major-to-minor order when
        a dim spans several axes), else ``Replicate()``. A split over an
        axis of one rank is that rank's whole tensor and is given as
        ``Replicate()``: the placements of one rank's tensors then agree,
        and DTensor redistributes nothing between them."""
        dim_of = {}
        for i, entry in enumerate(self.spec):
            for ax in _axes(entry):
                if ax not in self.mesh.mesh_dim_names:
                    raise ValueError(f"mesh axes {self.mesh.mesh_dim_names} "
                                     f"have no {ax!r}")
                if ax in dim_of:
                    raise ValueError(f"mesh axis {ax!r} shards two dims")
                dim_of[ax] = i
        return tuple(Shard(dim_of[ax]) if ax in dim_of
                     and axis_size(self.mesh, ax) > 1 else Replicate()
                     for ax in self.mesh.mesh_dim_names)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over (pod+data when multi-pod)."""
    if POD_AXIS in mesh.mesh_dim_names:
        return (POD_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def fsdp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes parameters are FSDP-sharded over (same as batch axes)."""
    return batch_axes(mesh)


def ns(mesh: DeviceMesh, *spec) -> MeshSharding:
    """A sharding of ``spec``; a one-axis tuple entry is stored as that
    axis's name, as ``PartitionSpec`` stores it."""
    return MeshSharding(mesh, tuple(
        e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec))


def data_sharding(mesh: DeviceMesh, rank: int) -> MeshSharding:
    """Shard leading (batch) dim over the batch axes, replicate the rest."""
    spec = [batch_axes(mesh)] + [None] * (rank - 1)
    return ns(mesh, *spec)


def replicated(mesh: DeviceMesh) -> MeshSharding:
    return ns(mesh)


def logical_to_sharding(mesh: DeviceMesh,
                        logical: Sequence[Optional[str]]) -> MeshSharding:
    """Map logical axis names to mesh axes.

    Logical names:
      'batch'   -> (pod, data)
      'fsdp'    -> (pod, data)   (parameter shard dim)
      'model'   -> model         (tensor-parallel dim)
      'expert'  -> model         (expert-parallel dim)
      'shard'   -> model         (Pyramid sub-HNSW dim)
      None      -> replicated dim
    """
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        elif name in ("batch", "fsdp"):
            ax = batch_axes(mesh)
            out.append(ax if len(ax) > 1 else ax[0])
        elif name in ("model", "expert", "shard"):
            out.append(MODEL_AXIS)
        else:
            raise ValueError(f"unknown logical axis {name!r}")
    return ns(mesh, *out)


def logical_to_sharding_shaped(mesh: DeviceMesh,
                               logical: Sequence[Optional[str]],
                               shape: Sequence[int]) -> MeshSharding:
    """Like ``logical_to_sharding`` but shape-aware:

    * drops the sharding of any dim whose size does not divide its mesh
      axes (e.g. vocab 50280 over 16);
    * resolves the special 'moe_ff' logical axis: model axis iff the
      'expert' dim was dropped (expert count < model axis, e.g. grok 8e),
      so tensor parallelism moves from the expert dim to d_ff.
    """
    expert_dropped = False
    fixed = []
    moe_ff_dims = []
    for i, (dim, name) in enumerate(
            zip(shape, list(logical) + [None] * (len(shape) - len(logical)))):
        if name == "moe_ff":
            moe_ff_dims.append(i)
            fixed.append(None)
            continue
        if name is None:
            fixed.append(None)
            continue
        single = logical_to_sharding(mesh, (name,)).spec[0]
        n = 1
        for a in _axes(single):
            n *= axis_size(mesh, a)
        if dim % n == 0:
            fixed.append(single)
        else:
            fixed.append(None)
            if name == "expert":
                expert_dropped = True
    for i in moe_ff_dims:
        if expert_dropped and shape[i] % axis_size(mesh, MODEL_AXIS) == 0:
            fixed[i] = MODEL_AXIS
    return ns(mesh, *fixed)


def count_devices(mesh: DeviceMesh) -> int:
    return mesh.size()


def batch_split(mesh: DeviceMesh, batch: int):
    """The spec entry of a batch dim of ``batch`` rows: the batch axes
    where they divide it, else None (also on a mesh without them, such as
    a model axis's own)."""
    bax = batch_axes(mesh)
    if not set(bax) <= set(mesh.mesh_dim_names):
        return None
    n = 1
    for ax in bax:
        n *= axis_size(mesh, ax)
    if batch % n:
        return None
    return bax if len(bax) > 1 else bax[0]


def shard_local(t: torch.Tensor, mesh: DeviceMesh,
                placements: Sequence) -> DTensor:
    """``t``, a whole tensor that every rank holds alike, as a DTensor of
    ``placements`` on ``mesh``: each rank keeps a copy of its own chunk
    (DTensor's split, uneven where a dim does not divide) and sends
    nothing."""
    local = distribute_tensor(t, mesh, placements,
                              src_data_rank=None).to_local()
    if local.numel() < t.numel() and local.untyped_storage().data_ptr() \
            == t.untyped_storage().data_ptr():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, shape=t.shape,
                              stride=t.stride())


# how deep this process is in plain_tensors_replicated (DTensor's own
# flag is process-wide too)
_replicated_depth = [0]


@contextlib.contextmanager
def plain_tensors_replicated():
    """DTensor's ``implicit_replication`` (a plain tensor in an op with
    DTensors counts as replicated), safe to nest: the outermost entry
    turns it on and its exit off."""
    outer = _replicated_depth[0] == 0
    with implicit_replication() if outer else contextlib.nullcontext():
        _replicated_depth[0] += 1
        try:
            yield
        finally:
            _replicated_depth[0] -= 1
