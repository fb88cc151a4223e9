"""Carry a reference index's state, or a reference model's parameters,
into the port.

A built Pyramid index is the state this system serves from, in the role
weights play for a model. :func:`index_from_arrays` takes it as plain
arrays and dicts -- the config fields, the meta ``HNSWGraph`` fields,
``part_of_center``, the sub-graphs' fields, and the int8 grid's manifest
dict when there is one -- and returns the port's ``PyramidIndex`` on a
device. :func:`lm_params_from_reference` does the same for the language
model's parameter tree. Neither imports anything of the reference
package: a caller extracts the arrays (for example with
``dataclasses.asdict`` on each graph, or ``jax.tree.map(np.asarray,
params)``) and passes them in; :func:`opt_state_from_reference` carries
an AdamW state's step and moments across the same way.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.common.config import ArchConfig, PyramidConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.hnsw import HNSWGraph
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.core.quant import QuantParams

GRAPH_FIELDS = ("data", "ids", "neighbors", "levels", "entry", "metric",
                "tags")


def graph_from_arrays(arrays: Mapping) -> HNSWGraph:
    """An ``HNSWGraph`` from its fields (``GRAPH_FIELDS``; ``tags``
    optional)."""
    tags = arrays.get("tags")
    return HNSWGraph(
        data=np.ascontiguousarray(arrays["data"], dtype=np.float32),
        ids=np.asarray(arrays["ids"], dtype=np.int64),
        neighbors=[np.asarray(lv, dtype=np.int32)
                   for lv in arrays["neighbors"]],
        levels=np.asarray(arrays["levels"], dtype=np.int32),
        entry=int(arrays["entry"]),
        metric=str(arrays["metric"]),
        tags=None if tags is None else np.asarray(tags, dtype=np.int64))


def index_from_arrays(config: Mapping, meta: Mapping,
                      part_of_center: np.ndarray, subs: List[Mapping], *,
                      quant: Optional[Dict] = None,
                      build_stats: Optional[dict] = None,
                      device: DeviceLike = "cuda") -> PyramidIndex:
    """The port's ``PyramidIndex`` from a reference index's arrays.

    Args:
      config: ``PyramidConfig`` fields.
      meta / subs: graph fields (see :func:`graph_from_arrays`).
      part_of_center: [m] partition label of every meta vertex.
      quant: the int8 grid as its manifest dict
        (``QuantParams.to_manifest()``), when the index has one.
      device: where the index lives (``"cuda"`` unless asked otherwise).
    """
    dev = resolve_device(device)
    cfg = PyramidConfig(**{k: v for k, v in dict(config).items()
                           if k in PyramidConfig.__dataclass_fields__})
    index = PyramidIndex(
        config=cfg, meta=graph_from_arrays(meta),
        part_of_center=np.asarray(part_of_center, dtype=np.int32),
        subs=[graph_from_arrays(g) for g in subs],
        build_stats=dict(build_stats or {}), device=dev)
    if quant is not None:
        index.attach_quant_params(QuantParams.from_manifest(quant))
    return index


LM_TOP_KEYS = ("embedding", "final_norm", "lm_head")
# the keys of each ported layer group, stacked on a leading layer axis
LM_LAYER_KEYS = {
    "attention": ("norm_attn", "norm_mlp", "w_q", "w_k", "w_v", "w_o",
                  "q_norm", "k_norm", "w_gate", "w_in", "w_out",
                  "router", "e_gate", "e_in", "e_out"),
    "mamba2": ("norm_in", "in_proj", "bc_proj", "dt_w", "dt_bias", "a_log",
               "d_skip", "conv_w", "conv_b", "ssm_norm", "out_proj"),
}


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A tensor from a numpy array, bfloat16 (``ml_dtypes``) included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_reference(params: Mapping, cfg: ArchConfig,
                             device: DeviceLike = "cuda") -> dict:
    """The port's parameters of ``cfg`` from the reference's parameter
    tree as numpy arrays: ``embedding``, ``final_norm`` and ``lm_head`` at
    the top, and each layer group's weights (``blocks/attention``,
    ``blocks/mamba2``; ``LM_LAYER_KEYS``) with their leading layer axis.
    Every array keeps its dtype (the Mamba2 ``a_log``, ``dt_bias`` and
    ``d_skip`` and the MoE ``router`` stay float32 in a bf16 model). Other groups and keys are
    not ported yet and raise."""
    from repro_torch.models.transformer import _check_ported
    dev = resolve_device(device)
    _check_ported(cfg)
    blocks = params.get("blocks", {})
    extra = set(blocks) - set(LM_LAYER_KEYS)
    if extra:
        raise NotImplementedError(f"parameter groups {sorted(extra)} are not "
                                  f"ported yet")
    unknown = set(params) - set(LM_TOP_KEYS) - {"blocks"}
    if unknown:
        raise NotImplementedError(f"parameters {sorted(unknown)} are not "
                                  f"ported yet")
    out = {key: _tensor(params[key], dev) for key in LM_TOP_KEYS
           if key in params}
    out["blocks"] = {}
    for group, layers in blocks.items():
        unknown = set(layers) - set(LM_LAYER_KEYS[group])
        if unknown:
            raise NotImplementedError(f"{group} layer parameters "
                                      f"{sorted(unknown)} are not ported yet")
        out["blocks"][group] = {key: _tensor(a, dev)
                                for key, a in layers.items()}
    return out


def opt_state_from_reference(step, mu: Mapping, nu: Mapping, cfg: ArchConfig,
                             device: DeviceLike = "cuda"):
    """The port's ``OptState`` from a reference AdamW state's step and its
    two moment trees as numpy arrays (float32, shaped like the
    parameters; see :func:`lm_params_from_reference`)."""
    from repro_torch.train.optimizer import OptState
    dev = resolve_device(device)
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        mu=lm_params_from_reference(mu, cfg, dev),
        nu=lm_params_from_reference(nu, cfg, dev))
