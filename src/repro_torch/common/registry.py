"""Architecture registry (port of ``repro.common.registry``).

``repro_torch/configs/<arch>.py`` modules register themselves when they
are imported; the registry imports the configs package on the first
lookup, so ``get_arch("qwen3-1.7b")`` works from anywhere.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.config import ArchConfig

_REGISTRY: Dict[str, ArchConfig] = {}
_LOADED = False


def register_arch(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch registration: {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    global _LOADED
    if not _LOADED:
        importlib.import_module("repro_torch.configs")
        _LOADED = True


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
