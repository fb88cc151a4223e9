"""Device selection for the port's entry points.

Entry points default to ``"cuda"``. Asking for CUDA on a machine without
a card raises; nothing falls back to the CPU unless the caller asks for
it with ``device="cpu"``.
"""
from __future__ import annotations

import functools
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of CUDA device ``dev``."""
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())
