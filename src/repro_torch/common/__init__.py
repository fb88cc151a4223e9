from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import resolve_device

__all__ = ["PyramidConfig", "resolve_device"]
