from repro_torch.common.config import (ArchConfig, AttentionKind, BlockKind,
                                       MoEConfig, PyramidConfig, RoPEKind,
                                       SSMConfig)
from repro_torch.common.device import resolve_device

__all__ = ["ArchConfig", "AttentionKind", "BlockKind", "MoEConfig",
           "PyramidConfig", "RoPEKind", "SSMConfig", "resolve_device"]
