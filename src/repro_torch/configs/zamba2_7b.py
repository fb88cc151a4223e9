"""zamba2-7b — hybrid: Mamba2 backbone + weight-shared attention blocks.

[arXiv:2411.15242] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64. Pattern: 5 Mamba2 blocks then one shared
attention block (weight-tied across all its occurrences; zamba2's
per-invocation LoRA deltas are simplified away, as in the reference).
"""
from repro_torch.common.config import ArchConfig, BlockKind, SSMConfig
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=(BlockKind.MAMBA2,) * 5 + (BlockKind.SHARED_ATTENTION,),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
    source="[arXiv:2411.15242]",
))
