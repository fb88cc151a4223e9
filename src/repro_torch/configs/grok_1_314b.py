"""grok-1-314b — 8-expert top-2 MoE.

[hf:xai-org/grok-1] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2.
"""
from repro_torch.common.config import ArchConfig, MoEConfig
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    moe=MoEConfig(num_experts=8, experts_per_token=2),
    source="[hf:xai-org/grok-1]",
))
