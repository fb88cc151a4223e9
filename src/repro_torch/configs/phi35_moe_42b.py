"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.

[hf:microsoft/Phi-3.5-MoE-instruct] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.common.config import ArchConfig, MoEConfig
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, experts_per_token=2),
    source="[hf:microsoft/Phi-3.5-MoE-instruct]",
))
