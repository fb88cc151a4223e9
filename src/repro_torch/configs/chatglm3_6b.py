"""chatglm3-6b — dense GQA (kv=2) with GLM 2d RoPE.

[arXiv:2406.12793] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
2d RoPE: rotary applied to the first half of each head dim.
"""
from repro_torch.common.config import ArchConfig, RoPEKind
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope=RoPEKind.TWO_D,
    source="[arXiv:2406.12793]",
))
