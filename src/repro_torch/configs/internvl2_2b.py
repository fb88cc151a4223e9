"""internvl2-2b — VLM: InternViT frontend (stub) + InternLM2-1.8b decoder.

[arXiv:2404.16821] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The vision encoder and projector are a stub: the model takes precomputed
patch embeddings [B, S, frontend_dim], applies a learned projection and
runs the language decoder.
"""
from repro_torch.common.config import ArchConfig
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    frontend_dim=1024,   # InternViT-300M patch embedding width
    source="[arXiv:2404.16821]",
))
