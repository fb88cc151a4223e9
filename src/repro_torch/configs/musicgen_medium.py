"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L d_model=1536 24H (GQA kv=24, i.e. MHA) d_ff=6144
vocab=2048. The EnCodec conv codec frontend is a stub: the model takes
precomputed frame embeddings [B, S, frontend_dim].
"""
from repro_torch.common.config import ArchConfig
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
    frontend_dim=128,    # EnCodec latent width
    source="[arXiv:2306.05284]",
))
