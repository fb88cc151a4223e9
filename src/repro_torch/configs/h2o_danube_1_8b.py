"""h2o-danube-1.8b — dense llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
Danube uses Mistral-style SWA (window 4096 during training).
"""
from repro_torch.common.config import ArchConfig, AttentionKind
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attention_kind=AttentionKind.SLIDING,
    sliding_window=4096,
    source="[arXiv:2401.16818]",
))
