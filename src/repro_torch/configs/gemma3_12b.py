"""gemma3-12b — dense, 5:1 local(SWA):global attention pattern, 128k ctx.

[hf:google/gemma-3 family] 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144. Local layers use a 1024-token sliding window (gemma3 spec);
every 6th layer is global.
"""
from repro_torch.common.config import ArchConfig, AttentionKind
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=240,
    attention_kind=AttentionKind.LOCAL_GLOBAL,
    local_to_global_ratio=5,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    source="[hf:google/gemma-3-1b-pt]",
))
