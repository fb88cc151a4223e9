"""mamba2-780m — attention-free SSM with state-space duality.

[arXiv:2405.21060] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280,
ssm_state=128.
"""
from repro_torch.common.config import ArchConfig, BlockKind, RoPEKind, SSMConfig
from repro_torch.common.registry import register_arch

CONFIG = register_arch(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=(BlockKind.MAMBA2,),
    rope=RoPEKind.NONE,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
    source="[arXiv:2405.21060]",
))
