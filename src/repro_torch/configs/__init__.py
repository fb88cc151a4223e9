"""Architecture configs of the port. Importing this package registers
them with ``repro_torch.common.registry``. Ported so far: the dense
full-attention ``qwen3-1.7b`` and the attention-free ``mamba2-780m``;
the other families come with their blocks (ROADMAP.md, section 1)."""
from repro_torch.configs import mamba2_780m, qwen3_1_7b  # noqa: F401
