"""Architecture configs of the port. Importing this package registers
them with ``repro_torch.common.registry``. Only the dense full-attention
``qwen3-1.7b`` is ported so far; the other families come with their
blocks (ROADMAP.md, section 1)."""
from repro_torch.configs import qwen3_1_7b  # noqa: F401
