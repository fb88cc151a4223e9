"""Architecture configs of the port. Importing this package registers
them with ``repro_torch.common.registry``. Ported so far: the dense
full-attention ``qwen3-1.7b`` and ``chatglm3-6b`` (2-D rope), the
sliding-window ``h2o-danube-1.8b`` and the local-global ``gemma3-12b``,
and the attention-free ``mamba2-780m``; the other families come with
their blocks (ROADMAP.md, section 1)."""
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b,
    gemma3_12b,
    h2o_danube_1_8b,
    mamba2_780m,
    qwen3_1_7b,
)
