"""Architecture configs of the port. Importing this package registers
them with ``repro_torch.common.registry``: the ten of the reference, the
dense full-attention ``qwen3-1.7b`` and ``chatglm3-6b`` (2-D rope), the
sliding-window ``h2o-danube-1.8b`` and the local-global ``gemma3-12b``,
the attention-free ``mamba2-780m``, the hybrid ``zamba2-7b`` (Mamba2 with
one weight-tied attention block), the MoE ``phi3.5-moe-42b-a6.6b`` and
``grok-1-314b``, and the frontend stubs ``internvl2-2b`` (vision) and
``musicgen-medium`` (audio)."""
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b,
    gemma3_12b,
    grok_1_314b,
    h2o_danube_1_8b,
    internvl2_2b,
    mamba2_780m,
    musicgen_medium,
    phi35_moe_42b,
    qwen3_1_7b,
    zamba2_7b,
)
