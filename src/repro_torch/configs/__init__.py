"""Config registry: one module per assigned architecture + the paper's own.

``--arch <id>`` anywhere in the framework resolves through ``get_config``.
"""
from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_configs,
    register,
    shapes_for,
)

# importing each module registers its CONFIG
from repro_torch.configs import (  # noqa: F401
    grok1_314b,
    llama3_8b,
    minicpm_2b,
    pixtral_12b,
    qwen2_1p5b,
    qwen2_72b,
    qwen3_moe_30b_a3b,
    rwkv6_1p6b,
    seamless_m4t_large_v2,
    zamba2_2p7b,
)
from repro_torch.configs import vgg16  # noqa: F401  (paper's own model; CNN config)

ASSIGNED_ARCHS = (
    "zamba2-2.7b",
    "qwen2-72b",
    "minicpm-2b",
    "qwen2-1.5b",
    "llama3-8b",
    "pixtral-12b",
    "grok-1-314b",
    "qwen3-moe-30b-a3b",
    "seamless-m4t-large-v2",
    "rwkv6-1.6b",
)
