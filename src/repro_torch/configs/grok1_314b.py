"""grok-1-314b [moe] — 8 experts, top-2 routing.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2
[hf:xai-org/grok-1]

8 experts < 16-way model axis → tensor-parallel experts (shard d_ff=32768
16-way inside each expert) instead of expert parallelism. Grok-1 applies a
30.0 attention-logit softcap. Adafactor: 314B × Adam fp32 state would not
fit a 256-chip v5e pod (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="grok-1-314b",
        family="moe",
        block_type="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_head=128,
        d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_tok=2,
        moe_d_ff=32768,
        moe_parallelism="tensor",  # 8 experts < 16-way axis
        attn_logit_softcap=30.0,
        rope_theta=1.0e4,
        attn_tp=True,  # 48 / 16 = 3
        kv_tp=False,
        optimizer="adafactor",
        supports_long_context=False,
    )
)
