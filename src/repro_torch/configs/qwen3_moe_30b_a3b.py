"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8 routing.

48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B]

128 experts shard 8-per-device over the 16-way model axis (expert
parallelism with capacity-based scatter dispatch). d_head=128 (attention dim
4096 != d_model 2048, per the HF config).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        block_type="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_head=128,
        d_ff=768,  # per-expert FFN width (moe_d_ff)
        vocab_size=151936,
        num_experts=128,
        experts_per_tok=8,
        moe_d_ff=768,
        moe_parallelism="expert",
        rope_theta=1.0e6,
        attn_tp=True,  # 32 / 16 = 2
        kv_tp=False,   # 4 kv heads < 16
        supports_long_context=False,
    )
)
