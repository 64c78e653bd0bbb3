"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 [arXiv:2404.05892]

RWKV-6 time-mix heads: d_model / 64 = 32 heads of size 64. O(1) decode state
→ supports long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        block_type="rwkv6",
        num_layers=24,
        d_model=2048,
        num_heads=32,     # wkv heads (d_model / 64)
        num_kv_heads=32,
        d_head=64,
        d_ff=7168,
        vocab_size=65536,
        attn_tp=True,  # 32 / 16 = 2
        kv_tp=True,
        supports_long_context=True,  # attention-free, O(1) state
    )
)
