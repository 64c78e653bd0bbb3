"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

Zamba2 runs a Mamba-2 backbone with ONE shared attention+MLP block invoked
every 6 layers (weights shared across invocations, input is
concat(hidden, original_embedding) → 2*d_model). long_500k is supported:
the SSM backbone is O(1)-state; the periodic shared attention block uses a
4096-token sliding window at that shape (config ``sliding_window``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        block_type="mamba2",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_head=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        attn_every=6,
        sliding_window=4096,
        rope_theta=1.0e4,
        tie_embeddings=True,
        attn_tp=True,   # 32 heads / 16-way model axis = 2
        kv_tp=True,
        supports_long_context=True,  # hybrid / state-space backbone
    )
)
