"""qwen2-1.5b [dense] — GQA, QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2407.10671; hf]

12 q heads and 2 kv heads are not divisible by the 16-way model axis →
attention replicated over 'model' at baseline; MLP TP-sharded (8960 % 16==0).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        block_type="attn_mlp",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_head=128,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1.0e6,
        tie_embeddings=True,
        attn_tp=False,  # 12 % 16 != 0
        kv_tp=False,
        supports_long_context=False,
    )
)
