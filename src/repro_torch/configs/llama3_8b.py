"""llama3-8b [dense] — GQA, 128k vocab.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 [arXiv:2407.21783]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama3-8b",
        family="dense",
        block_type="attn_mlp",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=5.0e5,
        attn_tp=True,   # 32 / 16 = 2
        kv_tp=False,    # 8 kv heads < 16
        supports_long_context=False,
    )
)
