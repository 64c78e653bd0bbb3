"""minicpm-2b [dense] — WSD schedule, llama-like arch.

40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753 [arXiv:2404.06395; hf]

36 heads are not divisible by the 16-way model axis → attention weights are
replicated over 'model' at baseline (attn_tp=False); the MLP is TP-sharded
(5760 % 16 == 0). vocab 122753 is padded to 122880 (multiple of 256).
Trains with the paper's WSD (warmup-stable-decay) schedule.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minicpm-2b",
        family="dense",
        block_type="attn_mlp",
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        d_head=64,
        d_ff=5760,
        vocab_size=122753,
        rope_theta=1.0e4,
        tie_embeddings=True,
        attn_tp=False,  # 36 % 16 != 0
        kv_tp=False,
        supports_long_context=False,
    )
)
