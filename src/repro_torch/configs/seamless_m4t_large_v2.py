"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]

Modeled as a 24L encoder + 24L decoder transformer backbone; the speech
frontend is a STUB per the assignment (``input_specs()`` provides precomputed
frame embeddings, frontend='audio'). It is enc-dec (NOT encoder-only), so
decode shapes apply: decode lowers the decoder step with cached encoder
output + decoder KV cache. vocab 256206 padded to 256256.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        block_type="attn_mlp",
        num_layers=24,
        num_encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_head=64,
        d_ff=8192,
        vocab_size=256206,
        rope_theta=1.0e4,
        attn_tp=True,  # 16 / 16 = 1
        kv_tp=True,
        frontend="audio",
        supports_long_context=False,
    )
)
