"""pixtral-12b [vlm] — pixtral-ViT frontend + mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409]

Per the assignment spec, the vision frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings (frontend='vision'); only the
transformer backbone is modeled. d_head=128 (mistral-nemo style: attention
dim 4096 != d_model 5120).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="pixtral-12b",
        family="vlm",
        block_type="attn_mlp",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1.0e6,
        attn_tp=True,
        kv_tp=False,
        frontend="vision",
        supports_long_context=False,
    )
)
