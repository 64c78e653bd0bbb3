"""qwen2-72b [dense] — GQA, QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2407.10671; hf]

kv=8 heads are NOT divisible by the 16-way model axis → baseline replicates
KV projections over 'model' (kv_tp=False); fixing this is a §Perf hillclimb
target. Uses Adafactor (72B params × Adam fp32 would be 1TB+grad; Adafactor
is the PaLM/T5 TPU-production choice).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-72b",
        family="dense",
        block_type="attn_mlp",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_head=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1.0e6,
        attn_tp=True,    # 64 / 16 = 4
        kv_tp=False,     # 8 kv heads < 16-way model axis → replicate (baseline)
        optimizer="adafactor",
        supports_long_context=False,  # pure full attention → skip long_500k
    )
)
