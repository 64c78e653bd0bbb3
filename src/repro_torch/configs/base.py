"""Configuration system of the PyTorch port: a pure-data copy of
``repro/configs/base.py``, field for field, so every registered name
resolves to the same ``ModelConfig`` in both packages.

Every architecture is a frozen ``ModelConfig``; every benchmark input shape is
a frozen ``ShapeConfig``.  Configs are pure data — they never touch device
state — so importing this package is always safe.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional

VOCAB_PAD_MULTIPLE = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark input shape (assigned per-arch in the task spec)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four LM shapes shared by all 10 assigned architectures.
TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``block_type`` selects the per-layer block implementation:
      - 'attn_mlp'  : pre-norm GQA attention + (GLU) MLP            (dense LMs)
      - 'moe'       : pre-norm GQA attention + top-k MoE FFN        (grok, qwen3)
      - 'mamba2'    : Mamba-2 SSD block (used by zamba2 backbone)
      - 'rwkv6'     : RWKV-6 time-mix + channel-mix

    ``family`` is informational (matches the assignment table).
    """

    name: str
    family: str  # dense|moe|hybrid|ssm|encdec|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    block_type: str = "attn_mlp"

    # encoder-decoder (seamless-m4t)
    num_encoder_layers: int = 0

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    sliding_window: int = 0  # 0 == full causal; >0 == sliding-window attention
    attn_logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_parallelism: str = "expert"  # 'expert' (EP all-to-all) | 'tensor' (TP d_ff)

    # SSM (Mamba-2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: shared attention block applied every k layers

    # embeddings / head
    tie_embeddings: bool = False
    norm_eps: float = 1.0e-5

    # parallelism hints (consumed by dist.sharding)
    attn_tp: bool = True       # False when num_heads is not divisible by model axis
    kv_tp: bool = True         # False when num_kv_heads is not divisible by model axis
    sequence_parallel: bool = False  # SP for norms/residual (hillclimb lever)

    # numerics / optimizer
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"   # 'adafactor' for the largest models
    remat_policy: str = "full"  # 'full'|'dots'|'none'

    # modality frontend stub ([vlm]/[audio] per assignment: backbone only)
    frontend: str = "none"  # 'none'|'vision'|'audio'

    # which benchmark shapes this arch supports (long_500k only for sub-quadratic)
    supports_long_context: bool = False

    # ----- derived -----
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.d_head

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def n_params(self) -> int:
        """Analytical parameter count (used by roofline MODEL_FLOPS and memory
        sanity checks; exact to within norm/bias epsilon)."""
        p = 0
        V, D = self.padded_vocab, self.d_model
        p += V * D  # token embedding
        if not self.tie_embeddings:
            p += V * D  # lm head
        layers = []
        if self.block_type in ("attn_mlp", "moe"):
            layers += [("decoder", self.num_layers)]
        elif self.block_type == "mamba2":
            layers += [("mamba", self.num_layers)]
        elif self.block_type == "rwkv6":
            layers += [("rwkv", self.num_layers)]
        if self.num_encoder_layers:
            layers += [("encoder", self.num_encoder_layers)]
        for kind, n in layers:
            per = 0
            if kind in ("decoder", "encoder"):
                per += D * self.attn_dim + 2 * D * self.kv_dim + self.attn_dim * D
                if kind == "decoder" and self.num_encoder_layers:
                    per += D * self.attn_dim + 2 * D * self.kv_dim + self.attn_dim * D  # cross-attn
                if self.is_moe:
                    per += self.num_experts * 3 * D * self.moe_d_ff
                    per += D * self.num_experts  # router
                else:
                    per += 3 * D * self.d_ff  # GLU (gate, up, down)
                per += 2 * D  # norms
            elif kind == "mamba":
                din, S, H = self.ssm_d_inner, self.ssm_state, self.ssm_heads
                per += D * 2 * din          # in_proj (x, z)
                per += din * (2 * S)        # B, C projections
                per += din * H // self.ssm_heads * H if False else din  # dt proj (per-head)
                per += self.ssm_conv * din  # depthwise conv
                per += din * D              # out proj
                per += 2 * D + H            # norms + A_log
            elif kind == "rwkv":
                per += 4 * D * D            # r,k,v,g (time mix)
                per += 2 * 64 * D           # data-dependent decay LoRA (rank 64)
                per += D * D                # output proj
                per += 2 * D * self.d_ff    # channel mix (k, v)
                per += D * D                # channel mix receptance
                per += 2 * D
            p += per * n
        if self.attn_every and self.block_type == "mamba2":
            # zamba2: ONE shared attention+MLP block (weights shared across uses)
            D2 = 2 * D  # zamba2 shared block consumes concat(hidden, residual)
            p += D2 * self.attn_dim + 2 * D2 * self.kv_dim + self.attn_dim * D
            p += 3 * D * self.d_ff
        return p

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (1 device)."""

        def shrink(v, lo, factor):
            return max(lo, v // factor)

        kw: dict = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            num_encoder_layers=min(self.num_encoder_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(max(1, self.num_kv_heads * 4 // max(1, self.num_heads)), 4),
            d_head=32,
            d_ff=256,
            vocab_size=512,
            rope_theta=self.rope_theta,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )
        if self.is_moe:
            kw.update(num_experts=4, experts_per_tok=min(2, self.experts_per_tok), moe_d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_conv=self.ssm_conv)
        if self.attn_every:
            kw.update(attn_every=2)
        return replace(self, **kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import registers everything
        from repro_torch import configs as _c  # noqa: F401

        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)


def shapes_for(cfg: ModelConfig) -> list:
    """The assigned shape cells for this arch (skips noted in DESIGN.md)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return out
