"""Model facade: one uniform API over the ported architecture families.

The port of ``repro/models/api.py``.  ``get_model(cfg)`` returns a
``ModelAPI`` whose members are plain functions of (params, inputs).  Only
the ``attn_mlp`` family is ported; every other family raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch._device import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import init_params


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    schema: Any
    forward: Callable  # (params, tokens) -> logits
    decode_step: Callable  # (params, token, cache, cache_len) -> (logits, cache)
    #   cache_len: scalar, or (B,) per-lane lengths
    cache_schema: Callable  # (batch, capacity) -> schema
    prefill: Optional[Callable] = None

    def init(self, generator: torch.Generator, device: DeviceLike = None):
        return init_params(self.schema, generator, device)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.block_type in ("attn_mlp", "moe") and not cfg.num_encoder_layers:
        # the transformer itself names what is not ported yet (MoE, vision)
        return ModelAPI(
            cfg=cfg,
            schema=transformer.lm_schema(cfg),
            forward=lambda p, t: transformer.forward(p, t, cfg),
            prefill=lambda p, t, cap: transformer.prefill(p, t, cfg, cap),
            decode_step=lambda p, tok, cache, n: transformer.decode_step(p, tok, cache, n, cfg),
            cache_schema=lambda b, cap: transformer.cache_schema(cfg, b, cap),
        )
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.block_type!r} is not ported yet "
        "(ROADMAP Queue 1, item 10); the port serves attn_mlp models")
