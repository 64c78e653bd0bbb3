"""Model facade: one uniform API over the ported architecture families.

The port of ``repro/models/api.py``.  ``get_model(cfg)`` returns a
``ModelAPI`` whose members are plain functions of (params, inputs).  The
``attn_mlp`` family (training, prefill and decode), the ``rwkv6`` family
and the ``mamba2`` hybrid family (training and decode; no ``prefill``, as
in the reference) are ported; every other family raises.
``layer_graph(shape)`` is the model's burst-planner graph;
``train_input_specs`` is one training batch as ``meta``-device tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch._device import DeviceLike
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import hybrid, rwkv_lm, transformer
from repro_torch.models.graph import build_lm_graph
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
    loss: Optional[Callable] = None  # (params, batch) -> (loss, metrics)

    def init(self, generator: torch.Generator, device: DeviceLike = None):
        return init_params(self.schema, generator, device)

    def layer_graph(self, shape: ShapeConfig):
        return build_lm_graph(self.cfg, shape)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.block_type in ("attn_mlp", "moe") and not cfg.num_encoder_layers:
        # the transformer itself names what is not ported yet (MoE, vision)
        return ModelAPI(
            cfg=cfg,
            schema=transformer.lm_schema(cfg),
            loss=lambda p, b: transformer.loss_fn(p, b, cfg),
            forward=lambda p, t: transformer.forward(p, t, cfg),
            prefill=lambda p, t, cap: transformer.prefill(p, t, cfg, cap),
            decode_step=lambda p, tok, cache, n: transformer.decode_step(p, tok, cache, n, cfg),
            cache_schema=lambda b, cap: transformer.cache_schema(cfg, b, cap),
        )
    if cfg.block_type == "rwkv6":
        return ModelAPI(
            cfg=cfg,
            schema=rwkv_lm.rwkv_lm_schema(cfg),
            loss=lambda p, b: rwkv_lm.loss_fn(p, b, cfg),
            forward=lambda p, t: rwkv_lm.forward(p, t, cfg),
            decode_step=lambda p, tok, cache, n: rwkv_lm.decode_step(p, tok, cache, n, cfg),
            cache_schema=lambda b, cap: rwkv_lm.cache_schema(cfg, b, cap),
        )
    if cfg.block_type == "mamba2":
        return ModelAPI(
            cfg=cfg,
            schema=hybrid.hybrid_schema(cfg),
            loss=lambda p, b: hybrid.loss_fn(p, b, cfg),
            forward=lambda p, t: hybrid.forward(p, t, cfg),
            decode_step=lambda p, tok, cache, n: hybrid.decode_step(p, tok, cache, n, cfg),
            cache_schema=lambda b, cap: hybrid.cache_schema(cfg, b, cap),
        )
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.block_type!r} is not ported yet "
        "(ROADMAP Queue 1, item 10); the port runs attn_mlp, rwkv6 and mamba2 models")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One ``loss``-mode batch of a decoder-only model as ``meta`` tensors
    (shapes and dtypes, no storage): the counterpart of the reference's
    ``train_input_specs``, in the port's batch dtype (int64, as
    ``data.pipeline`` makes them).  Encoder-decoder and vision batches are
    not ported yet (ROADMAP Queue 1, item 10)."""
    if cfg.num_encoder_layers or cfg.frontend == "vision":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision batches are not ported yet "
            "(ROADMAP Queue 1, item 10)")
    B, S = shape.global_batch, shape.seq_len
    spec = lambda: torch.empty((B, S), dtype=torch.long, device="meta")  # noqa: E731
    return {"tokens": spec(), "labels": spec()}
