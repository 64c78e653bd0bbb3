"""Model facade: one uniform API over the ported architecture families.

The port of ``repro/models/api.py``.  ``get_model(cfg)`` returns a
``ModelAPI`` whose members are plain functions of (params, inputs), for
every family of the reference: ``attn_mlp`` and ``moe`` (with pixtral's
vision prefix: ``forward`` and ``prefill`` take ``patch_embeds=``) train,
prefill and decode; the encoder-decoder family (``forward(params, frames,
tokens)``), ``rwkv6`` and the ``mamba2`` hybrid train and decode, with no
``prefill``, as in the reference.  ``init(generator, device, dtype)`` draws
the parameters (straight into a serving dtype when ``dtype`` is given).
``abstract()`` and ``axes()`` are the parameters as ``meta``-device tensors
and their logical axes; ``layer_graph(shape)`` is the model's
burst-planner graph; ``train_input_specs``, ``decode_input_specs`` and
``input_specs`` are a step's inputs as ``meta``-device tensors (what the
sharding rules place); ``make_batch`` a random batch.  VGG-16 has no ``ModelAPI`` in either
package: it is ``models/vgg.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch._device import DeviceLike, as_dtype
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, rwkv_lm, transformer
from repro_torch.models.graph import build_lm_graph
from repro_torch.models.layers import abstract_params, init_params, logical_axes


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    schema: Any
    forward: Callable  # (params, *inputs) -> logits
    decode_step: Callable  # (params, token, cache, cache_len) -> (logits, cache)
    #   cache_len: scalar, or (B,) per-lane lengths
    cache_schema: Callable  # (batch, capacity) -> schema
    prefill: Optional[Callable] = None
    loss: Optional[Callable] = None  # (params, batch) -> (loss, metrics)

    def init(self, generator: torch.Generator, device: DeviceLike = None,
             dtype: Optional[str] = None):
        return init_params(self.schema, generator, device, dtype)

    def abstract(self):
        return abstract_params(self.schema)

    def axes(self):
        return logical_axes(self.schema)

    def layer_graph(self, shape: ShapeConfig):
        return build_lm_graph(self.cfg, shape)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.block_type in ("attn_mlp", "moe") and not cfg.num_encoder_layers:
        return ModelAPI(
            cfg=cfg,
            schema=transformer.lm_schema(cfg),
            loss=lambda p, b: transformer.loss_fn(p, b, cfg),
            forward=lambda p, t, **kw: transformer.forward(p, t, cfg, **kw),
            prefill=lambda p, t, cap, **kw: transformer.prefill(p, t, cfg, cap, **kw),
            decode_step=lambda p, tok, cache, n: transformer.decode_step(p, tok, cache, n, cfg),
            cache_schema=lambda b, cap: transformer.cache_schema(cfg, b, cap),
        )
    if cfg.num_encoder_layers:
        return ModelAPI(
            cfg=cfg,
            schema=encdec.encdec_schema(cfg),
            loss=lambda p, b: encdec.loss_fn(p, b, cfg),
            forward=lambda p, frames, tokens: encdec.forward(p, frames, tokens, cfg),
            decode_step=lambda p, tok, cache, n: encdec.decode_step(p, tok, cache, n, cfg),
            cache_schema=lambda b, cap: encdec.cache_schema(cfg, b, cap),
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
    raise ValueError(f"no model for {cfg.name} ({cfg.block_type})")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One ``loss``-mode batch as ``meta`` tensors (shapes and dtypes, no
    storage): the counterpart of the reference's ``train_input_specs``, with
    token and label ids in the port's batch dtype (int64, as
    ``data.pipeline`` makes them) and frames and patches in ``cfg.dtype``.
    An encoder-decoder batch has ``max(S // DEC_RATIO, 16)`` decoder tokens;
    a vision batch ``min(VISION_PREFIX, S // 4)`` patch positions and the
    rest text."""
    B, S = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.long):
        return torch.empty(dims, dtype=dtype, device="meta")

    if cfg.num_encoder_layers:  # enc-dec: frames in, tokens out
        S_dec = max(S // encdec.DEC_RATIO, 16)
        return {"frames": spec(B, S, cfg.d_model, dtype=as_dtype(cfg.dtype)),
                "tokens": spec(B, S_dec), "labels": spec(B, S_dec)}
    if cfg.frontend == "vision":
        S_img = min(transformer.VISION_PREFIX, S // 4)
        S_txt = S - S_img
        return {"tokens": spec(B, S_txt), "labels": spec(B, S_txt),
                "patch_embeds": spec(B, S_img, cfg.d_model, dtype=as_dtype(cfg.dtype))}
    return {"tokens": spec(B, S), "labels": spec(B, S)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One ``decode_step`` call with a full cache, as ``meta`` tensors."""
    B, cap = shape.global_batch, shape.seq_len
    return {
        "token": torch.empty((B, 1), dtype=torch.long, device="meta"),
        "cache": abstract_params(get_model(cfg).cache_schema(B, cap)),
        "cache_len": torch.empty((), dtype=torch.long, device="meta"),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The inputs of the step ``shape.kind`` names: a decode call, a
    prefill (the training batch without labels: the full-sequence forward)
    or a training batch."""
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    if shape.kind == "prefill":
        spec = train_input_specs(cfg, shape)
        spec.pop("labels", None)
        return spec
    return train_input_specs(cfg, shape)


def make_batch(cfg: ModelConfig, batch: int, seq: int, generator: torch.Generator,
               device: DeviceLike = None) -> dict:
    """Concrete random batch at smoke scale from ``generator`` (which lives
    on ``device``): uniform token ids and independent uniform labels,
    int64; standard-normal frames or patches drawn in fp32, then cast to
    ``cfg.dtype``.  The reference draws the same distributions from a JAX
    key, with its own length rules, which differ from
    ``train_input_specs``': ``max(seq // DEC_RATIO, 8)`` decoder tokens,
    ``max(seq // 4, 4)`` patch positions."""
    def ids(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=generator,
                             device=device)

    def normal(n):
        return torch.randn((batch, n, cfg.d_model), generator=generator, device=device,
                           dtype=torch.float32).to(as_dtype(cfg.dtype))

    if cfg.num_encoder_layers:
        S_dec = max(seq // encdec.DEC_RATIO, 8)
        return {"frames": normal(seq), "tokens": ids(S_dec), "labels": ids(S_dec)}
    if cfg.frontend == "vision":
        S_img = max(seq // 4, 4)
        S_txt = seq - S_img
        return {"tokens": ids(S_txt), "labels": ids(S_txt), "patch_embeds": normal(S_img)}
    return {"tokens": ids(seq), "labels": ids(seq)}
