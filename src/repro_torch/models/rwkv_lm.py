"""RWKV-6 LM stack (rwkv6-1.6b), in PyTorch. Attention-free; O(1) decode state.

The port of ``repro/models/rwkv_lm.py``.  Per-layer leaves are stacked on a
leading ``layers`` axis, as in the reference; its ``lax.scan`` over layers
is a Python loop.  With ``cfg.remat_policy != "none"`` each block runs
under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint``: the block's activations are recomputed in
the backward pass, WKV forward included.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (
    ParamSpec,
    rms_norm,
    softmax_xent,
    stack_schema,
    unstack,
)
from repro_torch.models.rwkv6 import rwkv6_channel_mix, rwkv6_schema, rwkv6_time_mix
from repro_torch.models.transformer import embed_tokens, layer_params, unembed


def _layer_schema(cfg) -> dict:
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), ("norm",), init="zeros"),
        "ln2": ParamSpec((D,), ("norm",), init="zeros"),
        "mix": rwkv6_schema(cfg),
    }


def rwkv_lm_schema(cfg) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamSpec((Vp, D), ("vocab", "embed"), init="embed"),
        "layers": stack_schema(_layer_schema(cfg), cfg.num_layers),
        "final_norm": ParamSpec((D,), ("norm",), init="zeros"),
        "lm_head": ParamSpec((D, Vp), ("embed", "vocab")),
    }


def _block(lp: dict, h: torch.Tensor, cfg, decode: bool = False, states=None) -> tuple:
    tm_in = rms_norm(h, lp["ln1"], cfg.norm_eps)
    if decode:
        wkv_state, tm_shift, cm_shift = states
        tm_out, wkv_new, tm_last = rwkv6_time_mix(
            lp["mix"], tm_in, cfg, state=wkv_state, decode=True, shift_state=tm_shift)
    else:
        tm_out, wkv_new, tm_last = rwkv6_time_mix(lp["mix"], tm_in, cfg)
        cm_shift = None
    h = h + tm_out
    cm_in = rms_norm(h, lp["ln2"], cfg.norm_eps)
    cm_out, cm_last = rwkv6_channel_mix(lp["mix"], cm_in, shift_state=cm_shift)
    return h + cm_out, (wkv_new, tm_last, cm_last)


def _block_h(lp: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    return _block(lp, h, cfg)[0]


def hidden_states(params: dict, tokens, cfg) -> torch.Tensor:
    h = embed_tokens(params, tokens, cfg)
    for lp in unstack(params["layers"], cfg.num_layers):
        if cfg.remat_policy != "none":
            h = checkpoint(_block_h, lp, h, cfg, use_reentrant=False)
        else:
            h = _block_h(lp, h, cfg)
    return h


def forward(params: dict, tokens, cfg) -> torch.Tensor:
    return unembed(params, hidden_states(params, tokens, cfg), cfg)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    logits = forward(params, batch["tokens"], cfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = (labels >= 0).float()
    xent = softmax_xent(logits, torch.clamp(labels, min=0), mask)
    return xent, {"loss": xent, "xent": xent}


def cache_schema(cfg, batch: int, capacity: int) -> dict:
    """O(1) state — ``capacity`` is ignored (kept for API uniformity)."""
    H, hd, D, L = cfg.num_heads, cfg.d_head, cfg.d_model, cfg.num_layers
    return {
        "wkv": ParamSpec((L, batch, H, hd, hd),
                         ("layers", "act_batch", "heads", "head_dim", "head_dim2"),
                         init="zeros", dtype="float32"),
        "tm_shift": ParamSpec((L, batch, D), ("layers", "act_batch", "act_embed"),
                              init="zeros", dtype=cfg.dtype),
        "cm_shift": ParamSpec((L, batch, D), ("layers", "act_batch", "act_embed"),
                              init="zeros", dtype=cfg.dtype),
    }


def decode_step(params: dict, token, cache: dict, cache_len, cfg) -> tuple:
    """token (B, 1) ids; cache {'wkv', 'tm_shift', 'cm_shift'} stacked over
    layers.  Position-free: ``cache_len`` is ignored.  Returns
    (logits (B, V), new cache)."""
    del cache_len
    h = embed_tokens(params, token, cfg)
    wkv, tms, cms = [], [], []
    for i in range(cfg.num_layers):
        tm, cm = cache["tm_shift"][i], cache["cm_shift"][i]
        h, (w_new, tm_last, cm_last) = _block(
            layer_params(params, i), h, cfg, decode=True,
            states=(cache["wkv"][i], tm.to(h.dtype), cm.to(h.dtype)))
        wkv.append(w_new)
        tms.append(tm_last.to(tm.dtype))
        cms.append(cm_last.to(cm.dtype))
    logits = unembed(params, h, cfg)[:, 0]
    return logits, {"wkv": torch.stack(wkv), "tm_shift": torch.stack(tms),
                    "cm_shift": torch.stack(cms)}
