"""RWKV-6 LM stack (rwkv6-1.6b), in PyTorch. Attention-free; O(1) decode state.

The port of ``repro/models/rwkv_lm.py``.  Per-layer leaves are stacked on a
leading ``layers`` axis, as in the reference; its ``lax.scan`` over layers
is a Python loop.  Each block runs under ``layers.remat`` (the
reference's ``jax.checkpoint`` unless ``cfg.remat_policy == "none"``):
the block's activations are recomputed in the backward pass, WKV forward
included, and its ``fsdp.gather`` (the reference's site) with them.
Under tensor parallelism over 'model' the blocks run on this rank's heads
(``models/rwkv6.py``), the decode state stays split by heads
(``cache_schema``) and the logits by vocabulary.  Where the tokens' placement
splits their sequence over 'model' (sequence parallelism) the residual
stream and the norms hold this rank's slice (``dist/fsdp.py``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import fsdp
from repro_torch.models.layers import (
    ParamSpec,
    remat,
    rms_norm,
    stack_schema,
    unstack,
)
from repro_torch.models.rwkv6 import rwkv6_channel_mix, rwkv6_schema, rwkv6_time_mix
from repro_torch.models.transformer import embed_tokens, layer_params, lm_xent, unembed


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


def _block(lp: dict, h: torch.Tensor, cfg, decode: bool = False, states=None,
           seq: bool = False) -> tuple:
    lp = fsdp.gather(lp, _layer_schema(cfg))
    tm_in = rms_norm(h, fsdp.tp_copy(lp["ln1"]) if seq else lp["ln1"], cfg.norm_eps)
    if decode:
        wkv_state, tm_shift, cm_shift = states
        tm_out, wkv_new, tm_last = rwkv6_time_mix(
            lp["mix"], tm_in, cfg, state=wkv_state, decode=True, shift_state=tm_shift)
    else:
        tm_out, wkv_new, tm_last = rwkv6_time_mix(lp["mix"], tm_in, cfg, seq=seq)
        cm_shift = None
    h = h + tm_out
    cm_in = rms_norm(h, fsdp.tp_copy(lp["ln2"]) if seq else lp["ln2"], cfg.norm_eps)
    cm_out, cm_last = rwkv6_channel_mix(lp["mix"], cm_in, cfg, shift_state=cm_shift, seq=seq)
    return h + cm_out, (wkv_new, tm_last, cm_last)


def _block_h(lp: dict, h: torch.Tensor, cfg, seq: bool) -> torch.Tensor:
    return _block(lp, h, cfg, seq=seq)[0]


def hidden_states(params: dict, tokens, cfg) -> tuple:
    """-> (h, whether ``h`` is this rank's slice of the sequence)."""
    seq = fsdp.input_split("tokens")
    h = embed_tokens(params, tokens, cfg, seq)
    for lp in unstack(params["layers"], cfg.num_layers):
        h = remat(cfg, _block_h, lp, h, cfg, seq)
    return h, seq


def forward(params: dict, tokens, cfg) -> torch.Tensor:
    h, seq = hidden_states(params, tokens, cfg)
    return unembed(params, h, cfg, seq)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    h, seq = hidden_states(params, batch["tokens"], cfg)
    xent = lm_xent(params, h, batch["labels"], cfg, seq)
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
