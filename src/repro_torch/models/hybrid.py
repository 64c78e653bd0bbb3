"""zamba2 hybrid stack, in PyTorch: Mamba-2 backbone + ONE shared attention block.

The port of ``repro/models/hybrid.py``.  The shared block's weights are used
at every ``attn_every``-th layer (weight sharing across invocations, the
zamba2 signature).  Its input is concat(hidden, first-layer embedding)
(2 d_model); attention projects back to d_model, then a gated MLP.
[arXiv:2411.15242]

The reference's ``lax.cond`` on the layer index is a Python ``if``; its
``lax.scan`` over layers a Python loop over the stacked layers, unbound
once.  Each layer, its shared-block invocation included, runs under
``layers.remat`` (the reference's ``jax.checkpoint`` unless
``cfg.remat_policy == "none"``).  The reference's
``fsdp.gather`` is the identity on one device and is dropped.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    ParamSpec,
    _proj_in,
    apply_rope,
    mlp_apply,
    mlp_schema,
    out_project,
    remat,
    rms_norm,
    softmax_xent,
    stack_schema,
    unstack,
)
from repro_torch.models.mamba2 import mamba2_apply, mamba2_schema
from repro_torch.models.transformer import embed_tokens, unembed


def shared_block_schema(cfg) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    D2 = 2 * D
    return {
        "ln_in": ParamSpec((D2,), ("norm",), init="zeros"),
        "wq": ParamSpec((D2, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D2, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D2, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed")),
        "ln_mlp": ParamSpec((D,), ("norm",), init="zeros"),
        "mlp": mlp_schema(cfg),
    }


def _layer_schema(cfg) -> dict:
    return {"ln": ParamSpec((cfg.d_model,), ("norm",), init="zeros"),
            "mamba": mamba2_schema(cfg)}


def hybrid_schema(cfg) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamSpec((Vp, D), ("vocab", "embed"), init="embed"),
        "layers": stack_schema(_layer_schema(cfg), cfg.num_layers),
        "shared": shared_block_schema(cfg),
        "final_norm": ParamSpec((D,), ("norm",), init="zeros"),
    }


def n_shared_invocations(cfg) -> int:
    return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every


def _shared_qkv(sp: dict, xcat: torch.Tensor, positions: torch.Tensor, cfg) -> tuple:
    a_in = rms_norm(xcat, sp["ln_in"], cfg.norm_eps)
    q, k, v = (_proj_in(a_in, sp[n]) for n in ("wq", "wk", "wv"))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _shared_out(sp: dict, h: torch.Tensor, attn_out: torch.Tensor, cfg) -> torch.Tensor:
    h = h + out_project(sp, attn_out)
    return h + mlp_apply(sp["mlp"], rms_norm(h, sp["ln_mlp"], cfg.norm_eps))


def shared_block(sp: dict, h: torch.Tensor, h0: torch.Tensor, positions: torch.Tensor,
                 cfg) -> torch.Tensor:
    q, k, v = _shared_qkv(sp, torch.cat([h, h0], dim=-1), positions, cfg)
    attn_out = attn_lib.attend(q, k, v, causal=True, window=cfg.sliding_window)
    return _shared_out(sp, h, attn_out, cfg)


def _layer(lp: dict, sp: dict, h: torch.Tensor, h0: torch.Tensor, positions, idx: int,
           cfg) -> torch.Tensor:
    m_out, _ = mamba2_apply(lp["mamba"], rms_norm(h, lp["ln"], cfg.norm_eps), cfg)
    h = h + m_out
    if idx % cfg.attn_every == 0:
        h = shared_block(sp, h, h0, positions, cfg)
    return h


def hidden_states(params: dict, tokens, cfg) -> torch.Tensor:
    h = embed_tokens(params, tokens, cfg)
    h0 = h
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    sp = params["shared"]
    for idx, lp in enumerate(unstack(params["layers"], cfg.num_layers)):
        h = remat(cfg, _layer, lp, sp, h, h0, positions, idx, cfg)
    return h


def forward(params: dict, tokens, cfg) -> torch.Tensor:
    return unembed(params, hidden_states(params, tokens, cfg), cfg)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    logits = forward(params, batch["tokens"], cfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = (labels >= 0).float()
    xent = softmax_xent(logits, torch.clamp(labels, min=0), mask)
    return xent, {"loss": xent, "xent": xent}


# ---------------------------------------------------------------------------
# Decode (serving): Mamba states per layer + shared-block KV caches per
# invocation; the shared block's concat input is the current token's
# embedding (as in forward, where h0[t] = embed(tokens[t])).
# ---------------------------------------------------------------------------


def cache_schema(cfg, batch: int, capacity: int) -> dict:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    KV, hd = cfg.num_kv_heads, cfg.d_head
    L, NS = cfg.num_layers, n_shared_invocations(cfg)
    kv = ParamSpec((NS, batch, capacity, KV, hd),
                   ("layers", "act_batch", "act_kv_seq", "kv_heads", "head_dim"),
                   init="zeros", dtype=cfg.dtype)
    return {
        "ssm": ParamSpec((L, batch, H, P, N),
                         ("layers", "act_batch", "heads", "head_dim", "ssm_state"),
                         init="zeros", dtype="float32"),
        "conv": ParamSpec((L, batch, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                          ("layers", "act_batch", "conv_k", "ssm_inner"),
                          init="zeros", dtype=cfg.dtype),
        "k": kv,
        "v": kv,
    }


def _shared_block_decode(sp, h, h0, k_cache, v_cache, cache_len, cfg) -> torch.Tensor:
    """One shared-attention invocation at decode time over its (B, cap, KV,
    hd) cache, which takes the new entry in place at ``cache_len``."""
    n = int(cache_len)
    positions = torch.full((h.shape[0], 1), n, dtype=torch.long, device=h.device)
    q, k, v = _shared_qkv(sp, torch.cat([h, h0], dim=-1), positions, cfg)
    k_cache[:, n] = k[:, 0].to(k_cache.dtype)
    v_cache[:, n] = v[:, 0].to(v_cache.dtype)
    attn_out = attn_lib.decode_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), n + 1,
                                         window=cfg.sliding_window)
    return _shared_out(sp, h, attn_out, cfg)


def decode_step(params: dict, token, cache: dict, cache_len, cfg) -> tuple:
    """token (B, 1) ids; cache {'ssm', 'conv'} stacked over layers and
    {'k', 'v'} over shared invocations; ``cache_len`` a scalar.  The KV
    caches are written in place.  Returns (logits (B, V), new cache)."""
    h = embed_tokens(params, token, cfg)
    h0 = h
    sp = params["shared"]
    ssm, conv = [], []
    for idx, lp in enumerate(unstack(params["layers"], cfg.num_layers)):
        conv_state = cache["conv"][idx]
        m_out, (s_new, c_new) = mamba2_apply(
            lp["mamba"], rms_norm(h, lp["ln"], cfg.norm_eps), cfg,
            state=(cache["ssm"][idx], conv_state), decode=True)
        h = h + m_out
        if idx % cfg.attn_every == 0:
            slot = idx // cfg.attn_every
            h = _shared_block_decode(sp, h, h0, cache["k"][slot], cache["v"][slot],
                                     cache_len, cfg)
        ssm.append(s_new)
        conv.append(c_new.to(conv_state.dtype))
    logits = unembed(params, h, cfg)[:, 0]
    return logits, {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
                    "k": cache["k"], "v": cache["v"]}
