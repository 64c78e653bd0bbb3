"""Decoder-only LM stack (the ``attn_mlp`` family), in PyTorch.

The port of ``repro/models/transformer.py`` for dense models (llama3-8b,
qwen2, minicpm, ...).  Parameters are the reference's tree: nested dicts
with every per-layer leaf stacked on a leading ``layers`` axis; the
reference's ``lax.scan`` over layers is a Python loop over that axis.

Modes:
  forward(params, tokens)                        -> logits     (teacher forcing)
  loss_fn(params, batch)                         -> (loss, metrics)
  prefill(params, tokens, cache_capacity)        -> (last-position logits, cache)
  decode_step(params, token, cache, cache_len)   -> (logits, cache)

The training stack (``hidden_states``) rematerialises each layer as
``cfg.remat_policy`` says (``layers.remat``, the reference's
``_maybe_remat``).

``decode_step`` writes the new KV entries into ``cache`` in place and
returns the same tensors.  MoE blocks and the vision frontend are not
ported yet (ROADMAP Queue 1, item 10).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    ParamSpec,
    apply_rope,
    attention_schema,
    cast,
    mlp_apply,
    mlp_schema,
    out_project,
    qkv_project,
    remat,
    rms_norm,
    softmax_xent,
    stack_schema,
    tree_map,
    unstack,
    zeros,
)


def _check_supported(cfg) -> None:
    if cfg.block_type == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet (ROADMAP Queue 1, item 10)")
    if cfg.frontend == "vision":
        raise NotImplementedError(
            f"{cfg.name}: the vision frontend is not ported yet "
            "(ROADMAP Queue 1, item 10)")
    if cfg.block_type != "attn_mlp":
        raise NotImplementedError(f"{cfg.name}: block_type {cfg.block_type!r} "
                                  "is not a decoder-only attn_mlp model")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def block_schema(cfg) -> dict:
    _check_supported(cfg)
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), ("norm",), init="zeros"),
        "ln2": ParamSpec((D,), ("norm",), init="zeros"),
        "attn": attention_schema(cfg),
        "mlp": mlp_schema(cfg),
    }


def lm_schema(cfg) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    schema = {
        "embed": ParamSpec((Vp, D), ("vocab", "embed"), init="embed"),
        "layers": stack_schema(block_schema(cfg), cfg.num_layers),
        "final_norm": ParamSpec((D,), ("norm",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamSpec((D, Vp), ("embed", "vocab"))
    return schema


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``layers`` tree (views)."""
    return tree_map(lambda x: x[i], params["layers"])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def decoder_block(p: dict, h: torch.Tensor, positions: torch.Tensor, cfg) -> tuple:
    """Full-sequence (train/prefill) block. Returns (h, (k, v))."""
    a_in = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(p["attn"], a_in, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn_out = attn_lib.attend(
        q, k, v, causal=True, window=cfg.sliding_window, softcap=cfg.attn_logit_softcap
    )
    h = h + out_project(p["attn"], attn_out)
    m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + mlp_apply(p["mlp"], m_in), (k, v)


def decoder_block_decode(p: dict, h: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, cfg) -> tuple:
    """One-token block over a (B, cap, KV, hd) cache.  ``cache_len`` is an
    int or 0-d tensor (all lanes aligned) or a (B,) tensor of per-lane
    lengths; the new entry is written in place at that position."""
    B = h.shape[0]
    n = torch.as_tensor(cache_len, device=h.device).long()
    per_row = n.dim() == 1  # continuous batching: ragged lanes
    positions = n.reshape(-1, 1).expand(B, 1)
    a_in = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(p["attn"], a_in, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if per_row:
        rows = torch.arange(B, device=h.device)
        k_cache[rows, n] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, n] = v[:, 0].to(v_cache.dtype)
    else:
        k_cache[:, n] = k[:, 0].to(k_cache.dtype)
        v_cache[:, n] = v[:, 0].to(v_cache.dtype)
    attn_out = attn_lib.decode_attention(
        q,
        k_cache.to(q.dtype),
        v_cache.to(q.dtype),
        n + 1,
        window=cfg.sliding_window,
        softcap=cfg.attn_logit_softcap,
    )
    h = h + out_project(p["attn"], attn_out)
    m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + mlp_apply(p["mlp"], m_in), k_cache, v_cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def embed_tokens(params: dict, tokens, cfg) -> torch.Tensor:
    emb = params["embed"]
    return cast(emb, cfg.dtype)[_tokens(tokens, emb.device)]


def unembed(params: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ cast(params["embed"], h.dtype).T
    return h @ cast(params["lm_head"], h.dtype)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _block_h(lp: dict, h: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    return decoder_block(lp, h, positions, cfg)[0]


def hidden_states(params: dict, tokens, cfg) -> torch.Tensor:
    _check_supported(cfg)
    h = embed_tokens(params, tokens, cfg)
    B, S, _ = h.shape
    positions = _positions(B, S, h.device)
    for lp in unstack(params["layers"], cfg.num_layers):
        h = remat(cfg, _block_h, lp, h, positions, cfg)
    return h


def forward(params: dict, tokens, cfg) -> torch.Tensor:
    return unembed(params, hidden_states(params, tokens, cfg), cfg)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    """batch: tokens (B,S), labels (B,S) (-1 = masked).  Masked
    cross-entropy plus ``0.01 * aux``; ``aux`` (the MoE load-balancing
    loss) is an fp32 zero until MoE is ported.  Returns (loss, metrics)."""
    h = hidden_states(params, batch["tokens"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    logits = unembed(params, h, cfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = (labels >= 0).float()
    xent = softmax_xent(logits, torch.clamp(labels, min=0), mask)
    loss = xent + 0.01 * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


def prefill(params: dict, tokens, cfg, cache_capacity: int) -> tuple:
    """Returns (last-position logits (B, V), cache {'k','v'} (L, B, cap, KV, hd))."""
    _check_supported(cfg)
    h = embed_tokens(params, tokens, cfg)
    B, S, _ = h.shape
    if S > cache_capacity:
        raise ValueError(f"prompt of {S} tokens exceeds cache capacity {cache_capacity}")
    positions = _positions(B, S, h.device)
    cache = zeros(cache_schema(cfg, B, cache_capacity), h.device)
    for i in range(cfg.num_layers):
        h, (k, v) = decoder_block(layer_params(params, i), h, positions, cfg)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    logits = unembed(params, h[:, -1:], cfg)[:, 0]
    return logits, cache


def decode_step(params: dict, token, cache: dict, cache_len, cfg) -> tuple:
    """token: (B, 1) ids; cache: {'k','v'} stacked (L, B, cap, KV, hd),
    updated in place.  ``cache_len`` is a scalar (all lanes aligned) or a
    (B,) vector of per-lane lengths.  Returns (logits (B, V), cache)."""
    _check_supported(cfg)
    h = embed_tokens(params, token, cfg)
    for i in range(cfg.num_layers):
        h, _, _ = decoder_block_decode(layer_params(params, i), h, cache["k"][i],
                                       cache["v"][i], cache_len, cfg)
    logits = unembed(params, h, cfg)[:, 0]
    return logits, cache


def cache_schema(cfg, batch: int, capacity: int) -> dict:
    """Abstract KV-cache layout (used by the serving engine)."""
    KV, hd, L = cfg.num_kv_heads, cfg.d_head, cfg.num_layers
    spec = ParamSpec(
        (L, batch, capacity, KV, hd),
        ("layers", "act_batch", "act_kv_seq", "kv_heads", "head_dim"),
        init="zeros",
        dtype=cfg.dtype,
    )
    return {"k": spec, "v": spec}
