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
``cfg.remat_policy == "none"``).  The ``fsdp.gather`` sites are the
reference's: the shared block once per call, each layer inside its remat
function.

Under tensor parallelism over 'model' the Mamba-2 layers run on this
rank's heads (``models/mamba2.py``) and the shared block runs the dense
family's: its query and KV heads split, and its SwiGLU MLP, through
``models/transformer.py``'s helpers on the 2 d_model-wide input.  At
decode its KV caches may also be split along their sequence (a batch of
1 leaves the data axes to ``act_kv_seq``): it decodes split-KV through
``transformer.decode_attend`` and ``write_kv`` (``dist/fsdp.py``).  Under
sequence parallelism the residual stream, ``h0`` and the norms hold this
rank's slice of the sequence, and the Mamba-2 layers and the shared block
gather it at their entry (``dist/fsdp.py``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import fsdp
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    ParamSpec,
    apply_rope,
    mlp_schema,
    remat,
    rms_norm,
    stack_schema,
    unstack,
)
from repro_torch.models.mamba2 import mamba2_apply, mamba2_schema
from repro_torch.models.transformer import (
    _attn_out,
    _kv_for_heads,
    _mlp,
    _qkv,
    _whole_positions,
    decode_attend,
    embed_tokens,
    lm_xent,
    unembed,
    write_kv,
)


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


def _shared_qkv(sp: dict, xcat: torch.Tensor, positions: torch.Tensor, cfg,
                seq: bool = False) -> tuple:
    a_in = rms_norm(xcat, fsdp.tp_copy(sp["ln_in"]) if seq else sp["ln_in"], cfg.norm_eps)
    q, k, v = _qkv(sp, a_in, cfg, seq)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _shared_out(sp: dict, h: torch.Tensor, attn_out: torch.Tensor, cfg,
                seq: bool = False) -> torch.Tensor:
    h = h + _attn_out(sp, attn_out, cfg, seq)
    ln = fsdp.tp_copy(sp["ln_mlp"]) if seq else sp["ln_mlp"]
    return h + _mlp(sp["mlp"], rms_norm(h, ln, cfg.norm_eps), cfg, seq)


def shared_block(sp: dict, h: torch.Tensor, h0: torch.Tensor, positions: torch.Tensor,
                 cfg, seq: bool = False) -> torch.Tensor:
    q, k, v = _shared_qkv(sp, torch.cat([h, h0], dim=-1), positions, cfg, seq)
    Hq = q.shape[2]
    attn_out = attn_lib.attend(q, _kv_for_heads(k, Hq, cfg), _kv_for_heads(v, Hq, cfg),
                               causal=True, window=cfg.sliding_window)
    return _shared_out(sp, h, attn_out, cfg, seq)


def _layer(lp: dict, sp: dict, h: torch.Tensor, h0: torch.Tensor, positions, idx: int,
           cfg, seq: bool) -> torch.Tensor:
    lp = fsdp.gather(lp, _layer_schema(cfg))
    ln = fsdp.tp_copy(lp["ln"]) if seq else lp["ln"]
    m_out, _ = mamba2_apply(lp["mamba"], rms_norm(h, ln, cfg.norm_eps), cfg, seq=seq)
    h = h + m_out
    if idx % cfg.attn_every == 0:
        h = shared_block(sp, h, h0, positions, cfg, seq)
    return h


def hidden_states(params: dict, tokens, cfg) -> tuple:
    """-> (h, whether ``h`` is this rank's slice of the sequence)."""
    seq = fsdp.input_split("tokens")
    h = embed_tokens(params, tokens, cfg, seq)
    h0 = h
    positions = _whole_positions(h, seq)
    sp = fsdp.gather(params["shared"], shared_block_schema(cfg))
    for idx, lp in enumerate(unstack(params["layers"], cfg.num_layers)):
        h = remat(cfg, _layer, lp, sp, h, h0, positions, idx, cfg, seq)
    return h, seq


def forward(params: dict, tokens, cfg) -> torch.Tensor:
    h, seq = hidden_states(params, tokens, cfg)
    return unembed(params, h, cfg, seq)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    h, seq = hidden_states(params, batch["tokens"], cfg)
    xent = lm_xent(params, h, batch["labels"], cfg, seq)
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
    hd) cache, or this rank's slice of it, which takes the new entry in
    place at ``cache_len`` (read on the device: a decode step never waits
    for the host)."""
    n = torch.as_tensor(cache_len, device=h.device).long()
    positions = n.reshape(1, 1).expand(h.shape[0], 1)
    q, k, v = _shared_qkv(sp, torch.cat([h, h0], dim=-1), positions, cfg)
    axes = fsdp.kv_seq_axes("k")
    write_kv(k_cache, v_cache, k, v, n, axes)
    attn_out = decode_attend(q, k_cache, v_cache, n + 1, cfg, axes=axes,
                             window=cfg.sliding_window)
    return _shared_out(sp, h, attn_out, cfg)


def decode_step(params: dict, token, cache: dict, cache_len, cfg) -> tuple:
    """token (B, 1) ids; cache {'ssm', 'conv'} stacked over layers and
    {'k', 'v'} over shared invocations; ``cache_len`` a scalar.  The KV
    caches are written in place.  Returns (logits (B, V), new cache)."""
    h = embed_tokens(params, token, cfg)
    h0 = h
    sp = fsdp.gather(params["shared"], shared_block_schema(cfg))
    ssm, conv = [], []
    for idx, lp in enumerate(unstack(params["layers"], cfg.num_layers)):
        lp = fsdp.gather(lp, _layer_schema(cfg))
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
