"""Decoder-only LM stack (dense and MoE variants), in PyTorch.

The port of ``repro/models/transformer.py``: the ``attn_mlp`` family
(llama3-8b, qwen2, minicpm, pixtral-12b's backbone, ...) and the ``moe``
family (qwen3-moe, grok-1), whose blocks replace the MLP by
``models/moe.moe_apply``.  Parameters are the reference's tree: nested dicts
with every per-layer leaf stacked on a leading ``layers`` axis; the
reference's ``lax.scan`` over layers is a Python loop over that axis.

Modes:
  forward(params, tokens[, patch_embeds])                  -> logits  (teacher forcing)
  loss_fn(params, batch)                                   -> (loss, metrics)
  prefill(params, tokens, cache_capacity[, patch_embeds])  -> (last-position logits, cache)
  decode_step(params, token, cache, cache_len)             -> (logits, cache)

The vision frontend (pixtral) is a stub: ``patch_embeds`` (B, S_img, D)
are precomputed patch embeddings, projected by ``frontend_proj`` and
prepended to the token embeddings; positions run over patches and text
together, and ``loss_fn`` scores the text positions only.

The training stack (``hidden_states``) rematerialises each layer as
``cfg.remat_policy`` says (``layers.remat``, the reference's
``_maybe_remat``).

``decode_step`` writes the new KV entries into ``cache`` in place and
returns the same tensors.

Sharding: the ``dist/fsdp.py`` hooks sit where the reference has them
(each layer's ``gather`` inside the remat function, ``gather_leaf`` for
the embedding, unembedding and vision projection) and are the identity
outside a sharding context.  Under ``model`` > 1 the blocks run
Megatron-style tensor parallelism on the local shards the gathers hand
out, reading what is split from the shapes: query heads (and KV heads,
or, where those stay whole, each rank's query heads take theirs from the
full K/V), the MLP's ``d_ff``, the MoE experts or their ``moe_d_ff``
(``models/moe.py``), the vocabulary and pixtral's vision projection
(``embed_out``).  The column-parallel inputs enter through
``fsdp.tp_copy``, the row-parallel products (the attention
out-projection, the MLP down-projection) and the embedding leave through
``fsdp.tp_sum`` (an all-reduce over ``model``), the vision projection's
split output through ``fsdp.tp_gather``, and the logits stay split by
vocabulary into ``softmax_xent(vocab_parallel=True)``.  The helpers
(``_qkv``, ``_attn_out``, ``_mlp``) take one attention or MLP subtree, so
zamba2's shared block and seamless's three attentions run them too.  A
decode cache split along its sequence (``act_kv_seq``: the KV heads cannot
split over 'model', or a batch of 1 leaves the data axes to the sequence)
decodes split-KV (``decode_attend``, ``write_kv``; ``dist/fsdp.py``'s
rule).
"""
from __future__ import annotations

import torch

from repro_torch.dist import fsdp
from repro_torch.models import attention as attn_lib
from repro_torch.models.moe import moe_apply, moe_schema
from repro_torch.models.layers import (
    ParamSpec,
    _proj_in,
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
    swiglu,
    tree_map,
    unstack,
    zeros,
)

VISION_PREFIX = 1024  # pixtral: number of precomputed patch-embedding positions


def _check_supported(cfg) -> None:
    if cfg.block_type not in ("attn_mlp", "moe"):
        raise NotImplementedError(f"{cfg.name}: block_type {cfg.block_type!r} "
                                  "is not a decoder-only attn_mlp or moe model")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def block_schema(cfg) -> dict:
    _check_supported(cfg)
    D = cfg.d_model
    s = {
        "ln1": ParamSpec((D,), ("norm",), init="zeros"),
        "ln2": ParamSpec((D,), ("norm",), init="zeros"),
        "attn": attention_schema(cfg),
    }
    if cfg.block_type == "moe":
        s["moe"] = moe_schema(cfg)
    else:
        s["mlp"] = mlp_schema(cfg)
    return s


def lm_schema(cfg) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    schema = {
        "embed": ParamSpec((Vp, D), ("vocab", "embed"), init="embed"),
        "layers": stack_schema(block_schema(cfg), cfg.num_layers),
        "final_norm": ParamSpec((D,), ("norm",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamSpec((D, Vp), ("embed", "vocab"))
    if cfg.frontend == "vision":
        schema["frontend_proj"] = ParamSpec((D, D), ("embed", "embed_out"))
    return schema


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``layers`` tree (views)."""
    return tree_map(lambda x: x[i], params["layers"])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _heads_split(pa: dict, cfg) -> bool:
    """Whether this rank holds a slice of the query heads of the attention
    ``pa`` (TP attention)."""
    return pa["wq"].shape[1] < cfg.num_heads


def _qkv(pa: dict, x: torch.Tensor, cfg) -> tuple:
    """q, k, v of the attention ``pa`` (a gathered attention subtree) on
    ``x``: the plain projections, or under TP this rank's query heads and
    its share of the KV heads, or all of them where the rules keep them
    whole; then K/V enter the parallel region on their own, so every rank's
    gradient of the whole K/V projection is complete."""
    if not _heads_split(pa, cfg):
        return qkv_project(pa, x, cfg)
    dt = x.dtype
    xin = fsdp.tp_copy(x)
    q = _proj_in(xin, pa["wq"])
    kv_split = pa["wk"].shape[1] < cfg.num_kv_heads
    src = xin if kv_split else x
    k, v = _proj_in(src, pa["wk"]), _proj_in(src, pa["wv"])
    if cfg.qkv_bias:
        q = q + cast(pa["bq"], dt)
        k = k + cast(pa["bk"], dt)
        v = v + cast(pa["bv"], dt)
    if not kv_split:
        k, v = fsdp.tp_copy(k), fsdp.tp_copy(v)
    return q, k, v


def _kv_for_heads(k: torch.Tensor, q_heads: int, cfg) -> torch.Tensor:
    """The KV heads this rank's ``q_heads`` query heads read: ``k`` as it
    is, unless it holds all KV heads while the query heads are split.  Then
    the KV heads of the rank's query heads: their one head where they lie
    in one group, or the run of heads where they cover whole groups (a
    grouped attention over fewer KV heads), else one per query head (a
    group of one)."""
    if q_heads == cfg.num_heads or k.shape[2] < cfg.num_kv_heads:
        return k
    group = cfg.num_heads // cfg.num_kv_heads
    first = fsdp.model_rank() * q_heads
    if group % q_heads == 0 or q_heads % group == 0:
        return k.narrow(2, first // group, max(1, q_heads // group)).contiguous()
    idx = torch.arange(first, first + q_heads, device=k.device) // group
    return k.index_select(2, idx)


def _attn_out(pa: dict, attn_out: torch.Tensor, cfg) -> torch.Tensor:
    out = out_project(pa, attn_out)
    return fsdp.tp_sum(out) if _heads_split(pa, cfg) else out


def _mlp(pm: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The SwiGLU MLP ``pm``; column- then row-parallel when ``d_ff`` is split."""
    if pm["wg"].shape[1] == cfg.d_ff:
        return mlp_apply(pm, x)
    dt = x.dtype
    xin = fsdp.tp_copy(x)
    h = swiglu(xin @ cast(pm["wg"], dt), xin @ cast(pm["wu"], dt))
    return fsdp.tp_sum(h @ cast(pm["wd"], dt))


def write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             n: torch.Tensor) -> None:
    """The new entries ``k``, ``v`` (B, 1, KV, hd) written in place at
    position ``n`` (0-d, or (B,) per lane) of this rank's cache slice: only
    the rank whose slice holds ``n`` changes its cache (``dist/fsdp.py``)."""
    off = fsdp.kv_seq_offset(k_cache.shape[1])
    attn_lib.cache_write(k_cache, k, n, off)
    attn_lib.cache_write(v_cache, v, n, off)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len,
                  cfg, *, window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """This rank's query heads ``q`` (B, 1, Hq, hd) over the cache's first
    ``cache_len`` positions: ``decode_attention`` over a whole cache, or,
    split along its sequence (``fsdp.kv_seq_axes()``), the split form over
    this rank's slice merged across the ranks, with ``q`` first gathered
    over 'model' where 'model' splits the sequence and the query heads."""
    axes = fsdp.kv_seq_axes()
    gather = "model" in axes and q.shape[2] < cfg.num_heads
    qa = fsdp.tp_gather(q, 2) if gather else q
    Hq = qa.shape[2]
    k = _kv_for_heads(k_cache, Hq, cfg).to(q.dtype)
    v = _kv_for_heads(v_cache, Hq, cfg).to(q.dtype)
    if not axes:
        return attn_lib.decode_attention(q, k, v, cache_len, window=window, softcap=softcap)
    out, lse = attn_lib.decode_attention_partial(
        qa, k, v, cache_len, fsdp.kv_seq_offset(k_cache.shape[1]), window=window,
        softcap=softcap)
    out = attn_lib.merge_partials(out, lse, fsdp.seq_max, fsdp.seq_sum).to(q.dtype)
    if gather:
        out = out.narrow(2, fsdp.model_rank() * q.shape[2], q.shape[2])
    return out


def _ffn(p: dict, x: torch.Tensor, cfg) -> tuple:
    """The block's MLP or MoE -> (out, MoE aux loss or None)."""
    if cfg.block_type == "moe":
        return moe_apply(p["moe"], x, cfg)
    return _mlp(p["mlp"], x, cfg), None


def decoder_block(p: dict, h: torch.Tensor, positions: torch.Tensor, cfg) -> tuple:
    """Full-sequence (train/prefill) block. Returns (h, (k, v), aux): aux
    is the MoE load-balancing loss, None for a dense block; (k, v) hold the
    KV heads this rank keeps in its cache."""
    a_in = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], a_in, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    Hq = q.shape[2]
    attn_out = attn_lib.attend(
        q, _kv_for_heads(k, Hq, cfg), _kv_for_heads(v, Hq, cfg), causal=True,
        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap
    )
    h = h + _attn_out(p["attn"], attn_out, cfg)
    m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
    out, aux = _ffn(p, m_in, cfg)
    return h + out, (k, v), aux


def decoder_block_decode(p: dict, h: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, cfg) -> tuple:
    """One-token block over a (B, cap, KV, hd) cache, or this rank's slice
    of it.  ``cache_len`` is an int or 0-d tensor (all lanes aligned) or a
    (B,) tensor of per-lane lengths; the new entry is written in place at
    that position."""
    B = h.shape[0]
    n = torch.as_tensor(cache_len, device=h.device).long()
    positions = n.reshape(-1, 1).expand(B, 1)
    a_in = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], a_in, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    write_kv(k_cache, v_cache, k, v, n)
    attn_out = decode_attend(q, k_cache, v_cache, n + 1, cfg, window=cfg.sliding_window,
                             softcap=cfg.attn_logit_softcap)
    h = h + _attn_out(p["attn"], attn_out, cfg)
    m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + _ffn(p, m_in, cfg)[0], k_cache, v_cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _vocab_split(w: torch.Tensor, dim: int, cfg) -> bool:
    return w.shape[dim] < cfg.padded_vocab


def embed_tokens(params: dict, tokens, cfg) -> torch.Tensor:
    """Token embeddings; vocab-parallel when the embedding's rows are
    split: each rank looks up the ids in its own rows, zeros the rest, and
    the ranks' rows are summed."""
    emb = cast(fsdp.gather_leaf(params["embed"], ("vocab", "embed")), cfg.dtype)
    ids = _tokens(tokens, emb.device)
    if not _vocab_split(emb, 0, cfg):
        return emb[ids]
    rows = emb.shape[0]
    local = ids - fsdp.model_rank() * rows
    inside = (local >= 0) & (local < rows)
    out = emb[local.clamp(0, rows - 1)] * inside[..., None].to(emb.dtype)
    return fsdp.tp_sum(out)


def unembed(params: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """Logits; this rank's vocabulary slice when the vocabulary is split."""
    h = rms_norm(h, fsdp.gather_leaf(params["final_norm"], ("norm",)), cfg.norm_eps)
    if cfg.tie_embeddings:
        w = fsdp.gather_leaf(params["embed"], ("vocab", "embed"))
        hin = fsdp.tp_copy(h) if _vocab_split(w, 0, cfg) else h
        return hin @ cast(w, h.dtype).T
    w = fsdp.gather_leaf(params["lm_head"], ("embed", "vocab"))
    hin = fsdp.tp_copy(h) if _vocab_split(w, 1, cfg) else h
    return hin @ cast(w, h.dtype)


def _embed_inputs(params: dict, tokens, cfg, patch_embeds=None) -> torch.Tensor:
    """Token embeddings, with the projected patches prepended for a vision
    model given ``patch_embeds`` (cast to the compute dtype first)."""
    h = embed_tokens(params, tokens, cfg)
    if cfg.frontend == "vision" and patch_embeds is not None:
        fp = cast(fsdp.gather_leaf(params["frontend_proj"], ("embed", "embed_out")), h.dtype)
        pe = torch.as_tensor(patch_embeds, device=h.device).to(h.dtype)
        if fp.shape[1] < cfg.d_model:  # embed_out split: column-parallel, then gathered
            pe = fsdp.tp_gather(fsdp.tp_copy(pe) @ fp, -1)
        else:
            pe = pe @ fp
        h = torch.cat([pe, h], dim=1)
    return h


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _block_h(lp: dict, h: torch.Tensor, positions: torch.Tensor, cfg) -> tuple:
    h, _, aux = decoder_block(fsdp.gather(lp, block_schema(cfg)), h, positions, cfg)
    return h, aux


def hidden_states(params: dict, tokens, cfg, patch_embeds=None) -> tuple:
    """Embed (with the optional vision prefix) and run the layer stack ->
    (h, the layers' mean MoE aux loss, an fp32 zero for a dense model).
    Each layer's parameters are gathered inside its remat function."""
    _check_supported(cfg)
    h = _embed_inputs(params, tokens, cfg, patch_embeds)
    B, S, _ = h.shape
    positions = _positions(B, S, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in unstack(params["layers"], cfg.num_layers):
        h, a = remat(cfg, _block_h, lp, h, positions, cfg)
        if a is not None:
            aux = aux + a
    return h, aux / cfg.num_layers


def forward(params: dict, tokens, cfg, patch_embeds=None) -> torch.Tensor:
    return unembed(params, hidden_states(params, tokens, cfg, patch_embeds)[0], cfg)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    """batch: tokens (B,S), labels (B,S) (-1 = masked).  Masked
    cross-entropy plus ``0.01 * aux``, the layers' mean MoE load-balancing
    loss (zero for a dense model).  A vision batch's ``patch_embeds``
    positions are dropped before the unembedding: the loss is over text
    positions only.  Returns (loss, metrics)."""
    h, aux = hidden_states(params, batch["tokens"], cfg, batch.get("patch_embeds"))
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        h = h[:, batch["patch_embeds"].shape[1]:]
    logits = unembed(params, h, cfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = (labels >= 0).float()
    xent = softmax_xent(logits, torch.clamp(labels, min=0), mask,
                        vocab_parallel=logits.shape[-1] < cfg.padded_vocab)
    loss = xent + 0.01 * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


def prefill(params: dict, tokens, cfg, cache_capacity: int, patch_embeds=None) -> tuple:
    """Returns (last-position logits (B, V), cache {'k','v'} (L, B, cap, KV, hd));
    with ``patch_embeds`` the cache holds the S_img + S_txt positions."""
    _check_supported(cfg)
    h = _embed_inputs(params, tokens, cfg, patch_embeds)
    B, S, _ = h.shape
    if S > cache_capacity:
        raise ValueError(f"prompt of {S} tokens exceeds cache capacity {cache_capacity}")
    positions = _positions(B, S, h.device)
    bschema = block_schema(cfg)
    cache = None
    for i in range(cfg.num_layers):
        h, (k, v), _ = decoder_block(fsdp.gather(layer_params(params, i), bschema),
                                     h, positions, cfg)
        if cache is None:  # this rank's KV heads
            cache = zeros(cache_schema(cfg, B, cache_capacity, k.shape[2]), h.device)
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
    bschema = block_schema(cfg)
    for i in range(cfg.num_layers):
        lp = fsdp.gather(layer_params(params, i), bschema)
        h, _, _ = decoder_block_decode(lp, h, cache["k"][i], cache["v"][i], cache_len, cfg)
    logits = unembed(params, h, cfg)[:, 0]
    return logits, cache


def cache_schema(cfg, batch: int, capacity: int, kv_heads: int = 0) -> dict:
    """Abstract KV-cache layout (used by the serving engine); ``kv_heads``
    (default: all) sizes a rank's share under tensor parallelism."""
    KV, hd, L = kv_heads or cfg.num_kv_heads, cfg.d_head, cfg.num_layers
    spec = ParamSpec(
        (L, batch, capacity, KV, hd),
        ("layers", "act_batch", "act_kv_seq", "kv_heads", "head_dim"),
        init="zeros",
        dtype=cfg.dtype,
    )
    return {"k": spec, "v": spec}
