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
full K/V; where the KV heads split while the query heads stay whole, each
rank computes the query heads of its own KV groups, a slice of the whole
``wq`` and ``wo``, and the out-projection is row-parallel: 1/m of the
attention a rank, and the decode cache holds the rank's KV heads), the
MLP's ``d_ff``, the MoE experts or their ``moe_d_ff``
(``models/moe.py``), the vocabulary and pixtral's vision projection
(``embed_out``).  The column-parallel inputs enter through
``fsdp.tp_copy``, the row-parallel products (the attention
out-projection, the MLP down-projection) and the embedding leave through
``fsdp.tp_sum`` (an all-reduce over ``model``), the vision projection's
split output through ``fsdp.tp_gather``, and the logits stay split by
vocabulary into ``softmax_xent(vocab_parallel=True)``.  The helpers
(``_qkv``, ``_attn_out``, ``_mlp``) take one attention or MLP subtree, so
zamba2's shared block and seamless's three attentions run them too.
Under sequence parallelism (``seq``: the tokens' placement splits their
sequence over 'model') the residual stream holds this rank's slice: the
helpers gather it at their entry (``fsdp.sp_enter``, or ``tp_gather`` for
a whole block) and scatter it at their exit (``fsdp.sp_exit``, or
``sp_slice``), RoPE takes the whole sequence's positions after the gather,
the ids are gathered before the vocab-parallel lookup, and the logits
cover the whole sequence (the vocabulary split) or this rank's positions
(``lm_xent``).  pixtral's prefix is built whole, then sliced.  A
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
    """Whether this rank computes a share of the query heads of the
    attention ``pa``: its slice of them (TP attention), or, where the KV
    heads split over 'model' while the query heads stay whole, those of its
    own KV groups."""
    return pa["wq"].shape[1] < cfg.num_heads or pa["wk"].shape[1] < cfg.num_kv_heads


def _group_heads(pa: dict, name: str, dim: int, cfg) -> torch.Tensor:
    """``pa[name]`` (``wq``, ``bq`` or ``wo``) at the query heads this rank
    computes along ``dim``: as it is, or, where the KV heads split while the
    query heads stay whole, the heads of the rank's KV groups, a slice of
    the whole leaf read through ``fsdp.tp_copy`` (each rank's gradient fills
    its own heads)."""
    w = pa[name]
    if pa["wq"].shape[1] < cfg.num_heads or pa["wk"].shape[1] == cfg.num_kv_heads:
        return w
    n = cfg.num_heads * pa["wk"].shape[1] // cfg.num_kv_heads
    return fsdp.tp_copy(w).narrow(dim, fsdp.model_rank() * n, n)


def _qkv(pa: dict, x: torch.Tensor, cfg, seq: bool = False) -> tuple:
    """q, k, v of the attention ``pa`` (a gathered attention subtree) on
    ``x``, this rank's slice of the sequence where ``seq``: the plain
    projections (on the gathered sequence under ``seq``, alike on every
    rank), or under TP this rank's query heads and its share of the KV
    heads, or all of them where the rules keep them whole.  The input
    enters the parallel region through ``fsdp.tp_copy`` (``fsdp.sp_enter``
    under ``seq``).  Whole K/V then enter on their own, so every rank's
    gradient of the whole K/V projection is complete; under ``seq`` the
    whole K/V weights enter instead, since the gathered input's gradient is
    each rank's share."""
    if not _heads_split(pa, cfg):
        return qkv_project(pa, fsdp.tp_gather(x, 1) if seq else x, cfg)
    dt = x.dtype
    xin = fsdp.sp_enter(x) if seq else fsdp.tp_copy(x)
    q = _proj_in(xin, _group_heads(pa, "wq", 1, cfg))
    kv_split = pa["wk"].shape[1] < cfg.num_kv_heads
    kv = {n: pa[n] for n in ("wk", "wv", "bk", "bv") if n in pa}
    if not kv_split and seq:
        kv = {n: fsdp.tp_copy(w) for n, w in kv.items()}
    src = xin if kv_split or seq else x
    k, v = _proj_in(src, kv["wk"]), _proj_in(src, kv["wv"])
    if cfg.qkv_bias:
        q = q + cast(_group_heads(pa, "bq", 0, cfg), dt)
        k = k + cast(kv["bk"], dt)
        v = v + cast(kv["bv"], dt)
    if not kv_split and not seq:
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


def _attn_out(pa: dict, attn_out: torch.Tensor, cfg, seq: bool = False) -> torch.Tensor:
    """The out-projection of this rank's query heads: row-parallel, leaving
    through ``fsdp.tp_sum`` (``fsdp.sp_exit`` under ``seq``), where the rank
    computed a share of the heads; else whole (and this rank's slice of
    the sequence under ``seq``)."""
    out = out_project({"wo": _group_heads(pa, "wo", 0, cfg)}, attn_out)
    if _heads_split(pa, cfg):
        return fsdp.sp_exit(out) if seq else fsdp.tp_sum(out)
    return fsdp.sp_slice(out) if seq else out


def _mlp(pm: dict, x: torch.Tensor, cfg, seq: bool = False) -> torch.Tensor:
    """The SwiGLU MLP ``pm``; column- then row-parallel when ``d_ff`` is
    split, on the gathered sequence under ``seq`` (``x`` this rank's
    slice of it, as is the output)."""
    if pm["wg"].shape[1] == cfg.d_ff:
        return fsdp.sp_slice(mlp_apply(pm, fsdp.tp_gather(x, 1))) if seq else mlp_apply(pm, x)
    dt = x.dtype
    xin = fsdp.sp_enter(x) if seq else fsdp.tp_copy(x)
    h = swiglu(xin @ cast(pm["wg"], dt), xin @ cast(pm["wu"], dt))
    out = h @ cast(pm["wd"], dt)
    return fsdp.sp_exit(out) if seq else fsdp.tp_sum(out)


def write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             n: torch.Tensor, axes: tuple = ()) -> None:
    """The new entries ``k``, ``v`` (B, 1, KV, hd) written in place at
    position ``n`` (0-d, or (B,) per lane) of this rank's cache slice, split
    over ``axes`` (the leaf's ``fsdp.kv_seq_axes``): only the rank whose
    slice holds ``n`` changes its cache (``dist/fsdp.py``)."""
    off = fsdp.kv_seq_offset(k_cache.shape[1], axes)
    attn_lib.cache_write(k_cache, k, n, off)
    attn_lib.cache_write(v_cache, v, n, off)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len,
                  cfg, *, axes: tuple = (), window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """This rank's query heads ``q`` (B, 1, Hq, hd) over the cache's first
    ``cache_len`` positions: ``decode_attention`` over a whole cache, or,
    split along its sequence over ``axes`` (the leaf's
    ``fsdp.kv_seq_axes``), the split form over this rank's slice merged
    across the ranks, with ``q`` first gathered over 'model' where 'model'
    splits the sequence and the query heads."""
    gather = "model" in axes and q.shape[2] < cfg.num_heads
    qa = fsdp.tp_gather(q, 2) if gather else q
    Hq = qa.shape[2]
    k = _kv_for_heads(k_cache, Hq, cfg).to(q.dtype)
    v = _kv_for_heads(v_cache, Hq, cfg).to(q.dtype)
    if not axes:
        return attn_lib.decode_attention(q, k, v, cache_len, window=window, softcap=softcap)
    out, lse = attn_lib.decode_attention_partial(
        qa, k, v, cache_len, fsdp.kv_seq_offset(k_cache.shape[1], axes), window=window,
        softcap=softcap)
    out = attn_lib.merge_partials(out, lse, lambda x: fsdp.reduce_over(x, axes, "max"),
                                  lambda x: fsdp.reduce_over(x, axes)).to(q.dtype)
    if gather:
        out = out.narrow(2, fsdp.model_rank() * q.shape[2], q.shape[2])
    return out


def _ffn(p: dict, x: torch.Tensor, cfg, seq: bool = False) -> tuple:
    """The block's MLP or MoE -> (out, MoE aux loss or None).  Under
    ``seq`` the MoE routes and dispatches the gathered sequence, alike on
    every rank (its groups and capacities stay the batch's), and keeps
    this rank's slice of the combined output."""
    if cfg.block_type != "moe":
        return _mlp(p["mlp"], x, cfg, seq), None
    if not seq:
        return moe_apply(p["moe"], x, cfg)
    out, aux = moe_apply(p["moe"], fsdp.tp_gather(x, 1), cfg)
    return fsdp.sp_slice(out), aux


def decoder_block(p: dict, h: torch.Tensor, positions: torch.Tensor, cfg,
                  seq: bool = False) -> tuple:
    """Full-sequence (train/prefill) block. Returns (h, (k, v), aux): aux
    is the MoE load-balancing loss, None for a dense block; (k, v) hold the
    KV heads this rank keeps in its cache, over the whole sequence.  Under
    ``seq`` ``h`` is this rank's slice of the sequence (``positions`` stay
    the whole sequence's: RoPE runs after the gather)."""
    a_in = rms_norm(h, fsdp.tp_copy(p["ln1"]) if seq else p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], a_in, cfg, seq)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    Hq = q.shape[2]
    attn_out = attn_lib.attend(
        q, _kv_for_heads(k, Hq, cfg), _kv_for_heads(v, Hq, cfg), causal=True,
        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap
    )
    h = h + _attn_out(p["attn"], attn_out, cfg, seq)
    m_in = rms_norm(h, fsdp.tp_copy(p["ln2"]) if seq else p["ln2"], cfg.norm_eps)
    out, aux = _ffn(p, m_in, cfg, seq)
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
    axes = fsdp.kv_seq_axes("k")
    a_in = rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p["attn"], a_in, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    write_kv(k_cache, v_cache, k, v, n, axes)
    attn_out = decode_attend(q, k_cache, v_cache, n + 1, cfg, axes=axes,
                             window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
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


def whole_len(x: torch.Tensor, name: str) -> int:
    """The whole sequence length of the step's input ``name`` whose local
    tensor is ``x``: its own, or the ranks' slices together where its
    placement splits it over 'model'."""
    return x.shape[1] * (fsdp.model_size() if fsdp.input_split(name) else 1)


def embed_tokens(params: dict, tokens, cfg, seq: bool = False) -> torch.Tensor:
    """Token embeddings; vocab-parallel when the embedding's rows are
    split: each rank looks up the ids in its own rows, zeros the rest, and
    the ranks' rows are summed.  Under ``seq`` ``tokens`` is this rank's
    slice of the sequence: the ids are gathered whole first, and the
    embeddings leave as this rank's slice (a reduce-scatter of the ranks'
    rows, ``fsdp.sp_exit``)."""
    emb = cast(fsdp.gather_leaf(params["embed"], ("vocab", "embed")), cfg.dtype)
    ids = _tokens(tokens, emb.device)
    if seq:
        ids = fsdp.tp_gather(ids, 1)
    if not _vocab_split(emb, 0, cfg):
        return fsdp.sp_slice(emb[ids]) if seq else emb[ids]
    rows = emb.shape[0]
    local = ids - fsdp.model_rank() * rows
    inside = (local >= 0) & (local < rows)
    out = emb[local.clamp(0, rows - 1)] * inside[..., None].to(emb.dtype)
    return fsdp.sp_exit(out) if seq else fsdp.tp_sum(out)


def unembed(params: dict, h: torch.Tensor, cfg, seq: bool = False,
            drop: int = 0) -> torch.Tensor:
    """Logits; this rank's vocabulary slice when the vocabulary is split,
    from position ``drop`` of the sequence on (pixtral's text).  Under
    ``seq`` ``h`` is this rank's slice of the sequence: with the vocabulary
    split the normed ``h`` is gathered (``fsdp.sp_enter``) and the logits
    cover the whole sequence; with it whole they are this rank's positions
    (those from ``drop`` on)."""
    ln = fsdp.gather_leaf(params["final_norm"], ("norm",))
    h = rms_norm(h, fsdp.tp_copy(ln) if seq else ln, cfg.norm_eps)
    if cfg.tie_embeddings:
        w = fsdp.gather_leaf(params["embed"], ("vocab", "embed"))
        split = _vocab_split(w, 0, cfg)
    else:
        w = fsdp.gather_leaf(params["lm_head"], ("embed", "vocab"))
        split = _vocab_split(w, 1, cfg)
    if split:
        hin = (fsdp.sp_enter(h) if seq else fsdp.tp_copy(h))[:, drop:]
    elif seq:
        w = fsdp.tp_copy(w)
        hin = h[:, max(0, drop - fsdp.model_rank() * h.shape[1]):]
    else:
        hin = h[:, drop:]
    return hin @ cast(w, h.dtype).T if cfg.tie_embeddings else hin @ cast(w, h.dtype)


def _embed_inputs(params: dict, tokens, cfg, patch_embeds=None) -> tuple:
    """(h, seq): token embeddings, with the projected patches prepended for
    a vision model given ``patch_embeds`` (cast to the compute dtype
    first); ``seq``: whether ``h`` is this rank's slice of the sequence.
    The vision prefix is built whole on every rank (each input gathered
    first where its placement splits it: a rank's slices of the patches
    and of the text are not a slice of their concatenation), then this
    rank's slice is kept where the whole length splits."""
    split = fsdp.input_split("tokens")
    if cfg.frontend != "vision" or patch_embeds is None:
        return embed_tokens(params, tokens, cfg, split), split
    if split:
        tokens = fsdp.tp_gather(torch.as_tensor(tokens).long(), 1)
    h = embed_tokens(params, tokens, cfg)
    fp = cast(fsdp.gather_leaf(params["frontend_proj"], ("embed", "embed_out")), h.dtype)
    pe = torch.as_tensor(patch_embeds, device=h.device).to(h.dtype)
    if fsdp.input_split("patch_embeds"):
        pe = fsdp.tp_gather(pe, 1)
    if fp.shape[1] < cfg.d_model:  # embed_out split: column-parallel, then gathered
        pe = fsdp.tp_gather(fsdp.tp_copy(pe) @ fp, -1)
    else:
        pe = pe @ fp
    h = torch.cat([pe, h], dim=1)
    seq = fsdp.input_split("residual")
    return (fsdp.sp_slice(h) if seq else h), seq


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _whole_positions(h: torch.Tensor, seq: bool) -> torch.Tensor:
    """The positions of the whole sequence of which ``h`` is this rank's
    slice under ``seq`` (the blocks' RoPE runs on the gathered sequence)."""
    return _positions(h.shape[0], h.shape[1] * (fsdp.model_size() if seq else 1), h.device)


def _block_h(lp: dict, h: torch.Tensor, positions: torch.Tensor, cfg, seq: bool) -> tuple:
    h, _, aux = decoder_block(fsdp.gather(lp, block_schema(cfg)), h, positions, cfg, seq)
    return h, aux


def hidden_states(params: dict, tokens, cfg, patch_embeds=None) -> tuple:
    """Embed (with the optional vision prefix) and run the layer stack ->
    (h, the layers' mean MoE aux loss, an fp32 zero for a dense model,
    whether ``h`` is this rank's slice of the sequence).  Each layer's
    parameters are gathered inside its remat function."""
    _check_supported(cfg)
    h, seq = _embed_inputs(params, tokens, cfg, patch_embeds)
    positions = _whole_positions(h, seq)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in unstack(params["layers"], cfg.num_layers):
        h, a = remat(cfg, _block_h, lp, h, positions, cfg, seq)
        if a is not None:
            aux = aux + a
    return h, aux / cfg.num_layers, seq


def forward(params: dict, tokens, cfg, patch_embeds=None) -> torch.Tensor:
    h, _, seq = hidden_states(params, tokens, cfg, patch_embeds)
    return unembed(params, h, cfg, seq)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    """batch: tokens (B,S), labels (B,S) (-1 = masked).  Masked
    cross-entropy plus ``0.01 * aux``, the layers' mean MoE load-balancing
    loss (zero for a dense model).  A vision batch's ``patch_embeds``
    positions are dropped before the unembedding: the loss is over text
    positions only (``lm_xent``).  Returns (loss, metrics)."""
    patches = batch.get("patch_embeds") if cfg.frontend == "vision" else None
    h, aux, seq = hidden_states(params, batch["tokens"], cfg, patches)
    first = 0 if patches is None else whole_len(torch.as_tensor(patches), "patch_embeds")
    xent = lm_xent(params, h, batch["labels"], cfg, seq, first)
    loss = xent + 0.01 * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


def lm_xent(params: dict, h: torch.Tensor, labels, cfg, seq: bool = False,
            first: int = 0) -> torch.Tensor:
    """The masked cross-entropy (labels below 0 masked) of the logits of
    ``h`` from position ``first`` on against ``labels``, every family's
    loss.  Under sequence parallelism (``seq``: ``h`` is this rank's slice)
    the labels are gathered whole where their placement splits them, and
    where the logits are this rank's positions (the vocabulary whole) the
    labels of those positions are kept and the mean sums over 'model'
    too."""
    logits = unembed(params, h, cfg, seq, drop=first)
    labels = torch.as_tensor(labels, device=logits.device).long()
    if fsdp.input_split("labels"):
        labels = fsdp.tp_gather(labels, 1)
    vocab_parallel = logits.shape[-1] < cfg.padded_vocab
    local = seq and not vocab_parallel  # the logits are this rank's positions
    if local:
        lo = max(fsdp.model_rank() * h.shape[1], first) - first
        labels = labels[:, lo:lo + logits.shape[1]]
    mask = (labels >= 0).float()
    return softmax_xent(logits, torch.clamp(labels, min=0), mask,
                        vocab_parallel=vocab_parallel, seq=local)


def prefill(params: dict, tokens, cfg, cache_capacity: int, patch_embeds=None) -> tuple:
    """Returns (last-position logits (B, V), cache {'k','v'} (L, B, cap, KV, hd));
    with ``patch_embeds`` the cache holds the S_img + S_txt positions."""
    _check_supported(cfg)
    h, seq = _embed_inputs(params, tokens, cfg, patch_embeds)
    positions = _whole_positions(h, seq)
    B, S = positions.shape
    if S > cache_capacity:
        raise ValueError(f"prompt of {S} tokens exceeds cache capacity {cache_capacity}")
    bschema = block_schema(cfg)
    cache = None
    for i in range(cfg.num_layers):
        h, (k, v), _ = decoder_block(fsdp.gather(layer_params(params, i), bschema),
                                     h, positions, cfg, seq)
        if cache is None:  # this rank's KV heads
            cache = zeros(cache_schema(cfg, B, cache_capacity, k.shape[2]), h.device)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    if seq:  # the last position lies on the last rank's slice
        h = fsdp.tp_gather(h, 1)
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
