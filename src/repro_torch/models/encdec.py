"""Encoder-decoder stack (seamless-m4t-large-v2 backbone), in PyTorch.

The port of ``repro/models/encdec.py``.  The speech frontend is a stub:
inputs are precomputed frame embeddings (B, S_enc, D), projected by
``frontend_proj``.  Encoder: bidirectional self-attention with RoPE.
Decoder: causal self-attention, then cross-attention (q from the decoder,
k/v from the encoder output, no RoPE, not causal), then the MLP.

Shape mapping: for training and prefill the encoder consumes ``seq_len``
frames and the decoder ``seq_len // DEC_RATIO`` tokens; ``decode_step``
runs one decoder step against a decoder KV cache and a cached encoder
memory of ``ENC_MEMORY`` frames, over which its cross-attention runs
``decode_attention`` (plain PyTorch on every device, as in the reference).

Parameters are the reference's tree, with every per-layer leaf stacked on
a leading ``layers`` axis; each stack is unbound once (``layers.unstack``).
Under any ``remat_policy`` other than ``"none"`` a whole block is
rematerialised (non-reentrant ``torch.utils.checkpoint``), as the
reference wraps each block in ``jax.checkpoint``: ``"dots"`` means
``"full"`` here.  Each block's ``fsdp.gather`` (the reference's site)
runs inside it.  On CUDA every self- and cross-attention of ``encode``
and ``forward`` goes to the flash kernels (``models/attention.attend``).

Under tensor parallelism over 'model' the encoder, the decoder and the
cross-attention run the dense family's rule through
``models/transformer.py``'s helpers: query and KV heads and ``d_ff``
split, each row-parallel product ending in ``fsdp.tp_sum``;
``frontend_proj`` column-parallel behind ``fsdp.tp_copy``, then gathered
along D (pixtral's vision projection); the cross-attention's K/V project
the replicated encoder output, which enters through ``fsdp.tp_copy``
(``_enc_kv``).  At decode the self-attention cache and the encoder memory
``enc_k``/``enc_v`` are split by KV heads over 'model', and along their
sequence where the rules put ``act_kv_seq`` on live axes (a batch of 1):
both attentions then decode split-KV (``transformer.decode_attend``,
``dist/fsdp.py``), the encoder memory with every position valid, each
leaf by its own placement (at a capacity the divisibility guard keeps
whole, the self-attention cache decodes whole while the encoder memory
splits).  Under sequence parallelism the frames and the decoder tokens
each split by their own placement, and the cross-attention's K/V gather
the encoder output whole.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import as_dtype
from repro_torch.dist import fsdp
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    ParamSpec,
    _proj_in,
    apply_rope,
    attention_schema,
    cast,
    mlp_schema,
    rms_norm,
    stack_schema,
    tree_map,
    unstack,
)
from repro_torch.models.transformer import (
    _attn_out,
    _group_heads,
    _heads_split,
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

DEC_RATIO = 4       # decoder length = encoder length // 4 for train/prefill
ENC_MEMORY = 4096   # encoder memory length at decode shapes


def encoder_block_schema(cfg) -> dict:
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), ("norm",), init="zeros"),
        "ln2": ParamSpec((D,), ("norm",), init="zeros"),
        "attn": attention_schema(cfg),
        "mlp": mlp_schema(cfg),
    }


def decoder_block_schema(cfg) -> dict:
    D = cfg.d_model
    return {
        "ln1": ParamSpec((D,), ("norm",), init="zeros"),
        "lnx": ParamSpec((D,), ("norm",), init="zeros"),
        "ln2": ParamSpec((D,), ("norm",), init="zeros"),
        "self_attn": attention_schema(cfg),
        "cross_attn": attention_schema(cfg),
        "mlp": mlp_schema(cfg),
    }


def encdec_schema(cfg) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    return {
        "frontend_proj": ParamSpec((D, D), ("embed", "embed_out")),
        "embed": ParamSpec((Vp, D), ("vocab", "embed"), init="embed"),
        "enc_layers": stack_schema(encoder_block_schema(cfg), cfg.num_encoder_layers),
        "dec_layers": stack_schema(decoder_block_schema(cfg), cfg.num_layers),
        "enc_norm": ParamSpec((D,), ("norm",), init="zeros"),
        "final_norm": ParamSpec((D,), ("norm",), init="zeros"),
        "lm_head": ParamSpec((D, Vp), ("embed", "vocab")),
    }


def _block(cfg, fn, *args):
    """``fn(*args)``, rematerialised whole unless ``remat_policy`` is
    ``"none"`` (the reference's ``jax.checkpoint`` of the block)."""
    if cfg.remat_policy == "none":
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def _enc_block(lp: dict, h: torch.Tensor, positions: torch.Tensor, cfg,
               seq: bool = False) -> torch.Tensor:
    lp = fsdp.gather(lp, encoder_block_schema(cfg))
    a_in = rms_norm(h, fsdp.tp_copy(lp["ln1"]) if seq else lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(lp["attn"], a_in, cfg, seq)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    Hq = q.shape[2]
    out = attn_lib.attend(q, _kv_for_heads(k, Hq, cfg), _kv_for_heads(v, Hq, cfg), causal=False)
    h = h + _attn_out(lp["attn"], out, cfg, seq)
    m_in = rms_norm(h, fsdp.tp_copy(lp["ln2"]) if seq else lp["ln2"], cfg.norm_eps)
    return h + _mlp(lp["mlp"], m_in, cfg, seq)


def encode(params: dict, frames, cfg, seq: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frame embeddings (frontend stub),
    cast to ``cfg.dtype`` before the ``frontend_proj`` product (column-
    parallel, then gathered along D, where ``embed_out`` is split).  Under
    ``seq`` ``frames`` is this rank's slice of the sequence and so is the
    encoder output: a split ``frontend_proj`` takes the frames gathered
    whole (its output columns of every position), a whole one reads this
    rank's frames."""
    fp = fsdp.gather_leaf(params["frontend_proj"], ("embed", "embed_out"))
    h = torch.as_tensor(frames, device=fp.device).to(as_dtype(cfg.dtype))
    if fp.shape[1] < cfg.d_model:
        x = fsdp.tp_gather(h, 1) if seq else h
        h = fsdp.tp_gather(fsdp.tp_copy(x) @ cast(fp, h.dtype), -1)
        h = fsdp.sp_slice(h) if seq else h
    else:
        h = h @ cast(fsdp.tp_copy(fp) if seq else fp, h.dtype)
    positions = _whole_positions(h, seq)
    for lp in unstack(params["enc_layers"], cfg.num_encoder_layers):
        h = _block(cfg, _enc_block, lp, h, positions, cfg, seq)
    ln = fsdp.gather_leaf(params["enc_norm"], ("norm",))
    return rms_norm(h, fsdp.tp_copy(ln) if seq else ln, cfg.norm_eps)


def _enc_kv(lp: dict, enc_out: torch.Tensor, cfg, seq: bool = False) -> tuple:
    """Cross-attention k, v (B, S_enc, KV, hd) from the (replicated) encoder
    output; under TP this rank's KV heads, from an input that entered the
    parallel region (``tp_copy``), so the encoder's gradient sums every
    rank's heads, or, where the KV heads stay whole while the query heads
    split, all of them, each entering on its own.  Under ``seq``
    ``enc_out`` is this rank's slice of the frames, gathered whole here:
    through ``fsdp.sp_enter`` for this rank's KV heads, else alike on every
    rank (``fsdp.tp_gather``)."""
    pa = lp["cross_attn"]
    kv_split = pa["wk"].shape[1] < cfg.num_kv_heads
    if seq:
        x = fsdp.sp_enter(enc_out) if kv_split else fsdp.tp_gather(enc_out, 1)
    else:
        x = fsdp.tp_copy(enc_out) if kv_split else enc_out
    k, v = _proj_in(x, pa["wk"]), _proj_in(x, pa["wv"])
    if _heads_split(pa, cfg) and not kv_split:
        k, v = fsdp.tp_copy(k), fsdp.tp_copy(v)
    return k, v


def _cross_q(lp: dict, h: torch.Tensor, cfg, seq: bool = False) -> torch.Tensor:
    """The cross-attention's query from the decoder's ``lnx`` output
    (``wq`` alone, no RoPE): this rank's heads under TP, over the gathered
    sequence under ``seq``."""
    pa = lp["cross_attn"]
    x = rms_norm(h, fsdp.tp_copy(lp["lnx"]) if seq else lp["lnx"], cfg.norm_eps)
    if _heads_split(pa, cfg):
        x = fsdp.sp_enter(x) if seq else fsdp.tp_copy(x)
    elif seq:
        x = fsdp.tp_gather(x, 1)
    return _proj_in(x, _group_heads(pa, "wq", 1, cfg))


def _cross_attend(lp: dict, h: torch.Tensor, enc_kv: tuple, positions, cfg,
                  seq: bool = False) -> torch.Tensor:
    """Cross-attention: q from the decoder's h, k/v precomputed from the
    encoder, not causal; ``positions`` is unused, as in the reference."""
    q = _cross_q(lp, h, cfg, seq)
    k, v = enc_kv
    Hq = q.shape[2]
    out = attn_lib.attend(q, _kv_for_heads(k, Hq, cfg), _kv_for_heads(v, Hq, cfg), causal=False)
    return h + _attn_out(lp["cross_attn"], out, cfg, seq)


def _dec_block(lp: dict, h: torch.Tensor, enc_out: torch.Tensor, positions: torch.Tensor,
               cfg, seq: bool = False, enc_seq: bool = False) -> torch.Tensor:
    lp = fsdp.gather(lp, decoder_block_schema(cfg))
    a_in = rms_norm(h, fsdp.tp_copy(lp["ln1"]) if seq else lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(lp["self_attn"], a_in, cfg, seq)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    Hq = q.shape[2]
    out = attn_lib.attend(q, _kv_for_heads(k, Hq, cfg), _kv_for_heads(v, Hq, cfg), causal=True)
    h = h + _attn_out(lp["self_attn"], out, cfg, seq)
    h = _cross_attend(lp, h, _enc_kv(lp, enc_out, cfg, enc_seq), positions, cfg, seq)
    m_in = rms_norm(h, fsdp.tp_copy(lp["ln2"]) if seq else lp["ln2"], cfg.norm_eps)
    return h + _mlp(lp["mlp"], m_in, cfg, seq)


def _decoder(params: dict, frames, tokens, cfg) -> tuple:
    """The decoder's output and whether it is this rank's slice of the
    sequence: the frames and the tokens each split by their own placement."""
    enc_seq = fsdp.input_split("frames")
    enc_out = encode(params, frames, cfg, enc_seq)
    seq = fsdp.input_split("tokens")
    h = embed_tokens(params, tokens, cfg, seq)
    positions = _whole_positions(h, seq)
    for lp in unstack(params["dec_layers"], cfg.num_layers):
        h = _block(cfg, _dec_block, lp, h, enc_out, positions, cfg, seq, enc_seq)
    return h, seq


def forward(params: dict, frames, tokens, cfg) -> torch.Tensor:
    """Teacher-forced logits (B, S_dec, padded vocab)."""
    h, seq = _decoder(params, frames, tokens, cfg)
    return unembed(params, h, cfg, seq)


def loss_fn(params: dict, batch: dict, cfg) -> tuple:
    """batch: frames (B, S_enc, D), tokens and labels (B, S_dec) (labels
    below 0 masked).  Masked cross-entropy, no aux term."""
    h, seq = _decoder(params, batch["frames"], batch["tokens"], cfg)
    xent = lm_xent(params, h, batch["labels"], cfg, seq)
    return xent, {"loss": xent, "xent": xent}


def cache_schema(cfg, batch: int, capacity: int) -> dict:
    """Decoder KV (L, B, capacity, KV, hd) and the encoder memory's
    cross-attention k/v, always ``ENC_MEMORY`` frames."""
    KV, hd, L = cfg.num_kv_heads, cfg.d_head, cfg.num_layers
    axes = ("layers", "act_batch", "act_kv_seq", "kv_heads", "head_dim")
    kv = ParamSpec((L, batch, capacity, KV, hd), axes, init="zeros", dtype=cfg.dtype)
    enc_kv = ParamSpec((L, batch, ENC_MEMORY, KV, hd), axes, init="zeros", dtype=cfg.dtype)
    return {"k": kv, "v": kv, "enc_k": enc_kv, "enc_v": enc_kv}


def decode_step(params: dict, token, cache: dict, cache_len, cfg) -> tuple:
    """One decoder step; the encoder memory's k/v are in ``cache``.
    ``cache_len`` is a scalar (all lanes aligned); the new self-attention
    entry is written into ``cache`` in place.  Returns (logits (B, V), cache)."""
    h = embed_tokens(params, token, cfg)
    B = h.shape[0]
    n = torch.as_tensor(cache_len, device=h.device).long()
    positions = n.reshape(1, 1).expand(B, 1)
    self_axes, enc_axes = fsdp.kv_seq_axes("k"), fsdp.kv_seq_axes("enc_k")
    for i in range(cfg.num_layers):
        lp = fsdp.gather(tree_map(lambda x: x[i], params["dec_layers"]),
                         decoder_block_schema(cfg))
        kc, vc = cache["k"][i], cache["v"][i]
        a_in = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(lp["self_attn"], a_in, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        write_kv(kc, vc, k, v, n, self_axes)
        h = h + _attn_out(lp["self_attn"], decode_attend(q, kc, vc, n + 1, cfg, axes=self_axes),
                          cfg)
        # cross-attention over the full encoder memory: every position valid
        qx = _cross_q(lp, h, cfg)
        h = h + _attn_out(lp["cross_attn"], decode_attend(
            qx, cache["enc_k"][i], cache["enc_v"][i], n.new_full((), ENC_MEMORY), cfg,
            axes=enc_axes), cfg)
        m_in = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + _mlp(lp["mlp"], m_in, cfg)
    logits = unembed(params, h, cfg)[:, 0]
    return logits, cache
