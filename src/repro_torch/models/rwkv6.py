"""RWKV-6 "Finch" block, in PyTorch — attention-free, data-dependent decay.
[arXiv:2404.05892]

The port of ``repro/models/rwkv6.py``.  Time-mix: per-head linear
recurrence ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` with a per-channel decay
``w_t`` from a low-rank projection, read out as
``o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)``.

The full-sequence path (training, prefill) calls ``kernels.ops.wkv``: the
hand-written CUDA kernel on the card, its plain chunked version
``kernels.wkv6.wkv6_plain`` on the CPU.  That plain version takes the
place of the reference's ``wkv6_chunked``: any S, and exponents never
positive, so it stays finite at every decay where the reference's form
overflows.  Decode carries the ``(B, H, K, V)`` fp32 state through
``wkv6_decode_step``.

Under tensor parallelism over 'model' (``dist/fsdp.py``'s rule) a rank
holds its share of the heads: ``wr``/``wk``/``wv``/``wg`` and the
channel-mix's ``cw_k`` and ``cw_r`` are column-parallel behind
``fsdp.tp_copy``, ``wo`` and ``cw_v`` row-parallel before ``fsdp.tp_sum``;
the decay ``w`` is computed whole and sliced to the local heads, ``ln_x``
normalises over all of D with a statistic summed over the ranks, and
``cw_r``'s split output is gathered (``fsdp.tp_gather``), so ``r * kv``
is replicated.  What is split is read from the gathered shapes.  Under
sequence parallelism (``seq``) each mix gathers the sequence before its
token shift (``fsdp.sp_enter``) and leaves through ``fsdp.sp_exit``;
``dist/fsdp.py``'s rule.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import fsdp
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, _proj_in, cast, out_project, rms_norm

DECAY_RANK = 64


def rwkv6_schema(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    H, hd = cfg.num_heads, cfg.d_head
    return {
        # time-mix
        "mix_r": ParamSpec((D,), ("norm",), init="zeros"),
        "mix_k": ParamSpec((D,), ("norm",), init="zeros"),
        "mix_v": ParamSpec((D,), ("norm",), init="zeros"),
        "mix_w": ParamSpec((D,), ("norm",), init="zeros"),
        "mix_g": ParamSpec((D,), ("norm",), init="zeros"),
        "wr": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wg": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "w_lora_a": ParamSpec((D, DECAY_RANK), ("embed", "norm"), init="small_normal"),
        "w_lora_b": ParamSpec((DECAY_RANK, D), ("norm", "embed"), init="small_normal"),
        "w0": ParamSpec((D,), ("norm",), init="zeros"),
        "u_bonus": ParamSpec((H, hd), ("heads", "head_dim"), init="small_normal"),
        "ln_x": ParamSpec((D,), ("norm",), init="zeros"),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed")),
        # channel-mix
        "cmix_k": ParamSpec((D,), ("norm",), init="zeros"),
        "cmix_r": ParamSpec((D,), ("norm",), init="zeros"),
        "cw_k": ParamSpec((D, F_), ("embed", "mlp")),
        "cw_v": ParamSpec((F_, D), ("mlp", "embed")),
        "cw_r": ParamSpec((D, D), ("embed", "embed_out")),
    }


def token_shift(x: torch.Tensor, prev: torch.Tensor = None) -> torch.Tensor:
    """x: (B,S,D) -> previous token's features (zeros / ``prev`` at position 0)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * torch.sigmoid(mu).to(x.dtype)


def wkv6_decode_step(r, k, v, w, u, state) -> tuple:
    """Single-token step. r/k/v/w: (B,1,H,*); state (B,H,K,V) fp32."""
    f32 = torch.float32
    r0, k0, v0, w0 = (a.to(f32)[:, 0] for a in (r, k, v, w))
    kv = k0[..., :, None] * v0[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r0, state + u.to(f32)[None, :, :, None] * kv)
    state = state * w0[..., None] + kv
    return o[:, None].to(r.dtype), state


def rwkv6_time_mix(p: dict, x: torch.Tensor, cfg, state=None, decode: bool = False,
                   shift_state=None, seq: bool = False) -> tuple:
    """The time mix; under ``seq`` ``x`` is this rank's slice of the
    sequence (and so is the output): with the heads split it enters
    through ``fsdp.sp_enter`` before the token shift, which reads the
    previous position, and every whole parameter this rank's share reads
    enters through ``fsdp.tp_copy``; with them whole the mix runs on the
    gathered sequence, alike on every rank."""
    H = p["wr"].shape[1]  # this rank's heads
    split = H < cfg.num_heads
    if seq and not split:
        out, new_state, last = rwkv6_time_mix(p, fsdp.tp_gather(x, 1), cfg, state)
        return fsdp.sp_slice(out), new_state, last
    if seq:
        x = fsdp.sp_enter(x)
    B, S, D = x.shape
    hd = cfg.d_head
    if seq:  # whole parameters read by this rank's share
        p = dict(p, **{n: fsdp.tp_copy(p[n]) for n in (
            "mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "w0", "w_lora_a", "w_lora_b")})
    enter = fsdp.tp_copy if split and not seq else (lambda t: t)
    xs = token_shift(x, shift_state)
    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mix_{n}"]) for n in "rkvwg")
    r, k, v, g = (_proj_in(enter(xi), p[n]) for xi, n in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                                                           (xg, "wg")))
    # data-dependent decay (Finch), in fp32: w = exp(-exp(w0 + lora(xw)))
    f32 = torch.float32
    dec = p["w0"].to(f32) + torch.tanh(xw.to(f32) @ p["w_lora_a"].to(f32)) @ p["w_lora_b"].to(f32)
    w = torch.exp(-torch.exp(dec)).reshape(B, S, cfg.num_heads, hd).to(x.dtype)
    ln_x = p["ln_x"]
    if split:  # whole, read by this rank's heads
        lo = fsdp.model_rank() * H
        w = enter(w)[:, :, lo:lo + H].contiguous()
        ln_x = fsdp.tp_copy(ln_x)[lo * hd:(lo + H) * hd]
    if decode:
        o, new_state = wkv6_decode_step(r, k, v, w, p["u_bonus"], state)
    else:
        o, new_state = ops.wkv(r, k, v, w, p["u_bonus"], init_state=state)
    o = rms_norm(o.reshape(B, S, H * hd), ln_x, cfg.norm_eps, width=D) * F.silu(g).flatten(-2)
    out = out_project(p, o.reshape(B, S, H, hd))
    out = fsdp.sp_exit(out) if seq else fsdp.tp_sum(out) if split else out
    return out, new_state, x[:, -1]


def rwkv6_channel_mix(p: dict, x: torch.Tensor, cfg, shift_state=None,
                      seq: bool = False) -> tuple:
    """The channel mix; ``cfg`` says whether ``cw_k``/``cw_v`` (its ``d_ff``)
    are split over 'model'.  Under ``seq`` as the time mix: with ``d_ff``
    split it enters through ``fsdp.sp_enter``, ``r * kv`` is this rank's
    partial sum and leaves through ``fsdp.sp_exit`` (``cw_r``'s split
    output is gathered with its gradient reduce-scattered back); with it
    whole the mix runs on the gathered sequence, alike on every rank."""
    dt = x.dtype
    mlp_split = p["cw_k"].shape[1] < cfg.d_ff
    if seq and not mlp_split:
        out, last = rwkv6_channel_mix(p, fsdp.tp_gather(x, 1), cfg)
        return fsdp.sp_slice(out), last
    if seq:
        x = fsdp.sp_enter(x)
    if seq:  # whole parameters read by this rank's share
        p = dict(p, **{n: fsdp.tp_copy(p[n]) for n in ("cmix_k", "cmix_r")})
    enter = fsdp.tp_copy if mlp_split and not seq else (lambda t: t)
    xs = token_shift(x, shift_state)
    xk = _mix(x, xs, p["cmix_k"])
    xr = _mix(x, xs, p["cmix_r"])
    k = torch.square(torch.relu(enter(xk) @ cast(p["cw_k"], dt)))
    kv = k @ cast(p["cw_v"], dt)
    if mlp_split and not seq:
        kv = fsdp.tp_sum(kv)
    if p["cw_r"].shape[1] < x.shape[-1]:  # embed_out split: gathered back to all of D
        if seq:
            r = torch.sigmoid(fsdp.sp_enter(xr @ cast(p["cw_r"], dt), -1))
        else:
            r = torch.sigmoid(fsdp.tp_gather(fsdp.tp_copy(xr) @ cast(p["cw_r"], dt), -1))
    else:
        r = torch.sigmoid(xr @ cast(fsdp.tp_copy(p["cw_r"]) if seq else p["cw_r"], dt))
    out = r * kv
    return (fsdp.sp_exit(out) if seq else out), x[:, -1]
