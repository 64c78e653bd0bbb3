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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
                   shift_state=None) -> tuple:
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.d_head
    xs = token_shift(x, shift_state)
    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mix_{n}"]) for n in "rkvwg")
    r, k, v, g = (_proj_in(xi, p[n]) for xi, n in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                                                    (xg, "wg")))
    # data-dependent decay (Finch), in fp32: w = exp(-exp(w0 + lora(xw)))
    f32 = torch.float32
    dec = p["w0"].to(f32) + torch.tanh(xw.to(f32) @ p["w_lora_a"].to(f32)) @ p["w_lora_b"].to(f32)
    w = torch.exp(-torch.exp(dec)).reshape(B, S, H, hd).to(x.dtype)
    if decode:
        o, new_state = wkv6_decode_step(r, k, v, w, p["u_bonus"], state)
    else:
        o, new_state = ops.wkv(r, k, v, w, p["u_bonus"], init_state=state)
    o = rms_norm(o.reshape(B, S, D), p["ln_x"], cfg.norm_eps) * F.silu(g).reshape(B, S, D)
    out = out_project(p, o.reshape(B, S, H, hd))
    return out, new_state, x[:, -1]


def rwkv6_channel_mix(p: dict, x: torch.Tensor, shift_state=None) -> tuple:
    dt = x.dtype
    xs = token_shift(x, shift_state)
    xk = _mix(x, xs, p["cmix_k"])
    xr = _mix(x, xs, p["cmix_r"])
    k = torch.square(torch.relu(xk @ cast(p["cw_k"], dt)))
    kv = k @ cast(p["cw_v"], dt)
    r = torch.sigmoid(xr @ cast(p["cw_r"], dt))
    return r * kv, x[:, -1]
