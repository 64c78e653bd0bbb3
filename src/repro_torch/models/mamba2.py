"""Mamba-2 (SSD — state space duality) block, in PyTorch. [arXiv:2405.21060]

The port of ``repro/models/mamba2.py``.  Layout: x ``(B, S, H, P)`` heads;
B/C projections shared across heads (ngroups = 1), state size N; a scalar
decay ``A`` and step ``dt`` per head.

The full-sequence path (training, prefill) calls ``kernels.ops.ssd``: the
hand-written CUDA kernel on the card, its plain chunked version
``kernels.ssd_scan.ssd_plain`` on the CPU.  That plain version takes the
place of the reference's ``_segsum``/``ssd_chunked``: any S, and the
segment sums masked to ``-inf`` before ``exp``.  Decode carries the
``(B, H, P, N)`` fp32 state and the conv window's tail through
``ssd_decode_step``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, cast, rms_norm


def mamba2_schema(cfg) -> dict:
    D, din = cfg.d_model, cfg.ssm_d_inner
    N, H = cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv
    return {
        "wx": ParamSpec((D, din), ("embed", "ssm_inner")),
        "wz": ParamSpec((D, din), ("embed", "ssm_inner")),
        "wB": ParamSpec((D, N), ("embed", "ssm_state")),
        "wC": ParamSpec((D, N), ("embed", "ssm_state")),
        "wdt": ParamSpec((D, H), ("embed", "heads")),
        "dt_bias": ParamSpec((H,), ("heads",), init="zeros"),
        "A_log": ParamSpec((H,), ("heads",), init="zeros"),
        "D_skip": ParamSpec((H,), ("heads",), init="ones"),
        "conv_w": ParamSpec((K, din), ("norm", "ssm_inner"), init="small_normal"),
        "conv_b": ParamSpec((din,), ("ssm_inner",), init="zeros"),
        "gate_norm": ParamSpec((din,), ("ssm_inner",), init="zeros"),
        "wo": ParamSpec((din, D), ("ssm_inner", "embed")),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. x: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):  # K is tiny (4): unrolled adds, as the reference
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def ssd_decode_step(x, dt, A, Bm, Cm, state) -> tuple:
    """Single-token step. x (B, 1, H, P), dt (B, 1, H), A (H,), Bm/Cm
    (B, 1, N), state (B, H, P, N) fp32 -> (y (B, 1, H, P), new state)."""
    f32 = torch.float32
    xb = x.to(f32)[:, 0] * dt.to(f32)[:, 0, :, None]  # (B, H, P)
    dec = torch.exp(dt.to(f32)[:, 0] * A.to(f32))  # (B, H)
    upd = torch.einsum("bhp,bn->bhpn", xb, Bm.to(f32)[:, 0])
    state = state * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm.to(f32)[:, 0])
    return y[:, None].to(x.dtype), state


def mamba2_apply(p: dict, u: torch.Tensor, cfg, state=None, decode: bool = False) -> tuple:
    """u: (B, S, D). Returns (out (B, S, D), new state).

    Full sequence: ``state`` is an optional (B, H, P, N) initial SSM state
    and the new state is the final one.  Decode carries state =
    (ssm_state (B, H, P, N) fp32, conv_state (B, K-1, din)), the conv
    window's tail, so decode matches the full-sequence conv exactly."""
    dt_c = u.dtype
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    B, S, _ = u.shape
    x = u @ cast(p["wx"], dt_c)
    z = u @ cast(p["wz"], dt_c)
    if decode:
        ssm_state, conv_state = state
        window = torch.cat([conv_state.to(dt_c), x], dim=1)  # (B, K, din)
        xc = torch.einsum("bki,ki->bi", window, cast(p["conv_w"], dt_c))[:, None]
        x = F.silu(xc + cast(p["conv_b"], dt_c))
        new_conv_state = window[:, 1:]
        state = ssm_state
    else:
        x = causal_conv1d(x, cast(p["conv_w"], dt_c), cast(p["conv_b"], dt_c))
    Bm = u @ cast(p["wB"], dt_c)
    Cm = u @ cast(p["wC"], dt_c)
    f32 = torch.float32
    dtv = F.softplus((u @ cast(p["wdt"], dt_c)).to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    xh = x.reshape(B, S, H, P)
    if decode:
        y, new_state = ssd_decode_step(xh, dtv, A, Bm, Cm, state)
    else:
        y, new_state = ops.ssd(xh, dtv, A, Bm, Cm, init_state=state)
    y = y + xh * cast(p["D_skip"], dt_c)[:, None]
    y = y.reshape(B, S, H * P)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ cast(p["wo"], dt_c)
    if decode:
        return out, (new_state, new_conv_state)
    return out, new_state
