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

Under tensor parallelism over 'model' (``dist/fsdp.py``'s rule) a rank
holds a contiguous share of ``d_inner``, which is its share of the heads:
``wx``/``wz``/``wdt`` are column-parallel behind ``fsdp.tp_copy``, the
whole ``B``/``C`` projections enter through ``fsdp.tp_copy``, the SSD runs
on the local heads, ``gate_norm`` normalises over all of ``d_inner`` with
a statistic summed over the ranks, and ``wo`` is row-parallel before
``fsdp.tp_sum``.  The decode state keeps ``ssm`` split by heads and
``conv`` by channels.  Where the rules split ``d_inner`` while the heads
stay whole, a rank's channels are gathered to all of them after the conv
and the scan runs over every head, alike on every rank; ``gate_norm``'s
statistic is over all of ``d_inner``, and this rank's channels feed the
row-parallel ``wo``.  Under sequence parallelism (``seq``) the input enters
through ``fsdp.sp_enter`` in place of ``fsdp.tp_copy`` (the causal conv reads
the positions before each one), the whole ``B``/``C`` weights through
``fsdp.tp_copy``, and the output leaves through ``fsdp.sp_exit``
(``dist/fsdp.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import fsdp
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


def mamba2_apply(p: dict, u: torch.Tensor, cfg, state=None, decode: bool = False,
                 seq: bool = False) -> tuple:
    """u: (B, S, D). Returns (out (B, S, D), new state).

    Full sequence: ``state`` is an optional (B, H, P, N) initial SSM state
    and the new state is the final one.  Decode carries state =
    (ssm_state (B, H, P, N) fp32, conv_state (B, K-1, din)), the conv
    window's tail, so decode matches the full-sequence conv exactly.  Under
    ``seq`` ``u`` is this rank's slice of the sequence, and so is the
    output: the causal conv reads the positions before each one, so the
    input is gathered first."""
    dt_c = u.dtype
    P = cfg.ssm_head_dim
    H = p["wdt"].shape[1]  # this rank's heads
    split = H < cfg.ssm_heads
    channels = p["wx"].shape[1] < cfg.ssm_d_inner  # d_inner split over 'model'
    if split and not channels:
        raise ValueError(f"{cfg.name}: the Mamba-2 heads split over 'model' while d_inner "
                         f"({cfg.ssm_d_inner}) stays whole: a rank's heads have no channels")
    if seq and not split:  # whole heads: the gathered sequence, alike on every rank
        out, new_state = mamba2_apply(p, fsdp.tp_gather(u, 1), cfg, state)
        return fsdp.sp_slice(out), new_state
    B, S = u.shape[0], u.shape[1] * (fsdp.model_size() if seq else 1)
    uin = fsdp.sp_enter(u) if seq else fsdp.tp_copy(u) if channels else u
    x = uin @ cast(p["wx"], dt_c)
    z = uin @ cast(p["wz"], dt_c)
    if decode:
        ssm_state, conv_state = state
        window = torch.cat([conv_state.to(dt_c), x], dim=1)  # (B, K, din)
        xc = torch.einsum("bki,ki->bi", window, cast(p["conv_w"], dt_c))[:, None]
        x = F.silu(xc + cast(p["conv_b"], dt_c))
        new_conv_state = window[:, 1:]
        state = ssm_state
    else:
        x = causal_conv1d(x, cast(p["conv_w"], dt_c), cast(p["conv_b"], dt_c))
    lo = fsdp.model_rank() * x.shape[-1]
    if channels and not split:  # whole heads: this rank's channels gathered to all of them
        x, z = fsdp.tp_gather(x, -1).contiguous(), fsdp.tp_gather(z, -1)
    if seq:  # the whole B/C weights read by this rank's heads
        Bm = uin @ cast(fsdp.tp_copy(p["wB"]), dt_c)
        Cm = uin @ cast(fsdp.tp_copy(p["wC"]), dt_c)
    else:
        Bm = u @ cast(p["wB"], dt_c)
        Cm = u @ cast(p["wC"], dt_c)
        if split:  # whole, read by this rank's heads
            Bm, Cm = fsdp.tp_copy(Bm), fsdp.tp_copy(Cm)
    f32 = torch.float32
    dtv = F.softplus(((uin if split else u) @ cast(p["wdt"], dt_c)).to(f32)
                     + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    xh = x.reshape(B, S, H, P)
    if decode:
        y, new_state = ssd_decode_step(xh, dtv, A, Bm, Cm, state)
    else:
        y, new_state = ops.ssd(xh, dtv, A, Bm, Cm, init_state=state)
    y = y + xh * cast(p["D_skip"], dt_c)[:, None]
    y = y.reshape(B, S, H * P) * F.silu(z)
    if channels and not split:  # normed over all of d_inner, then this rank's channels
        yf = y.float()
        yf = yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + cfg.norm_eps)
        C = p["gate_norm"].shape[0]
        y = (fsdp.tp_copy(yf)[..., lo:lo + C] * (1.0 + p["gate_norm"].float())).to(dt_c)
    else:
        y = rms_norm(y, p["gate_norm"], cfg.norm_eps, width=cfg.ssm_d_inner)
    out = y @ cast(p["wo"], dt_c)
    if seq:
        out = fsdp.sp_exit(out)
    elif channels:
        out = fsdp.tp_sum(out)
    if decode:
        return out, (new_state, new_conv_state)
    return out, new_state
