"""Naive oracles: full-softmax attention, the sequential SSD and WKV-6.

The port of ``repro/kernels/ref.py``: ``attention_reference`` (K/V heads
repeated, full softmax), ``ssd_reference`` and ``wkv6_reference`` (one
step at a time), deliberately independent of the blocked and chunked
formulations in ``flash_attention.py``, ``ssd_scan.py`` and ``wkv6.py``.
"""
from __future__ import annotations

import math

import torch


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Sq, H, d), k/v (B, Skv, KV, d) -> (B, Sq, H, d) in q's dtype."""
    B, Sq, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    kr = k.repeat_interleave(G, dim=2).float()
    vr = v.repeat_interleave(G, dim=2).float()
    qf = q.float() / math.sqrt(d)
    s = torch.einsum("bshd,bthd->bhst", qf, kr)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    ok = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    s = torch.where(ok[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, vr)
    return o.to(q.dtype)


def ssd_reference(x, dt, A, Bm, Cm, init_state=None) -> tuple:
    """Sequential SSM recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t.  x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, N),
    init_state (B, H, P, N) -> (y in x's dtype, final state fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    xb = x.to(f32) * dt.to(f32)[..., None]
    dec = torch.exp(dt.to(f32) * A.to(f32))
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for t in range(S):
        b_t, c_t = Bm[:, t].to(f32), Cm[:, t].to(f32)
        h = h * dec[:, t, :, None, None] + xb[:, t, :, :, None] * b_t[:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, c_t))
    return torch.stack(ys, 1).to(x.dtype), h


def wkv6_reference(r, k, v, w, u, init_state=None) -> tuple:
    """Sequential WKV-6: o_t = r_t.(S_{t-1} + diag(u) k_t v_t^T);
    S_t = diag(w_t) S_{t-1} + k_t v_t^T.  r/k/w (B, S, H, K), v (B, S, H, V),
    u (H, K), init_state (B, H, K, V) -> (o in r's dtype, final state fp32).
    No decay clip, as the reference oracle."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if init_state is None else init_state.to(f32))
    uf = u.to(f32)[None, :, :, None]
    outs = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (a[:, t].to(f32) for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, s + uf * kv))
        s = s * w_t[..., None] + kv
    return torch.stack(outs, 1).to(r.dtype), s
