"""Naive attention oracle: full softmax materialization, K/V heads repeated.

The port of ``repro/kernels/ref.py::attention_reference``; deliberately
independent of the blocked formulation in ``flash_attention.py``.
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
