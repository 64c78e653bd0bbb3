"""Attention execution paths, in PyTorch.

The port of ``repro/models/attention.py``:
  - ``full_attention``    : materializes (Sq, Skv) scores.
  - ``blocked_attention`` : a loop over query blocks; memory bounded by
                            block_q x Skv.
  - ``decode_attention``  : single-query attention against a KV cache
                            (plain PyTorch on every device; the reference
                            has no decode kernel).
  - ``attend``            : what the model forward passes call.  On CUDA
                            every prefill goes to ``kernels.ops.attention``
                            (the hand-written flash kernel), whatever its
                            length; on the CPU it picks full or blocked by
                            length, exactly as the reference does.

All paths implement GQA natively (no KV head repetition) plus causal,
sliding-window masking and grok-style logit soft-capping, with the finite
``NEG_INF``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

NEG_INF = -1.0e30


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """Additive mask (Sq, Skv) in fp32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,KV,G,hd), k: (B,Skv,KV,hd) -> (B,KV,G,Sq,Skv) fp32."""
    return torch.einsum("bsngh,btnh->bngst", q.float(), k.float())


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,KV,G,Sq,Skv) fp32, v: (B,Skv,KV,hd) -> (B,Sq,KV,G,hd)."""
    return torch.einsum("bngst,btnh->bsngh", p, v.to(p.dtype))


def full_attention(q, k, v, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd) * (1.0 / math.sqrt(hd))
    scores = _softcap(_gqa_scores(qg, k), softcap)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    p = torch.softmax(scores, dim=-1)
    return _gqa_out(p, v).reshape(B, Sq, H, hd).to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, block_q: int = 512) -> torch.Tensor:
    """Loop over query blocks; each block softmaxes over its full (masked)
    key row, so peak memory is O(block_q x Skv) per head group."""
    B, Sq, H, hd = q.shape
    if Sq % block_q != 0 or Sq <= block_q:
        return full_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    outs = [
        full_attention(q[:, i:i + block_q], k, v, causal=causal, window=window,
                       softcap=softcap, q_offset=i)
        for i in range(0, Sq, block_q)
    ]
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single new query (B, 1, H, hd) attends over the valid prefix of the
    cache (B, Skv, KV, hd); ``cache_len`` is a scalar or (B,) lengths."""
    B, _, H, hd = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd) * (1.0 / math.sqrt(hd))
    scores = _softcap(_gqa_scores(qg, k_cache), softcap)  # (B,KV,G,1,Skv)
    k_pos = torch.arange(Skv, device=q.device)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = k_pos[None, :] < n  # (B or 1, Skv)
    if window and window > 0:
        valid &= k_pos[None, :] >= (n - window)
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]
    p = torch.softmax(scores + bias, dim=-1)
    return _gqa_out(p, v_cache).reshape(B, 1, H, hd).to(q.dtype)


def attend(q, k, v, *, causal=True, window=0, softcap=0.0, block_q=512,
           min_blocked_len=2048):
    """Shape-dispatching attention used by the model forward passes: the
    flash kernels on the card (and on meta tensors, which model it)."""
    if q.device.type in ("cuda", "meta"):
        return ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.shape[1] >= min_blocked_len:
        return blocked_attention(
            q, k, v, causal=causal, window=window, softcap=softcap, block_q=block_q
        )
    return full_attention(q, k, v, causal=causal, window=window, softcap=softcap)
