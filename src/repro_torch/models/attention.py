"""Attention execution paths, in PyTorch.

The port of ``repro/models/attention.py``:
  - ``full_attention``    : materializes (Sq, Skv) scores.
  - ``blocked_attention`` : a loop over query blocks; memory bounded by
                            block_q x Skv.
  - ``decode_attention``  : single-query attention against a KV cache
                            (plain PyTorch on every device; the reference
                            has no decode kernel), and its split form over
                            a cache split along its sequence
                            (``decode_attention_partial``,
                            ``merge_partials``) with the owner-rank write
                            ``cache_write`` (``dist/fsdp.py``'s rule).
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


def _decode_scores(q, k_cache, cache_len, window, softcap, offset=0) -> torch.Tensor:
    """Masked fp32 scores (B, KV, G, 1, Skv) of one query per lane over a
    cache whose first entry sits at global position ``offset``: valid where
    ``pos < cache_len`` and, with a window, ``pos >= cache_len - window``."""
    B, _, H, hd = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd) * (1.0 / math.sqrt(hd))
    scores = _softcap(_gqa_scores(qg, k_cache), softcap)  # (B,KV,G,1,Skv)
    k_pos = torch.arange(Skv, device=q.device) + offset
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = k_pos[None, :] < n  # (B or 1, Skv)
    if window and window > 0:
        valid &= k_pos[None, :] >= (n - window)
    return scores + torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single new query (B, 1, H, hd) attends over the valid prefix of the
    cache (B, Skv, KV, hd); ``cache_len`` is a scalar or (B,) lengths."""
    B, _, H, hd = q.shape
    p = torch.softmax(_decode_scores(q, k_cache, cache_len, window, softcap), dim=-1)
    return _gqa_out(p, v_cache).reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_partial(q, k_slice, v_slice, cache_len, offset, *, window: int = 0,
                             softcap: float = 0.0) -> tuple:
    """The split form of ``decode_attention`` over one slice of the cache,
    whose first entry is global position ``offset`` (masked by global
    position, as the whole cache is) -> (out (B, 1, H, hd), lse (B, 1, H)),
    both fp32: the attention over this slice alone and its row's
    log-sum-exp.  A slice whose every position is masked gets an ``lse``
    near ``NEG_INF``, so ``merge_partials`` weighs it 0."""
    B, _, H, hd = q.shape
    s = _decode_scores(q, k_slice, cache_len, window, softcap, offset)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = _gqa_out(e / l, v_slice).reshape(B, 1, H, hd)
    lse = (m + torch.log(l)).reshape(B, H, 1).transpose(1, 2)  # (B,KV,G,1,1) -> (B,1,H)
    return out, lse


def merge_partials(out, lse, seq_max, seq_sum) -> torch.Tensor:
    """The slices' partials merged through each row's log-sum-exp, in fp32:
    ``m = seq_max(lse)``, ``w = exp(lse - m)``, ``seq_sum(out w) /
    seq_sum(w)``.  ``seq_max`` and ``seq_sum`` reduce over the slices
    (``dist.fsdp``'s all-reduces across ranks, or reductions over a stacked
    leading axis); both sums go through one ``seq_sum`` call."""
    w = torch.exp(lse - seq_max(lse))[..., None]
    total = seq_sum(torch.cat([out * w, w], dim=-1))
    return total[..., :-1] / total[..., -1:]


def cache_write(cache: torch.Tensor, new: torch.Tensor, n: torch.Tensor, offset=0) -> None:
    """Write the new entry ``new`` (B, 1, KV, hd) at global position ``n``
    (a 0-d tensor, or (B,) per-lane positions) into ``cache`` (B, S_loc,
    KV, hd), a slice of the cache starting at ``offset``, in place: a lane
    whose position lies outside the slice keeps its old entry (the index is
    clamped and the old value written back), so no value is read on the
    host."""
    S = cache.shape[1]
    local = n - offset
    hit = (local >= 0) & (local < S)
    idx = local.clamp(0, S - 1)
    new = new.to(cache.dtype)
    if n.dim() == 1:  # continuous batching: ragged lanes
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = torch.where(hit.reshape(-1, 1, 1), new[:, 0], cache[rows, idx])
    else:  # index_select, not cache[:, idx]: a 0-d index would be read on the host
        idx = idx.reshape(1)
        cache.index_copy_(1, idx, torch.where(hit, new, cache.index_select(1, idx)))


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
