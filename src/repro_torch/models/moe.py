"""Top-k MoE FFN with capacity-based scatter dispatch, in PyTorch.

The port of ``repro/models/moe.py``.  Each (token, k) pair gets its
(expert, slot) coordinate from a prefix count over the flattened routing
choices, token-major with ``k`` inner; a scatter builds the ``(E, C, D)``
expert buffer, the experts' SwiGLU runs as batched products over it, and a
gather reads each pair's result back, weighted by its renormalised gate.
Tokens beyond an expert's capacity ``C`` are dropped (written nowhere in
the buffer, and read back from slot ``C - 1`` with a zero gate, as the
reference does).  The Switch load-balancing loss is returned beside the
output.

The reference splits the pairs into ``fsdp.group_count('act_tokens')``
groups, which is 1 outside a sharding context; the port has one group.
The expert products are ``torch.bmm``: the reference leaves them to XLA,
outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, cast, swiglu


def moe_schema(cfg) -> dict:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": ParamSpec((D, E), ("embed", "expert"), init="small_normal"),
        "wg": ParamSpec((E, D, F_), ("expert", "embed", "moe_mlp")),
        "wu": ParamSpec((E, D, F_), ("expert", "embed", "moe_mlp")),
        "wd": ParamSpec((E, F_, D), ("expert", "moe_mlp", "embed")),
    }


def _capacity(tokens: int, cfg) -> int:
    c = int(tokens * cfg.experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(cfg.experts_per_tok, c)


def _top_k(probs: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x: (B, S, D) -> (out (B, S, D), aux_loss fp32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    T = B * S
    C = _capacity(T, cfg)
    xt = x.reshape(T, D)

    # --- routing (fp32) ---
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_vals, idx = _top_k(probs, K)  # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)

    # --- slots: prefix count over the (token, k) pairs, token-major ---
    # (the one-hot is laid out (E, TK), so the count runs along the inner
    # axis; each pair's slot is the number of earlier pairs routed to its
    # expert, as the reference's cumsum(onehot) - onehot gives it)
    flat_e = idx.reshape(T * K)
    onehot = (torch.arange(E, device=x.device)[:, None] == flat_e[None, :]).int()
    counts = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    slot = counts.gather(0, flat_e[None, :])[0].long() - 1  # (TK,)
    keep = slot < C
    slot_c = torch.clamp(slot, max=C - 1)

    # --- dispatch: scatter the pairs into (E, C, D) ---
    # The kept pairs' (expert, slot) rows are distinct, so the scatter is a
    # plain write; a dropped pair writes a spare row past the buffer, cut off
    # after the scatter (the reference adds its zeroed source into slot
    # C - 1 instead: the same buffer, and no gradient reaches it either way).
    dt = x.dtype
    row = torch.where(keep, flat_e * C + slot, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=dt, device=x.device).index_put(
        (row,), xt.repeat_interleave(K, dim=0))[:E * C].view(E, C, D)

    # --- expert SwiGLU as batched products ---
    g = torch.bmm(buf, cast(p["wg"], dt))
    u = torch.bmm(buf, cast(p["wu"], dt))
    y = torch.bmm(swiglu(g, u), cast(p["wd"], dt))  # (E, C, D)

    # --- combine: gather each pair's result, weight by its gate ---
    # (index_select: its backward adds into distinct rows, and a dropped
    # pair's zero gradient into slot C - 1, exact in any order)
    out_tk = y.view(E * C, D).index_select(0, flat_e * C + slot_c)  # (TK, D)
    w = (gate_vals.reshape(T * K) * keep.float()).to(dt)
    out = (out_tk * w[:, None]).reshape(T, K, D).sum(dim=1)
    return out.reshape(B, S, D), aux
