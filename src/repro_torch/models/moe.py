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

As in the reference, the pairs are split into
``fsdp.group_count('act_tokens')`` groups (1 outside a sharding context;
the data axes' size when the tokens split over them), each with its own
capacity ``max(K, C // groups)`` of the global ``C``, so slots are counted
within a group and a data shard's scatter never leaves it.  A rank holds
the groups of its batch shard; where one group spans every rank's rows
(the serving engine's steps, which route the whole batch as one group as
the reference's engine does), the ranks' top-k choices, a few bytes a
token, are gathered over the batch axes to count each pair's slot over the
whole batch, and each rank dispatches its own pairs into those slots.  The
load-balancing loss is over the global batch (``fsdp.batch_sum``).  The
``fsdp.constrain`` sites are the reference's.  The expert products are
``torch.bmm``: the reference leaves them to XLA, outside any Pallas
kernel.

Over a 'model' axis (``dist/fsdp.py``'s rule), read from the gathered
shapes:

  - expert parallelism (the router's and the experts' ``expert`` axis
    split): the router's column-parallel logits leave through
    ``fsdp.tp_gather``, so routing, gates and the aux loss are replicated;
    the dispatch buffer is built whole, as in the reference, then enters
    through ``fsdp.tp_copy`` and is sliced to this rank's experts (no
    collective); the experts' outputs leave through ``fsdp.tp_gather``
    along the experts, the reference's all-gather over the EP axis, so the
    combine is replicated;
  - tensor-parallel experts (``moe_mlp`` split): the buffer enters through
    ``fsdp.tp_copy``, ``wg``/``wu`` are column-parallel and ``wd``
    row-parallel before ``fsdp.tp_sum``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import fsdp
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
    shards = fsdp.batch_shards()  # ranks the batch is split over
    T_all = T * shards
    C = _capacity(T_all, cfg)
    xt = x.reshape(T, D)

    El = p["wg"].shape[0]  # this rank's experts: all, or its share under EP
    expert_split = El < E
    ff_split = p["wg"].shape[2] < cfg.moe_d_ff

    # --- routing (fp32) ---
    if p["router"].shape[1] < E:  # the router's experts split: gathered back
        logits = fsdp.tp_gather(fsdp.tp_copy(xt).float() @ p["router"].float(), -1)
    else:
        logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate_vals, idx = _top_k(probs, K)  # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e, over the
    # global batch
    top1 = F.one_hot(idx[:, 0], E).float()
    if shards == 1:
        me, ce = probs.mean(dim=0), top1.mean(dim=0)
    else:
        me = fsdp.batch_sum(probs.sum(dim=0)) / T_all
        ce = fsdp.batch_sum(top1.sum(dim=0)) / T_all
    aux = E * torch.sum(me * ce)

    # --- group-local slots: a prefix count over each group's (token, k)
    # pairs, token-major (the one-hot is laid out (G, E, TKg), so the count
    # runs along the inner axis; each pair's slot is the number of earlier
    # pairs of its group routed to its expert, as the reference's
    # cumsum(onehot) - onehot gives it) ---
    groups = fsdp.group_count("act_tokens")
    while (T_all * K) % groups != 0:  # defensive, as the reference
        groups //= 2
    # one group over every rank's rows (the serving engine, as the
    # reference's outside any context): each pair's slot counts the pairs of
    # the whole batch before it, from the ranks' top-k choices gathered in
    # the batch's order
    spans = groups == 1 and shards > 1
    if groups % shards and not spans:
        raise ValueError(f"{groups} token groups over a batch split {shards} ways")
    G = 1 if spans else groups // shards  # this rank's groups
    TKg = T * K // G
    Cg = max(K, C // groups)
    flat_e = idx.reshape(G, TKg)
    every = fsdp.batch_gather(idx.reshape(1, T * K), dim=1) if spans else flat_e
    onehot = (torch.arange(E, device=x.device)[None, :, None] == every[:, None, :]).int()
    counts = torch.cumsum(onehot, dim=2, dtype=torch.int32)
    slot = counts.gather(1, every[:, None, :])[:, 0].long() - 1
    if spans:  # this rank's pairs
        slot = slot.narrow(1, fsdp.batch_index() * T * K, T * K)
    keep = slot < Cg
    slot_c = torch.clamp(slot, max=Cg - 1)
    base = (torch.arange(G, device=x.device)[:, None] * E + flat_e) * Cg  # (G, TKg)

    # --- dispatch: scatter the pairs into (G, E, Cg, D) ---
    # The kept pairs' (group, expert, slot) rows are distinct, so the scatter
    # is a plain write; a dropped pair writes a spare row past the buffer, cut
    # off after the scatter (the reference adds its zeroed source into slot
    # Cg - 1 instead: the same buffer, and no gradient reaches it either way).
    dt = x.dtype
    src = fsdp.constrain(xt.repeat_interleave(K, dim=0).view(G, TKg, D),
                         ("act_tokens", None, "act_embed"))
    row = torch.where(keep, base + slot, G * E * Cg).reshape(-1)
    buf = torch.zeros((G * E * Cg + 1, D), dtype=dt, device=x.device).index_put(
        (row,), src.reshape(-1, D))[:G * E * Cg].view(G, E, Cg, D)
    buf = fsdp.constrain(buf, ("act_tokens", None, None, "act_embed"))
    buf = fsdp.constrain(buf, ("act_tokens", "act_expert", None, "act_embed"))

    if expert_split or ff_split:
        buf = fsdp.tp_copy(buf)
    if expert_split:  # this rank's experts: a local slice
        lo = fsdp.model_rank() * El
        buf = buf[:, lo:lo + El]

    # --- expert SwiGLU as batched products over each expert's slots ---
    xe = buf.reshape(El, Cg, D) if G == 1 else buf.transpose(0, 1).reshape(El, G * Cg, D)
    g = torch.bmm(xe, cast(p["wg"], dt))
    u = torch.bmm(xe, cast(p["wu"], dt))
    for t in (g, u):
        fsdp.constrain(t.view(G, El, -1, t.shape[-1]), ("act_tokens", "act_expert", None,
                                                        "act_moe_ff"))
    y = torch.bmm(swiglu(g, u), cast(p["wd"], dt))  # (El, G * Cg, D)
    if ff_split:
        y = fsdp.tp_sum(y)
    if G > 1:
        y = y.view(El, G, Cg, D).transpose(0, 1)
    y = fsdp.constrain(y.reshape(G, El, Cg, D), ("act_tokens", "act_expert", None,
                                                 "act_embed"))
    if expert_split:  # all-gather over the EP axis
        y = fsdp.tp_gather(y, 1)
    y = fsdp.constrain(y, ("act_tokens", None, None, "act_embed"))

    # --- combine: gather each pair's result, weight by its gate ---
    # (index_select: its backward adds into distinct rows, and a dropped
    # pair's zero gradient into slot Cg - 1, exact in any order)
    out_tk = y.reshape(G * E * Cg, D).index_select(0, (base + slot_c).reshape(-1))
    out_tk = fsdp.constrain(out_tk.view(G, TKg, D), ("act_tokens", None, "act_embed"))
    w = (gate_vals.reshape(G, TKg) * keep.float()).to(dt)
    out = (out_tk * w[..., None]).reshape(T, K, D).sum(dim=1)
    return out.reshape(B, S, D), aux
