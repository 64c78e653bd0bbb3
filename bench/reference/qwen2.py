"""Plain Qwen2 decoder [arXiv:2407.10671], as the port computes it, in
float32: the loss of one batch.

Per layer, pre-norm (RMS norm, the scale stored as its offset from 1):
grouped-query attention with biases on q, k and v, rotary embeddings on
q and k (the two halves of each head rotated, ``theta`` from the
configuration), causal softmax attention scaled by ``1/sqrt(d_head)``;
then a SwiGLU MLP ``(silu(x W_g) * (x W_u)) W_d``.  A final RMS norm and
the tied embedding as the head, over the padded vocabulary the port
holds (its padding rows take part in the softmax, as in the port).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import Leaf, Precision, checkpointed, lm_loss, rms_norm

BLOCK_Q = 1024  # query rows of one block of the attention


def schema(m: dict) -> dict:
    L, D, F_ = m["num_layers"], m["d_model"], m["d_ff"]
    H, KV, hd, V = m["num_heads"], m["num_kv_heads"], m["d_head"], m["padded_vocab"]
    s = {"embed": Leaf((V, D), 0.02), "final_norm": Leaf((D,))}
    layer = {
        "ln1": Leaf((D,)), "ln2": Leaf((D,)),
        "attn/wq": Leaf.normal((D, H, hd), D), "attn/wk": Leaf.normal((D, KV, hd), D),
        "attn/wv": Leaf.normal((D, KV, hd), D), "attn/wo": Leaf.normal((H, hd, D), H * hd),
        "attn/bq": Leaf((H, hd)), "attn/bk": Leaf((KV, hd)), "attn/bv": Leaf((KV, hd)),
        "mlp/wg": Leaf.normal((D, F_), D), "mlp/wu": Leaf.normal((D, F_), D),
        "mlp/wd": Leaf.normal((F_, D), F_),
    }
    for path, leaf in layer.items():
        s[f"layers/{path}"] = Leaf((L,) + leaf.shape, leaf.std)
    return s


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, d) at positions 0..S-1."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=x.dtype, device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=x.dtype, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, exact: bool = False) -> torch.Tensor:
    """Causal attention, query head ``h`` on KV head ``h // (H / KV)``.
    q (B, S, H, d), k/v (B, S, KV, d).  Blocks of ``BLOCK_Q`` query rows,
    each against the keys up to its last row, masked; ``exact`` takes one
    row at a time against exactly its live keys (small sizes: the tests,
    the FLOP count)."""
    B, S, H, d = q.shape
    G = H // k.shape[2]
    q = q.transpose(1, 2) / math.sqrt(d)  # (B, H, S, d)
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    rows = 1 if exact else BLOCK_Q
    out = []
    for i in range(0, S, rows):
        end = min(i + rows, S)
        s = q[:, :, i:end] @ k[:, :, :end].transpose(-1, -2)  # (B, H, r, end)
        if not exact:
            qp = torch.arange(i, end, device=q.device)[:, None]
            s = s.masked_fill(torch.arange(end, device=q.device)[None, :] > qp, float("-inf"))
        out.append(torch.softmax(s, -1) @ v[:, :, :end])
    return torch.cat(out, 2).transpose(1, 2)  # (B, S, H, d)


def _block(h: torch.Tensor, p: dict, m: dict, prec: Precision, exact: bool) -> torch.Tensor:
    B, S, D = h.shape
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["d_head"]
    a, at = prec.act, p["attn"]
    x = a(rms_norm(h, p["ln1"], m["norm_eps"]))
    q = a(prec.mm(x, at["wq"].reshape(D, H * hd)).reshape(B, S, H, hd) + at["bq"])
    k = a(prec.mm(x, at["wk"].reshape(D, KV * hd)).reshape(B, S, KV, hd) + at["bk"])
    v = a(prec.mm(x, at["wv"].reshape(D, KV * hd)).reshape(B, S, KV, hd) + at["bv"])
    q, k = a(rope(q, m["rope_theta"])), a(rope(k, m["rope_theta"]))
    o = a(attention(q, k, v, exact))
    h = a(h + prec.mm(o.reshape(B, S, H * hd), at["wo"].reshape(H * hd, D)))
    x = a(rms_norm(h, p["ln2"], m["norm_eps"]))
    mp = p["mlp"]
    gate = a(a(F.silu(prec.mm(x, mp["wg"]))) * prec.mm(x, mp["wu"]))
    return a(h + prec.mm(gate, mp["wd"]))


def loss(params: dict, batch: dict, m: dict, prec: Precision, exact: bool = False) -> torch.Tensor:
    """The mean cross-entropy of ``batch`` (``tokens``, ``labels``).  Each
    layer is recomputed in the backward pass."""
    h = prec.act(params["embed"][batch["tokens"]])
    layers = params["layers"]
    parts = {k: {n: t.unbind(0) for n, t in v.items()} if isinstance(v, dict) else v.unbind(0)
             for k, v in layers.items()}
    for i in range(m["num_layers"]):
        p = {k: {n: t[i] for n, t in v.items()} if isinstance(v, dict) else v[i]
             for k, v in parts.items()}
        h = checkpointed(lambda x, q: _block(x, q, m, prec, exact), h, p)
    h = prec.act(rms_norm(h, params["final_norm"], m["norm_eps"]))
    return lm_loss(h, params["embed"], batch["labels"], prec, transpose=True)
