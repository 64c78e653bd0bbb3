"""The WKV-6 recurrence, plain:

    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)     S_t = diag(w_t) S_{t-1} + k_t v_t^T

over r/k/w ``(B, S, H, K)``, v ``(B, S, H, V)``, u ``(H, K)``, with the
decays clipped to ``[1e-6, 1]``, from a zero state.

``wkv6_steps`` walks it step by step, one product per step for the
read-out: the statement of the recurrence, and the form whose products
``FlopCounterMode`` counts for the model-FLOP formula.  ``wkv6_chunked``
is a frozen copy of the port's plain chunked form (``wkv6_plain``, chunks of
16 steps, every decay exponent a masked sum of exactly the ``log w`` steps
it spans, so no exponent is positive): the same function at a cost that
fits a full-size step; the tests hold the two together.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

W_MIN = 1e-6
CHUNK = 16
F32 = torch.float32


def wkv6_steps(r, k, v, w, u) -> torch.Tensor:
    B, S, H, K = r.shape
    V = v.shape[-1]
    w = torch.clamp(w, W_MIN, 1.0)
    state = r.new_zeros((B, H, K, V))
    out = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, K, V)
        read = (r[:, t, :, None, :] @ (state + u[None, :, :, None] * kv))[:, :, 0]
        out.append(read)  # (B, H, V)
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(out, 1)


def _masks(L: int, device) -> tuple:
    i = torch.arange(L, device=device)
    t, j, m = i[:, None, None], i[None, :, None], i[None, None, :]
    return (((j < m) & (m < t)).to(F32), (i[None, :] < i[:, None]).to(F32),
            (i[None, :] > i[:, None]).to(F32))


def wkv6_chunked(r, k, v, w, u) -> torch.Tensor:
    B, S, H, K = r.shape
    V = v.shape[-1]
    L = CHUNK
    pad = (-S) % L
    rf, kf, vf = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
    lw = F.pad(torch.log(torch.clamp(w, W_MIN, 1.0)), (0, 0, 0, 0, 0, pad))
    n = (S + pad) // L
    rc, kc, lwc = (x.reshape(B, n, L, H, K) for x in (rf, kf, lw))
    vc = vf.reshape(B, n, L, H, V)
    between, before, after = _masks(L, r.device)

    decay = torch.exp(torch.einsum("tjm,bnmhk->bntjhk", between, lwc))
    A = (rc[:, :, :, None] * kc[:, :, None, :] * decay).sum(-1)  # (B, n, t, j, H)
    A = A * before[None, None, :, :, None]
    diag = (rc * u * kc).sum(-1)
    o = torch.einsum("bntjh,bnjhv->bnthv", A, vc) + diag[..., None] * vc

    r_in = rc * torch.exp(torch.einsum("tm,bnmhk->bnthk", before, lwc))
    k_out = kc * torch.exp(torch.einsum("jm,bnmhk->bnjhk", after, lwc))
    chunk_states = torch.einsum("bnjhk,bnjhv->bnhkv", k_out, vc)
    chunk_decay = torch.exp(lwc.sum(2))
    state = r.new_zeros((B, H, K, V))
    prev = []
    for c in range(n):
        prev.append(state)
        state = state * chunk_decay[:, c, :, :, None] + chunk_states[:, c]
    o = o + torch.einsum("bnthk,bnhkv->bnthv", r_in, torch.stack(prev, 1))
    return o.reshape(B, n * L, H, V)[:, :S]
