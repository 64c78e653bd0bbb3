"""PowerSGD gradient compression with error feedback [Vogels et al. 2019].

The port of ``repro/optim/grad_compression.py``.  Each 2-D view G (m×n)
of a gradient is compressed to rank-r factors P (m×r), Q (n×r); only P and
Q are averaged over the data-parallel ranks (r·(m+n) ≪ m·n), and the
compression error is fed back into the next step's gradient.

Two entry points:
  - ``powersgd_allreduce``: over a process group (the reference's
    ``shard_map`` path): per-rank gradients in, the same decompressed
    gradient out on every rank;
  - ``compress_decompress`` with no group: the gradient transform of
    ``train.step.make_train_step(grad_transform=...)``, which turns the
    gradient into its low-rank approximation plus error feedback.

Plain ``torch.linalg.qr`` and matmuls, as the reference computes them
outside any Pallas kernel.  The starting Q factors come from a
``torch.Generator``, so they differ from the reference's ``jax.random``
draw; its tests carry the reference's Q into the state.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


def _orthonormalize(m: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt via QR (columns)."""
    q, _ = torch.linalg.qr(m.float())
    return q


def _as_matrix(g: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    shape = tuple(g.shape)
    if g.dim() == 1:
        return g.reshape(1, -1), shape
    return g.reshape(-1, shape[-1]), shape


def init_state(params: Any, rank: int = 4, seed: int = 0) -> Dict[str, Any]:
    """Q factors (standard normal, from a ``torch.Generator`` seeded
    ``seed``, drawn leaf by leaf in ``tree_leaves`` order) and zeroed
    error-feedback buffers, in the structure of ``params``."""
    gen = torch.Generator().manual_seed(seed)

    def one(p):
        n = _as_matrix(p.detach())[0].shape[1]
        q = torch.randn((n, rank), generator=gen, dtype=torch.float32).to(p.device)
        return {"q": q, "err": torch.zeros_like(p, dtype=torch.float32)}

    return tree_map(one, _sorted(params))


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    y = x.clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


def compress_decompress(grads: Any, state: Any, rank: int = 4,
                        group: Optional[Any] = None) -> Tuple[Any, Any]:
    """One PowerSGD round per leaf.  With ``group`` (a process group) the
    P/Q factors, and the tiny leaves that go uncompressed, are averaged
    over its ranks; otherwise local.  Returns (approx_grads, new_state)."""

    def one(g, st):
        gf = g.float() + st["err"]
        m2, shape = _as_matrix(gf)
        if min(m2.shape) <= rank:  # tiny leaves: exact
            exact = _mean(gf, group) if group is not None else gf
            return exact.to(g.dtype), {"q": st["q"], "err": torch.zeros_like(st["err"])}
        p = m2 @ st["q"]  # (m, r)
        if group is not None:
            p = _mean(p, group)
        p = _orthonormalize(p)
        q = m2.T @ p  # (n, r)
        if group is not None:
            q = _mean(q, group)
        approx = (p @ q.T).reshape(shape)
        return approx.to(g.dtype), {"q": q, "err": gf - approx}

    return _split(_map_pairs(one, grads, state))


def _map_pairs(fn, grads, state):
    """``fn(grad, leaf_state)`` over the gradient tree; a leaf's state is
    the dict ``{"q", "err"}`` at the gradient leaf's path."""
    if isinstance(grads, dict):
        return {k: _map_pairs(fn, grads[k], state[k]) for k in grads}
    return fn(grads, state)


def _split(out):
    """A tree of (approx, state) pairs -> (approx tree, state tree)."""
    if isinstance(out, dict):
        parts = {k: _split(v) for k, v in out.items()}
        return ({k: v[0] for k, v in parts.items()}, {k: v[1] for k, v in parts.items()})
    return out


def powersgd_allreduce(grads: Any, state: Any, group: Any, rank: int = 4):
    """Per-rank gradients -> the same decompressed mean gradient on every
    rank of ``group`` (the reference's ``shard_map`` entry point)."""
    return compress_decompress(grads, state, rank=rank, group=group)


def compression_ratio(params: Any, rank: int = 4) -> float:
    """Bytes over the wire vs a dense all-reduce."""
    dense = comp = 0
    for p in tree_leaves(params):
        shape = tuple(p.shape)
        m, n = (1, shape[0]) if len(shape) == 1 else (math.prod(shape[:-1]), shape[-1])
        dense += m * n
        comp += (m + n) * rank if min(m, n) > rank else m * n
    return comp / max(dense, 1)
