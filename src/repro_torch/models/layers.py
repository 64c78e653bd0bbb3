"""Core layers + parameter-schema machinery, in PyTorch.

The port of ``repro/models/layers.py``.  A model is described by a
*schema*: a nested dict of ``ParamSpec`` leaves, with the reference's tree
paths, shapes and logical axes (the stacked ``layers`` axis included).
``init_params`` turns a schema into tensors from an explicit
``torch.Generator`` with the reference's std rules; the values differ from
JAX's PRNG, so parity tests carry weights over through
``repro_torch.checkpoint.ckpt`` instead.

Weights keep the reference layouts: q/k/v ``(D, H, hd)``, o ``(H, hd, D)``,
MLP ``(D, F)``/``(F, D)``.  Plain products go to ``torch.matmul``, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, as_dtype, resolve_device

# ---------------------------------------------------------------------------
# Param schema
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed' | 'small_normal'
    dtype: str = "float32"
    scale: Optional[float] = None  # override init std

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts (and of matching ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in the reference's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _fan_in(shape: tuple) -> int:
    if len(shape) == 1:
        return shape[0]
    return int(max(1, math.prod(shape[:-1])))


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    dt = as_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init in ("embed", "small_normal"):
        std = spec.scale if spec.scale is not None else 0.02
    else:
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(_fan_in(spec.shape))
    x = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * std).to(dt)


def init_params(schema: Any, generator: torch.Generator,
                device: DeviceLike = None) -> Any:
    """Random parameters for ``schema`` on ``device`` (default: the card).
    ``generator`` must live on that device."""
    dev = resolve_device(device)
    return tree_map(lambda s: init_leaf(s, generator, dev), schema)


def zeros(schema: Any, device: torch.device) -> Any:
    """Zeroed tensors of each spec's shape and dtype (KV caches)."""
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=as_dtype(s.dtype), device=device), schema)


def stack_schema(schema: Any, n: int) -> Any:
    """Prepend a stacked 'layers' axis to every spec."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.dtype, s.scale),
        schema,
    )


def unstack(layers: dict, n: int) -> list:
    """Per-layer views of a stacked tree through one ``unbind`` per leaf,
    so the backward pass stacks each leaf's gradient once (indexing layer
    by layer would add a zero-filled full-size gradient per layer)."""
    parts = tree_map(lambda x: x.unbind(0), layers)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def param_count(schema: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(schema))


# ---------------------------------------------------------------------------
# Numerics helpers
# ---------------------------------------------------------------------------


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(as_dtype(dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, S, V) any float dtype; labels int (B, S). fp32 reduction:
    the mean over ``mask``-weighted positions of ``logsumexp - gold``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, d_head); positions: (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Schema builders and applies for common sub-modules
# ---------------------------------------------------------------------------


def attention_schema(cfg) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    s: dict = {
        "wq": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def mlp_schema(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "wg": ParamSpec((D, F_), ("embed", "mlp")),
        "wu": ParamSpec((D, F_), ("embed", "mlp")),
        "wd": ParamSpec((F_, D), ("mlp", "embed")),
    }


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bsd,dhk->bshk as one matmul over the flattened (h, k)."""
    D, h, k = w.shape
    return (x @ cast(w, x.dtype).reshape(D, h * k)).unflatten(-1, (h, k))


def qkv_project(p: dict, x: torch.Tensor, cfg) -> tuple:
    dt = x.dtype
    q, k, v = (_proj_in(x, p[n]) for n in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + cast(p["bq"], dt)
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    return q, k, v


def out_project(p: dict, attn_out: torch.Tensor) -> torch.Tensor:
    """bshk,hkd->bsd."""
    h, k, D = p["wo"].shape
    return attn_out.flatten(-2) @ cast(p["wo"], attn_out.dtype).reshape(h * k, D)


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ cast(p["wg"], dt)
    u = x @ cast(p["wu"], dt)
    return swiglu(g, u) @ cast(p["wd"], dt)
