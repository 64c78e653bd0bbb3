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

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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


_WIDTH_AXES = ("embed", "embed_out", "vocab")  # the weight matrices' model-width axes


def keeps_fp32(spec: ParamSpec) -> bool:
    """Whether a serving copy keeps this leaf in fp32, as the reference
    reads it (it holds fp32 parameters and casts the matrices at each use):
    every leaf with no model-width axis (norm scales, biases, RWKV's bonus,
    Mamba-2's ``dt_bias``/``A_log``/gate norm), every leaf with a 'norm'
    axis (RWKV's decay LoRA), and the MoE router (last axis 'expert'),
    which routes in fp32.  The rest are the weight matrices, which every
    family reads in the compute dtype."""
    return ("norm" in spec.axes or spec.axes[-1] == "expert"
            or not any(a in _WIDTH_AXES for a in spec.axes))


def _std(spec: ParamSpec) -> float:
    if spec.init in ("embed", "small_normal"):
        return spec.scale if spec.scale is not None else 0.02
    return spec.scale if spec.scale is not None else 1.0 / math.sqrt(_fan_in(spec.shape))


_INIT_CHUNK = 1 << 26  # elements drawn in fp32 at a time


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device: torch.device, dtype=None) -> torch.Tensor:
    """One leaf in ``dtype`` (default: the spec's): zeros, ones, or a normal
    draw of the reference's std, written chunk by chunk (at most
    ``_INIT_CHUNK`` elements, a slice of the stacked layers axis or less,
    in fp32 at a time), so no fp32 copy of the whole leaf exists."""
    dt = as_dtype(dtype or spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    std = _std(spec)
    out = torch.empty(spec.shape, dtype=dt, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _INIT_CHUNK):
        n = min(_INIT_CHUNK, flat.numel() - i)
        x = torch.randn((n,), generator=generator, device=device, dtype=torch.float32)
        flat[i:i + n] = x.mul_(std)
    return out


def init_params(schema: Any, generator: torch.Generator,
                device: DeviceLike = None, dtype=None) -> Any:
    """Random parameters for ``schema`` on ``device`` (default: the card).
    ``generator`` must live on that device.  Each leaf is made in its
    spec's dtype, or with ``dtype`` (a serving dtype) every weight matrix in
    it and the ``keeps_fp32`` leaves in fp32: the tree
    ``serve.engine.serving_params`` makes, without an fp32 copy of the model
    ever existing."""
    dev = resolve_device(device)
    return tree_map(lambda s: init_leaf(
        s, generator, dev,
        None if dtype is None else torch.float32 if keeps_fp32(s) else dtype), schema)


def abstract_params(schema: Any) -> Any:
    """The schema as ``meta``-device tensors: shapes and dtypes, no storage
    (the reference's ShapeDtypeStructs)."""
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=as_dtype(s.dtype), device="meta"), schema)


def logical_axes(schema: Any) -> Any:
    return tree_map(lambda s: s.axes, schema)


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
# Rematerialisation
# ---------------------------------------------------------------------------

# products without batch dimensions: (tokens, D) x (D, F) weight matmuls;
# the attention scores (bmm, or the flash kernel) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg, block: Callable, *args):
    """``block(*args)`` under ``cfg.remat_policy``, for every family's layer
    loop (the reference's ``_maybe_remat``): ``"full"`` saves only the
    layer's inputs (non-reentrant ``torch.utils.checkpoint``), ``"dots"``
    also saves the weight matmuls' outputs (the counterpart of
    ``checkpoint_dots_with_no_batch_dims``), ``"none"`` saves everything.
    Any other value raises.  The reference's rwkv6 and zamba2 stacks take
    ``"dots"`` as ``"full"``; here it means the same in every family."""
    if cfg.remat_policy == "none":
        return block(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(block, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return checkpoint(block, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Numerics helpers
# ---------------------------------------------------------------------------


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(as_dtype(dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, width: int = 0) -> torch.Tensor:
    """RMS norm over the last axis.  Given a ``width`` larger than that
    axis, ``x`` and ``scale`` are this rank's channels of a width split
    over 'model': the sum of squares is summed over the ranks, and enters
    the local compute through ``fsdp.tp_copy``."""
    dt = x.dtype
    x = x.float()
    if width > x.shape[-1]:
        from repro_torch.dist import fsdp

        var = fsdp.tp_copy(fsdp.tp_sum(x.square().sum(dim=-1, keepdim=True))) / width
    else:
        var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 vocab_parallel: bool = False, seq: bool = False) -> torch.Tensor:
    """logits (B, S, V) any float dtype; labels int (B, S). fp32 reduction:
    the mean over ``mask``-weighted positions of ``logsumexp - gold``.

    Inside a sharding context the mean is over the global batch: the
    numerator and the denominator are summed over every rank that holds a
    share of the tokens (``fsdp.token_sum``: the batch axes, and 'model'
    where ``seq`` says the positions are this rank's slice of the
    sequence), never a mean of per-rank means.  With ``vocab_parallel``
    the logits are this rank's contiguous slice of the vocabulary: the row
    max, the exponentials' sum and the gold logit are reduced over
    ``model``."""
    from repro_torch.dist import fsdp

    logits = logits.float()
    if vocab_parallel:
        top = fsdp.model_max(logits.max(dim=-1).values)
        logz = torch.log(fsdp.tp_sum(torch.exp(logits - top[..., None]).sum(dim=-1))) + top
        V = logits.shape[-1]
        local = labels.long() - fsdp.model_rank() * V
        inside = (local >= 0) & (local < V)
        gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        gold = fsdp.tp_sum(gold * inside.float())
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if fsdp.batch_shards() == 1 and not (seq and fsdp.model_size() > 1):
        if mask is None:
            return nll.mean()
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return fsdp.token_sum((nll * mask).sum(), seq) / torch.clamp(
        fsdp.token_sum(mask.sum(), seq), min=1.0)


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
