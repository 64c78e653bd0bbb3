"""Mesh-shape-driven sharding-rules engine.

The port of ``repro/dist/sharding.py``.  A *rule set* maps logical axis
names (the vocabulary of ``models/layers.py``) to tuples of mesh axis
names.  ``sharding_rules`` derives one rule set per (ModelConfig, mesh,
ShapeConfig) cell; ``pspec`` turns a (logical-axes, shape) pair into a
spec under the reference's three invariants:

  1. divisibility guard — a dim whose size is not divisible by the product
     of its mesh axes is left unsharded, and the drop is recorded in a
     ``RuleReport``;
  2. no mesh-axis reuse — one mesh axis shards at most one dim per array;
     later occurrences are dropped;
  3. trailing-``None`` trimming — specs are canonical.

A spec is a plain tuple, equal element by element to the reference's
``PartitionSpec``: ``None``, one mesh axis name, or a tuple of names
(outermost first).  ``placements(spec, mesh)`` turns it into DTensor
placements, and ``NamedSharding``/``device_put`` place tensors by it.

Everything here reads only the mesh's axis names and shape: a
``DeviceMesh``'s ``mesh_dim_names`` and ``shape``, or a stand-in's
``axis_names`` and ``devices.shape`` (``launch.mesh.AbstractMesh``, the
tests' fakes).  So rule derivation works on meshes no process could
build.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch._device import as_dtype

# Mesh axes that carry the sample/FSDP dimension (ordered: outermost first).
DP_AXES = ("pod", "data")

# Per-device weight-byte budget above which serving cells keep FSDP on the
# 'embed' dim (small models replicate their weights instead — the all-gather
# would dominate decode latency).
SERVE_FSDP_BYTES = 2e9


@dataclass
class RuleReport:
    """Record of sharding rules dropped by the divisibility guard.

    ``dropped`` entries are ``(logical_axis, dim_size, mesh_axes_product)``.
    """

    dropped: List[Tuple[str, int, int]] = field(default_factory=list)

    def note_dropped(self, axis: str, dim: int, total: int) -> None:
        self.dropped.append((axis, dim, total))


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_shape(mesh) -> Tuple[int, ...]:
    devices = getattr(mesh, "devices", None)
    return tuple(devices.shape if devices is not None else mesh.shape)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), mesh_shape(mesh)))


def dp_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_axis_sizes(mesh)
    return tuple(a for a in DP_AXES if a in sizes)


def pspec(dims, shape, rules, mesh, report: Optional[RuleReport] = None) -> tuple:
    """The spec of an array with logical ``dims`` and concrete ``shape``.

    ``dims`` entries may be ``None`` (dimension never sharded).  Rules map
    each logical axis to a tuple of mesh axes; missing rules mean replicated.
    """
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    parts: list = []
    for name, dim in zip(dims, shape):
        axes = tuple(rules.get(name, ())) if name is not None else ()
        axes = tuple(a for a in axes if a in sizes)
        if not axes or any(a in used for a in axes):
            parts.append(None)
            continue
        total = int(math.prod(sizes[a] for a in axes))
        if total > 1 and dim % total != 0:
            if report is not None:
                report.note_dropped(name, dim, total)
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes[0] if len(axes) == 1 else axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def sharding_rules(cfg, mesh, shape_cfg=None) -> Dict[str, Tuple[str, ...]]:
    """Derive the logical-axis -> mesh-axes rule set for one benchmark cell.

    ``shape_cfg=None`` means the training layout (the elastic checkpoint
    path re-derives rules mesh-by-mesh without a shape).  All decisions are
    pure functions of (cfg, mesh shape, shape kind) — no device state.
    """
    sizes = mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = dp_axes(mesh)
    dp_size = int(math.prod(sizes[a] for a in dp)) if dp else 1
    kind = shape_cfg.kind if shape_cfg is not None else "train"
    batch = shape_cfg.global_batch if shape_cfg is not None else None

    def tp(enabled: bool, n: int) -> Tuple[str, ...]:
        return ("model",) if (enabled and n and n % model == 0) else ()

    heads = tp(cfg.attn_tp, cfg.num_heads)
    kv_heads = tp(cfg.kv_tp, cfg.num_kv_heads)
    expert_par = bool(
        cfg.is_moe and cfg.moe_parallelism == "expert" and cfg.num_experts % model == 0
    )

    # FSDP on 'embed': always during training; in serving only when the
    # per-device weight bytes (post-TP, in the serving dtype) exceed the budget.
    if kind == "train":
        embed = dp
    else:
        per_dev = cfg.n_params() * as_dtype(cfg.dtype).itemsize / max(model, 1)
        embed = dp if per_dev > SERVE_FSDP_BYTES else ()

    # Activation batch/token dims ride the DP axes when divisible.
    act_batch = dp if (batch is None or (dp_size and batch % dp_size == 0)) else ()
    act_tokens = dp if (
        shape_cfg is None or (dp_size and shape_cfg.tokens % dp_size == 0)
    ) else ()

    # KV-cache sequence dim (decode): recover parallelism lost elsewhere —
    # DP axes when the batch cannot shard (long-context batch=1), the model
    # axis when the kv heads cannot shard (GQA kv < model-axis width).
    act_kv_seq: list = []
    if kind == "decode":
        if not act_batch:
            act_kv_seq += list(dp)
        if not kv_heads:
            act_kv_seq.append("model")

    return {
        # -- weights --------------------------------------------------------
        "layers": (),
        "norm": (),
        "head_dim": (),
        "head_dim2": (),
        "conv_k": (),
        "ssm_state": (),
        "embed": embed,
        "embed_out": tp(True, cfg.d_model),
        "heads": heads,
        "kv_heads": kv_heads,
        "mlp": tp(True, cfg.d_ff),
        "vocab": tp(True, cfg.padded_vocab),
        "expert": ("model",) if expert_par else (),
        "moe_mlp": tp(cfg.is_moe and not expert_par, cfg.moe_d_ff),
        "ssm_inner": tp(bool(cfg.ssm_state), cfg.ssm_d_inner),
        # -- activations ----------------------------------------------------
        "act_batch": act_batch,
        "act_tokens": act_tokens,
        "act_seq": ("model",) if cfg.sequence_parallel else (),
        "act_embed": (),
        "act_kv_seq": tuple(act_kv_seq),
        "act_expert": ("model",) if expert_par else (),
        "act_moe_ff": tp(cfg.is_moe and not expert_par, cfg.moe_d_ff),
    }


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where dim ``d`` of the array is split over that mesh axis,
    else ``Replicate()``.  A dim split over several axes (``("pod",
    "data")``) is split over them outermost first, as the reference's
    ``PartitionSpec`` splits it, so their order must be the mesh's.  An
    axis of size 1 splits nothing and is ``Replicate()``, so a leaf's
    placements on such an axis never differ from its gathered layout's."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes} out of the mesh's "
                             f"axis order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _place(x, sharding: NamedSharding):
    """One tensor onto ``sharding``: a DTensor whose local shard every rank
    cuts from its own copy of ``x`` (no communication; every rank must hold
    the same ``x``), on the mesh's device type.  ``x`` lies on that device
    type already, or on the CPU or the meta device (a restored or abstract
    state); a tensor on another device raises ``ValueError``: it is never
    moved to make the mesh's collectives work.  A 0-d tensor or a number
    is returned as it is: a step counter or a cache length, replicated by
    construction."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        if x.device_mesh == sharding.mesh:
            return x.redistribute(sharding.mesh, sharding.placements)
        x = x.full_tensor()
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    mesh = sharding.mesh
    if x.device.type not in (mesh.device_type, "cpu", "meta"):
        raise ValueError(f"a tensor on {x.device} cannot be placed on a "
                         f"{mesh.device_type} mesh: build it on the mesh's device")
    out = distribute_tensor(x.detach(), mesh, sharding.placements, src_data_rank=None)
    return out.requires_grad_(x.requires_grad)


def _tree_map(fn, *trees):
    # imported here: models' modules import the hooks built on this module
    from repro_torch.models.layers import tree_map

    return tree_map(fn, *trees)


def device_put(tree: Any, shardings: Any) -> Any:
    """``jax.device_put(tree, shardings)``: every leaf placed as the
    matching ``NamedSharding`` of the ``shardings`` tree says."""
    return _tree_map(lambda x, s: _place(x, s), tree, shardings)


# ---------------------------------------------------------------------------
# Schema trees -> spec / NamedSharding trees
# ---------------------------------------------------------------------------


def param_pspecs(schema, rules, mesh, report: Optional[RuleReport] = None):
    """Map a ParamSpec tree to a spec tree under ``rules``."""
    return _tree_map(lambda s: pspec(s.axes, s.shape, rules, mesh, report), schema)


def param_shardings(schema, rules, mesh, report: Optional[RuleReport] = None):
    return _tree_map(
        lambda s: NamedSharding(mesh, pspec(s.axes, s.shape, rules, mesh, report)), schema)


# Logical axes of the non-cache model inputs, by input name.
_INPUT_AXES: Dict[str, Tuple[str, ...]] = {
    "tokens": ("act_batch", "act_seq"),
    "labels": ("act_batch", "act_seq"),
    "frames": ("act_batch", "act_seq", "act_embed"),
    "patch_embeds": ("act_batch", "act_seq", "act_embed"),
    "token": ("act_batch", "act_seq"),
    "cache_len": (),
}


def batch_pspecs(cfg, shape_cfg, rules, mesh, specs,
                 report: Optional[RuleReport] = None):
    """Spec tree matching an ``input_specs`` dict.

    Plain inputs are mapped by name via ``_INPUT_AXES``; the decode ``cache``
    subtree re-derives its logical axes from the model's cache schema (the
    input specs carry only shapes and dtypes).
    """
    out: Dict[str, Any] = {}
    for key, spec in specs.items():
        if key == "cache":
            from repro_torch.models.api import get_model

            schema = get_model(cfg).cache_schema(shape_cfg.global_batch, shape_cfg.seq_len)
            out[key] = param_pspecs(schema, rules, mesh, report)
            continue
        axes = _INPUT_AXES.get(key, ())
        ndim = len(spec.shape)
        axes = tuple(axes[:ndim]) + (None,) * (ndim - len(axes))
        out[key] = pspec(axes, spec.shape, rules, mesh, report)
    return out


def shardings_of(specs: Any, mesh) -> Any:
    """A spec tree -> the ``NamedSharding`` tree on ``mesh``."""
    if isinstance(specs, dict):
        return {k: shardings_of(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, specs)
