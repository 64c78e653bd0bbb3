"""train_step / forward / decode factories, unsharded and sharded.

The port of ``repro/train/step.py``.  ``make_train_step`` builds the full
step: loss, ``torch.autograd.grad`` over the parameter leaves, an optional
``grad_transform`` (PowerSGD, ``optim/grad_compression.py``), then
``optimizer.update`` (which clips and writes in place), for every family,
the encoder-decoder (``frames`` batches) and vision (``patch_embeds``)
ones included.  Its phases are spans (``repro_torch.spans``):
``train.step`` around the whole, and inside it ``train.forward``,
``train.backward``, ``train.grad_transform`` (when set) and
``train.optimizer``; every step built on it, the sharded one and the
background tenants' included, carries them.

``jit_train_step``, ``jit_forward`` and ``jit_decode_step`` keep the
reference's names so a reader finds the counterpart (``jit_prefill``, the
serving engine's prefill into a placed cache, is the port's own), but
nothing is jitted: each closes the step over a mesh (a ``DeviceMesh``, one process
per position) and returns ``(fn, state or param shardings, batch
shardings)``.  Parameters, optimizer state, batches and caches are
DTensors placed by those shardings (``dist.sharding.device_put``); the
step runs inside ``fsdp.context(mesh, rules)``, where the models gather
each parameter at its use site and compute on this rank's local shards,
and the optimizer updates the DTensor state (whose global-norm clipping
and Adafactor moments reduce over the sharded axes).  Tensor parallelism
over 'model' runs for every family (the dense and MoE blocks, rwkv6,
zamba2, pixtral's vision projection, seamless's encoder-decoder blocks:
``dist/fsdp.py``'s rule), and a decode cache split along its sequence
decodes split-KV, each leaf by its own placement (the same docstring).
Every layout the rules and their overrides give runs: sequence parallelism
where an input's placement splits its sequence over 'model', KV heads split
with the query heads whole, a Mamba-2 ``d_inner`` split over whole heads, a
parameter split on 'model' along an axis outside ``fsdp.TP_AXES`` (gathered
whole at its use) and a cache leaf the divisibility guard keeps whole.
What the placement of the inputs says reaches the models through
``fsdp.context``'s ``layout`` (``_layout``), which refuses with
``ValueError`` an input split along its sequence over another axis than
'model' and a batch split over 'model'.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import fsdp
from repro_torch.dist.sharding import (
    NamedSharding,
    batch_pspecs,
    device_put,
    mesh_axis_sizes,
    param_shardings,
    pspec,
    sharding_rules,
    shardings_of,
)
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.spans import span


def make_train_step(api, optimizer, grad_transform: Optional[Callable] = None):
    if api.loss is None:
        raise NotImplementedError(f"{api.cfg.name}: this ModelAPI has no loss_fn to train")

    def train_step(state, batch):
        with span("train.step"):
            params = state["params"]
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            with span("train.forward"):
                loss, metrics = api.loss(params, batch)
            # autograd's own thread issues the recompute and the backward while
            # this one waits here: their launches fall inside this span by time
            with span("train.backward"):
                grads = iter(torch.autograd.grad(loss, leaves))
                # tree_leaves and tree_map walk the dict keys in one order
                grads = tree_map(lambda _: next(grads), _sorted(params))
            if grad_transform is not None:
                with span("train.grad_transform"):
                    grads = grad_transform(grads)
            with span("train.optimizer"):
                new_params, new_opt = optimizer.update(grads, state["opt"], params)
            new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
            return new_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def _sorted(tree):
    """``tree`` with dict keys in sorted order (``tree_leaves``' order)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def make_forward(api):
    """Full-sequence forward (prefill benchmark shape)."""

    def fwd(params, batch):
        if "frames" in batch:
            return api.forward(params, batch["frames"], batch["tokens"])
        if "patch_embeds" in batch:
            return api.forward(params, batch["tokens"], patch_embeds=batch["patch_embeds"])
        return api.forward(params, batch["tokens"])

    return fwd


def make_decode_step(api):
    def step(params, batch):
        return api.decode_step(params, batch["token"], batch["cache"], batch["cache_len"])

    return step


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _layout(cfg, shape: ShapeConfig, rules, mesh, bt_specs: dict, inputs: dict) -> dict:
    """What the placement of a step's inputs (``bt_specs``, their specs;
    ``inputs``, anything with their shapes) says to the models (``fsdp.context``'s
    ``layout``): the inputs whose sequence is split over 'model' (sequence
    parallelism), with ``"residual"`` among them where the decoder's
    residual stream splits (the tokens, after pixtral's patches: their
    whole length through the same divisibility guard), and for each decode
    cache leaf the live mesh axes its sequence is split over.  An
    input split along its sequence over another axis than 'model', or a
    batch split over 'model', raises ``ValueError``: no model computes on
    such a slice."""
    from repro_torch.dist.sharding import _INPUT_AXES

    sizes = mesh_axis_sizes(mesh)
    live = [a for a in rules.get("act_batch", ()) if sizes.get(a, 1) > 1]
    if "model" in live:
        raise ValueError(f"{cfg.name}: act_batch splits the batch over 'model' ({live}): "
                         "'model' carries the heads, experts or the sequence")
    specs = dict(bt_specs)
    if "tokens" in inputs:
        B, n = inputs["tokens"].shape[:2]
        n += inputs["patch_embeds"].shape[1] if "patch_embeds" in inputs else 0
        specs["residual"] = pspec(("act_batch", "act_seq"), (B, n), rules, mesh)
    seq = set()
    for key, spec in specs.items():
        axes = ("act_batch", "act_seq") if key == "residual" else _INPUT_AXES.get(key, ())
        if key == "cache" or "act_seq" not in axes:
            continue
        d = axes.index("act_seq")
        got = [a for a in _axes_of(spec[d] if d < len(spec) else None) if sizes[a] > 1]
        if set(got) - {"model"}:
            raise ValueError(f"{cfg.name}: the input {key!r} is split along its sequence over "
                             f"{got}: sequence parallelism splits it over 'model' only")
        if got:
            seq.add(key)
    kv_seq = {}
    if "cache" in bt_specs:
        from repro_torch.models.api import get_model

        for key, s in get_model(cfg).cache_schema(shape.global_batch, shape.seq_len).items():
            if "act_kv_seq" in s.axes:
                e = (bt_specs["cache"][key] + (None,) * len(s.axes))[s.axes.index("act_kv_seq")]
                kv_seq[key] = tuple(a for a in _axes_of(e) if sizes[a] > 1)
    return {"seq": frozenset(seq), "kv_seq": kv_seq}


def _local(tree):
    """The local shards of a tree of DTensors (plain 0-d leaves and Python
    numbers pass: a step counter, a cache length)."""
    from torch.distributed.tensor import DTensor

    def one(x):
        if isinstance(x, DTensor):
            return x.to_local()
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            raise TypeError(f"a sharded step takes DTensors (dist.sharding.device_put), "
                            f"got a plain tensor of shape {tuple(x.shape)}")
        return x

    return tree_map(one, tree)


def _from_local(x: torch.Tensor, mesh, spec: tuple):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, mesh, NamedSharding(mesh, spec).placements)


def _logits_spec(api, rules, mesh, ndim: int, seq: bool = False) -> tuple:
    """The spec of this rank's logits: the batch dim split as the batch,
    the vocabulary over 'model' where the unembedding splits it; where it
    keeps the vocabulary whole and ``seq`` (the residual stream is this
    rank's slice of the sequence), the sequence over 'model'."""
    cfg = api.cfg
    name, vocab_dim = ("embed", 0) if cfg.tie_embeddings else ("lm_head", 1)
    w = api.schema[name]
    entry = (pspec(w.axes, w.shape, rules, mesh) + (None,) * 2)[vocab_dim]
    batch = tuple(rules.get("act_batch", ()))
    parts = [None if not batch else batch[0] if len(batch) == 1 else batch]
    parts += [None] * (ndim - 2) + ["model" if entry == "model" else None]
    if seq and entry != "model" and ndim == 3:
        parts[1] = "model"
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def jit_train_step(api, optimizer, mesh, shape: ShapeConfig, rules: Optional[dict] = None,
                   report=None):
    """Returns ``(fn, state_shardings, batch_shardings)``; ``fn(state,
    batch) -> (new_state, metrics)`` on a state and batch placed by them.
    The metrics are plain tensors, equal on every rank (the loss is the
    global batch's)."""
    from repro_torch.models.api import input_specs
    from repro_torch.train.state import state_shardings

    cfg = api.cfg
    rules = rules or sharding_rules(cfg, mesh, shape)
    st_sh = state_shardings(api, optimizer, rules, mesh, report)
    inputs = input_specs(cfg, shape)
    bt_specs = batch_pspecs(cfg, shape, rules, mesh, inputs, report)
    layout = _layout(cfg, shape, rules, mesh, bt_specs, inputs)
    bt_sh = shardings_of(bt_specs, mesh)
    step = make_train_step(api, optimizer)

    def step_with_fsdp(state, batch):
        with fsdp.context(mesh, rules, layout):
            return step(state, _local(batch))

    return step_with_fsdp, st_sh, bt_sh


def jit_forward(api, mesh, shape: ShapeConfig, rules: Optional[dict] = None, report=None):
    """Returns ``(fn, param_shardings, batch_shardings)``; ``fn(params,
    batch)`` gives the logits as a DTensor (batch split as the batch, the
    vocabulary over 'model' where the unembedding splits it)."""
    from repro_torch.models.api import input_specs

    cfg = api.cfg
    rules = rules or sharding_rules(cfg, mesh, shape)
    p_sh = param_shardings(api.schema, rules, mesh, report)
    inputs = input_specs(cfg, shape)
    bt_specs = batch_pspecs(cfg, shape, rules, mesh, inputs, report)
    layout = _layout(cfg, shape, rules, mesh, bt_specs, inputs)
    bt_sh = shardings_of(bt_specs, mesh)
    fwd = make_forward(api)
    spec = _logits_spec(api, rules, mesh, 3, "residual" in layout["seq"])

    @torch.no_grad()
    def fwd_with_fsdp(params, batch):
        with fsdp.context(mesh, rules, layout):
            return _from_local(fwd(params, _local(batch)), mesh, spec)

    return fwd_with_fsdp, p_sh, bt_sh


def jit_decode_step(api, mesh, shape: ShapeConfig, rules: Optional[dict] = None,
                    report=None):
    """Returns ``(fn, param_shardings, batch_shardings)``; ``fn(params,
    batch) -> (logits, cache)``, both DTensors, the cache placed as
    ``batch_shardings["cache"]`` (written in place where the family's
    ``decode_step`` writes in place)."""
    from repro_torch.models.api import input_specs

    cfg = api.cfg
    rules = rules or sharding_rules(cfg, mesh, shape)
    p_sh = param_shardings(api.schema, rules, mesh, report)
    inputs = input_specs(cfg, shape)
    bt_specs = batch_pspecs(cfg, shape, rules, mesh, inputs, report)
    layout = _layout(cfg, shape, rules, mesh, bt_specs, inputs)
    bt_sh = shardings_of(bt_specs, mesh)
    spec = _logits_spec(api, rules, mesh, 2)
    step = make_decode_step(api)

    @torch.no_grad()
    def decode_with_fsdp(params, batch):
        with fsdp.context(mesh, rules, layout):
            logits, cache = step(params, _local(batch))
        cache = tree_map(lambda x, sh: _from_local(x, mesh, sh.spec), cache, bt_sh["cache"])
        return _from_local(logits, mesh, spec), cache

    return decode_with_fsdp, p_sh, bt_sh


def _seq_share(x: torch.Tensor, spec, sharding) -> torch.Tensor:
    """This rank's share of a whole cache leaf along its sequence
    (``act_kv_seq``), as the leaf's own placement (``sharding``) splits it:
    a local slice, no collective.  Inside a ``fsdp.context``."""
    if "act_kv_seq" not in spec.axes:
        return x
    dim = spec.axes.index("act_kv_seq")
    sizes = mesh_axis_sizes(sharding.mesh)
    axes = [a for a in _axes_of((sharding.spec + (None,) * len(spec.axes))[dim])
            if sizes[a] > 1]
    local = x.shape[dim] // math.prod(sizes[a] for a in axes)
    return x.narrow(dim, fsdp.kv_seq_offset(local, axes), local).contiguous()


def jit_prefill(api, mesh, shape: ShapeConfig, rules: Optional[dict] = None,
                report=None):
    """The fused prefill into a cache placed by the rules.  ``shape`` is the
    decode cell (global batch, cache capacity); returns ``(fn,
    param_shardings, cache_shardings)``; ``fn(params, tokens)`` takes the
    (batch, prompt) ids on every rank and gives ``(last-position logits,
    cache)``, both DTensors, the cache placed as ``cache_shardings`` say
    (those of ``jit_decode_step``'s cache).  Each rank runs the prefill on
    its batch rows and heads (tensor parallelism as ``jit_forward``), which
    builds the whole sequence, and keeps its share of it where the rules
    split the cache along its sequence (``act_kv_seq``): a local slice, so
    the placement survives the prefill with no collective."""
    cfg = api.cfg
    if api.prefill is None:
        raise NotImplementedError(f"{cfg.name}: this family has no fused prefill; feed the "
                                  "prompt through the decode step")
    rules = rules or sharding_rules(cfg, mesh, shape)
    p_sh = param_shardings(api.schema, rules, mesh, report)
    schema = api.cache_schema(shape.global_batch, shape.seq_len)
    c_sh = param_shardings(schema, rules, mesh, report)
    spec = _logits_spec(api, rules, mesh, 2)

    @torch.no_grad()
    def prefill_with_fsdp(params, tokens):
        tok_spec = pspec(("act_batch", "act_seq"), tokens.shape, rules, mesh)  # as a batch's
        layout = _layout(cfg, shape, rules, mesh, {"tokens": tok_spec}, {"tokens": tokens})
        with fsdp.context(mesh, rules, layout):
            tokens = _local(device_put(tokens, NamedSharding(mesh, tok_spec)))
            logits, cache = api.prefill(params, tokens, shape.seq_len)
            cache = tree_map(lambda x, s, sh: _from_local(_seq_share(x, s, sh), mesh, sh.spec),
                             cache, schema, c_sh)
        return _from_local(logits, mesh, spec), cache

    return prefill_with_fsdp, p_sh, c_sh


def bg_step_factory(arch: str = "qwen2-1.5b", *, batch: int = 4, seq: int = 8,
                    seed: int = 0, on_loss: Optional[Callable] = None,
                    per_device_batch: Optional[int] = None):
    """``make_bg_step_fn`` for executable gap collocation
    (``Collocator.run_executable``): returns a callable that, given a gap
    slice (``launch.mesh.DeviceSlice``), builds a REAL tiny-LM training
    step on it with a private state replica and issues one step per call.
    ``on_loss`` observes each step's (device-resident) loss.  Shared by
    ``launch/multiplex_demo.py`` and the training entrypoint's --bg-arch
    path.

    The state (from ``torch.Generator`` seeded ``seed``) and the one fixed
    batch every step reuses (seeded ``seed + 1``) are made on the slice's
    device and stream, and each step is issued on that stream, so a step
    never runs ahead of its state and nothing waits for the rest of the
    device.  A slice of several ranks (``launch.mesh.rank_slice``) runs
    ``jit_train_step`` over its ``DeviceMesh``, with the state and batch
    placed by its shardings; every rank of the slice calls the step.

    ``per_device_batch`` sizes the tenant's step to its own chunk width
    (the per-tenant bg step quantum): each step uses
    ``per_device_batch * slice.size`` samples, so a tenant holding a wide
    gap chunk trains a proportionally bigger global batch instead of
    everyone running the batch sized for the global gap minimum.  Without
    it, ``batch`` is the fixed global batch.

    The returned factory carries a ``signature`` attribute
    (``"{arch}-b{batch}-s{seq}-r{seed}"``, or ``-pdb{n}-`` in
    per-device-batch mode) identifying the built step for
    ``ExecutableCache`` reuse across re-plans: two tenants built from
    factories with equal signatures and landing on the same gap slice
    share one step.  (The cache key also carries the slice's position ids
    and shape, so per-device sizing never aliases across chunk widths.)
    """
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model, make_batch
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.state import init_state

    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    opt = make_optimizer(cfg)

    def make_bg_step_fn(mesh):
        dev = mesh.device
        b_global = batch
        if per_device_batch is not None:
            b_global = max(1, per_device_batch * mesh.size)
        with torch.cuda.stream(mesh.stream):  # no-op for None (the CPU)
            holder = {"state": init_state(
                api, opt, torch.Generator(device=dev).manual_seed(seed), dev)}
            b = make_batch(cfg, b_global, seq, torch.Generator(device=dev).manual_seed(seed + 1),
                           dev)
            if mesh.mesh is None:
                train_step = make_train_step(api, opt)
            else:
                train_step, st_sh, bt_sh = jit_train_step(
                    api, opt, mesh.mesh, ShapeConfig("bg", seq, b_global, "train"))
                holder["state"], b = device_put(holder["state"], st_sh), device_put(b, bt_sh)

        def step():
            with torch.cuda.stream(mesh.stream):
                holder["state"], metrics = train_step(holder["state"], b)
            if on_loss is not None:
                on_loss(metrics["loss"])
            return metrics["loss"]

        step.mesh = mesh  # the slice (and stream) the step runs on
        return step

    if per_device_batch is not None:
        make_bg_step_fn.signature = f"{arch}-pdb{per_device_batch}-s{seq}-r{seed}"
    else:
        make_bg_step_fn.signature = f"{arch}-b{batch}-s{seq}-r{seed}"
    return make_bg_step_fn
