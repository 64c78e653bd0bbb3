"""train_step / forward factories.

The port of ``repro/train/step.py::make_train_step``, ``make_forward`` and
``bg_step_factory``: loss, ``torch.autograd.grad`` over the parameter
leaves, then ``optimizer.update`` (which clips and writes in place), for
every family, the encoder-decoder (``frames`` batches) and vision
(``patch_embeds``) ones included.  The jit and sharding wrappers (``jit_train_step`` and friends) wait for the
multi-device layer (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.layers import tree_leaves, tree_map


def make_train_step(api, optimizer):
    if api.loss is None:
        raise NotImplementedError(f"{api.cfg.name}: this ModelAPI has no loss_fn to train")

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = api.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        # tree_leaves and tree_map walk the dict keys in one order
        grads = tree_map(lambda _: next(grads), _sorted(params))
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
    device.  The slice must be one card (a wider one raises, naming the
    multi-device item).

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
    train_step = make_train_step(api, opt)

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
