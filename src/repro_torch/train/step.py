"""train_step / forward factories.

The port of ``repro/train/step.py::make_train_step`` and ``make_forward``:
loss, ``torch.autograd.grad`` over the parameter leaves, then
``optimizer.update`` (which clips and writes in place).  The jit and
sharding wrappers (``jit_train_step`` and friends) wait for the
multi-device layer; ``bg_step_factory`` for executable gap multiplexing.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import tree_leaves, tree_map


def make_train_step(api, optimizer):
    if api.loss is None:
        raise NotImplementedError(
            f"{api.cfg.name}: training the {api.cfg.block_type!r} family waits for "
            "its loss_fn, not ported yet (ROADMAP Queue 1, item 4)")

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
        return api.forward(params, batch["tokens"])

    return fwd
