"""TrainState: a plain dict of params, optimizer state and step.

The port of ``repro/train/state.py``.  The tree is the reference's, so a
saved state loads both ways through ``checkpoint.ckpt``; its specs and
shardings come from the schema (both optimizers' state schemas carry
their leaves' logical axes), so a sharded state is ``device_put(state,
state_shardings(...))``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.dist.sharding import param_pspecs, param_shardings
from repro_torch.models.layers import ParamSpec, abstract_params, init_params, tree_leaves


def state_schema(api, optimizer) -> Dict[str, Any]:
    return {
        "params": api.schema,
        "opt": optimizer.state_schema(api.schema),
        "step": ParamSpec((), (), init="zeros", dtype="int32"),
    }


def init_state(api, optimizer, generator: torch.Generator,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Fresh state on ``device`` (default: the card); ``generator`` must
    live there.  Parameters are leaves that require grad."""
    dev = resolve_device(device)
    params = init_params(api.schema, generator, dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_state(api, optimizer):
    return abstract_params(state_schema(api, optimizer))


def state_pspecs(api, optimizer, rules, mesh, report=None):
    return param_pspecs(state_schema(api, optimizer), rules, mesh, report)


def state_shardings(api, optimizer, rules, mesh, report=None):
    return param_shardings(state_schema(api, optimizer), rules, mesh, report)
