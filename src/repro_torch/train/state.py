"""TrainState: a plain dict of params, optimizer state and step.

The port of ``repro/train/state.py`` (the single-device part; sharding
waits for the multi-device layer).  The tree is the reference's, so a
saved state loads both ways through ``checkpoint.ckpt``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.layers import ParamSpec, init_params, tree_leaves


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
