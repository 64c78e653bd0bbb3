"""The reference's first steps: the same weights (made again from the seed)
and the same batches as the program's, the loss and gradients of the
configuration's plain reference model, and AdamW, in float32 with TF32
off (or in the control's precision).

``follow`` returns what the check compares: each step's loss, each leaf's
norm of the first (clipped) gradient, and each leaf's norm of the change
of the parameters after the steps.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from bench.reference.common import AdamW, Precision, make_leaf, nest, no_tf32


def model_module(config: dict):
    """The plain reference model the configuration names."""
    return importlib.import_module(f"bench.reference.{config['reference']}")


def follow(config: dict, seed: int, batches: List[dict], device, prec: Precision,
           exact: bool = False) -> Dict[str, object]:
    no_tf32()
    mod = model_module(config)
    m = config["model"]
    specs = mod.schema(m)
    params = {p: make_leaf(s, seed, p, device).requires_grad_(True) for p, s in specs.items()}
    adam = AdamW(params, config["optimizer"])
    losses, first = [], None
    for batch in batches:
        loss = mod.loss(nest(params), batch, m, prec, exact)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        norms = adam.update(params, dict(zip(params, grads)))
        del grads
        first = norms if first is None else first
    with torch.no_grad():
        change = {p: float(torch.linalg.vector_norm(x - make_leaf(specs[p], seed, p, device)))
                  for p, x in params.items()}
    return {"loss": losses, "grad_norm": first, "change_norm": change}
