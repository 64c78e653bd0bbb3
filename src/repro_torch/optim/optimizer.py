"""Optimizers + LR schedules, in PyTorch.

The port of ``repro/optim/optimizer.py``: the WSD, cosine and constant
schedules, ``global_norm``/``clip_by_global_norm`` and AdamW with
decoupled weight decay on leaves with ``ndim >= 2``.  Parameters and state
are nested dicts of tensors in the reference's layout (``{"m", "v",
"count"}``), so checkpoints carry over both ways.

Unlike the reference's pure ``update``, ``adamw``'s ``update`` writes the
new moments and parameters in place (under ``no_grad``) and returns the
same tensors: at rwkv6-1.6b's 1.6 B fp32 parameters a functional update
would hold a second copy of parameters and moments, 19 GB.  Adafactor
(qwen2-72b, grok-1) is not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.layers import ParamSpec, tree_leaves, tree_map

# ---------------------------------------------------------------------------
# LR schedules: step (a number) -> learning rate (a float)
# ---------------------------------------------------------------------------


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.1) -> Callable:
    """MiniCPM's warmup-stable-decay [arXiv:2404.06395]."""

    def lr(step):
        step = float(step)
        warm = peak_lr * min(step / max(warmup, 1), 1.0)
        in_decay = min(max((step - warmup - stable) / max(decay, 1), 0.0), 1.0)
        dec = peak_lr * (1.0 - (1.0 - floor_frac) * in_decay)
        return warm if step < warmup + stable else dec

    return lr


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    def lr(step):
        step = float(step)
        warm = peak_lr * min(step / max(warmup, 1), 1.0)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + math.cos(math.pi * t)))
        return warm if step < warmup else cos

    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: float(lr_val)


# ---------------------------------------------------------------------------
# Optimizer interface
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> opt_state
    update: Callable  # (grads, opt_state, params) -> (new_params, new_opt_state)
    state_schema: Callable  # param schema -> opt-state schema (ParamSpec tree)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float) -> tuple:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(
    lr: Callable,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1.0e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        count = state["count"] + 1
        cf = float(count)
        lr_t = lr(cf)
        bc1, bc2 = 1 - b1 ** cf, 1 - b2 ** cf

        def upd(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if p.dim() >= 2:
                step.add_(p.float(), alpha=weight_decay)
            p.copy_(p.float() - lr_t * step)

        for g, m, v, p in zip(*(tree_leaves(t) for t in (grads, state["m"], state["v"],
                                                          params))):
            upd(g, m, v, p)
        return params, {"m": state["m"], "v": state["v"], "count": count}

    def state_schema(schema):
        moment = lambda s: ParamSpec(s.shape, s.axes, init="zeros", dtype="float32")
        return {
            "m": tree_map(moment, schema),
            "v": tree_map(moment, schema),
            "count": ParamSpec((), (), init="zeros", dtype="int32"),
        }

    return Optimizer(init, update, state_schema)


def make_optimizer(cfg, total_steps: int = 10_000) -> Optimizer:
    if cfg.optimizer == "adafactor":
        raise NotImplementedError(
            f"{cfg.name}: adafactor is not ported yet (ROADMAP Queue 1, item 5)")
    if cfg.name.startswith("minicpm"):
        sched = wsd_schedule(1e-3 * 0.3, warmup=int(0.01 * total_steps),
                             stable=int(0.79 * total_steps), decay=int(0.2 * total_steps))
    else:
        sched = cosine_schedule(3e-4, warmup=min(2000, total_steps // 10), total=total_steps)
    return adamw(sched)
