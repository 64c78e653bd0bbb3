"""Optimizers + LR schedules, in PyTorch.

The port of ``repro/optim/optimizer.py``: the WSD, cosine and constant
schedules, ``global_norm``/``clip_by_global_norm``, AdamW with decoupled
weight decay on leaves with ``ndim >= 2``, and Adafactor (qwen2-72b,
grok-1) with factored second moments over the last two dims.  Parameters
and state are nested dicts of tensors in the reference's layout (AdamW's
``{"m", "v", "count"}``, Adafactor's ``{"stats", "count"}``), so
checkpoints carry over both ways.

Unlike the reference's pure ``update``, both ``update``s write the new
state and parameters in place (under ``no_grad``) and return the same
tensors: at rwkv6-1.6b's 1.6 B fp32 parameters a functional update would
hold a second copy of parameters and moments, 19 GB.

Each ``update`` marks its global-norm clip as the span ``optim.clip`` and
its loop over the leaves as ``optim.update`` (``repro_torch.spans``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.layers import ParamSpec, tree_leaves, tree_map
from repro_torch.spans import span

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
            # on the host: the schedule reads it every update, and reading
            # a device scalar would wait for the step's stream each time.
            # ``torch.tensor`` keeps it a real value under FakeTensorMode
            # (launch/dryrun.py), where ``float(count)`` must still work
            "count": torch.tensor(0, dtype=torch.int32),
        }

    @torch.no_grad()
    def update(grads, state, params):
        with span("optim.clip"):
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

        with span("optim.update"):
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


# ---------------------------------------------------------------------------
# Adafactor (factored second moments over the trailing two dims)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _param_stats(params, stats) -> list:
    """(param, its stats dict) pairs in ``tree_leaves``' order: a stats
    tree is the parameter tree with a dict of moments at each leaf."""
    if isinstance(params, dict):
        return [pair for k in sorted(params) for pair in _param_stats(params[k], stats[k])]
    return [(params, stats)]


def adafactor(
    lr: Callable,
    decay: float = 0.8,
    eps: float = 1.0e-30,
    clip_threshold: float = 1.0,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    """Adafactor [arXiv:1804.04235] as the reference has it: no first
    moment; for a leaf whose last two dims are both >= 2 the second moment
    is factored into row (``vr``) and column (``vc``) means, else a full
    ``v``; ``beta = 1 - count^-decay``; the update clipped to RMS
    ``clip_threshold`` per leaf, after global-norm clipping of the
    gradients; no weight decay."""

    def init(params):
        def st(p):
            if _factored(p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device),
                }
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        # the count on the host, as adamw's
        return {"stats": tree_map(st, params), "count": torch.tensor(0, dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params):
        with span("optim.clip"):
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        count = state["count"] + 1
        cf = float(count)
        beta = 1.0 - cf ** (-decay)
        lr_t = lr(cf)

        def upd(g, st, p):
            g = g.float()
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr, vc = st["vr"], st["vc"]
                vr.mul_(beta).add_(g2.mean(dim=-1), alpha=1 - beta)
                vc.mul_(beta).add_(g2.mean(dim=-2), alpha=1 - beta)
                rfac = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = g / (torch.sqrt(rfac)[..., None] * torch.sqrt(vc)[..., None, :] + eps)
            else:
                v = st["v"]
                v.mul_(beta).add_(g2, alpha=1 - beta)
                u = g / (torch.sqrt(v) + eps)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p.copy_(p.float() - lr_t * u)

        with span("optim.update"):
            for g, (p, st) in zip(tree_leaves(grads), _param_stats(params, state["stats"])):
                upd(g, st, p)
        return params, {"stats": state["stats"], "count": count}

    def state_schema(schema):
        def st(s):
            if _factored(s.shape):
                return {
                    "vr": ParamSpec(s.shape[:-1], s.axes[:-1], init="zeros", dtype="float32"),
                    "vc": ParamSpec(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:],
                                    init="zeros", dtype="float32"),
                }
            return {"v": ParamSpec(s.shape, s.axes, init="zeros", dtype="float32")}

        return {
            "stats": tree_map(st, schema),
            "count": ParamSpec((), (), init="zeros", dtype="int32"),
        }

    return Optimizer(init, update, state_schema)


def make_optimizer(cfg, total_steps: int = 10_000) -> Optimizer:
    """The schedule (WSD for minicpm, else cosine), then the config's
    optimizer (``adafactor`` or AdamW), as the reference picks them."""
    if cfg.name.startswith("minicpm"):
        sched = wsd_schedule(1e-3 * 0.3, warmup=int(0.01 * total_steps),
                             stable=int(0.79 * total_steps), decay=int(0.2 * total_steps))
    else:
        sched = cosine_schedule(3e-4, warmup=min(2000, total_steps // 10), total=total_steps)
    if cfg.optimizer == "adafactor":
        return adafactor(sched)
    return adamw(sched)
