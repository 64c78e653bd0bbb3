"""The system under test: the port's training step, built as
``repro_torch.train.loop.train`` builds it, over weights the benchmark
made.  The only module of the benchmark that imports the port.

``build`` returns the step ``make_train_step(get_model(cfg),
make_optimizer(cfg, total_steps))`` and the state tree
``train.state.init_state`` lays out (parameters that require grad, the
optimizer's ``init`` of them, a step counter), with the parameters taken
from ``weights`` (``{path: fp32 tensor}``) instead of drawn by the port.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

from bench.reference.common import flat_paths, nest

SRC = Path(__file__).resolve().parents[1] / "src"


def _port():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step

    return get_config, get_model, make_optimizer, make_train_step


def model_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file: its registered
    config with every size of the file's ``model`` block in place."""
    get_config = _port()[0]
    base = get_config(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    sizes = {k: v for k, v in config["model"].items() if k != "padded_vocab"}
    unknown = set(sizes) - fields
    if unknown:
        raise ValueError(f"{config['name']}: the port's config has no {sorted(unknown)}")
    cfg = dataclasses.replace(base, **sizes)
    if cfg.padded_vocab != config["model"]["padded_vocab"]:
        raise ValueError(f"{config['name']}: the port pads the vocabulary to "
                         f"{cfg.padded_vocab}, the file says {config['model']['padded_vocab']}")
    return cfg


def build(config: dict, weights: dict):
    """``(step, state)``; ``weights`` are moved into the state, not copied."""
    _, get_model, make_optimizer, make_train_step = _port()
    cfg = model_config(config)
    api = get_model(cfg)
    schema = {p: tuple(s.shape) for p, s in flat_paths(api.schema).items()}
    given = {p: tuple(w.shape) for p, w in weights.items()}
    if schema != given:
        raise ValueError(f"{config['name']}: the port's parameters {schema} are not the "
                         f"reference's {given}")
    opt = make_optimizer(cfg, total_steps=config["optimizer"]["total_steps"])
    params = nest({p: w.requires_grad_(True) for p, w in weights.items()})
    dev = next(iter(weights.values())).device
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    return make_train_step(api, opt), state


def first_moments(state: dict) -> dict:
    """``{path: AdamW's first moment}`` of the state."""
    return flat_paths(state["opt"]["m"])


def parameters(state: dict) -> dict:
    return flat_paths(state["params"])
