"""Fault-tolerant training loop, single device.

The port of the single-device path of ``repro/train/loop.py``: the data
pipeline, the train step, synchronous checkpointing every ``ckpt_every``
steps, restart from the latest checkpoint, fail-stop restart on a step
failure (``RuntimeError``/``ValueError``/``FloatingPointError``, at most
``max_failures`` times) and straggler logging from EMA deadlines.

The reference's mesh argument is gone: the state lives on ``device``
(default: the card).  Background multiplexing, the coordinator, the
heartbeat, the transport, the control loop, the lease, applied
reconfiguration and continuous admission wait for their layers; setting
any of them raises ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.dist.faults import MitigationLog, StepTimer
from repro_torch.models.api import get_model
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step

_WAITING = {  # TrainConfig field -> the ROADMAP item it waits for
    "bg_step_fn": "Queue 1, item 9 (executable gap multiplexing)",
    "coordinator": "Queue 1, item 12 (control plane)",
    "heartbeat": "Queue 1, item 12 (control plane)",
    "transport": "Queue 1, item 12 (control plane)",
    "control_loop": "Queue 1, item 12 (control plane)",
    "lease": "Queue 1, item 12 (control plane)",
    "apply_reconfig": "Queue 1, item 11 (multi-device)",
    "admit_every": "Queue 1, item 12 (control plane)",
}


@dataclass
class TrainConfig:
    steps: int = 20
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    keep: int = 3
    seed: int = 0
    log_every: int = 5
    max_failures: int = 3
    straggler_factor: float = 3.0
    # not ported yet: each raises NotImplementedError when set (see _WAITING)
    bg_step_fn: Optional[Callable] = None
    coordinator: Optional[Any] = None
    heartbeat: Optional[Any] = None
    transport: Optional[Any] = None
    control_loop: Optional[Any] = None
    admit_every: int = 0
    apply_reconfig: bool = False
    lease: Optional[Any] = None


@dataclass
class TrainReport:
    steps_done: int = 0
    restarts: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    mitigations: MitigationLog = field(default_factory=MitigationLog)
    state: Any = None  # the train state after the last step


def train(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig,
          fault_injector: Optional[Callable[[int], None]] = None,
          device: DeviceLike = None) -> TrainReport:
    """Run ``tc.steps`` steps with checkpoint/restart + straggler monitoring.
    ``fault_injector(step)`` may raise to simulate failures (tests)."""
    for name, item in _WAITING.items():
        if getattr(tc, name):
            raise NotImplementedError(f"TrainConfig.{name} is not ported yet (ROADMAP {item})")
    dev = resolve_device(device)
    api = get_model(cfg)
    opt = make_optimizer(cfg, total_steps=tc.steps)
    step_fn = make_train_step(api, opt)
    report = TrainReport()
    timer = StepTimer(deadline_factor=tc.straggler_factor)

    def fresh_state():
        return init_state(api, opt, torch.Generator(device=dev).manual_seed(tc.seed), dev)

    def restore_latest():
        """(state, step) from the latest checkpoint, the data cursor moved there."""
        state, meta = ckpt_lib.restore(tc.ckpt_dir, fresh_state())
        data.restore(meta.get("data", {"seed": tc.seed, "step": meta["step"]}))
        return state, meta["step"]

    data = SyntheticLMData(cfg, shape.global_batch, shape.seq_len, seed=tc.seed,
                           device=dev)
    try:
        if tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) is not None:
            state, step = restore_latest()
            report.restarts += 1
        else:
            state, step = fresh_state(), 0
        failures = 0
        while step < tc.steps:
            try:
                if fault_injector is not None:
                    fault_injector(step)
                batch = next(data)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                timer.record(dt)
                if timer.is_straggler_step(dt):
                    report.mitigations.log("straggler", step=step, dt=dt)
                report.losses.append(loss)
                report.step_times.append(dt)
                step += 1
                report.steps_done += 1
                if tc.ckpt_dir and step % tc.ckpt_every == 0:
                    ckpt_lib.save(tc.ckpt_dir, state, step, keep=tc.keep,
                                  extra_meta={"data": data.state()}, async_=False)
            except (RuntimeError, ValueError, FloatingPointError) as e:
                failures += 1
                report.mitigations.log("failure", step=step, err=repr(e)[:200])
                if failures > tc.max_failures:
                    raise
                # fail-stop: restart from the last checkpoint (or fresh if none)
                if tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) is not None:
                    state, step = restore_latest()
                else:
                    state, step = fresh_state(), 0
                    data.restore({"seed": tc.seed, "step": 0})
                report.restarts += 1
    finally:
        data.close()
    report.state = state
    return report
