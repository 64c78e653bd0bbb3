"""Fault-tolerant training loop.

The port of ``repro/train/loop.py``: the data pipeline, the train step,
synchronous checkpointing every ``ckpt_every`` steps, restart from the
latest checkpoint, fail-stop restart on a step failure
(``RuntimeError``/``ValueError``/``FloatingPointError``, at most
``max_failures`` times) and straggler logging from EMA deadlines.

Without ``mesh`` the state lives on ``device`` (default: the card) and
the step is ``make_train_step``'s.  With ``mesh`` (a ``DeviceMesh``; every
rank of it runs ``train`` with its own ``device``) the step is
``jit_train_step``'s: the state, each batch (every rank draws the same
global batch and keeps its shard) and restored checkpoints are placed by
its shardings, and checkpoints are written by rank 0.

Multiplexing (``TrainConfig.bg_step_fn``): once the foreground step is
issued, ``multiplex.max_inflight`` background steps are
dispatched while it runs, then the loop waits on the foreground loss.
With background work the foreground's state, data and step live on a
stream of their own, of the greatest priority when
``multiplex.use_priorities`` (CUDA's default stream has the least), so
``float(loss)`` waits for the foreground stream alone; each background
step issues on its own stream (``train.step.bg_step_factory``).  The
coordinator, the heartbeat, the transport, the control loop, the lease,
applied reconfiguration and continuous admission wait for their layers;
setting any of them raises ``NotImplementedError`` naming the ROADMAP
item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch._device import DeviceLike, priority_stream, resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.multiplex import MultiplexConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.dist.faults import MitigationLog, StepTimer
from repro_torch.dist.sharding import device_put
from repro_torch.models.api import get_model
from repro_torch.models.layers import tree_leaves
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.train.state import init_state
from repro_torch.train.step import jit_train_step, make_train_step

_WAITING = {  # TrainConfig field -> the ROADMAP item it waits for
    "coordinator": "Queue 1, item 12 (control plane)",
    "heartbeat": "Queue 1, item 12 (control plane)",
    "transport": "Queue 1, item 12 (control plane)",
    "control_loop": "Queue 1, item 12 (control plane)",
    "lease": "Queue 1, item 12 (control plane)",
    "apply_reconfig": "Queue 1, item 12 (control plane)",
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
    bg_step_fn: Optional[Callable] = None  # multiplexed background work
    multiplex: MultiplexConfig = field(default_factory=MultiplexConfig)
    # not ported yet: each raises NotImplementedError when set (see _WAITING)
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
    bg_steps: int = 0
    state: Any = None  # the train state after the last step


def train(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig,
          fault_injector: Optional[Callable[[int], None]] = None,
          device: DeviceLike = None, mesh=None) -> TrainReport:
    """Run ``tc.steps`` steps with checkpoint/restart + straggler monitoring.
    ``fault_injector(step)`` may raise to simulate failures (tests).  With
    ``mesh`` the sharded step runs on it (every rank of it calls ``train``)."""
    for name, item in _WAITING.items():
        if getattr(tc, name):
            raise NotImplementedError(f"TrainConfig.{name} is not ported yet (ROADMAP {item})")
    dev = resolve_device(device)
    if mesh is not None and dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not the mesh's device type {mesh.device_type!r}: "
                         "the state and batches are built on the mesh's device")
    api = get_model(cfg)
    opt = make_optimizer(cfg, total_steps=tc.steps)
    if mesh is None:
        step_fn, st_sh, bt_sh = make_train_step(api, opt), None, None
    else:
        step_fn, st_sh, bt_sh = jit_train_step(api, opt, mesh, shape)
    report = TrainReport()
    timer = StepTimer(deadline_factor=tc.straggler_factor)

    def placed(tree, shardings):
        return tree if shardings is None else device_put(tree, shardings)

    def fresh_state():
        return placed(init_state(api, opt, torch.Generator(device=dev).manual_seed(tc.seed),
                                 dev), st_sh)

    def restore_latest():
        """(state, step) from the latest checkpoint, the data cursor moved there."""
        like = init_state(api, opt, torch.Generator(device=dev).manual_seed(tc.seed), dev)
        state, meta = ckpt_lib.restore(tc.ckpt_dir, like, shardings=st_sh)
        data.restore(meta.get("data", {"seed": tc.seed, "step": meta["step"]}))
        return state, meta["step"]

    # the foreground's own stream when background work shares the card
    # (None on the CPU, and without background work: the current stream)
    fg_stream = (priority_stream(dev, urgent=tc.multiplex.use_priorities)
                 if tc.bg_step_fn is not None else None)
    with torch.cuda.stream(fg_stream):  # no-op for None
        # on fg_stream too: the state, and each batch's copy to the card,
        # are ordered before the steps that read them
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
                    batch = placed(next(data), bt_sh)
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch)
                    # multiplexing: dispatch paced background steps while the
                    # foreground step is in flight (asynchronous issue)
                    if tc.bg_step_fn is not None:
                        for _ in range(tc.multiplex.max_inflight):
                            tc.bg_step_fn()
                            report.bg_steps += 1
                    loss = float(metrics["loss"])  # waits for the step's stream
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
    if fg_stream is not None:
        # the caller's stream sees the final state only after the last step,
        # and the state's blocks, allocated on fg_stream, are not reused
        # while work the caller queues on its own stream may still read them
        caller = torch.cuda.current_stream(dev)
        caller.wait_stream(fg_stream)
        for t in tree_leaves(state):
            t = t.to_local() if hasattr(t, "to_local") else t  # a DTensor's shard
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(caller)
    report.state = state
    return report
