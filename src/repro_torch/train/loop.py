"""Fault-tolerant training loop.

The port of ``repro/train/loop.py``: the data pipeline, the train step,
synchronous checkpointing every ``ckpt_every`` steps, restart from the
latest checkpoint, fail-stop restart on a step failure
(``RuntimeError``/``ValueError``/``FloatingPointError``, at most
``max_failures`` times), straggler logging from EMA deadlines, and the
live control plane (paper §3.2).

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
step issues on its own stream (``train.step.bg_step_factory``).

The control plane (``coordinator``, ``heartbeat``, ``transport``,
``control_loop``, ``lease``, ``admit_every``) is the reference's: each step
beats (over the transport through a ``WorkerClient``, else straight into
``heartbeat``), pumps the co-hosted ``CoordinatorLoop`` (gated by the
lease, with ``bootstrap_from_log`` on acquiring it), logs the
reconfiguration events pushed back, and re-sweeps admission every
``admit_every`` steps; a step failure is reported once to a wired
coordinator.  Every rank of a mesh runs ``train``, so the control plane
lives on the mesh's first rank alone: one beat, one pump and one lease
tick a step, as in the reference's one process.  The other ranks leave
those fields unread.

The loop runs in *mesh generations*: with ``apply_reconfig`` set, a
re-plan the coordinator pushed back is applied at the next epoch
boundary.  The first rank sends the pending event (or None) to every rank
of the mesh after each step, so all break at the same step; every rank of
the process group re-carves through ``launch.mesh.remesh_for_pool``;
each state leaf is gathered on the old mesh (every rank of it taking part)
and placed by the new carving's shardings; the data cursor resumes where
it stopped.  A rank outside the new carving ends its ``train`` after the
gather (``TrainReport.left_mesh``).  Each carving's step goes through an
``ExecutableCache`` (the coordinator's, when wired), keyed on the
carving's rank ids, so churning back to a pool seen before reuses the
built step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch._device import DeviceLike, priority_stream, resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.multiplex import ExecutableCache, MultiplexConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.dist.faults import HeartbeatMonitor, MitigationLog, StepTimer
from repro_torch.dist.sharding import device_put
from repro_torch.dist.transport import WorkerClient
from repro_torch.models.api import get_model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.train.state import init_state
from repro_torch.train.step import jit_train_step, make_train_step


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
    # elastic re-planning: when set, failures are reported to the
    # coordinator (which re-plans the foreground job on the surviving
    # subset) and each step beats the heartbeat monitor
    coordinator: Optional[Any] = None  # ClusterCoordinator
    heartbeat: Optional[HeartbeatMonitor] = None
    worker_id: int = 0
    # live control plane: with `transport` set, beats go over the wire
    # (WorkerClient) instead of directly into `heartbeat`, and the worker
    # applies reconfiguration events the coordinator pushes back; with
    # `control_loop` set (the coordinator side co-hosted in this loop),
    # every step pumps the consumption path so HeartbeatMonitor.failed()/
    # stragglers() drive handle_failure + MitigationLog from live beats.
    # `admit_every` > 0 re-sweeps tenant admission (coordinator.readmit)
    # every that-many steps — the continuous-admission epoch cadence
    transport: Optional[Any] = None  # worker-side Transport endpoint
    control_loop: Optional[Any] = None  # CoordinatorLoop (co-hosted)
    admit_every: int = 0
    # applied reconfiguration: re-carve the mesh onto the surviving pool at
    # the epoch boundary after a replan event arrives (instead of logging
    # the event and continuing on the stale mesh)
    apply_reconfig: bool = False
    # coordinator election: with `lease` set (CoordinatorLease), the
    # co-hosted control loop only pumps while this worker holds the lease;
    # on acquiring it (failover), the loop bootstraps coordinator state
    # from the topic log before its first pump
    lease: Optional[Any] = None


@dataclass
class TrainReport:
    steps_done: int = 0
    restarts: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    mitigations: MitigationLog = field(default_factory=MitigationLog)
    bg_steps: int = 0
    remeshes: int = 0  # applied reconfigurations (mesh actually re-carved)
    left_mesh: bool = False  # this rank is outside the last re-carved mesh
    state: Any = None  # the train state after the last step


def _ranks(mesh) -> tuple:
    """The global ranks of ``mesh``, row-major (one rank: ``(0,)``)."""
    return (0,) if mesh is None else tuple(int(r) for r in mesh.mesh.flatten().tolist())


def _carving(mesh) -> tuple:
    """What identifies a carving: its ranks and its shape."""
    return _ranks(mesh), ((1, 1) if mesh is None else tuple(mesh.mesh.shape))


def _remesh(mesh, pool):
    """``remesh_for_pool`` over the process group (every rank of it calls
    this).  Without a mesh the carving is this process alone: the pool
    must hold its id 0, and the carving never changes."""
    from repro_torch.launch.mesh import remesh_for_pool

    if mesh is not None:
        return remesh_for_pool(pool)
    if 0 not in {int(i) for i in pool}:
        raise ValueError(f"reconfig pool {sorted(int(i) for i in pool)} has no local "
                         f"devices (process has 1)")
    return None


def _gathered(state):
    """Every DTensor leaf gathered whole (a collective over its mesh)."""
    def full(x):
        if hasattr(x, "full_tensor"):
            return x.full_tensor().detach().requires_grad_(x.requires_grad)
        return x

    return tree_map(full, state)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _mesh_group(ranks: tuple):
    """A process group over ``ranks`` (None: the default group, when they
    are the whole world); only they take part in building it."""
    import torch.distributed as dist

    if len(ranks) == dist.get_world_size():
        return None
    return dist.new_group(list(ranks), use_local_synchronization=True)


def _agree(pending: Optional[dict], src: int, group, dev: torch.device) -> Optional[dict]:
    """The first rank's pending reconfiguration event (or None), sent to
    every rank of the mesh, so all of them break at the same step."""
    import torch.distributed as dist

    box = [pending]
    dist.broadcast_object_list(box, src=src, group=group,
                               device=dev if dev.type == "cuda" else None)
    return box[0]


def train(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig,
          fault_injector: Optional[Callable[[int], None]] = None,
          device: DeviceLike = None, mesh=None) -> TrainReport:
    """Run ``tc.steps`` steps with checkpoint/restart + straggler monitoring.
    ``fault_injector(step)`` may raise to simulate failures (tests).  With
    ``mesh`` the sharded step runs on it (every rank of it calls ``train``)."""
    dev = resolve_device(device)
    if mesh is not None and dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not the mesh's device type {mesh.device_type!r}: "
                         "the state and batches are built on the mesh's device")
    api = get_model(cfg)
    opt = make_optimizer(cfg, total_steps=tc.steps)
    report = TrainReport()
    timer = StepTimer(deadline_factor=tc.straggler_factor)
    # built fg steps per carving: re-carving back onto a pool seen before
    # (join after failure) reuses the step through the same bounded LRU
    # the bg tenants use (the coordinator's, when wired)
    exec_cache: ExecutableCache = (tc.coordinator.exec_cache if tc.coordinator is not None
                                   else ExecutableCache())

    # the control plane runs on the mesh's first rank alone
    lead = mesh is None or _rank() == _ranks(mesh)[0]
    worker_client = (WorkerClient(tc.transport, tc.worker_id)
                     if tc.transport is not None and lead else None)
    if tc.control_loop is not None and tc.control_loop.log is None and lead:
        tc.control_loop.log = report.mitigations
    groups: dict = {}  # ranks -> the process group they agree through

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

    def build_step():
        if mesh is None:
            return make_train_step(api, opt), None, None
        return jit_train_step(api, opt, mesh, shape)

    # the foreground's own stream when background work shares the card
    # (None on the CPU, and without background work: the current stream)
    fg_stream = (priority_stream(dev, urgent=tc.multiplex.use_priorities)
                 if tc.bg_step_fn is not None else None)
    failures = 0
    step = 0
    flagged_stragglers: set = set()
    admitted: Optional[tuple] = None
    state = None
    data_state: Optional[dict] = None
    pending_reconfig: Optional[dict] = None
    first_generation = True
    with torch.cuda.stream(fg_stream):  # no-op for None
        while True:  # one iteration per mesh generation (re-carved on reconfig)
            ranks = _ranks(mesh)
            sig = f"fg-train-{cfg.name}-{shape.name}-s{tc.seed}"
            key = (sig, ranks, (1, 1)) if mesh is None else ExecutableCache.key(sig, mesh)
            step_fn, st_sh, bt_sh = exec_cache.get_or_build(key, build_step)
            # several ranks agree on each epoch boundary through this group
            agree = tc.apply_reconfig and len(ranks) > 1
            if agree and ranks not in groups:
                groups[ranks] = _mesh_group(ranks)
            # on fg_stream too: the state, and each batch's copy to the
            # card, are ordered before the steps that read them
            data = SyntheticLMData(cfg, shape.global_batch, shape.seq_len, seed=tc.seed,
                                   device=dev)
            try:
                if first_generation:
                    first_generation = False
                    if tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) is not None:
                        state, step = restore_latest()
                        report.restarts += 1
                    else:
                        state = fresh_state()
                else:
                    # new carving: place the gathered state by its shardings
                    # and resume the data cursor where the last generation
                    # stopped
                    state = placed(state, st_sh)
                    data.restore(data_state)
                while step < tc.steps:
                    try:
                        if fault_injector is not None:
                            fault_injector(step)
                        batch = placed(next(data), bt_sh)
                        t0 = time.perf_counter()
                        state, metrics = step_fn(state, batch)
                        # multiplexing: dispatch paced background steps while
                        # the foreground step is in flight (asynchronous issue)
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
                        if lead:
                            admitted, flagged_stragglers, events = _control_plane(
                                tc, report, worker_client, step, admitted,
                                flagged_stragglers)
                            for ev in events:
                                if (tc.apply_reconfig and ev.get("action") == "replan"
                                        and ev.get("devices")):
                                    pending_reconfig = ev  # the latest event wins
                        if agree:
                            pending_reconfig = _agree(pending_reconfig, ranks[0],
                                                      groups[ranks], dev)
                        if tc.ckpt_dir and step % tc.ckpt_every == 0:
                            ckpt_lib.save(tc.ckpt_dir, state, step, keep=tc.keep,
                                          extra_meta={"data": data.state()}, async_=False)
                        if pending_reconfig is not None:
                            break  # epoch boundary: re-carve before the next step
                    except (RuntimeError, ValueError, FloatingPointError) as e:
                        failures += 1
                        report.mitigations.log("failure", step=step, err=repr(e)[:200])
                        if failures > tc.max_failures:
                            raise
                        # fail-stop semantics (paper §3.2): a wired coordinator
                        # treats a step failure as loss of this worker's
                        # device.  Report it once — repeats of the same worker
                        # would only re-run an identical planner search.
                        if (lead and tc.coordinator is not None
                                and tc.worker_id in tc.coordinator.healthy):
                            new_plan = tc.coordinator.handle_failure(tc.worker_id)
                            if new_plan is not None:
                                report.mitigations.log("replan", step=step,
                                                       gpus=new_plan.num_gpus)
                        # restart from the last checkpoint (or fresh if none),
                        # the failed state freed first: its blocks serve the new one
                        state = None
                        if tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) is not None:
                            state, step = restore_latest()
                        else:
                            state, step = fresh_state(), 0
                            data.restore({"seed": tc.seed, "step": 0})
                        report.restarts += 1
                data_state = data.state()
            finally:
                data.close()
            if step >= tc.steps or pending_reconfig is None:
                break
            # -- applied reconfig: re-carve onto the surviving pool ----------
            ev, pending_reconfig = pending_reconfig, None
            new_mesh = _remesh(mesh, ev["devices"])
            if _carving(new_mesh) == _carving(mesh):
                continue  # this carving is unchanged (the event is logged above)
            state = _gathered(state)  # on the old mesh, every rank of it
            mesh = new_mesh
            report.remeshes += 1
            report.mitigations.log("reconfig_applied", step=step, gpus=ev.get("gpus"),
                                   mesh_devices=len(_ranks(new_mesh)), reason=ev.get("reason"))
            if _rank() not in _ranks(new_mesh):
                report.left_mesh = True
                break
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


def _control_plane(tc: TrainConfig, report: TrainReport, worker_client, step: int,
                   admitted, flagged: set):
    """One step's control plane on the first rank: the beat, the pump
    (lease-gated), the legacy straggler scan, the reconfiguration events
    and continuous admission.  Returns (admitted roster, flagged
    stragglers, the reconfiguration events polled)."""
    if worker_client is not None:
        # live path: the beat goes over the transport; the co-hosted
        # CoordinatorLoop (or a remote coordinator) consumes it — detection,
        # handle_failure, straggler logging and continuous admission all
        # happen on the consumption side, not here
        worker_client.beat(step)
    elif tc.heartbeat is not None:
        tc.heartbeat.beat(tc.worker_id, step)
    if tc.control_loop is not None:
        if tc.lease is not None:
            # election-gated coordination: pump only while holding the
            # lease; a fresh acquisition (failover) bootstraps from the
            # topic log so mitigations the dead holder already fired are
            # adopted, never re-fired
            if tc.lease.tick():
                if tc.lease.acquired:
                    tc.control_loop.bootstrap_from_log()
                tc.control_loop.pump()
        else:
            tc.control_loop.pump()
    elif tc.heartbeat is not None:
        # legacy in-process path (no transport): classify stragglers
        # directly off the monitor
        lagging = set(tc.heartbeat.stragglers())
        for w in sorted(lagging - flagged):
            report.mitigations.log("straggler_worker", step=step, worker=w)
        flagged = lagging  # recovered ones re-arm
    events = worker_client.poll_reconfig() if worker_client is not None else []
    for ev in events:
        # epoch-boundary reconfiguration: the re-plans the coordinator
        # pushed back since the last step
        report.mitigations.log("reconfig", step=step,
                               **{k: v for k, v in ev.items() if k != "kind"})
    if tc.admit_every > 0 and tc.coordinator is not None and step % tc.admit_every == 0:
        # continuous admission: re-sweep the tenant roster at the epoch
        # cadence (churn events re-sweep via the control loop); log only
        # when the admitted set changed
        decision = tc.coordinator.readmit(reason="epoch")
        if decision is not None:
            now = tuple(t.job for t in decision.admitted)
            if admitted is not None and now != admitted:
                report.mitigations.log("admission", step=step, admitted=list(now),
                                       rejected=[t.job for t in decision.rejected])
            admitted = now
    return admitted, flagged, events
