"""Foreground/background multiplexing (paper §5).

The port of ``repro/core/multiplex.py``.  The simulation, prediction and
scheduling are pure Python, the reference's arithmetic in its order; the
executable path runs the reference's loop statement for statement on
torch devices and CUDA streams.

1. ``MultiplexSim`` — a discrete-event model of one accelerator cluster
   multiplexing a burst-parallel foreground job with background jobs.  It
   reproduces the paper's §7.2 ablation (Fig 11): each QoS mechanism
   (priorities, launch pacing, slowdown feedback loop, background
   granularity reduction) can be toggled, and the simulator reports
   foreground slowdown + background throughput.  The interference model is
   parameterized by the paper's own measurements (naive collocation ≈ halves
   fg throughput; NCCL all-reduce >2× sensitive; non-preemptive overrun).
   This path needs no accelerators and runs everywhere: planning-time
   what-ifs, coordinator policy decisions, and the Fig-11 ablation tests.

2. ``Collocator`` — the scheduling, calibration, prediction and admission
   of background tenants in the plan's gaps, and the executable path:
   ``submeshes()`` carves the plan's positions into the foreground slice
   and per-gap tenant slices (``repro_torch.launch.mesh``), and
   ``run_executable()`` runs real foreground stages and tenant steps on
   them, interleaved with dispatch pacing (bounded in-flight steps) and
   the slowdown feedback loop driven by a QoSMonitor of *measured* stage
   times.  Where the positions are distinct cards, a gap is a disjoint set
   of cards (the reference's TPU submesh mode; the coordinator falls back
   to ``MultiplexSim`` when there are too few).  On one card
   (``MultiplexConfig.collocate_same_device``, the paper's GPU mode) every
   position is the card: the foreground is issued on a stream of the
   greatest priority (with ``use_priorities``) and each (chunk, tenant)
   on its own stream of the least, so tenants overlap each other and the
   foreground as disjoint submeshes do.  Every dispatch is followed by a
   ``torch.cuda.Event`` recorded on its stream, and the loop waits on
   those events alone: ``torch.cuda.synchronize()`` would wait for every
   stream and time the background into the foreground stage.

Multi-tenant gap scheduling (paper §5's cluster-throughput setting — several
background jobs packed into one foreground job's gaps):

- ``BgTenant(job, priority, step_fn_factory)`` names one background job.
  ``Collocator(tenants=[...])`` packs the tenants into each gap's free
  device ranges by priority — ``repro_torch.core.plan.pack_ranges`` carves the
  free set into disjoint quantum-aligned chunks, largest chunk to the
  highest-priority tenant — and ``run_executable`` interleaves every
  tenant's paced dispatch under the shared QoS loop, reporting per-tenant
  throughput as ``CollocationResult.tenants`` (``TenantResult`` rows).
- ``ExecutableCache`` memoizes built bg step fns across re-plans, keyed
  on (tenant signature, the gap slice's position ids, its shape).  A
  coordinator-owned cache survives ``handle_failure``/``handle_join``
  re-plans, so a re-plan whose gap shape is unchanged reuses the jitted bg
  steps (and their training state) instead of recompiling — the dominant
  cost of burst re-scaling.
- ``Collocator.calibrate(results)`` fits the ``InterferenceModel``'s
  submesh-mode multipliers (``gap_inflation``) from measured
  ``CollocationResult``s, and ``Collocator.predict()`` replays the tenant
  schedule through the calibrated model so ``MultiplexSim`` / planning-time
  what-ifs track the hardware the executable path actually measured.

Admission-controlled fair sharing (this layer decides *who runs* before
anything compiles):

- Per-tenant quanta: ``BgTenant.quantum`` aligns that tenant's gap chunks to
  its own submesh width (``pack_ranges`` per-tenant mode) and each tenant's
  bg step-time quantum is sized to the smallest gap *it* occupies rather
  than the global gap minimum — a tenant holding only wide gaps runs bigger
  (more efficient) steps.
- Weighted fair sharing with a starvation guard: within an equal-priority
  group, chunk ownership rotates across iterations and a per-tenant deficit
  counter (``BgTenant.weight``-scaled fair share minus actual launches)
  promotes starved tenants to the front of the next assignment, so no
  tenant's measured throughput stays at zero while peers run.  Reported per
  tenant via ``TenantResult.deficit``.
- ``ExecutableCache`` is a bounded LRU (``max_entries``) with explicit
  eviction of stale device subsets (``evict_stale``) — repeated
  ``handle_failure``/``handle_join`` re-plan cycles no longer hold dead
  jitted state alive.
- Per-stage calibration: ``InterferenceModel.gap_inflation`` generalizes to
  a per-gap-op vector (``gap_inflation_stages``) fitted by
  ``Collocator.calibrate`` from per-stage measurements
  (``CollocationResult.stage_slowdowns``), applied by both
  ``MultiplexSim.run`` and ``Collocator.predict``.
- Admission control: ``Collocator.admit`` sweeps candidate tenant counts
  through the calibrated ``predict()`` and admits the
  argmax-cluster-throughput roster *before compiling anything*, rejecting
  tenants that would push fg slowdown past the paper's 1.33x QoS bound
  (``ClusterCoordinator.collocate`` runs this by default).
"""
from __future__ import annotations

import math
import time as _time
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import priority_stream
from repro_torch.core.plan import BurstPlan, pack_ranges


# ---------------------------------------------------------------------------
# QoS monitoring (slowdown feedback loop — paper §5 "monitors the runtimes of
# each operation, and pauses collocation when a foreground job runs an
# operator that has been observed to suffer large slowdowns")
# ---------------------------------------------------------------------------


@dataclass
class QoSMonitor:
    slowdown_threshold: float = 1.3
    ema_alpha: float = 0.3
    baseline: Dict[str, float] = field(default_factory=dict)
    ema: Dict[str, float] = field(default_factory=dict)
    banned: set = field(default_factory=set)

    def record_baseline(self, op: str, t: float) -> None:
        self.baseline[op] = t

    def record(self, op: str, t: float, collocated: bool) -> None:
        prev = self.ema.get(op, t)
        self.ema[op] = (1 - self.ema_alpha) * prev + self.ema_alpha * t
        if collocated and self.slowdown(op) > self.slowdown_threshold:
            self.banned.add(op)

    def slowdown(self, op: str) -> float:
        b = self.baseline.get(op)
        if not b:
            return 1.0
        return self.ema.get(op, b) / b

    def collocation_allowed(self, op: str) -> bool:
        return op not in self.banned


# ---------------------------------------------------------------------------
# Interference model (paper Fig 11 / Fig 12 calibration)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InterferenceModel:
    """Foreground inflation when a background task shares the device.

    Calibrated to the paper's measurements on A100:
      naive same-device collocation        -> ~1.9× fg stage time
      + stream priorities alone            -> ~1.8× (barely helps; Fig 11)
      + launch pacing                      -> ~1.25×
      sensitive ops (all-reduce/sync)      -> ≥2.1× unless banned
      non-preemptive overrun               -> bg tail blocks the next fg stage

    ``gap_inflation`` is the submesh-mode counterpart: the measured fg
    stage-time multiplier while disjoint-device tenants collocate in the
    stage's gap (host-side dispatch contention, shared interconnect).  It is
    1.0 by default (ideal disjointness) and is *fitted from measurement* by
    ``Collocator.calibrate`` so simulator predictions track the hardware.

    ``gap_inflation_stages`` refines the scalar into a per-gap-op vector:
    ``(stage_index, multiplier)`` pairs fitted from per-stage measurements
    (``CollocationResult.stage_slowdowns``).  ``gap_inflation_for(si)``
    returns the stage's fitted multiplier, falling back to the scalar for
    stages without a per-stage fit.  Every fitted multiplier is clamped to
    >= 1.0 — a noisy host can measure a sub-1.0 slowdown, but interference
    never *speeds up* the foreground.

    ``density_slope`` makes the model *tenant-density aware*: the fitted
    multipliers describe interference at one collocated tenant per gap
    stage (density 1), and a stage shared by ``d`` tenants inflates its
    excess linearly — ``gap_inflation_at(si, d)`` returns
    ``1 + (base-1) * (1 + density_slope*(d-1))``.  Host-side dispatch
    contention and interconnect pressure scale with how many tenants pile
    into a gap, so the admission sweep's predicted slowdown becomes
    monotone in roster size and ``Collocator.admit`` can reject the
    *marginal* tenant (0 < k < n) instead of all-or-nothing.  The default
    0.0 is density-blind (every prior behavior unchanged); ``calibrate``
    fits it from measurements taken at different densities.
    """

    naive_inflation: float = 1.9
    priority_inflation: float = 1.8
    paced_inflation: float = 1.25
    sensitive_inflation: float = 2.1
    sensitive_kinds: tuple = ("sync", "allreduce")
    gap_inflation: float = 1.0  # submesh mode; calibrated from measurement
    gap_inflation_stages: Tuple[Tuple[int, float], ...] = ()  # per-stage fit
    density_slope: float = 0.0  # per-extra-tenant excess growth; fitted

    def gap_inflation_for(self, stage_index: int) -> float:
        """Submesh-mode fg multiplier for one gap stage at density 1
        (per-stage fit when available, else the scalar ``gap_inflation``)."""
        for si, v in self.gap_inflation_stages:
            if si == stage_index:
                return v
        return self.gap_inflation

    def density_factor(self, density: float) -> float:
        """Excess-inflation multiplier for ``density`` collocated tenants
        sharing one gap stage (1.0 at density <= 1 or with no fitted slope)."""
        if density <= 1.0 or self.density_slope <= 0.0:
            return 1.0
        return 1.0 + self.density_slope * (density - 1.0)

    def gap_inflation_at(self, stage_index: int, density: float = 1.0) -> float:
        """Submesh-mode fg multiplier for one gap stage shared by
        ``density`` tenants."""
        base = self.gap_inflation_for(stage_index)
        return 1.0 + (base - 1.0) * self.density_factor(density)

    def fg_multiplier(self, *, priorities: bool, pacing: bool, sensitive: bool,
                      banned: bool) -> float:
        if banned:
            return 1.0
        if sensitive:
            return self.sensitive_inflation
        if priorities and pacing:
            return self.paced_inflation
        if priorities:
            return self.priority_inflation
        return self.naive_inflation


@dataclass(frozen=True)
class MultiplexConfig:
    use_priorities: bool = True
    use_pacing: bool = True  # launch pacing (bounded outstanding work)
    use_feedback: bool = True  # slowdown feedback loop (ban sensitive ops)
    use_granularity: bool = True  # reduce bg step size (non-preemption guard)
    collocate_same_device: bool = False  # one device shared (paper) vs disjoint device subsets
    max_inflight: int = 2
    bg_step_time: float = 2.0e-3  # isolated bg step latency at full batch
    bg_min_step_time: float = 0.25e-3  # granularity floor (smaller batch)
    sync_fraction: float = 0.25  # fraction of each fg stage that is grad sync


@dataclass
class SimResult:
    fg_iter_time: float
    fg_iter_time_isolated: float
    bg_steps_per_iter: float
    fg_slowdown: float
    bg_throughput_frac: float  # vs one device running bg flat-out
    cluster_throughput: float  # fg + bg useful device-seconds per second

    def row(self) -> str:
        return (
            f"fg_slowdown={self.fg_slowdown:.3f} bg_steps/iter={self.bg_steps_per_iter:.1f} "
            f"cluster_util={self.cluster_throughput:.3f}"
        )


class MultiplexSim:
    """Discrete-event multiplexing of one fg BurstPlan + one bg job."""

    def __init__(
        self,
        plan: BurstPlan,
        cfg: MultiplexConfig,
        interference: InterferenceModel = InterferenceModel(),
        monitor: Optional[QoSMonitor] = None,
    ):
        self.plan = plan
        self.cfg = cfg
        self.imodel = interference
        self.monitor = monitor or QoSMonitor()

    def bg_step_time(self) -> float:
        """Granularity reduction: size bg steps to the smallest gap."""
        t = self.cfg.bg_step_time
        if not self.cfg.use_granularity:
            return t
        gaps = self.plan.gaps()
        if gaps:
            smallest = min(g.duration for g in gaps)
            t = min(t, max(self.cfg.bg_min_step_time, smallest / 2.0))
        return max(t, self.cfg.bg_min_step_time)

    def run(self, iterations: int = 50) -> SimResult:
        cfg, plan = self.cfg, self.plan
        stages = plan.stages()
        G = plan.num_gpus
        bg_t = self.bg_step_time()
        bg_eff = min(1.0, bg_t / cfg.bg_step_time) ** 0.25  # small batches less efficient
        fg_iso = plan.total_time
        unpaced_queue = 2  # unbounded-queue depth proxy (paper: loss of QoS)

        fg_time_total = 0.0
        bg_busy_total = 0.0
        bg_steps_total = 0.0
        for _ in range(iterations):
            t = 0.0
            carry_overrun = 0.0
            prev_free = 0
            for si, st in enumerate(stages):
                free = G - st.gpus
                op = f"stage{si}"
                window = st.duration
                sf = cfg.sync_fraction if st.gpus > 1 else 0.0
                stage_time = window

                if cfg.collocate_same_device:
                    # GPU mode (paper's setting): bg shares the fg devices.
                    # Slowdown feedback bans collocation on the sensitive
                    # (gradient-sync) portion once observed.
                    m_norm = self.imodel.fg_multiplier(
                        priorities=cfg.use_priorities, pacing=cfg.use_pacing,
                        sensitive=False, banned=False,
                    )
                    if cfg.use_feedback:
                        m_sens = 1.0  # banned after first observation
                    else:
                        m_sens = self.imodel.fg_multiplier(
                            priorities=cfg.use_priorities, pacing=cfg.use_pacing,
                            sensitive=True, banned=False,
                        )
                    stage_time = window * (1.0 - sf) * m_norm + window * sf * m_sens
                    # half of the inflation is useful bg cycles, half is waste
                    stolen = (stage_time - window) * st.gpus * 0.5
                    bg_busy_total += stolen * bg_eff
                    bg_steps_total += stolen / bg_t

                if free > 0:
                    # gap: bg runs on the disjoint idle devices.  In submesh
                    # mode the calibrated gap_inflation models the measured
                    # residual interference (host dispatch, interconnect) —
                    # but only where collocation actually happens: a gap the
                    # feedback loop banned admits no bg and stays clean.
                    if (not cfg.collocate_same_device
                            and (not cfg.use_feedback
                                 or self.monitor.collocation_allowed(op))):
                        stage_time = window * self.imodel.gap_inflation_for(si)
                    n_per_dev = math.floor(window / bg_t)
                    if cfg.use_pacing:
                        # paced: bounded outstanding work; residual overrun is
                        # one half-step of estimation error
                        overrun = 0.5 * bg_t
                    else:
                        n_per_dev += unpaced_queue
                        overrun = unpaced_queue * bg_t
                    bg_steps_total += n_per_dev * free
                    bg_busy_total += n_per_dev * bg_t * free * bg_eff
                    carry_overrun = max(carry_overrun, overrun)
                    prev_free = free
                else:
                    # non-preemptive bg tail on previously-free devices delays
                    # this stage iff it now needs those devices
                    if carry_overrun > 0.0 and st.gpus > G - prev_free:
                        stage_time += carry_overrun
                    carry_overrun = 0.0

                self.monitor.record_baseline(op, window)
                self.monitor.record(op, stage_time, collocated=True)
                t += stage_time
            t += carry_overrun  # tail overrun beyond the iteration boundary
            fg_time_total += t

        fg_iter = fg_time_total / iterations
        fg_busy = sum(s.duration * s.gpus for s in stages)
        # bg cannot use more device-time than exists beyond fg's actual usage
        budget = fg_iter * G - fg_busy
        bg_busy = min(bg_busy_total / iterations, max(budget, 0.0))
        bg_per_iter = bg_steps_total / iterations * (
            bg_busy / max(bg_busy_total / iterations, 1e-30)
        )
        cluster = (fg_busy + bg_busy) / (fg_iter * G)
        return SimResult(
            fg_iter_time=fg_iter,
            fg_iter_time_isolated=fg_iso,
            bg_steps_per_iter=bg_per_iter,
            fg_slowdown=fg_iter / fg_iso,
            bg_throughput_frac=bg_busy / (fg_iter * G),
            cluster_throughput=cluster,
        )


# ---------------------------------------------------------------------------
# Background tenants and the collocator (device-subset mode)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BgTenant:
    """One background job competing for gap devices.

    ``priority`` orders tenants (higher first): the highest-priority tenant
    gets the largest chunk of each gap's free device ranges and dispatches
    first.  ``step_fn_factory(mesh)`` returns a zero-arg callable dispatching
    one training step on the tenant's gap submesh (the ``make_bg_step_fn``
    contract of ``run_executable``).  ``signature`` identifies the compiled
    executable for cache reuse across re-plans; it defaults to the factory's
    ``signature`` attribute (set by ``train.step.bg_step_factory``) and,
    for untagged factories, to the factory object itself — never to the job
    name alone, so two *different* factories submitted under one name can't
    silently share a compiled executable.

    ``weight`` scales the tenant's fair share among equal-priority peers
    (deficit-rotation fair sharing); ``quantum`` is the tenant's own device
    chunk alignment (its submesh model width) — when set, each of the
    tenant's gap chunks is a multiple of it instead of the scheduler's
    global ``bg_model``, and the tenant's bg step-time quantum is sized to
    its own chunks rather than the global gap minimum.
    """

    job: str
    priority: int = 0
    step_fn_factory: Optional[Callable] = None
    signature: Optional[object] = None  # any hashable executable identity
    weight: float = 1.0                 # fair share among equal priorities
    quantum: Optional[int] = None       # per-tenant chunk alignment

    @property
    def cache_signature(self):
        if self.signature:
            return self.signature
        sig = getattr(self.step_fn_factory, "signature", None)
        if sig:
            return sig
        return self.step_fn_factory if self.step_fn_factory is not None \
            else self.job


@dataclass
class ExecutableCache:
    """Built bg-step reuse across re-plans — a bounded LRU.

    Keyed on (tenant signature, the gap slice's position ids, its shape): a
    built step closes over its training state on the slice's device, so
    identity of the *positions* — not just the shape — is what makes reuse
    sound.  On one card every position is the same device, so a key of
    device ids would let different gap chunks share one tenant step and
    its state; the position ids keep them apart as the reference's device
    ids do.  After a ``handle_failure``/``handle_join`` re-plan whose gap
    ranges are unchanged, the same key recurs and the step (with its
    training state) is reused instead of rebuilt.

    Two bounds keep the cache from holding dead state alive across
    repeated re-plans:

    - ``max_entries`` caps the entry count; inserting beyond it evicts the
      least-recently-used entry (lookups refresh recency).
    - ``evict_stale(live_ids)`` drops every entry whose slice uses a
      position outside the live set — after a device failure the steps
      (and their training state) on that subset are dead and must be
      rebuilt even if the same gap shape later returns.
    """

    max_entries: int = 64
    entries: "OrderedDict[tuple, Callable]" = field(default_factory=OrderedDict)
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @staticmethod
    def key(signature: str, mesh) -> tuple:
        """``mesh`` is a ``launch.mesh.DeviceSlice`` (keyed on its position
        ids) or a ``DeviceMesh`` (keyed on its ranks, which the
        coordinator's ``evict_stale`` reads as device ids)."""
        if hasattr(mesh, "ids"):
            return (signature, tuple(mesh.ids), tuple(mesh.shape))
        return (signature, tuple(int(r) for r in mesh.mesh.flatten().tolist()),
                tuple(mesh.mesh.shape))

    def __len__(self) -> int:
        return len(self.entries)

    def get_or_build(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        fn = self.entries.get(key)
        if fn is not None:
            self.hits += 1
            self.entries.move_to_end(key)
            return fn
        self.misses += 1
        fn = self.entries[key] = build()
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)  # LRU out
            self.evictions += 1
        return fn

    def evict_stale(self, live_device_ids: Iterable[int]) -> int:
        """Drop entries whose submesh touches a device outside ``live``
        (explicit post-re-plan eviction of stale device subsets).  Returns
        the number of entries evicted."""
        live = set(live_device_ids)
        stale = [k for k in self.entries if not set(k[1]) <= live]
        for k in stale:
            del self.entries[k]
        self.evictions += len(stale)
        return len(stale)


@dataclass(frozen=True)
class TenantResult:
    """Per-tenant slice of a CollocationResult.

    ``weight``/``deficit`` report the fair-sharing state: ``deficit`` is the
    tenant's accumulated weighted fair share minus its actual launches — a
    persistently positive deficit means the starvation guard is owed steps
    and will promote this tenant in upcoming chunk assignments."""

    job: str
    priority: int
    bg_steps_per_iter: float
    bg_throughput: float  # steps per second of collocated fg wall time
    gap_stages: Tuple[int, ...] = ()  # stages where this tenant held devices
    devices: int = 0                  # largest submesh the tenant held
    weight: float = 1.0
    deficit: float = 0.0              # fair-share owed at end of run
    quantum: int = 1                  # chunk alignment the tenant packed with
    step_time: float = 0.0            # the tenant's bg step-time quantum

    def row(self) -> str:
        return (f"{self.job}(p{self.priority}): "
                f"{self.bg_steps_per_iter:.1f} steps/iter on "
                f"<= {self.devices} devices")


@dataclass
class CollocationResult:
    """Measured (not simulated) outcome of executable gap collocation.

    ``fg_slowdown`` is the steady state after the feedback loop has banned
    harmful origins — the bound the QoS mechanism promises.  ``iter_details``
    exposes every collocated iteration as (wall_time, bg_steps_launched) so
    the learning-phase tradeoff (iterations that collocated heavily may have
    run slower) stays visible rather than hidden by the min.
    """

    fg_iter_time: float
    fg_iter_time_isolated: float
    fg_slowdown: float
    bg_steps_per_iter: float
    bg_throughput: float  # bg steps per second of collocated fg wall time
    iterations: int
    banned_ops: Tuple[str, ...] = ()
    iter_details: Tuple[Tuple[float, int], ...] = ()
    tenants: Tuple[TenantResult, ...] = ()  # per-tenant accounting
    cache_hits: int = 0    # executable-cache hits while building this run
    cache_misses: int = 0
    # measured per-gap-stage fg slowdown (stage_index, min_col/baseline) for
    # collocated stages — the raw material of per-stage calibration
    stage_slowdowns: Tuple[Tuple[int, float], ...] = ()
    # (fg + bg useful device-seconds) / (iteration wall x cluster size), in
    # plan-time units — the admission controller's objective
    cluster_throughput: float = 0.0
    # tenants the admission controller refused to compile (job names)
    rejected_tenants: Tuple[str, ...] = ()
    # Jain's index over per-tenant weighted service time, recorded at
    # construction (mixed-quanta rosters included: service-time
    # normalization makes heterogeneous step sizes comparable)
    jain_index: float = 1.0

    def jain_fairness(self) -> float:
        """Jain's fairness index over per-tenant weighted *service time*
        (1.0 = perfectly fair; 1/n = one tenant has everything).  Service is
        steps x the tenant's own step-time quantum — tenants deliberately
        run different step sizes, so raw step counts are incomparable
        across quanta (same rationale as the deficit accounting in
        ``note_launched``).  Tenants with zero weight are excluded; rows
        without a recorded step time (hand-built results) count steps
        directly; no tenants -> 1.0."""
        xs = [
            t.bg_steps_per_iter
            * (t.step_time if t.step_time > 0 else 1.0) / t.weight
            for t in self.tenants if t.weight > 0
        ]
        if not xs:
            return 1.0
        denom = len(xs) * sum(x * x for x in xs)
        if denom <= 0.0:
            return 1.0
        return sum(xs) ** 2 / denom

    def row(self) -> str:
        per_tenant = ""
        if self.tenants:
            per_tenant = " " + " ".join(t.row() for t in self.tenants)
        return (
            f"fg_slowdown={self.fg_slowdown:.3f} "
            f"bg_steps/iter={self.bg_steps_per_iter:.1f} "
            f"bg_steps/s={self.bg_throughput:.1f} "
            f"banned={list(self.banned_ops) or 'none'}" + per_tenant
        )


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of the predict-before-compile admission sweep.

    ``curve`` holds one (k, predicted fg slowdown, predicted cluster
    throughput) triple per candidate tenant count 0..n; ``n_admitted`` is
    the argmax-cluster-throughput k among those whose predicted fg slowdown
    stays within ``bound``.  ``rejected`` tenants are never compiled.
    """

    bound: float
    n_admitted: int
    admitted: Tuple[BgTenant, ...]
    rejected: Tuple[BgTenant, ...]
    curve: Tuple[Tuple[int, float, float], ...]

    def row(self) -> str:
        pts = " ".join(f"k={k}:{s:.3f}x/{c:.3f}" for k, s, c in self.curve)
        rej = ",".join(t.job for t in self.rejected) or "none"
        return (f"admitted {self.n_admitted}/{self.n_admitted + len(self.rejected)} "
                f"(bound {self.bound:.2f}x, rejected: {rej}) curve: {pts}")


@dataclass
class Collocator:
    """Dispatches background steps into plan gaps with pacing + feedback.

    ``run_executable`` is the real path: it carves fg/bg device slices
    from the plan (``submeshes()``), builds the caller's stage/step
    factories onto them, and interleaves paced background dispatch with the
    foreground stages, measuring slowdown via the QoSMonitor.
    ``run_iteration`` is the lighter legacy harness: the caller supplies
    ready callables and only the dispatch loop runs here.
    ``devices`` pins an explicit device list, one entry per plan position
    (default: in GPU mode, ``cfg.collocate_same_device``, the current card
    once for each of the plan's positions; otherwise the process's cards).
    ``device_ids`` names those positions (default: their indices); the
    executable cache keys on them.

    ``tenants`` is a prioritized list of background jobs (``BgTenant``);
    each gap's free device ranges are packed among them largest-chunk-to-
    highest-priority (``schedule_tenants``).  ``cache`` (``ExecutableCache``)
    memoizes built bg steps across collocators — pass the coordinator's
    cache so re-plans with unchanged gap shapes reuse the steps.
    ``interference`` seeds the analytic model used by ``predict()``;
    ``calibrate()`` refits it from measured results.
    """

    plan: BurstPlan
    cfg: MultiplexConfig
    monitor: QoSMonitor = field(default_factory=QoSMonitor)
    devices: Optional[Sequence] = None
    tenants: Sequence[BgTenant] = ()
    cache: Optional[ExecutableCache] = None
    interference: InterferenceModel = field(default_factory=InterferenceModel)
    device_ids: Optional[Sequence[int]] = None

    def __post_init__(self):
        # priority order is fixed at construction: slot 0 = highest priority
        # (stable for equal priorities, preserving submission order)
        self.tenants = tuple(
            sorted(self.tenants, key=lambda t: -t.priority)
        )
        # hoisted: one sim + one bg step-time quantum for the collocator's
        # lifetime (previously rebuilt inside every schedule() call)
        self._sim = MultiplexSim(self.plan, self.cfg, self.interference,
                                 monitor=self.monitor)
        self.bg_step_quantum = self._sim.bg_step_time()
        # fair-sharing state: per-roster-slot deficit counters (in service
        # seconds) and the rotation round (advanced by note_launched after
        # each collocated iteration) — see _fair_assignment
        self._deficits: Dict[int, float] = defaultdict(float)
        self._round = 0
        # last per-slot step-time quanta (set by _schedule_detail): converts
        # launched step counts into service time for the deficit accounting
        self._last_step_t: List[float] = []

    def set_tenants(self, tenants: Sequence[BgTenant]) -> None:
        """Replace the tenant roster in place.

        Request-level admission (serving) re-sweeps ``admit()`` every
        scheduler tick with the *current* candidate requests as tenants —
        rebuilding the Collocator each tick would discard the calibrated
        interference model, the QoS monitor's baselines/bans, and the
        hoisted sim/step quantum (plan and cfg are unchanged, so those all
        stay valid).  Per-slot deficits are kept positionally: a deficit
        describes the service history of the i-th chunk position, which is
        what the fair-share rotation needs even as roster *identity*
        churns request-to-request.
        """
        self.tenants = tuple(sorted(tenants, key=lambda t: -t.priority))

    def schedule(self) -> List[Tuple[int, int]]:
        """(stage_index, n_bg_steps) pairs for one iteration (single-tenant
        view; see ``schedule_tenants`` for the multi-tenant packing)."""
        bg_t = self.bg_step_quantum
        out = []
        for gap in self.plan.gaps():
            op = f"stage{gap.stage_index}"
            if self.cfg.use_feedback and not self.monitor.collocation_allowed(op):
                continue
            n = math.floor(gap.duration / bg_t)
            if self.cfg.use_pacing:
                n = min(n, self.cfg.max_inflight)
            if n > 0:
                out.append((gap.stage_index, n))
        return out

    def reset_measured_qos(self) -> None:
        """Drop this plan's per-stage QoS state (baselines/EMAs/bans) from
        the monitor.  The monitor may hold *simulated* times (a shared
        coordinator monitor fed by MultiplexSim) — a different time domain
        than wall-clock measurement — so ``run_executable`` re-derives QoS
        state from measurement, and the admission sweep must predict
        against the same reset state or it would admit a roster for a
        schedule (banned gaps excluded) the measured run then abandons."""
        for si in range(len(self.plan.stages())):
            op = f"stage{si}"
            self.monitor.baseline.pop(op, None)
            self.monitor.ema.pop(op, None)
            self.monitor.banned.discard(op)

    # -- fair-share scheduling ---------------------------------------------

    def _roster_for(self, n: int) -> List[BgTenant]:
        """The first ``n`` tenants, padded with placeholder slots for
        admission-control what-ifs beyond the current roster."""
        roster = list(self.tenants[:n])
        while len(roster) < n:
            roster.append(BgTenant(f"bg{len(roster)}"))
        return roster

    @staticmethod
    def _roster_quanta(roster: Sequence[BgTenant],
                       bg_model: int) -> List[int]:
        """Effective per-slot chunk quanta: each tenant's own ``quantum``,
        falling back to the scheduler-wide ``bg_model``.  The single source
        for scheduling, submesh carving and executable prebuild — they must
        agree or chunks and compiled meshes diverge."""
        return [t.quantum or bg_model for t in roster]

    @staticmethod
    def _priority_groups(roster: Sequence[BgTenant]) -> List[Tuple[int, int]]:
        """[start, end) slot spans of equal-priority runs (roster is
        priority-sorted, so equal priorities are contiguous)."""
        groups: List[Tuple[int, int]] = []
        i = 0
        while i < len(roster):
            j = i
            while j < len(roster) and roster[j].priority == roster[i].priority:
                j += 1
            groups.append((i, j))
            i = j
        return groups

    def _fair_assignment(self, roster: Sequence[BgTenant], iteration: int,
                         quanta: Sequence[int]) -> List[int]:
        """chunk position -> roster slot permutation for one iteration.

        Chunk positions are priority-ordered (position 0 = largest chunk).
        Within each equal-priority group the owning slot is chosen by
        (largest deficit first, then round-robin rotation by ``iteration``),
        so a tenant the packing starved accumulates deficit and is promoted
        to the front — the starvation guard: over k iterations every member
        of a k-tenant group owns the group's best chunk at least once.
        Rotation spans *mixed quanta* too: ``_schedule_detail`` carves each
        chunk position with the assigned tenant's own quantum (not the
        canonical owner's), so any group member's submesh tiles its chunk by
        construction — heterogeneous rosters no longer silently degrade to
        fixed priority-order ownership.  ``quanta`` is kept for signature
        stability (the carving, not the rotation, consumes it now).
        Singleton groups keep the identity assignment.
        """
        del quanta  # rotation no longer restricted to equal-quantum peers
        perm = list(range(len(roster)))
        for i, j in self._priority_groups(roster):
            k = j - i
            if k <= 1:
                continue
            order = sorted(
                range(i, j),
                key=lambda s: (-self._deficits[s], (s - i - iteration) % k),
            )
            for pos, slot in zip(range(i, j), order):
                perm[pos] = slot
        return perm

    def _slot_step_times(self, n: int, gap_chunks: Dict[int, list],
                         perm: Optional[Sequence[int]] = None) -> List[float]:
        """Per-slot bg step-time quantum: each tenant's step is sized to the
        smallest gap *it* occupies in the canonical layout, not the global
        gap minimum — a tenant holding only wide gaps runs bigger steps.
        A step's size is a property of the tenant's compiled executable, so
        it is sized once from the canonical (identity) layout — a rotation
        that moves the tenant into a narrower gap must fall back, not
        shrink the step mid-run.  ``perm`` overrides the position -> slot
        mapping for callers that want layout-specific sizing."""
        cfg = self.cfg
        if not cfg.use_granularity:
            return [cfg.bg_step_time] * n
        stages = self.plan.stages()
        out = [self.bg_step_quantum] * n
        slot_durs: Dict[int, list] = defaultdict(list)
        for si, chunks in gap_chunks.items():
            for pos, c in enumerate(chunks):
                if c is None:
                    continue
                slot = perm[pos] if perm is not None else pos
                slot_durs[slot].append(stages[si].duration)
        for slot in range(n):
            durs = slot_durs.get(slot)
            if durs:
                t = min(cfg.bg_step_time,
                        max(cfg.bg_min_step_time, min(durs) / 2.0))
                out[slot] = max(t, cfg.bg_min_step_time)
        return out

    def _schedule_detail(
        self, n_tenants: Optional[int] = None, bg_model: int = 1,
        iteration: Optional[int] = None,
        roster: Optional[Sequence[BgTenant]] = None,
    ) -> List[Tuple[int, int, int, Tuple[int, int], int, float]]:
        """Full per-iteration packing: (stage_index, tenant_slot, chunk_pos,
        (start, end), n_bg_steps, bg_step_time) rows.

        Each unbanned gap's per-stage free ranges are carved into per-tenant
        chunks (``pack_ranges`` per-tenant mode).  ``_fair_assignment``
        first maps chunk positions to owning slots (deficit promotion +
        round-robin rotation within each equal-priority group, mixed quanta
        included), and the carving aligns each position to the *assigned*
        tenant's quantum — so every owner's submesh tiles its chunk by
        construction, whatever the rotation round.  When any tenant carries
        a significant fair-share deficit, the per-position deficits feed
        ``pack_ranges``'s share-sizing (``shares``): lagging tenants claim
        *wider* chunks instead of rotating into the same equal-split chunk
        forever; a gap falls back to the equal-halving layout if share
        sizing would drop a slot the equal split served.  Steps pace at
        ``min(floor(gap / slot_step_time), max_inflight)`` per tenant.
        """
        n = n_tenants if n_tenants is not None else max(1, len(self.tenants))
        if n <= 0:
            return []
        roster = list(roster) if roster is not None else self._roster_for(n)
        quanta = self._roster_quanta(roster, bg_model)
        it = self._round if iteration is None else iteration
        perm = self._fair_assignment(roster, it, quanta)
        # carve at the assigned owner's quantum; size by its deficit share
        pos_quanta = [quanta[perm[pos]] for pos in range(n)]
        unit = max(self.bg_step_quantum, 1e-12)
        deficits = [self._deficits[s] for s in range(n)]
        pos_shares = None
        if any(d > 0.5 * unit for d in deficits):
            pos_shares = [1.0 + min(3.0, deficits[perm[pos]] / unit)
                          for pos in range(n)]
        gap_chunks: Dict[int, list] = {}
        for gap in self.plan.gaps():
            op = f"stage{gap.stage_index}"
            if self.cfg.use_feedback and not self.monitor.collocation_allowed(op):
                continue
            free = self.plan.free_device_ranges(gap.stage_index)
            chunks = pack_ranges(free, n, quantum=pos_quanta)
            if pos_shares is not None:
                sized = pack_ranges(free, n, quantum=pos_quanta,
                                    shares=pos_shares)
                # share sizing must never starve a slot the equal split
                # served (a boosted claim can make a later slot
                # unsatisfiable in tight layouts)
                if ({i for i, c in enumerate(chunks) if c is not None}
                        <= {i for i, c in enumerate(sized) if c is not None}):
                    chunks = sized
            if any(c is not None for c in chunks):
                gap_chunks[gap.stage_index] = chunks
        step_t = self._slot_step_times(n, gap_chunks)
        self._last_step_t = step_t
        stages = self.plan.stages()
        rows: List[Tuple[int, int, int, Tuple[int, int], int, float]] = []
        for si in sorted(gap_chunks):
            chunks = gap_chunks[si]
            dur = stages[si].duration
            assign = {pos: perm[pos] for pos, c in enumerate(chunks)
                      if c is not None}
            for pos in sorted(assign):
                slot = assign[pos]
                cs, ce = chunks[pos]
                nsteps = math.floor(dur / step_t[slot])
                if (nsteps <= 0 and slot != pos
                        and (ce - cs) % quanta[pos] == 0):
                    # a rotated-in tenant whose step is too big for this gap
                    # would leave the chunk idle — hand it back to the
                    # canonical owner (when its quantum tiles the chunk)
                    # rather than waste it
                    slot = pos
                    nsteps = math.floor(dur / step_t[slot])
                if self.cfg.use_pacing:
                    nsteps = min(nsteps, self.cfg.max_inflight)
                if nsteps > 0:
                    rows.append((si, slot, pos, (cs, ce), nsteps,
                                 step_t[slot]))
        return rows

    def schedule_tenants(
        self, n_tenants: Optional[int] = None, bg_model: int = 1,
        iteration: Optional[int] = None,
    ) -> List[Tuple[int, int, int]]:
        """(stage_index, tenant_slot, n_bg_steps) triples for one iteration.

        Mirrors the executable packing exactly — see ``_schedule_detail``
        for the per-tenant quantum / fair-rotation semantics.  ``iteration``
        selects the rotation round (default: the collocator's internal
        round, advanced by ``note_launched``)."""
        return [(si, slot, n) for si, slot, _pos, _c, n, _t in
                self._schedule_detail(n_tenants, bg_model, iteration)]

    def note_launched(self, launched_by: Sequence[int],
                      roster: Optional[Sequence[BgTenant]] = None) -> None:
        """Record one collocated iteration's per-slot launches: updates the
        fair-share deficit counters (weighted fair share minus actual, floor
        0) and advances the rotation round.  Called by ``run_executable``
        after every collocated iteration; scheduling-only callers drive it
        directly to exercise the starvation guard.

        Accounting is in *service time* (launched steps x the slot's
        step-time quantum), not raw step counts: tenants deliberately run
        different step sizes (per-tenant quanta), so counting steps would
        let a big-step tenant's deficit grow without bound — it can never
        match a small-step peer's count — freezing the rotation with that
        tenant pinned to the best chunk forever."""
        roster = list(roster) if roster is not None else list(self.tenants)
        step_t = self._last_step_t

        def service(s: int) -> float:
            got = launched_by[s] if s < len(launched_by) else 0
            t = step_t[s] if s < len(step_t) else self.bg_step_quantum
            return got * t

        for i, j in self._priority_groups(roster):
            if j - i <= 1:
                continue
            total = sum(service(s) for s in range(i, j))
            wsum = sum(max(roster[s].weight, 0.0) for s in range(i, j))
            if wsum <= 0.0:
                continue
            for s in range(i, j):
                fair = total * max(roster[s].weight, 0.0) / wsum
                self._deficits[s] = max(
                    0.0, self._deficits[s] + fair - service(s)
                )
        self._round += 1

    # -- executable submesh path -------------------------------------------

    def _device_list(self) -> list:
        """One device per plan position (see the class docstring)."""
        if self.devices is not None:
            return list(self.devices)
        from repro_torch.launch.mesh import host_devices

        if self.cfg.collocate_same_device:
            card = torch.device("cuda", torch.cuda.current_device())
            return [card] * self.plan.num_gpus
        return host_devices()

    def submeshes(self, *, fg_model: int = 1, bg_model: int = 1,
                  tenants: Optional[int] = None,
                  tenant_quanta: Optional[Sequence[int]] = None):
        """Disjoint fg/bg slices for this plan (PlanSubmeshes).

        ``tenants`` (default: this collocator's tenant count) splits each
        gap's free ranges into that many per-tenant slices.
        ``tenant_quanta`` (default: the roster's per-tenant quanta, when any
        tenant sets one) switches to the slot-aware per-tenant carving.
        What-if counts beyond the roster pad with placeholder slots exactly
        like the scheduler (quantum = ``bg_model``), so the carved chunks
        always match what ``schedule_tenants(n)`` packs."""
        from repro_torch.launch.mesh import split_mesh_for_plan

        n = tenants if tenants is not None else max(1, len(self.tenants))
        if tenant_quanta is None and any(t.quantum for t in self.tenants[:n]):
            tenant_quanta = self._roster_quanta(self._roster_for(n), bg_model)
        return split_mesh_for_plan(self.plan, devices=self._device_list(),
                                   ids=self.device_ids,
                                   fg_model=fg_model, bg_model=bg_model,
                                   tenants=n, tenant_quanta=tenant_quanta)

    # -- calibration + analytic prediction ---------------------------------

    def _current_densities(self, bg_model: int = 1) -> Dict[int, float]:
        """Per-stage tenant density of the current schedule (distinct
        tenant slots packed into each collocated gap stage)."""
        return _stage_densities(self._schedule_detail(None, bg_model))

    def calibrate(self, results: Sequence[CollocationResult]) -> InterferenceModel:
        """Fit the interference model's submesh-mode multipliers from
        measured ``CollocationResult``s.

        Scalar fit (always): the measured foreground slowdown is attributed
        to the collocated gap stages of the current tenant schedule — with
        collocated gap time ``W_gap`` out of total iteration time ``W``, a
        measured (geometric mean) slowdown ``s`` inverts to
        ``gap_inflation = 1 + (s-1)*W/W_gap`` — exactly the multiplier that
        makes ``predict()`` reproduce ``s``.

        Per-stage fit (when results carry ``stage_slowdowns``): each
        measured gap stage's multiplier is the geometric mean of its
        per-stage slowdowns, then the vector's excess over 1.0 is rescaled
        so the duration-weighted aggregate still reproduces ``s`` exactly —
        per-stage *shape* from the stage measurements, the closed-form
        aggregate inversion preserved.  Collocated stages without a
        per-stage measurement keep the scalar multiplier, and the vector is
        rescaled to the *residual* excess only, so partial stage coverage
        never double-counts the measured slowdown.

        Density fit (when results span *different* tenant densities): the
        measured excess slowdowns ``(s_r - 1)`` are regressed against each
        result's mean collocated density ``d_r`` under the linear model
        ``s - 1 = c * (1 + slope*(d-1))`` — an ordinary least-squares line
        ``y = b0 + b1*x`` over ``(d_r - 1, s_r - 1)`` gives
        ``density_slope = b1/b0``, clamped to [0, 10] and kept only when
        both coefficients are positive (interference grows with density or
        the fit is noise).  Results at a single density keep the prior
        slope — one operating point cannot identify it.  The scalar and
        per-stage inversions below then divide out the *current* schedule's
        per-stage density, so the stored multipliers are density-1 bases
        and ``predict()``'s ``gap_inflation_at`` reproduces ``s`` exactly
        at the calibration density.

        Every fitted multiplier (scalar and per-stage) is clamped to >= 1.0:
        on a noisy host a measured slowdown below 1.0 would otherwise fit a
        sub-1.0 multiplier and make ``predict()``/``MultiplexSim`` forecast
        that interference *speeds up* the foreground.  Installs the fitted
        model on this collocator's sim and returns it.
        """
        measured = [r for r in results
                    if r.iterations > 0 and r.fg_slowdown > 0.0]
        meas = [max(float(r.fg_slowdown), 1.0) for r in measured]
        if not meas:
            return self.interference
        log_mean = sum(math.log(s) for s in meas) / len(meas)
        s = math.exp(log_mean)
        slope = _fit_density_slope(measured, self.interference.density_slope)
        stages = self.plan.stages()
        detail = self._schedule_detail()
        cur_density = _stage_densities(detail)
        col_stages = set(cur_density)

        def dfac(si: int) -> float:
            d = cur_density.get(si, 1.0)
            if d <= 1.0 or slope <= 0.0:
                return 1.0
            return 1.0 + slope * (d - 1.0)

        # density-weighted gap time: the inversion divides the measured
        # excess across collocated stages in proportion to how much each
        # stage's density amplifies its base multiplier, so the stored base
        # is density-1 and predict() at the calibration density round-trips
        gap_t = sum(stages[si].duration * dfac(si) for si in col_stages)
        total = self.plan.total_time
        if gap_t <= 0.0 or total <= 0.0:
            gi = 1.0
        else:
            gi = 1.0 + (s - 1.0) * total / gap_t
        # per-stage fit: geomean of measured per-stage slowdowns, clamped,
        # then rescaled so the aggregate inversion stays exact.  Ingestion
        # keeps only stages the CURRENT schedule collocates: indices from an
        # earlier, differently-shaped plan would attribute slowdowns to the
        # wrong stages, and a stage the feedback loop has since banned never
        # inflates in predict() — folding its measurement into the rescale
        # denominator would dilute alpha and under-reproduce ``s``
        per_stage: Dict[int, List[float]] = defaultdict(list)
        for r in results:
            if r.iterations > 0:
                for si, v in r.stage_slowdowns:
                    if si in col_stages:
                        per_stage[si].append(max(float(v), 1.0))
        stage_vec: Tuple[Tuple[int, float], ...] = ()
        gi = max(gi, 1.0)
        if per_stage:
            fitted = {
                si: math.exp(sum(math.log(v) for v in vals) / len(vals))
                for si, vals in per_stage.items()
            }
            excess = sum(stages[si].duration * (fitted[si] - 1.0)
                         for si in fitted)
            # collocated stages WITHOUT a per-stage measurement keep the
            # scalar multiplier at predict() time, so the fitted vector must
            # explain only the residual excess — otherwise the aggregate is
            # double-counted and admission over-rejects
            unfitted_excess = sum(
                stages[si].duration * (gi - 1.0) * dfac(si)
                for si in col_stages if si not in fitted
            )
            want = max(0.0, (s - 1.0) * total - unfitted_excess)
            if excess > 0.0 and want > 0.0:
                alpha = want / excess
                # the measured per-stage slowdowns are *effective* values at
                # the calibration density; store the density-1 base so
                # gap_inflation_at reproduces the effective value exactly
                stage_vec = tuple(sorted(
                    (si, max(1.0, 1.0 + (fitted[si] - 1.0) * alpha / dfac(si)))
                    for si in fitted
                ))
            # excess == 0 (stage noise hid all inflation) -> no per-stage
            # shape to keep; fall back to the scalar inversion alone
        model = _dc_replace(self.interference, gap_inflation=gi,
                            gap_inflation_stages=stage_vec,
                            density_slope=slope)
        self.interference = model
        self._sim.imodel = model
        return model

    def predict(self, n_tenants: Optional[int] = None,
                bg_model: int = 1) -> CollocationResult:
        """Analytic (device-free) prediction of ``run_executable`` under the
        current (possibly calibrated) interference model and monitor state.

        Replays the tenant schedule through the calibrated multipliers:
        every collocated gap stage inflates by its per-stage
        ``gap_inflation_at`` — the fitted per-stage base (vector where
        available, scalar elsewhere) scaled by the stage's *tenant density*
        (how many distinct tenants pack into that gap this iteration, via
        the fitted ``density_slope``) — every packed tenant contributes its
        paced step count, and ``cluster_throughput`` — the admission
        objective — is (fg busy + bg busy) device-seconds over the inflated
        iteration, with bg busy estimated from each tenant's own step-time
        quantum and chunk width.  ``n_tenants=0`` is the fg-only operating
        point.  ``iterations == 0`` marks the result as predicted, not
        measured.
        """
        n = n_tenants if n_tenants is not None else max(1, len(self.tenants))
        n = max(0, n)
        detail = self._schedule_detail(n, bg_model) if n > 0 else []
        stages = self.plan.stages()
        fg_iso = self.plan.total_time
        density = _stage_densities(detail)
        fg_col = fg_iso + sum(
            stages[si].duration
            * (self.interference.gap_inflation_at(si, d) - 1.0)
            for si, d in density.items()
        )
        per_slot: Dict[int, int] = defaultdict(int)
        slot_stages: Dict[int, List[int]] = defaultdict(list)
        slot_devices: Dict[int, int] = defaultdict(int)
        slot_step_t: Dict[int, float] = {}
        bg_busy = 0.0
        for si, slot, _pos, (cs, ce), nsteps, bg_t in detail:
            per_slot[slot] += nsteps
            slot_stages[slot].append(si)
            slot_devices[slot] = max(slot_devices[slot], ce - cs)
            slot_step_t[slot] = bg_t
            bg_busy += nsteps * bg_t * (ce - cs)
        total_steps = float(sum(per_slot.values()))
        fg_busy = sum(s.duration * s.gpus for s in stages)
        cluster = (fg_busy + bg_busy) / max(fg_col * self.plan.num_gpus, 1e-30)
        # every scheduled slot gets a row — hypothetical tenant counts
        # (admission-control what-ifs beyond the current roster) show up as
        # placeholder tenants, so the per-tenant rows always sum to the
        # aggregate
        roster = self._roster_for(n)
        rows = tuple(
            TenantResult(
                job=t.job, priority=t.priority,
                bg_steps_per_iter=float(per_slot.get(slot, 0)),
                bg_throughput=per_slot.get(slot, 0) / max(fg_col, 1e-30),
                gap_stages=tuple(sorted(slot_stages.get(slot, ()))),
                devices=slot_devices.get(slot, 0),
                weight=t.weight,
                deficit=self._deficits[slot],
                quantum=t.quantum or bg_model,
                step_time=slot_step_t.get(slot, 0.0),
            )
            for slot, t in enumerate(roster)
        )
        res = CollocationResult(
            fg_iter_time=fg_col,
            fg_iter_time_isolated=fg_iso,
            fg_slowdown=fg_col / max(fg_iso, 1e-30),
            bg_steps_per_iter=total_steps,
            bg_throughput=total_steps / max(fg_col, 1e-30),
            iterations=0,
            banned_ops=tuple(sorted(self.monitor.banned)),
            tenants=rows,
            cluster_throughput=cluster,
        )
        res.jain_index = res.jain_fairness()
        return res

    def predicted_cache_keys(self, n_tenants: Optional[int] = None,
                             bg_model: int = 1,
                             device_ids: Optional[Sequence[int]] = None,
                             iteration: Optional[int] = None) -> List[tuple]:
        """Prediction-only collocation path: the ``ExecutableCache`` keys
        ``run_executable`` would compile for this iteration's schedule,
        without touching devices.

        Each scheduled (chunk, tenant) pair maps to the same
        ``(signature, device ids, mesh shape)`` triple ``ExecutableCache.key``
        derives from a real submesh — ``device_ids`` supplies the positional
        id mapping (the trace-driven cluster sim passes the sorted healthy
        set; default: identity).  Lets a device-free caller replay realistic
        cache reuse/eviction dynamics (LRU bound, ``evict_stale`` after
        re-plans) at simulated cluster scale.  Deduplicated, schedule order.
        """
        n = n_tenants if n_tenants is not None else max(1, len(self.tenants))
        if n <= 0:
            return []
        roster = self._roster_for(n)
        quanta = self._roster_quanta(roster, bg_model)
        keys: List[tuple] = []
        seen = set()
        for _si, slot, _pos, (cs, ce), _n, _t in self._schedule_detail(
                n, bg_model, iteration=iteration):
            if device_ids is not None:
                ids = tuple(device_ids[cs:ce])
            else:
                ids = tuple(range(cs, ce))
            model = quanta[slot]
            key = (roster[slot].cache_signature, ids,
                   ((ce - cs) // model, model))
            if key not in seen:
                seen.add(key)
                keys.append(key)
        return keys

    def admit(self, *, max_fg_slowdown: float = 1.33, bg_model: int = 1,
              max_tenants: Optional[int] = None) -> AdmissionDecision:
        """Predict-before-compile admission control (paper §5 operating-point
        selection): sweep candidate tenant counts 0..n through the
        calibrated ``predict()`` and admit the roster prefix whose predicted
        cluster throughput is highest among those keeping fg slowdown within
        ``max_fg_slowdown`` (the paper's 1.33x QoS bound).  Predicted
        throughput ties go to the *larger* roster — serving one more tenant
        at no predicted cluster cost is strictly better for fairness.  k=0
        (fg only, slowdown 1.0) is always feasible, so the decision never
        admits a roster the model says breaks the bound.  Nothing is
        compiled here — rejected tenants never reach the executable cache.
        """
        n_max = len(self.tenants) if max_tenants is None else max_tenants
        curve: List[Tuple[int, float, float]] = []
        best_k, best_c = 0, float("-inf")
        for k in range(n_max + 1):
            pred = self.predict(k, bg_model)
            curve.append((k, pred.fg_slowdown, pred.cluster_throughput))
            if (pred.fg_slowdown <= max_fg_slowdown + 1e-12
                    and pred.cluster_throughput >= best_c - 1e-9):
                best_k = k
                best_c = max(best_c, pred.cluster_throughput)
        return AdmissionDecision(
            bound=max_fg_slowdown,
            n_admitted=best_k,
            admitted=tuple(self.tenants[:best_k]),
            rejected=tuple(self.tenants[best_k:]),
            curve=tuple(curve),
        )

    def run_executable(
        self,
        make_fg_stage_fn: Callable,
        make_bg_step_fn: Optional[Callable] = None,
        *,
        tenants: Optional[Sequence[BgTenant]] = None,
        iterations: int = 3,
        fg_model: int = 1,
        bg_model: int = 1,
        time_fn: Callable[[], float] = _time.perf_counter,
    ) -> CollocationResult:
        """Measure real gap collocation on this collocator's device list.

        ``make_fg_stage_fn(stage, mesh)`` -> zero-arg callable running that
        foreground stage on its slice (a ``DeviceSlice`` over the stage's
        position prefix, carrying the foreground stream).  Background work
        comes from the prioritized tenant list — ``tenants`` here, else
        ``self.tenants``, else a single anonymous tenant wrapping
        ``make_bg_step_fn`` — and each tenant's ``step_fn_factory(mesh)``
        yields a zero-arg callable issuing one background step on its gap
        slice and stream (its completion is waited on by the pacing loop).
        Tenants pace independently on disjoint position chunks (per-tenant
        in-flight bound); dispatch per stage is in priority order.  When
        ``self.cache`` is set, built bg steps are looked up by (signature,
        position ids, shape) before building — a re-plan whose gap shapes
        are unchanged re-uses the steps.

        Every stage call and bg step is issued inside
        ``torch.cuda.stream(slice.stream)`` and followed by a
        ``torch.cuda.Event`` recorded on that stream; the loop waits on
        those events only (on the CPU, where slices have no stream, a call's
        own result stands for it).

        Runs ``iterations`` isolated iterations (recording per-stage
        baselines), ``iterations`` collocated ones, plus one final settled
        iteration after the feedback loop has banned harmful origins;
        returns min-over-iterations times so build noise and the feedback
        loop's learning phase don't pollute the steady state the QoS
        mechanism is meant to deliver.  The isolated baseline is then
        *re-measured* after the collocated phase and the slowdown computed
        against the slower of the two baselines (paired drift control:
        host-wide speed changes mid-measurement would otherwise read as
        collocation slowdown).  ``CollocationResult.tenants`` carries
        per-tenant throughput.
        """
        from repro_torch.launch.mesh import submesh_from_range

        roster = list(tenants) if tenants is not None else list(self.tenants)
        if not roster:
            if make_bg_step_fn is None:
                raise ValueError(
                    "run_executable needs background work: pass tenants or "
                    "make_bg_step_fn"
                )
            roster = [BgTenant("bg0", 0, make_bg_step_fn)]
        roster.sort(key=lambda t: -t.priority)  # stable: slot 0 = highest
        for t in roster:
            if t.step_fn_factory is None:
                raise ValueError(f"tenant {t.job!r} has no step_fn_factory")

        devs = self._device_list()
        # re-derive QoS state for this plan's ops from measurement so stale
        # (possibly simulated-domain) baselines can't poison the feedback
        self.reset_measured_qos()
        n_slots = len(roster)
        quanta = self._roster_quanta(roster, bg_model)
        # always pass the roster's quanta explicitly: submeshes() must carve
        # exactly the chunks _schedule_detail packs for THIS roster, even
        # when it differs from self.tenants (an override roster)
        split = self.submeshes(fg_model=fg_model, bg_model=bg_model,
                               tenants=n_slots, tenant_quanta=quanta)
        stages = self.plan.stages()
        # one stream carries every foreground stage: of the greatest priority
        # with use_priorities (a foreground left on the default stream would
        # share the least priority with the tenants)
        fg_stream = priority_stream(split.fg_mesh.device,
                                    urgent=self.cfg.use_priorities)
        mesh_cache: Dict[Tuple[int, int], object] = {
            split.fg_range: _dc_replace(split.fg_mesh, stream=fg_stream)
        }
        fg_fns = []
        for i, st in enumerate(stages):
            rng = split.stage_fg_range[i]
            if rng not in mesh_cache:
                model = fg_model if st.gpus % fg_model == 0 else 1
                mesh_cache[rng] = submesh_from_range(
                    rng[0], rng[1], model=model, devices=devs,
                    ids=self.device_ids, stream=fg_stream,
                )
            fg_fns.append(make_fg_stage_fn(st, mesh_cache[rng]))

        # per-(stage, chunk position, tenant-slot) bg step fns, built through
        # the executable cache so an unchanged gap slice reuses the built
        # step.  Only the canonical owner of each position (slot i on chunk
        # i) pre-builds; a fair-rotated (position, peer) combination builds
        # lazily on first dispatch — a k-member equal-priority group costs k
        # builds up front plus one per combination the rotation actually
        # reaches, never k^2 steps (and k^2 device-resident state replicas)
        # for assignments that may never occur.  A lazy build lands inside
        # one measured iteration; the min-over-iterations steady state
        # discards that sample.
        hits0 = self.cache.hits if self.cache else 0
        miss0 = self.cache.misses if self.cache else 0
        # bg step fns are keyed by (device chunk, tenant slot) — NOT by
        # (stage, position): rotation and deficit share-sizing re-carve the
        # chunks per iteration, and the same chunk reappearing in another
        # stage (or rotation round) must reuse the same built step.  Slices
        # are keyed by (chunk, model width) so a rotated-in tenant whose
        # quantum differs from the canonical owner's gets a slice shaped for
        # ITS model axis over the same positions.  Each built step keeps the
        # stream it was built on (its own, of the least priority), and the
        # cache holds the pair, so a cache hit issues on that same stream.
        bg_fns: Dict[Tuple[Tuple[int, int], int], Tuple[Callable, object]] = {}
        bg_meshes: Dict[Tuple[int, int, int], object] = {}
        slot_devices: Dict[int, int] = defaultdict(int)
        lazy_builds: List[Tuple[Tuple[int, int], int]] = []

        def build_bg_fn(chunk: Tuple[int, int],
                        slot: int) -> Optional[Tuple[Callable, object]]:
            fn = bg_fns.get((chunk, slot))
            if fn is not None:
                return fn
            if slot >= len(roster):
                return None
            cs, ce = chunk
            model = quanta[slot]
            if (ce - cs) % model:
                return None  # scheduler never emits this; belt-and-braces
            mesh = bg_meshes.get((cs, ce, model))
            if mesh is None:
                mesh = submesh_from_range(cs, ce, model=model, devices=devs,
                                          ids=self.device_ids)
                bg_meshes[(cs, ce, model)] = mesh
            tnt = roster[slot]

            def build(t=tnt, m=mesh, combo=(chunk, slot)):
                # only a REAL build marks the iteration as a build warm-up
                # — a warm-cache hit costs nothing and must not make
                # run_iter discard the iteration's QoS measurements
                lazy_builds.append(combo)
                own = _dc_replace(m, stream=priority_stream(m.device, urgent=False))
                return t.step_fn_factory(own), own.stream

            if self.cache is not None:
                key = ExecutableCache.key(tnt.cache_signature, mesh)
                fn = self.cache.get_or_build(key, build)
            else:
                fn = build()
            bg_fns[(chunk, slot)] = fn
            return fn

        for si, slots in split.bg_tenants.items():
            for pos, entry in enumerate(slots):
                if pos >= n_slots or entry is None:
                    continue
                bg_meshes[(entry[0][0], entry[0][1], quanta[pos])] = entry[1]
                build_bg_fn(entry[0], pos)  # canonical owner pre-builds

        # warm-up outside the timed region (cache hits re-warm too: one
        # step is cheap and keeps first-iteration timing honest)
        for fn in fg_fns:
            _block(_issue(fn, fg_stream))
        for bf, bs in bg_fns.values():
            _block(_issue(bf, bs))

        def run_iter(collocate: bool):
            rows = (
                self._schedule_detail(n_slots, bg_model,
                                      iteration=self._round, roster=roster)
                if collocate else []
            )
            by_stage: Dict[int, List[Tuple[int, int, Tuple[int, int], int]]] = (
                defaultdict(list))
            for si, slot, pos, c, n, _t in rows:
                by_stage[si].append((slot, pos, c, n))
            # per-tenant pacing: each tenant's slice is its own chunk of
            # positions on its own stream, so the in-flight bound
            # (non-preemptive tail control) applies per tenant, not across
            # them
            inflight: Dict[int, List[Tuple[int, object]]] = {
                s: [] for s in range(n_slots)
            }
            launched_by = [0] * n_slots
            stage_dts = [0.0] * len(fg_fns)
            builds_before = len(lazy_builds)
            t_start = time_fn()
            for si, fn in enumerate(fg_fns):
                op = f"stage{si}"
                for slot, pos, chunk, n_bg in sorted(by_stage.get(si, ())):
                    built = build_bg_fn(chunk, slot)  # lazy for rotated combos
                    if built is None:
                        continue
                    bf, bs = built
                    q = inflight[slot]
                    for _ in range(n_bg):
                        while len(q) >= self.cfg.max_inflight:
                            _block(q.pop(0)[1])  # launch pacing
                        q.append((si, _issue(bf, bs)))
                        launched_by[slot] += 1
                # completed steps no longer interfere — drop them so a slow
                # stage doesn't ban origins whose work already finished
                outstanding = set()
                for q in inflight.values():
                    q[:] = [(o, f) for o, f in q if not _future_done(f)]
                    outstanding.update(o for o, _ in q)
                t0 = time_fn()
                _block(_issue(fn, fg_stream))
                dt = time_fn() - t0
                stage_dts[si] = dt
                compiled = len(lazy_builds) > builds_before
                if not collocate:
                    prev = self.monitor.baseline.get(op)
                    self.monitor.record_baseline(
                        op, dt if prev is None else min(prev, dt)
                    )
                elif not compiled:
                    # an iteration that lazily built a rotated combo is a
                    # warm-up sample: its stage times include the build +
                    # state-replica setup, which must not feed the slowdown
                    # feedback (it would ban every collocated stage and shut
                    # collocation off for the rest of the run)
                    self.monitor.record(op, dt, collocated=bool(outstanding))
                    # non-preemptive bg tails harm *later* stages, not the
                    # gap they were launched into — attribute the overrun to
                    # the originating gap ops so the feedback loop converges
                    if (self.cfg.use_feedback and outstanding
                            and self.monitor.slowdown(op)
                            > self.monitor.slowdown_threshold):
                        self.monitor.banned.update(
                            f"stage{o}" for o in outstanding
                        )
            for q in inflight.values():
                for _, f in q:
                    _block(f)
            if collocate:
                # fair sharing: book per-slot launches into the deficit
                # counters and advance the rotation round
                self.note_launched(launched_by, roster)
            return (time_fn() - t_start, launched_by, rows, stage_dts,
                    len(lazy_builds) > builds_before)

        iso = [run_iter(False)[0] for _ in range(max(1, iterations))]
        fg_iso = min(iso)
        col: List[Tuple[float, int]] = []
        col_by_tenant: List[List[int]] = []
        col_bg_busy: List[float] = []
        slot_stages_ran: Dict[int, set] = defaultdict(set)
        col_stage_min: Dict[int, float] = {}

        def col_iter() -> None:
            t, launched_by, rows, stage_dts, compiled = run_iter(True)
            col.append((t, sum(launched_by)))
            col_by_tenant.append(launched_by)
            # bg device-seconds and per-tenant device footprint come from
            # the rows actually dispatched this iteration (not from every
            # chunk a rotation *candidate* could have held)
            col_bg_busy.append(sum(
                n * bg_t * (ce - cs) for _si, _sl, _p, (cs, ce), n, bg_t in rows
            ))
            for si, slot, _pos, (cs, ce), _n, _t in rows:
                slot_stages_ran[slot].add(si)
                slot_devices[slot] = max(slot_devices[slot], ce - cs)
                if not compiled:
                    col_stage_min[si] = min(
                        col_stage_min.get(si, float("inf")), stage_dts[si]
                    )
            # iteration-level watchdog: per-op feedback only bans ops whose
            # own slowdown crosses the threshold, but many sub-threshold
            # inflations can still break the iteration bound — ban every
            # origin that collocated in an over-bound iteration.  Warm-up
            # iterations (a rotated combo built lazily mid-iteration) are
            # exempt: their time is build + state setup, not interference
            if (self.cfg.use_feedback and rows and not compiled
                    and t > self.monitor.slowdown_threshold * fg_iso):
                self.monitor.banned.update(
                    f"stage{s}" for s, _, _, _, _, _ in rows
                )

        for _ in range(max(1, iterations)):
            col_iter()
        # settled phase: keep iterating until the feedback loop stops
        # learning (an iteration adds no new bans), so the measurement
        # includes the converged steady state the QoS mechanism promises
        # (bounded fg slowdown), not just the learning phase
        for _ in range(len(fg_fns)):
            before = set(self.monitor.banned)
            col_iter()
            if set(self.monitor.banned) == before:
                break
        # extra steady-state samples: the post-convergence min is the QoS
        # claim under test, so give it more than one draw against host
        # timing noise
        for _ in range(2):
            col_iter()
        # drift control: re-measure the isolated baseline now that the
        # collocated phase is done; min(col) is compared against the slower
        # of the before/after baselines so a host that slowed down (or sped
        # up) mid-run doesn't fake a slowdown the QoS loop never caused
        iso_post = [run_iter(False)[0] for _ in range(max(1, iterations))]
        fg_iso = max(fg_iso, min(iso_post))
        fg_col = min(t for t, _ in col)
        bg_steps = sum(n for _, n in col) / len(col)
        # per-gap-stage measured slowdown: collocated per-stage min against
        # the isolated per-stage baseline (per-stage calibration input).
        # Raw ratios — calibrate() clamps to >= 1.0 when fitting.
        stage_slowdowns = tuple(
            (si, col_stage_min[si] / self.monitor.baseline[f"stage{si}"])
            for si in sorted(col_stage_min)
            if self.monitor.baseline.get(f"stage{si}", 0.0) > 0.0
        )
        # measured cluster throughput in plan-time units: planned fg busy
        # over the slowdown-inflated iteration, plus the bg device-seconds
        # of the rows actually dispatched (per-row step-time quantum x its
        # own chunk width, averaged over the collocated iterations)
        slowdown = fg_col / max(fg_iso, 1e-30)
        fg_busy = sum(s.duration * s.gpus for s in stages)
        bg_busy = sum(col_bg_busy) / len(col_bg_busy)
        cluster = (fg_busy + bg_busy) / max(
            self.plan.total_time * slowdown * self.plan.num_gpus, 1e-30
        )
        tenant_rows = tuple(
            TenantResult(
                job=t.job, priority=t.priority,
                bg_steps_per_iter=(
                    sum(row[slot] for row in col_by_tenant) / len(col_by_tenant)
                ),
                bg_throughput=(
                    sum(row[slot] for row in col_by_tenant)
                    / len(col_by_tenant) / max(fg_col, 1e-30)
                ),
                gap_stages=tuple(sorted(slot_stages_ran.get(slot, ()))),
                devices=slot_devices.get(slot, 0),
                weight=t.weight,
                deficit=self._deficits[slot],
                quantum=quanta[slot],
                step_time=(self._last_step_t[slot]
                           if slot < len(self._last_step_t)
                           else self.bg_step_quantum),
            )
            for slot, t in enumerate(roster)
        )
        res = CollocationResult(
            fg_iter_time=fg_col,
            fg_iter_time_isolated=fg_iso,
            fg_slowdown=slowdown,
            bg_steps_per_iter=bg_steps,
            bg_throughput=bg_steps / max(fg_col, 1e-30),
            iterations=len(col),
            banned_ops=tuple(sorted(self.monitor.banned)),
            iter_details=tuple((t, n) for t, n in col),
            tenants=tenant_rows,
            cache_hits=(self.cache.hits - hits0) if self.cache else 0,
            cache_misses=(self.cache.misses - miss0) if self.cache else 0,
            stage_slowdowns=stage_slowdowns,
            cluster_throughput=cluster,
        )
        res.jain_index = res.jain_fairness()
        return res

    def run_iteration(self, fg_stage_fns: List[Callable], bg_step_fn: Callable,
                      time_fn: Callable[[], float]) -> Dict[str, float]:
        """Execute one fg iteration, filling gaps with bg steps (real
        dispatch, used by examples + small-scale tests).  The callables own
        their streams, so each returns what ``_block`` waits on: the
        ``torch.cuda.Event`` recorded after its work, a CPU tensor, or any
        other object (counted as still outstanding)."""
        sched = dict(self.schedule())
        inflight: List = []
        t_start = time_fn()
        for si, fn in enumerate(fg_stage_fns):
            op = f"stage{si}"
            n_bg = sched.get(si, 0)
            for _ in range(n_bg):
                while len(inflight) >= self.cfg.max_inflight:
                    inflight.pop(0)()  # block on oldest (pacing)
                fut = bg_step_fn()
                inflight.append(lambda f=fut: _block(f))
            t0 = time_fn()
            out = fn()
            _block(out)
            dt = time_fn() - t0
            if op not in self.monitor.baseline:
                self.monitor.record_baseline(op, dt)
            self.monitor.record(op, dt, collocated=n_bg > 0)
        for f in inflight:
            f()
        return {"iter_time": time_fn() - t_start}


def _stage_densities(detail) -> Dict[int, float]:
    """Per-stage tenant density from ``_schedule_detail`` rows: the number
    of distinct tenant slots launching steps inside each gap stage."""
    slots: Dict[int, set] = defaultdict(set)
    for si, slot, _pos, _chunk, nsteps, _t in detail:
        if nsteps > 0:
            slots[si].add(slot)
    return {si: float(len(s)) for si, s in slots.items()}


def _result_density(r: "CollocationResult") -> float:
    """Mean collocated-tenant density of a measured result: for each gap
    stage any tenant occupied, how many active tenants shared it, averaged
    over stages.  1.0 when the result carries no per-tenant rows (a
    single-tenant measurement)."""
    occupancy: Dict[int, int] = defaultdict(int)
    for t in r.tenants:
        if t.bg_steps_per_iter > 0:
            for si in t.gap_stages:
                occupancy[si] += 1
    if not occupancy:
        return 1.0
    return sum(occupancy.values()) / len(occupancy)


def _fit_density_slope(measured, prior: float) -> float:
    """OLS fit of ``density_slope`` from measured results at different
    tenant densities: under ``s - 1 = c * (1 + slope*(d-1))`` the line
    ``y = b0 + b1*x`` over points ``(d_r - 1, s_r - 1)`` has
    ``slope = b1/b0``.  Needs >= 2 distinct densities to identify the
    slope (else keeps ``prior``); negative or degenerate fits (interference
    shrinking with density = measurement noise) fall back to 0; clamped to
    [0, 10] so one noisy pair can't make admission reject everything."""
    pts = [(max(_result_density(r), 1.0) - 1.0,
            max(float(r.fg_slowdown), 1.0) - 1.0) for r in measured]
    if len({round(x, 9) for x, _ in pts}) < 2:
        return prior
    n = float(len(pts))
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    sxx = sum((x - mx) ** 2 for x, _ in pts)
    sxy = sum((x - mx) * (y - my) for x, y in pts)
    if sxx <= 0.0:
        return prior
    b1 = sxy / sxx
    b0 = my - b1 * mx
    if b0 <= 1e-9 or b1 <= 0.0:
        return 0.0
    return min(10.0, b1 / b0)


def _issue(fn: Callable, stream):
    """Call ``fn`` on ``stream`` and return what ``_block`` waits on: the
    event recorded on the stream right after the call (CUDA), or the
    call's own result (the CPU, where a slice has no stream)."""
    with torch.cuda.stream(stream):  # no-op for None
        out = fn()
    if stream is None:
        return out
    done = torch.cuda.Event()
    done.record(stream)
    return done


def _block(x):
    """Wait for a dispatched result: an event is synchronised (that stream
    alone, never the device), a CPU tensor is ready, and any other object is
    returned as it is (``_future_done`` counts it as still outstanding).
    A CUDA tensor without its event cannot be waited on here: the
    caller's stream is unknown, and ``torch.cuda.synchronize()`` would time
    every other stream's work into this one."""
    if isinstance(x, torch.cuda.Event):
        x.synchronize()
    elif isinstance(x, torch.Tensor) and x.device.type != "cpu":
        raise ValueError(
            f"_block: a {x.device} tensor without the torch.cuda.Event recorded on its "
            "stream after the dispatch")
    return x


def _future_done(x) -> bool:
    """True when a dispatched bg result has already completed (an event
    that has been reached, a CPU tensor); unknown objects count as still
    outstanding."""
    if isinstance(x, torch.cuda.Event):
        return bool(x.query())
    return isinstance(x, torch.Tensor) and x.device.type == "cpu"
