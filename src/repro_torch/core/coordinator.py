"""Cluster coordinator (paper §3.2): job registry, placement, elasticity.

The port of ``repro/core/coordinator.py``.  ``collocate`` simulates
collocation, or with ``executable=True`` measures it on real devices
(``Collocator.run_executable``): in GPU mode
(``MultiplexConfig.collocate_same_device``) every healthy position is one
card, in submesh mode each is one of the host's cards, and too few of them
falls back to the simulation, as in the reference.

Manages all runtimes: places a new foreground job on the device subset its
burst plan requests, registers background jobs per device, and handles
cluster-size changes (device failure / elastic scale) by *re-planning* —
elastic scaling falls out of the planner abstraction, since a BurstPlan is a
pure function of (graph, G, amp_limit).
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.costmodel import Hardware
from repro_torch.core.multiplex import (
    AdmissionDecision,
    BgTenant,
    Collocator,
    CollocationResult,
    ExecutableCache,
    InterferenceModel,
    MultiplexConfig,
    MultiplexSim,
    QoSMonitor,
)
from repro_torch.core.plan import BurstPlan
from repro_torch.core.planner import plan as make_plan
from repro_torch.launch.mesh import host_devices

# paper §5: the fg slowdown the QoS/admission machinery must hold
QOS_SLOWDOWN_BOUND = 1.33


def _placeholder_factory(mesh):
    """Stand-in step factory for prediction-only admission sweeps: rosters
    jobs registered without a ``step_fn_factory`` so ``readmit`` can reason
    about them analytically; never compiled or called."""
    return lambda: None


@dataclass
class Job:
    name: str
    kind: str  # 'foreground' | 'background'
    graph: list  # LayerGraph
    amp_limit: float = 2.0
    plan: Optional[BurstPlan] = None
    devices: tuple = ()
    status: str = "pending"  # pending | running | failed | done
    steps_done: int = 0
    priority: int = 0  # background jobs: higher packs first into gaps
    step_fn_factory: Optional[Callable] = None  # mesh -> zero-arg bg step
    weight: float = 1.0  # fair-share weight among equal-priority tenants
    quantum: Optional[int] = None  # device-chunk alignment for gap packing


@dataclass
class ClusterEvent:
    t: float
    kind: str  # 'failure' | 'join' | 'replan' | 'straggler'
    detail: str


class ClusterCoordinator:
    """Single source of truth for placement + plan lifecycle.

    ``clock`` injects a time source for the event log (the trace-driven
    cluster simulator advances a virtual clock per replayed event; default
    is wall time).  ``virtual_devices=True`` decouples the coordinator from
    the process's CUDA devices entirely: device ids ARE the healthy indices,
    so a 1024-device cluster can be simulated on a 1-device host and
    executable-cache eviction reasons about simulated ids instead of
    positionally mapping onto ``range(torch.cuda.device_count())``.
    """

    def __init__(self, num_devices: int, hw: Optional[Hardware] = None, *,
                 clock: Optional[Callable[[], float]] = None,
                 virtual_devices: bool = False,
                 verify_plans: Optional[bool] = None):
        self.num_devices = num_devices
        self.hw = hw or Hardware()
        self._clock = clock or time.time
        self.virtual_devices = virtual_devices
        # every installed/re-planned plan goes through the static verifier
        # (repro_torch.analysis.verify) — O(layers + stages) pure metadata,
        # so it is on by default; REPRO_VERIFY_PLANS=0 (or
        # verify_plans=False) turns it off for hot replay loops that
        # re-plan thousands of times
        if verify_plans is None:
            verify_plans = os.environ.get("REPRO_VERIFY_PLANS", "1") != "0"
        self.verify_plans = verify_plans
        self.healthy = set(range(num_devices))
        self.jobs: Dict[str, Job] = {}
        self.events: List[ClusterEvent] = []
        self.monitor = QoSMonitor()
        # survives re-plans: unchanged gap shapes reuse compiled bg steps
        self.exec_cache = ExecutableCache()
        self.interference = InterferenceModel()
        self.collocation_results: List[CollocationResult] = []
        self._last_mcfg = MultiplexConfig()  # config of the last collocation
        self.last_admission: Optional[AdmissionDecision] = None

    # -- job lifecycle ------------------------------------------------------

    def submit_foreground(self, job: Job) -> BurstPlan:
        job.kind = "foreground"
        job.plan = make_plan(job.graph, self._usable_devices(), job.amp_limit, self.hw)
        job.devices = tuple(sorted(self.healthy))
        job.status = "running"
        self.jobs[job.name] = job
        self._verify_installed(job.plan, f"submit_foreground({job.name})")
        return job.plan

    def submit_background(self, job: Job) -> None:
        job.kind = "background"
        job.status = "running"
        self.jobs[job.name] = job

    def foreground(self) -> Optional[Job]:
        for j in self.jobs.values():
            if j.kind == "foreground" and j.status == "running":
                return j
        return None

    def background_tenants(
        self, default_step_fn_factory: Optional[Callable] = None
    ) -> List[BgTenant]:
        """Running background jobs as a prioritized BgTenant roster.

        A job without its own ``step_fn_factory`` falls back to
        ``default_step_fn_factory`` (the ``make_bg_step_fn`` passed to
        ``collocate``); jobs with neither are skipped.  Sorted by priority
        (higher first), stable in submission order.
        """
        out = []
        for j in self.jobs.values():
            if j.kind != "background" or j.status != "running":
                continue
            factory = j.step_fn_factory or default_step_fn_factory
            if factory is None:
                continue
            sig = None
            if j.step_fn_factory is None:
                # shared default factory: scope the executable identity per
                # job, or two jobs whose chunks happen to land on the same
                # device range would silently share one compiled step (and
                # its training state) through the cache
                sig = (j.name,
                       getattr(factory, "signature", None) or factory)
            out.append(BgTenant(j.name, j.priority, factory, signature=sig,
                                weight=j.weight, quantum=j.quantum))
        out.sort(key=lambda t: -t.priority)
        return out

    def _usable_devices(self) -> int:
        """Every healthy device.  The planner's scale set covers non-pow2
        pool sizes (``plan_scales``), so a 1024-device pool with 3 dead
        devices plans at 1021 instead of rounding down to 512 and silently
        discarding ~half the survivors."""
        return len(self.healthy)

    def _verify_installed(self, plan: Optional[BurstPlan],
                          context: str) -> None:
        """Statically verify a just-installed plan against the current pool
        (range disjointness, coverage, amp limits, survivor-pool exactness
        — ``repro_torch.analysis.verify``).  Gated by ``verify_plans``;
        raises ``PlanVerificationError`` so a planner regression fails at
        install time instead of surfacing as silent throughput loss."""
        if plan is None or not self.verify_plans:
            return
        from repro_torch.analysis.verify import verify_plan_or_raise

        verify_plan_or_raise(plan, pool_size=len(self.healthy),
                             context=context)

    # -- elasticity / fault handling ---------------------------------------

    def handle_failure(self, device_id: int) -> Optional[BurstPlan]:
        """Device loss: shrink the healthy set and re-plan the foreground
        job onto the exact surviving pool. Returns the new plan.
        Compiled bg steps whose submesh touched the dead device are evicted
        from the executable cache — their device-committed state is gone, so
        holding them alive would only pin dead jitted state."""
        self.healthy.discard(device_id)
        self.events.append(ClusterEvent(self._clock(), "failure", f"device {device_id}"))
        self._evict_stale_executables()
        fg = self.foreground()
        if fg is None:
            return None
        old = fg.plan
        fg.plan = make_plan(fg.graph, self._usable_devices(), fg.amp_limit, self.hw)
        fg.devices = tuple(sorted(self.healthy))
        self._drop_stale_measurements(old, fg.plan)
        self.events.append(
            ClusterEvent(self._clock(), "replan", f"G={fg.plan.num_gpus}")
        )
        self._verify_installed(fg.plan, f"handle_failure({device_id})")
        return fg.plan

    def handle_join(self, device_ids) -> Optional[BurstPlan]:
        """Elastic scale-up: devices join, re-plan to exploit them.

        Idempotent: a join announcement covering only already-healthy
        devices (re-delivered heartbeat, duplicate trace event) changes
        nothing — no join event is logged and no spurious re-plan runs.
        Returns the new plan, or None when the healthy set is unchanged
        or no foreground job is running.
        """
        new = set(device_ids) - self.healthy
        if not new:
            return None
        self.healthy.update(new)
        self.events.append(ClusterEvent(self._clock(), "join", f"+{len(new)}"))
        self._evict_stale_executables()
        fg = self.foreground()
        if fg is None:
            return None
        old = fg.plan
        fg.plan = make_plan(fg.graph, self._usable_devices(), fg.amp_limit, self.hw)
        fg.devices = tuple(sorted(self.healthy))
        self._drop_stale_measurements(old, fg.plan)
        self._verify_installed(fg.plan, f"handle_join(+{len(new)})")
        return fg.plan

    def restore_pool(self, devices) -> None:
        """Coordinator failover: adopt the surviving pool a previous holder
        already re-planned onto (``CoordinatorLoop.bootstrap_from_log``).

        Unlike ``handle_failure``/``handle_join`` this fires no mitigation
        and publishes nothing — those mitigations already ran on the old
        coordinator and the workers already hold the reconfig events; a
        fresh holder that re-fired them would double-plan and double-log.
        The foreground is re-planned *silently* when its plan does not
        match the restored pool, and stale executables are evicted."""
        self.healthy = set(int(d) for d in devices)
        self._evict_stale_executables()
        fg = self.foreground()
        if fg is None:
            return
        if fg.plan is None or fg.plan.num_gpus != len(self.healthy):
            old = fg.plan
            fg.plan = make_plan(fg.graph, self._usable_devices(),
                                fg.amp_limit, self.hw)
            fg.devices = tuple(sorted(self.healthy))
            self._drop_stale_measurements(old, fg.plan)
            self._verify_installed(fg.plan, "restore_pool")

    def handle_departure(self, name: str) -> bool:
        """Tenant churn: a running job finishes/leaves the cluster.  The job
        is marked done (so ``background_tenants`` stops rostering it) and
        the departure is logged; the next ``collocate``/admission sweep sees
        the shrunken roster.  Returns False for unknown/already-gone jobs
        (trace replay may race a departure against a crash)."""
        job = self.jobs.get(name)
        if job is None or job.status != "running":
            return False
        job.status = "done"
        self.events.append(ClusterEvent(self._clock(), "departure", name))
        return True

    def readmit(self, admission_bound: float = QOS_SLOWDOWN_BOUND, *,
                reason: str = "epoch") -> Optional[AdmissionDecision]:
        """Continuous admission: re-sweep the current tenant roster against
        the current plan (prediction only — nothing compiles).

        The live control plane calls this each epoch and on every churn
        event (``CoordinatorLoop``), instead of admission running once at
        submesh-carving time: after a failure shrinks the gaps, or a tenant
        arrives/departs, the argmax-cluster-throughput sweep re-decides
        which prefix of the roster stays under the QoS bound.  With the
        density-aware ``InterferenceModel`` the sweep rejects the
        *marginal* tenant — each extra collocated tenant inflates the gap
        stages a bit more, so the curve peaks at some 0 < k < n instead of
        all-or-nothing.

        The sweep predicts against a fresh ``QoSMonitor`` (stale feedback
        bans from a previous operating point must not leak into the
        decision) and uses placeholder factories for rostered jobs so
        prediction works with or without compiled steps.  Logs an
        'admission' ClusterEvent only when the admitted set *changed* since
        the previous decision (churn is the signal; a stable roster
        re-admitted every epoch stays silent).  Returns the decision, or
        None when there is no planned foreground job or no tenants.
        """
        fg = self.foreground()
        if fg is None or fg.plan is None:
            return None
        tenants = self.background_tenants(_placeholder_factory)
        if not tenants:
            return None
        col = Collocator(fg.plan, self._last_mcfg, monitor=QoSMonitor(),
                         tenants=tenants, interference=self.interference)
        decision = col.admit(max_fg_slowdown=admission_bound)
        prev = self.last_admission
        prev_set = tuple(t.job for t in prev.admitted) if prev else None
        now_set = tuple(t.job for t in decision.admitted)
        if prev_set != now_set:
            self.events.append(ClusterEvent(
                self._clock(), "admission", f"{reason}: {decision.row()}"
            ))
        self.last_admission = decision
        return decision

    def _drop_stale_measurements(self, old: Optional[BurstPlan],
                                 new: Optional[BurstPlan]) -> None:
        """A re-plan that actually changed the foreground plan invalidates
        the accumulated CollocationResults: their per-stage slowdowns (and
        schedules) describe the old plan's stages, and feeding them to
        ``calibrate`` would attribute interference to the wrong stages of
        the new plan.  The fitted per-stage inflation vector is stale for
        the same reason (keyed by old-plan stage indices) and is dropped
        too; the scalar ``gap_inflation`` survives — it measures the host,
        not the plan shape, and is the best prior for the next admission
        sweep until the new plan is measured.  A no-op re-plan (identical
        layer tuple) keeps everything."""
        if old is not None and new is not None and old.layers != new.layers:
            self.collocation_results.clear()
            if self.interference.gap_inflation_stages:
                self.interference = dataclasses.replace(
                    self.interference, gap_inflation_stages=()
                )

    def _evict_stale_executables(self) -> int:
        """Drop executable-cache entries whose slice uses a position outside
        the healthy set.  In ``virtual_devices`` mode, and in GPU mode (the
        last collocation's ``collocate_same_device``: every healthy position
        is on the one card), the healthy indices themselves are the live
        ids, so simulated 1024-device clusters get real eviction semantics
        on a 1-device host.  Otherwise healthy indices map positionally onto
        the process's CUDA devices (``range(torch.cuda.device_count())``).
        No-op when the cache is empty."""
        if not self.exec_cache.entries:
            return 0
        if self.virtual_devices or self._last_mcfg.collocate_same_device:
            live = set(self.healthy)
        else:
            n_dev = torch.cuda.device_count()
            live = {i for i in self.healthy if i < n_dev}
        n = self.exec_cache.evict_stale(live)
        if n:
            self.events.append(
                ClusterEvent(self._clock(), "evict", f"{n} stale executables")
            )
        return n

    # -- multiplexing -------------------------------------------------------

    def simulate_collocation(self, mcfg: Optional[MultiplexConfig] = None):
        fg = self.foreground()
        assert fg is not None and fg.plan is not None
        sim = MultiplexSim(fg.plan, mcfg or MultiplexConfig(),
                           self.interference, monitor=self.monitor)
        return sim.run()

    def collocate(
        self,
        mcfg: Optional[MultiplexConfig] = None,
        *,
        executable: bool = False,
        make_fg_stage_fn: Optional[Callable] = None,
        make_bg_step_fn: Optional[Callable] = None,
        iterations: int = 3,
        calibrate: bool = False,
        admission_bound: Optional[float] = QOS_SLOWDOWN_BOUND,
        device: DeviceLike = None,
    ):
        """Collocate background work into the foreground plan's gaps.

        ``executable=True`` dispatches real steps onto the plan's device
        slices (``Collocator.run_executable``), returning a measured
        ``CollocationResult``.  In GPU mode (``mcfg.collocate_same_device``)
        every healthy position is ``device`` (default: the card; ``"cpu"``
        runs the same loop on the CPU), each tenant on its own stream.  In
        submesh mode the positions are the host's devices of ``device``'s
        type, and when there are fewer than the plan assumes it falls back
        to the costless ``MultiplexSim`` (logged as a 'fallback'
        ClusterEvent) and returns a ``SimResult`` — both expose
        ``fg_slowdown`` / ``bg_steps_per_iter`` / ``row()``.

        Every running background job becomes a tenant
        (``background_tenants``), so several ``submit_background`` jobs
        actually co-run inside the gaps, packed by priority; a job without
        its own ``step_fn_factory`` uses ``make_bg_step_fn``.  With no
        background jobs registered, ``make_bg_step_fn`` runs as a single
        anonymous tenant.  Built bg steps go through the coordinator's
        ``exec_cache`` — after a ``handle_failure``/``handle_join`` re-plan
        with unchanged gap shapes the steps are reused.
        ``calibrate=True`` refits ``self.interference`` from the measured
        result so subsequent ``simulate_collocation`` calls track hardware.

        Admission control runs *before anything is built*: the candidate
        roster is swept through the calibrated ``Collocator.predict`` and
        only the argmax-cluster-throughput prefix whose predicted fg
        slowdown stays within ``admission_bound`` (paper §5: 1.33x) is
        built and run — rejected tenants are reported on
        ``CollocationResult.rejected_tenants`` and logged as an 'admission'
        ClusterEvent, and never touch the executable cache.  With an
        uncalibrated model (``gap_inflation`` 1.0) every tenant is
        predicted harmless and admitted.  ``admission_bound=None`` disables
        the sweep.
        """
        fg = self.foreground()
        assert fg is not None and fg.plan is not None
        self._last_mcfg = mcfg or MultiplexConfig()
        if executable:
            tenants = self.background_tenants(make_bg_step_fn)
            if make_fg_stage_fn is None or (
                not tenants and make_bg_step_fn is None
            ):
                raise ValueError(
                    "executable collocation needs make_fg_stage_fn and "
                    "background work (make_bg_step_fn or submitted "
                    "background jobs with step_fn_factory)"
                )
            # collocate onto the SURVIVING positions (the sorted healthy
            # set): after a low-index failure the carving must not place
            # work on the dead device, and the eviction semantics (entries
            # touching a dead position are dropped) only hold if the dead
            # position is actually excluded from new slices
            healthy = sorted(self.healthy)
            if self._last_mcfg.collocate_same_device:
                dev = resolve_device(device)
                if dev.type == "cuda" and dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                ids = healthy
                survivors = [dev] * len(ids)
            else:
                devs = host_devices(device)
                ids = [i for i in healthy if i < len(devs)]
                survivors = [devs[i] for i in ids]
            if len(survivors) >= fg.plan.num_gpus:
                col = Collocator(fg.plan, mcfg or MultiplexConfig(),
                                 monitor=self.monitor, tenants=tenants,
                                 devices=survivors, device_ids=ids,
                                 cache=self.exec_cache,
                                 interference=self.interference)
                rejected: tuple = ()
                if admission_bound is not None and col.tenants:
                    # the measured run re-derives per-stage QoS state from
                    # wall-clock measurement; the admission sweep must
                    # predict against that same reset state, not stale bans
                    # the run is about to discard
                    col.reset_measured_qos()
                    decision = self.last_admission = col.admit(
                        max_fg_slowdown=admission_bound
                    )
                    if decision.rejected:
                        rejected = tuple(t.job for t in decision.rejected)
                        self.events.append(ClusterEvent(
                            self._clock(), "admission", decision.row()
                        ))
                    if decision.n_admitted == 0:
                        # nothing admitted: return the fg-only prediction —
                        # no tenant is ever built (iterations == 0 marks it
                        # predicted, so calibrate() ignores it)
                        res = col.predict(0)
                        res.rejected_tenants = rejected
                        return res
                    if decision.rejected:
                        col = Collocator(fg.plan, self._last_mcfg,
                                         monitor=self.monitor,
                                         tenants=decision.admitted,
                                         devices=survivors, device_ids=ids,
                                         cache=self.exec_cache,
                                         interference=self.interference)
                res = col.run_executable(
                    make_fg_stage_fn, make_bg_step_fn, iterations=iterations
                )
                res.rejected_tenants = rejected
                self.collocation_results.append(res)
                if calibrate:
                    self.interference = col.calibrate(self.collocation_results)
                return res
            self.events.append(ClusterEvent(
                self._clock(), "fallback",
                f"executable collocation wants {fg.plan.num_gpus} devices, "
                f"process has {len(survivors)} healthy -> MultiplexSim",
            ))
        return self.simulate_collocation(mcfg)

    def calibrate(self) -> InterferenceModel:
        """Refit ``self.interference`` from every measured CollocationResult
        so far (``Collocator.calibrate``), making ``simulate_collocation``
        track the measured hardware.  Uses the coordinator's live monitor
        and the config of the last collocation, so feedback bans and pacing
        limits attribute the measured slowdown to the same gap stages the
        measurements actually collocated."""
        fg = self.foreground()
        assert fg is not None and fg.plan is not None
        col = Collocator(fg.plan, self._last_mcfg, monitor=self.monitor,
                         tenants=self.background_tenants(lambda m: None)
                         or (), interference=self.interference)
        self.interference = col.calibrate(self.collocation_results)
        return self.interference
