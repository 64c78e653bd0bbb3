"""Trace-driven cluster simulator: the real control plane, a virtual clock
(the port of ``repro/sim/cluster_sim.py``).

Replays a ``repro_torch.sim.trace.Trace`` (job arrivals / departures, device
failures / rejoins, heartbeat losses) through the REAL coordination stack
— no stubs:

  * the live transport consumption path: every simulated device publishes
    heartbeats over an ``InProcessBus`` and a ``CoordinatorLoop`` pumps
    them at every boundary — a ``heartbeat_loss`` event silences a device
    and the loss must be *detected* (``HeartbeatMonitor.failed()`` at
    ``t + hb_timeout``) before ``handle_failure`` fires, exactly the code
    path the live train loop runs (the simulator is the regression bed
    for the control plane before hardware),
  * ``ClusterCoordinator`` with an injected virtual clock and
    ``virtual_devices=True`` (device ids are the simulated healthy indices,
    so a 1024-device cluster runs on a 0-accelerator host),
  * the vectorized matrix-DP planner for every elasticity re-plan
    (failures / joins re-plan onto the exact surviving pool, non-pow2
    included),
  * ``Collocator.admit()`` — the predict-before-compile admission sweep
    under the measurement-calibrated ``InterferenceModel`` — and
    ``Collocator.predict()`` for the operating point of each epoch,
  * ``MultiplexSim`` as a per-epoch discrete-event cross-check of the
    foreground slowdown,
  * the coordinator's ``ExecutableCache``, touched through
    ``Collocator.predicted_cache_keys`` so compile reuse, the LRU bound and
    post-failure ``evict_stale`` behave exactly as in a real deployment.

Between consecutive trace events the cluster state is constant (an
*epoch*); the simulator integrates goodput over each epoch and re-derives
the operating point after every event.  Goodput is reported in
single-device equivalents (one unit = one device running the job
standalone, the paper's speedup axis):

  fg goodput rate = plan.speedup / predicted fg slowdown
  bg goodput rate = sum_t steps/iter x step_time x chunk_width x eff(t)
                    / collocated iteration time,
                    eff = (step_time / bg_step_time) ** 0.25

(the ``eff`` factor discounts granularity-reduced background steps: a
tenant forced to tiny steps by small gaps does proportionally less useful
work per device-second).  The reference's cluster-throughput-vs-scale
curve (``benchmarks/bench_cluster_sim.py``) compares total goodput against
the single-task data-parallel baseline ``plan_data_parallel(G).speedup``.

Everything is deterministic: traces are seeded, the replay draws no
randomness, and ``SimReport.to_json()`` round-trips bit-identically
(pinned by tests/test_torch_sim.py, against the reference's replay).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.coordinator import ClusterCoordinator, Job, QOS_SLOWDOWN_BOUND
from repro_torch.core.costmodel import Hardware
from repro_torch.core.multiplex import (
    Collocator,
    InterferenceModel,
    MultiplexConfig,
    MultiplexSim,
    QoSMonitor,
)
from repro_torch.dist.faults import HeartbeatMonitor, MitigationLog
from repro_torch.dist.transport import (
    HEARTBEAT_TOPIC,
    RECONFIG_TOPIC,
    CoordinatorLease,
    CoordinatorLoop,
    InProcessBus,
    WorkerClient,
)
from repro_torch.sim.trace import Trace


def _bg_factory(mesh):  # pragma: no cover - never dispatched in simulation
    return lambda: None


@dataclass
class Segment:
    """One constant-state epoch: [t0, t1) between consecutive trace events."""

    t0: float
    t1: float
    n_healthy: int
    plan_gpus: int
    n_tenants: int
    n_admitted: int
    fg_slowdown: float
    sim_fg_slowdown: float  # MultiplexSim cross-check (single-tenant DES)
    fg_rate: float          # single-device equivalents / virtual second
    bg_rate: float
    jain: float

    def to_json(self) -> dict:
        d = dict(self.__dict__)
        for k, v in d.items():
            if isinstance(v, float):
                d[k] = round(v, 9)
        return d


@dataclass
class SimReport:
    """Aggregated outcome of one trace replay."""

    n_devices: int
    horizon: float
    n_events: int
    n_replans: int          # planner invocations from failures/joins
    n_epochs: int
    admitted_total: int     # tenant-epochs admitted
    rejected_total: int     # tenant-epochs refused by the QoS bound
    fg_goodput: float       # time-integrated, in device x seconds
    bg_goodput: float
    cache_hits: int
    cache_misses: int
    cache_evictions: int
    cache_final_size: int
    jain_time_avg: float    # time-weighted schedule-level Jain index
    jain_service: float     # Jain over per-job accumulated weighted service
    mean_fg_slowdown: float  # time-weighted
    per_job_service: Dict[str, float] = field(default_factory=dict)
    # per-kind counts from the live control plane's MitigationLog
    # (failure_detected / replan / straggler_worker / ...): non-empty only
    # when the trace carries heartbeat_loss events, and deterministic —
    # the CI gate pins the counts across replays
    mitigations: Dict[str, int] = field(default_factory=dict)
    # coordinator failovers replayed through the real election path
    # (lease_churn traces) and the per-topic retained log sizes at the end
    # of the replay — with gc_every set these stay bounded across churns
    n_failovers: int = 0
    topic_backlog: Dict[str, int] = field(default_factory=dict)
    segments: List[Segment] = field(default_factory=list)

    @property
    def total_goodput(self) -> float:
        return self.fg_goodput + self.bg_goodput

    @property
    def mean_goodput_rate(self) -> float:
        """Cluster throughput in single-device equivalents (curve y-axis)."""
        return self.total_goodput / max(self.horizon, 1e-30)

    def to_json(self, *, with_segments: bool = False) -> dict:
        d = {
            k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in self.__dict__.items()
            if k not in ("segments", "per_job_service")
        }
        d["per_job_service"] = {
            k: round(v, 9) for k, v in sorted(self.per_job_service.items())
        }
        d["total_goodput"] = round(self.total_goodput, 9)
        d["mean_goodput_rate"] = round(self.mean_goodput_rate, 9)
        if with_segments:
            d["segments"] = [s.to_json() for s in self.segments]
        return d


class ClusterSim:
    """Replay a trace through the real coordinator / admission stack.

    ``graph`` is the foreground job's layer graph (planned by the matrix-DP
    planner at every pool size the trace visits); ``interference`` seeds
    the calibrated model used by admission + prediction — pass the fit from
    measured collocation records so the simulation carries measured
    hardware behavior instead of optimism.
    """

    def __init__(
        self,
        trace: Trace,
        graph,
        *,
        hw: Optional[Hardware] = None,
        amp_limit: float = 2.0,
        mcfg: Optional[MultiplexConfig] = None,
        interference: Optional[InterferenceModel] = None,
        qos_bound: float = QOS_SLOWDOWN_BOUND,
        fg_job: str = "fg",
        hb_timeout: float = 5.0,
        lease_timeout: float = 2.0,
        gc_every: int = 0,
    ):
        self.trace = trace
        self.graph = graph
        self.hw = hw or Hardware()
        self.amp_limit = amp_limit
        # virtual replay never dispatches async work, so the pacing bound
        # models steady-state gap occupancy rather than a real in-flight
        # window: leave it wide and let gap duration / step time cap steps
        self.mcfg = mcfg or MultiplexConfig(max_inflight=10 ** 6)
        self.interference = interference or InterferenceModel()
        self.qos_bound = qos_bound
        self.fg_job = fg_job
        # heartbeat_loss detection latency: a silenced device is declared
        # failed by the CoordinatorLoop hb_timeout virtual seconds after
        # its last beat (a synthetic detection boundary is inserted there)
        self.hb_timeout = hb_timeout
        # lease-churn traces run the real election: the coordinator role
        # moves to the lowest survivor lease_timeout after the holder dies,
        # and with gc_every > 0 each holder compacts the topics every
        # that-many pumps (the backlog stays bounded across churns)
        self.lease_timeout = lease_timeout
        self.gc_every = gc_every
        self._lease_mode = any(e.kind == "lease_churn" for e in trace.events)
        self._t = 0.0
        self._silent: set = set()
        self._holder: Optional[int] = None

    # -- replay -------------------------------------------------------------

    def run(self, *, keep_segments: bool = True) -> SimReport:
        tr = self.trace
        self._t = 0.0
        self._silent = set()
        self._holder = None
        coord = ClusterCoordinator(
            tr.n_devices, self.hw, clock=lambda: self._t,
            virtual_devices=True,
        )
        coord.interference = self.interference
        coord.submit_foreground(
            Job(self.fg_job, "foreground", self.graph,
                amp_limit=self.amp_limit)
        )
        horizon = tr.horizon or (tr.events[-1].t if tr.events else 0.0)
        # the live control plane: every simulated device beats over the bus
        # at each boundary; the CoordinatorLoop pumps the same consumption
        # path the train loop runs (detection -> handle_failure -> replan).
        # Admission stays with _epoch (the sweep below is richer: it feeds
        # the cache-traffic and goodput accounting), so the loop's own
        # readmit hook is off.
        bus = InProcessBus()
        monitor = HeartbeatMonitor(tr.n_devices, timeout=self.hb_timeout,
                                   clock=lambda: self._t)
        mlog = MitigationLog()
        cloop = CoordinatorLoop(bus, monitor, coordinator=coord, log=mlog,
                                gc_every=self.gc_every)
        workers = {w: WorkerClient(bus, w) for w in range(tr.n_devices)}
        # lease mode (the trace carries lease_churn events): the real
        # election protocol arbitrates who pumps — every live worker ticks
        # its CoordinatorLease each boundary, only the holder's loop runs.
        # Worker 0 seeds the initial claim (lowest id, same as production).
        leases: Dict[int, CoordinatorLease] = {}
        n_failovers = 0
        if self._lease_mode:
            leases = {
                w: CoordinatorLease(bus, w, timeout=self.lease_timeout,
                                    clock=lambda: self._t)
                for w in range(tr.n_devices)
            }
            if not leases[0].tick():
                raise RuntimeError("worker 0 must win the seed election")
            self._holder = 0
        # synthetic detection boundaries: a silenced device's loss becomes
        # visible exactly hb_timeout after its last beat; a dead lease
        # holder triggers a failover boundary at t + lease_timeout and its
        # own detection one hb_timeout after that (the new holder re-joined
        # it with a fresh grace period during bootstrap).  Merged stably
        # (time, then trace order, events before detections at equal t) so
        # the replay stays deterministic.
        entries = [(e.t, 0, i, e) for i, e in enumerate(tr.events)]
        for i, e in enumerate(tr.events):
            if e.kind == "heartbeat_loss" and e.t + self.hb_timeout < horizon:
                entries.append((e.t + self.hb_timeout, 1, i, None))
            elif e.kind == "lease_churn":
                for dt in (self.lease_timeout,
                           self.lease_timeout + self.hb_timeout):
                    if e.t + dt < horizon:
                        entries.append((e.t + dt, 1, i, None))
        entries.sort(key=lambda x: (x[0], x[1], x[2]))
        segments: List[Segment] = []
        per_job: Dict[str, float] = {}
        n_replans = 0
        admitted_total = rejected_total = 0
        epoch = self._epoch(coord)
        t_prev = 0.0
        beat_round = 0
        for t_ev, _phase, _i, ev in entries + [(horizon, 2, -1, None)]:
            t_ev = min(max(t_ev, t_prev), horizon)
            if t_ev > t_prev:
                seg = self._integrate(epoch, t_prev, t_ev, per_job)
                segments.append(seg)
                admitted_total += seg.n_admitted
                rejected_total += seg.n_tenants - seg.n_admitted
                t_prev = t_ev
            if _phase == 2:
                break
            self._t = t_ev
            # live beats from every healthy, non-silent device, then pump:
            # a silenced device's age crosses hb_timeout exactly at its
            # synthetic boundary and the loop fires handle_failure itself
            beat_round += 1
            for w in sorted(coord.healthy - self._silent):
                if w in monitor.last:
                    # consume pending reconfigs first so the beat carries a
                    # current ack — the cursor aggregation GC feeds on these
                    workers[w].poll_reconfig()
                    workers[w].beat(beat_round)
            live_replans: List[dict] = []
            if self._lease_mode:
                # election-gated pumping: ticking in id order means the
                # live holder renews before anyone checks staleness, and
                # after a churn the lowest survivor claims first and wins
                for w in sorted(coord.healthy - self._silent):
                    if not leases[w].tick():
                        continue
                    if leases[w].acquired and w != self._holder:
                        # failover: a fresh loop on the new holder rebuilds
                        # monitor/ack state from the topic log — adopting
                        # (never re-firing) the old holder's mitigations
                        monitor = HeartbeatMonitor(
                            0, timeout=self.hb_timeout, clock=lambda: self._t
                        )
                        cloop = CoordinatorLoop(
                            bus, monitor, coordinator=coord, log=mlog,
                            gc_every=self.gc_every,
                        )
                        cloop.bootstrap_from_log()
                        self._holder = w
                        n_failovers += 1
                    live_replans = cloop.pump()
            else:
                live_replans = cloop.pump()
            n_replans += len(live_replans)
            changed = bool(live_replans)
            if ev is not None:
                ev_changed, replanned = self._apply(coord, monitor, ev)
                n_replans += replanned
                changed = changed or ev_changed
            if changed:
                epoch = self._epoch(coord)
        total_t = sum(s.t1 - s.t0 for s in segments) or 1e-30
        jain_avg = sum(s.jain * (s.t1 - s.t0) for s in segments) / total_t
        slow_avg = sum(
            s.fg_slowdown * (s.t1 - s.t0) for s in segments) / total_t
        return SimReport(
            n_devices=tr.n_devices,
            horizon=horizon,
            n_events=len(tr.events),
            n_replans=n_replans,
            n_epochs=len(segments),
            admitted_total=admitted_total,
            rejected_total=rejected_total,
            fg_goodput=sum(s.fg_rate * (s.t1 - s.t0) for s in segments),
            bg_goodput=sum(s.bg_rate * (s.t1 - s.t0) for s in segments),
            cache_hits=coord.exec_cache.hits,
            cache_misses=coord.exec_cache.misses,
            cache_evictions=coord.exec_cache.evictions,
            cache_final_size=len(coord.exec_cache),
            jain_time_avg=jain_avg,
            jain_service=_jain(list(per_job.values())),
            mean_fg_slowdown=slow_avg,
            per_job_service=per_job,
            mitigations={k: mlog.count(k) for k in sorted(
                {e["kind"] for e in mlog.events})},
            n_failovers=n_failovers,
            topic_backlog={t: bus.backlog(t) for t in
                           (HEARTBEAT_TOPIC, RECONFIG_TOPIC)},
            segments=segments if keep_segments else [],
        )

    # -- event application --------------------------------------------------

    def _apply(self, coord: ClusterCoordinator, monitor: HeartbeatMonitor,
               ev) -> Tuple[bool, int]:
        """Returns (state_changed, n_replans)."""
        if ev.kind == "job_arrival":
            coord.submit_background(Job(
                ev.job, "background", [], priority=ev.priority or 1,
                step_fn_factory=_bg_factory,
                weight=ev.weight if ev.weight is not None else 1.0,
                quantum=ev.quantum,
            ))
            return True, 0
        if ev.kind == "job_departure":
            return coord.handle_departure(ev.job), 0
        if ev.kind == "device_failure":
            if ev.device not in coord.healthy or len(coord.healthy) <= 1:
                return False, 0
            # fail-stop: the loss is ANNOUNCED (not detected) — handled
            # directly, and the monitor stops tracking the device so the
            # heartbeat path can't double-report it later
            monitor.forget(ev.device)
            self._silent.discard(ev.device)
            coord.handle_failure(ev.device)
            return True, 1
        if ev.kind == "device_join":
            if ev.device in coord.healthy:
                return False, 0
            monitor.join(ev.device)
            self._silent.discard(ev.device)
            coord.handle_join([ev.device])
            return True, 1
        if ev.kind == "heartbeat_loss":
            # the device goes silent NOW; nothing else happens until the
            # CoordinatorLoop detects the missing beats hb_timeout later
            # (the synthetic detection boundary pumps it)
            if ev.device not in coord.healthy or ev.device in self._silent:
                return False, 0
            self._silent.add(ev.device)
            return False, 0
        if ev.kind == "lease_churn":
            # the coordinator host dies NOW: its beats *and* lease renewals
            # stop.  Election (lowest survivor claims) happens at the
            # t + lease_timeout synthetic boundary; the dead ex-holder's
            # device loss is detected one hb_timeout after the new holder
            # re-joined it during bootstrap
            h = self._holder
            if h is None or h in self._silent or h not in coord.healthy:
                return False, 0
            self._silent.add(h)
            return False, 0
        raise ValueError(f"unknown trace event kind: {ev.kind!r}")

    # -- per-epoch operating point ------------------------------------------

    def _epoch(self, coord: ClusterCoordinator) -> dict:
        """Re-derive the operating point for the current cluster state:
        admission sweep + prediction + executable-cache traffic."""
        fg = coord.foreground()
        plan = fg.plan
        roster = coord.background_tenants(_bg_factory)
        # fresh monitor per epoch: predictions carry no measured QoS bans
        col = Collocator(plan, self.mcfg, monitor=QoSMonitor(),
                         tenants=roster, interference=self.interference)
        k = 0
        if roster:
            decision = col.admit(max_fg_slowdown=self.qos_bound)
            coord.last_admission = decision
            k = decision.n_admitted
        pred = col.predict(k)
        # prediction-only collocation path: the cache keys this schedule
        # would compile.  Positional device ids come from the sorted healthy
        # set — exactly what run_executable's submeshes would use.
        ids = sorted(coord.healthy)
        for key in col.predicted_cache_keys(k, device_ids=ids):
            if not set(key[1]) <= coord.healthy:
                raise RuntimeError(f"cache key {key} outside the healthy pool "
                                   f"{sorted(coord.healthy)}")
            coord.exec_cache.get_or_build(key, object)
        des = MultiplexSim(plan, self.mcfg, self.interference,
                           monitor=QoSMonitor()).run(iterations=8)
        fg_rate = plan.speedup / max(pred.fg_slowdown, 1e-30)
        # exact per-chunk bg busy from the schedule rows (per-tenant rows
        # only carry the max chunk width, which overstates multi-gap work)
        busy: Dict[int, float] = {}
        for _si, slot, _pos, (cs, ce), nsteps, bg_t in (
                col._schedule_detail(k) if k > 0 else []):
            eff = min(1.0, bg_t / self.mcfg.bg_step_time) ** 0.25
            busy[slot] = busy.get(slot, 0.0) + nsteps * bg_t * (ce - cs) * eff
        bg_rate = 0.0
        job_rates: Dict[str, float] = {}
        for slot, t in enumerate(pred.tenants[:k]):
            rate = busy.get(slot, 0.0) / max(pred.fg_iter_time, 1e-30)
            bg_rate += rate
            job_rates[t.job] = rate / max(t.weight, 1e-30)
        job_rates[self.fg_job] = fg_rate
        return {
            "n_healthy": len(coord.healthy),
            "plan_gpus": plan.num_gpus,
            "n_tenants": len(roster),
            "n_admitted": k,
            "fg_slowdown": pred.fg_slowdown,
            "sim_fg_slowdown": des.fg_slowdown,
            "fg_rate": fg_rate,
            "bg_rate": bg_rate,
            "jain": pred.jain_index,
            "job_rates": job_rates,
        }

    def _integrate(self, epoch: dict, t0: float, t1: float,
                   per_job: Dict[str, float]) -> Segment:
        dt = t1 - t0
        for job, rate in epoch["job_rates"].items():
            per_job[job] = per_job.get(job, 0.0) + rate * dt
        return Segment(
            t0=t0, t1=t1,
            n_healthy=epoch["n_healthy"],
            plan_gpus=epoch["plan_gpus"],
            n_tenants=epoch["n_tenants"],
            n_admitted=epoch["n_admitted"],
            fg_slowdown=epoch["fg_slowdown"],
            sim_fg_slowdown=epoch["sim_fg_slowdown"],
            fg_rate=epoch["fg_rate"],
            bg_rate=epoch["bg_rate"],
            jain=epoch["jain"],
        )


def _jain(xs: List[float]) -> float:
    xs = [x for x in xs if x > 0]
    if not xs:
        return 1.0
    return sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs))
