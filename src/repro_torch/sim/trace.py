"""Seeded cluster event traces: generation, JSON (de)serialization (the
port of ``repro/sim/trace.py``).

A trace is the replayable input of the cluster simulator
(``repro_torch.sim.cluster_sim``): a device count plus a time-ordered list of
events drawn from six kinds —

  job_arrival     a background job enters the cluster
                  (fields: job, priority, weight, quantum)
  job_departure   a background job finishes / leaves (field: job)
  device_failure  one device dies fail-stop, announced to the coordinator
                  directly (field: device)
  device_join     a device (re)joins the pool (field: device)
  heartbeat_loss  a device goes *silent* at t — its heartbeats stop but
                  nothing announces the loss (field: device).  The
                  simulator replays this through the live control plane:
                  the device keeps beating until t, then the coordinator's
                  ``CoordinatorLoop`` must *detect* the loss from missing
                  beats (``HeartbeatMonitor.failed()`` at t + hb_timeout)
                  and fire ``handle_failure`` itself — the same
                  consumption path the live train loop runs.
  lease_churn     the worker currently holding the coordinator lease dies
                  at t (no ``device`` field — the victim is resolved at
                  replay time, it is whoever holds the lease then).  The
                  simulator replays this through the real election path:
                  the holder goes silent, its lease renewals stop, and at
                  t + lease_timeout the lowest surviving worker claims the
                  next lease epoch, reconstructs coordinator state from
                  the topic log (``CoordinatorLoop.bootstrap_from_log``)
                  and resumes pumping; the dead ex-holder is then
                  *detected* from missing beats like any other loss.

Trace JSON schema (version 1)::

    {
      "version": 1,
      "n_devices": 128,
      "seed": 7,                      # null for hand-written traces
      "horizon": 600.0,               # virtual seconds the trace spans
      "events": [
        {"t": 3.25, "kind": "job_arrival", "job": "bg000",
         "priority": 1, "weight": 1.0, "quantum": 1},
        {"t": 41.0, "kind": "device_failure", "device": 17},
        {"t": 55.5, "kind": "device_join", "device": 17},
        {"t": 90.1, "kind": "job_departure", "job": "bg000"}
      ]
    }

``generate_trace`` is fully deterministic in its arguments (it draws only
from ``random.Random(seed)``), and ``save_trace``/``load_trace`` round-trip
bit-identically: generate -> save -> load -> simulate gives the same report
as simulating the in-memory trace (pinned by tests/test_torch_sim.py).
"""
from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import List, Optional

EVENT_KINDS = ("job_arrival", "job_departure", "device_failure",
               "device_join", "heartbeat_loss", "lease_churn")


@dataclass(frozen=True)
class TraceEvent:
    """One timestamped cluster event.  Unused payload fields stay None and
    are dropped from the JSON form (schema above)."""

    t: float
    kind: str
    job: Optional[str] = None
    priority: Optional[int] = None
    weight: Optional[float] = None
    quantum: Optional[int] = None
    device: Optional[int] = None

    def to_json(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}

    @classmethod
    def from_json(cls, d: dict) -> "TraceEvent":
        if d.get("kind") not in EVENT_KINDS:
            raise ValueError(f"unknown trace event kind: {d.get('kind')!r}")
        return cls(**{k: d.get(k) for k in
                      ("t", "kind", "job", "priority", "weight", "quantum",
                       "device")})


@dataclass
class Trace:
    n_devices: int
    events: List[TraceEvent] = field(default_factory=list)
    seed: Optional[int] = None
    horizon: float = 0.0
    version: int = 1

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "n_devices": self.n_devices,
            "seed": self.seed,
            "horizon": self.horizon,
            "events": [e.to_json() for e in self.events],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Trace":
        if d.get("version") != 1:
            raise ValueError(f"unsupported trace version: {d.get('version')!r}")
        return cls(
            n_devices=int(d["n_devices"]),
            events=[TraceEvent.from_json(e) for e in d["events"]],
            seed=d.get("seed"),
            horizon=float(d.get("horizon", 0.0)),
        )


def _sorted(events: List[TraceEvent]) -> List[TraceEvent]:
    """Deterministic replay order: by time, ties broken by emission order
    (Python's sort is stable, so equal-t events keep generator order)."""
    return sorted(events, key=lambda e: e.t)


def generate_trace(
    n_devices: int,
    seed: int = 0,
    *,
    horizon: float = 600.0,
    arrival_rate: float = 0.05,
    mean_job_lifetime: float = 120.0,
    failure_rate: float = 0.0003,
    mean_repair_time: float = 60.0,
    max_dead_fraction: float = 0.25,
) -> Trace:
    """Seeded generator of job-churn + device-failure traces.

    Poisson job arrivals (``arrival_rate`` jobs / virtual second) with
    exponential lifetimes emit matched arrival/departure pairs; Poisson
    device failures pick a uniformly random currently-healthy device and
    schedule its rejoin after an exponential repair time.  The dead set is
    capped at ``max_dead_fraction`` of the pool (a failure drawn while at
    the cap is skipped), so the foreground keeps a plannable pool.
    Identical arguments produce an identical trace, bit for bit.
    """
    rng = random.Random(seed)
    events: List[TraceEvent] = []
    # -- job churn ----------------------------------------------------------
    t, n_jobs = 0.0, 0
    while True:
        t += rng.expovariate(arrival_rate)
        if t >= horizon:
            break
        name = f"bg{n_jobs:03d}"
        n_jobs += 1
        events.append(TraceEvent(
            t=round(t, 6), kind="job_arrival", job=name,
            priority=rng.choice((1, 1, 1, 2)),
            weight=float(rng.choice((1.0, 1.0, 2.0))),
            quantum=rng.choice((1, 1, 2)),
        ))
        depart = t + rng.expovariate(1.0 / mean_job_lifetime)
        if depart < horizon:
            events.append(TraceEvent(t=round(depart, 6),
                                     kind="job_departure", job=name))
    # -- device failures / repairs -----------------------------------------
    t = 0.0
    dead: dict = {}  # device -> rejoin time
    max_dead = max(1, int(n_devices * max_dead_fraction))
    while True:
        t += rng.expovariate(failure_rate * n_devices)
        if t >= horizon:
            break
        for dev, back in sorted(dead.items()):
            if back <= t:
                del dead[dev]
        if len(dead) >= max_dead:
            continue
        alive = [d for d in range(n_devices) if d not in dead]
        dev = rng.choice(alive)
        events.append(TraceEvent(t=round(t, 6), kind="device_failure",
                                 device=dev))
        back = t + rng.expovariate(1.0 / mean_repair_time)
        dead[dev] = back
        if back < horizon:
            events.append(TraceEvent(t=round(back, 6), kind="device_join",
                                     device=dev))
    return Trace(n_devices=n_devices, events=_sorted(events), seed=seed,
                 horizon=horizon)


def generate_failure_storm(
    n_devices: int,
    seed: int = 0,
    *,
    horizon: float = 120.0,
    dead_fraction: float = 0.25,
) -> Trace:
    """A failure-storm trace: ``dead_fraction`` of the pool dies in a burst
    early in the trace (no rejoin), with a couple of background jobs around
    to exercise cache eviction + admission under the shrunken pool."""
    rng = random.Random(seed)
    events: List[TraceEvent] = [
        TraceEvent(t=1.0, kind="job_arrival", job="bg000", priority=1,
                   weight=1.0, quantum=1),
        TraceEvent(t=2.0, kind="job_arrival", job="bg001", priority=1,
                   weight=1.0, quantum=1),
    ]
    n_dead = max(1, int(n_devices * dead_fraction))
    victims = rng.sample(range(n_devices), n_dead)
    t = horizon * 0.1
    for dev in victims:
        t += rng.expovariate(n_dead / (horizon * 0.4))
        events.append(TraceEvent(t=round(min(t, horizon * 0.6), 6),
                                 kind="device_failure", device=dev))
    return Trace(n_devices=n_devices, events=_sorted(events), seed=seed,
                 horizon=horizon)


def generate_heartbeat_loss(
    n_devices: int,
    seed: int = 0,
    *,
    horizon: float = 120.0,
    n_losses: int = 3,
    n_jobs: int = 2,
) -> Trace:
    """A heartbeat-loss trace: ``n_losses`` distinct devices go silent
    (their beats stop, nothing announces the loss) spread over the middle
    of the horizon, with ``n_jobs`` background jobs around so the
    continuous-admission re-sweep has a roster to re-decide after each
    detected loss.  The losses are never rejoined — the final healthy pool
    is exactly ``n_devices - n_losses``, which pins the detection path:
    every loss must be *detected* from missing beats for the pool to get
    there."""
    rng = random.Random(seed)
    events: List[TraceEvent] = [
        TraceEvent(t=float(1 + i), kind="job_arrival", job=f"bg{i:03d}",
                   priority=1, weight=1.0, quantum=1)
        for i in range(n_jobs)
    ]
    victims = rng.sample(range(n_devices), n_losses)
    for i, dev in enumerate(victims):
        t = horizon * (0.2 + 0.5 * i / max(1, n_losses - 1)
                       if n_losses > 1 else 0.3)
        t += rng.uniform(0.0, horizon * 0.05)
        events.append(TraceEvent(t=round(t, 6), kind="heartbeat_loss",
                                 device=dev))
    return Trace(n_devices=n_devices, events=_sorted(events), seed=seed,
                 horizon=horizon)


def generate_lease_churn(
    n_devices: int,
    seed: int = 0,
    *,
    horizon: float = 120.0,
    n_churns: int = 3,
    n_jobs: int = 2,
) -> Trace:
    """A lease-churn trace: the coordinator host dies ``n_churns`` times.

    Each ``lease_churn`` event kills whichever worker holds the lease at
    replay time (the events carry no device — churn 2 kills whoever won
    the failover after churn 1), so ``n_churns`` successive failovers each
    elect the lowest survivor and shrink the pool by one.  Churns are
    spread evenly with a small seeded jitter, leaving room between them
    for the failover (lease timeout) *and* the subsequent detection of the
    dead ex-holder (heartbeat timeout) to complete; ``n_jobs`` background
    jobs give the rebuilt admission state a roster to re-decide."""
    rng = random.Random(seed)
    events: List[TraceEvent] = [
        TraceEvent(t=float(1 + i), kind="job_arrival", job=f"bg{i:03d}",
                   priority=1, weight=1.0, quantum=1)
        for i in range(n_jobs)
    ]
    for i in range(n_churns):
        t = horizon * (0.15 + 0.6 * i / max(1, n_churns - 1)
                       if n_churns > 1 else 0.3)
        t += rng.uniform(0.0, horizon * 0.02)
        events.append(TraceEvent(t=round(t, 6), kind="lease_churn"))
    return Trace(n_devices=n_devices, events=_sorted(events), seed=seed,
                 horizon=horizon)


def save_trace(trace: Trace, path) -> None:
    with open(path, "w") as f:
        json.dump(trace.to_json(), f, indent=1, sort_keys=True)
        f.write("\n")


def load_trace(path) -> Trace:
    with open(path) as f:
        return Trace.from_json(json.load(f))
