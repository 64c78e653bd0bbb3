"""Bounded-interleaving model checker for the transport control plane.

The port of ``repro/analysis/protocheck.py``.  Scripted scenarios test the
live control plane's safety properties one by one; this pass checks them
*mechanically* by driving the real
protocol objects — ``InProcessBus`` + ``WorkerClient`` +
``CoordinatorLease`` + ``CoordinatorLoop`` + ``HeartbeatMonitor`` — through
every interleaving of a small action alphabet (exhaustive to a bounded
depth, plus seeded-random longer schedules) on a virtual clock.  Only the
planner is abstracted away (``ModelCoordinator`` stub): the properties are
about the protocol, not the plan contents.

Safety properties, asserted after every action of every schedule:

- **cursor safety** — each worker's delivered reconfig sequence is
  strictly consecutive (never skips, never re-reads), and no consumer
  cursor ever falls below a topic's compacted ``low_water`` mark;
- **lease uniqueness** — per epoch, at most one worker ever *settles* as
  holder (believes it holds after consuming the entire lease log);
- **mitigation-once** — each device failure is mitigated (re-planned) at
  most once across arbitrary coordinator failovers:
  ``bootstrap_from_log`` adopts the pool-of-record instead of re-firing;
- **pool-of-record survival** — once any reconfig event was published,
  the newest one survives every GC schedule (it is what a failover
  restores from).

Seeded mutants demonstrate the checker's power by re-introducing the
control plane's past bug classes; each must be re-detected (see MUTANTS):

- ``cursor-reread``   — worker ack cursor off-by-one (re-reads the tail);
- ``adopt-skip``      — failover skips pool adoption (double-fires the
  old holder's mitigations);
- ``gc-head``         — GC compacts the reconfig log without retaining
  the newest event (loses the failover pool-of-record).

Run as ``python -m repro_torch.analysis.protocheck`` (exit 1 on violations, or —
with ``--mutant NAME`` — exit 1 when the mutant is NOT detected).
"""
from __future__ import annotations

import argparse
import itertools
import random
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.verify import Violation
from repro_torch.dist.faults import HeartbeatMonitor
from repro_torch.dist.transport import (
    HEARTBEAT_TOPIC,
    LEASE_TOPIC,
    RECONFIG_TOPIC,
    CoordinatorLease,
    CoordinatorLoop,
    InProcessBus,
    WorkerClient,
)

HB_TIMEOUT = 2.0        # small timeouts shrink the temporal diameter of the
LEASE_TIMEOUT = 3.0     # state space: every interesting pattern (failure
DT_SMALL = 1.0          # detection, lease expiry, failover) is reachable in
DT_BIG = 3.5            # fewer actions.  DT_SMALL is under both timeouts;
                        # DT_BIG expires both at once.


class RecordingBus(InProcessBus):
    """InProcessBus that remembers every published seq per topic (so the
    checker knows the newest reconfig independently of the log state)."""

    def __init__(self):
        super().__init__()
        self.published: Dict[str, List[int]] = {}

    def publish(self, topic: str, payload: dict) -> int:
        seq = super().publish(topic, payload)
        self.published.setdefault(topic, []).append(seq)
        return seq


class RecordingWorkerClient(WorkerClient):
    """WorkerClient that records the seq of every delivered reconfig."""

    def __init__(self, transport, worker_id: int):
        super().__init__(transport, worker_id)
        self.delivered: List[int] = []

    def poll_reconfig(self) -> List[dict]:
        msgs = sorted(
            self.transport.poll(RECONFIG_TOPIC, self._seen_reconfig),
            key=lambda sp: sp[0])
        out = []
        for seq, p in msgs:
            if seq < self._seen_reconfig:
                continue
            self.delivered.append(seq)
            self._seen_reconfig = seq + 1
            out.append(p)
        return out


@dataclass
class FakePlan:
    num_gpus: int


class ModelCoordinator:
    """Planner-free coordinator stub with the exact surface
    ``CoordinatorLoop`` touches (healthy / handle_failure / handle_join /
    restore_pool / readmit).  Mitigation counters live in ``shared`` so
    they survive coordinator failovers — each new lease holder builds a
    fresh instance (like the real train loop) but the *cluster truth* of
    which failures were already mitigated is global."""

    def __init__(self, n_devices: int, shared: Dict[int, int]):
        self.healthy = set(range(n_devices))
        self.failure_mitigations = shared  # device -> times re-planned

    def handle_failure(self, device_id: int) -> Optional[FakePlan]:
        self.healthy.discard(device_id)
        self.failure_mitigations[device_id] = \
            self.failure_mitigations.get(device_id, 0) + 1
        return FakePlan(len(self.healthy))

    def handle_join(self, device_ids) -> Optional[FakePlan]:
        new = set(int(d) for d in device_ids) - self.healthy
        if not new:
            return None
        self.healthy.update(new)
        for d in new:  # a re-join starts a new life: the next failure is a
            self.failure_mitigations.pop(d, None)  # new event, not a re-fire
        return FakePlan(len(self.healthy))

    def restore_pool(self, devices) -> None:
        self.healthy = set(int(d) for d in devices)

    def readmit(self, *a, **kw) -> None:
        return None


# -- mutants (seeded bug re-introductions) ----------------------------------


class MutantRereadClient(RecordingWorkerClient):
    """Bug class: ack cursor off-by-one — the consumer sets its cursor
    *to* the delivered seq instead of past it, re-reading the tail event on
    every later poll."""

    def poll_reconfig(self) -> List[dict]:
        msgs = sorted(
            self.transport.poll(RECONFIG_TOPIC, self._seen_reconfig),
            key=lambda sp: sp[0])
        out = []
        for seq, p in msgs:
            self.delivered.append(seq)
            self._seen_reconfig = seq  # BUG: should be seq + 1
            out.append(p)
        return out


class MutantAdoptSkipCoordinator(ModelCoordinator):
    """Bug class: a fresh lease holder that does not adopt the old
    holder's pool-of-record — the already-mitigated dead worker is back in
    ``healthy``, so the next detection double-fires the mitigation."""

    def restore_pool(self, devices) -> None:
        pass  # BUG: bootstrap adoption skipped


class MutantGCHeadLoop(CoordinatorLoop):
    """Bug class: reconfig GC driven purely by consumer acks, without
    retaining the newest event — once every live worker acked, the
    failover pool-of-record is compacted away."""

    def gc(self) -> Tuple[int, int]:
        hb_lw = self.transport.compact(HEARTBEAT_TOPIC, self._seen_beats)
        live_acks = [a for w, a in self._acks.items()
                     if w in self.monitor.last]
        rc_lw = self.transport.low_water(RECONFIG_TOPIC)
        if live_acks and len(live_acks) == len(self.monitor.last):
            rc_lw = self.transport.compact(
                RECONFIG_TOPIC, min(live_acks))  # BUG: no head-1 retention
        return hb_lw, rc_lw


@dataclass
class Mutant:
    name: str
    bug_class: str
    client_cls: type = RecordingWorkerClient
    coordinator_cls: type = ModelCoordinator
    loop_cls: type = CoordinatorLoop


MUTANTS: Dict[str, Mutant] = {
    m.name: m for m in (
        Mutant("cursor-reread", "cursor re-read",
               client_cls=MutantRereadClient),
        Mutant("adopt-skip", "double-fired mitigation",
               coordinator_cls=MutantAdoptSkipCoordinator),
        Mutant("gc-head", "lost pool-of-record",
               loop_cls=MutantGCHeadLoop),
    )
}


# -- the model --------------------------------------------------------------


class ProtocolModel:
    """One fresh control-plane universe: N workers over one bus, driven by
    named actions on a virtual clock, with the safety properties checked
    after every action."""

    def __init__(self, n_workers: int = 2, mutant: Optional[Mutant] = None):
        m = mutant or Mutant("none", "none")
        self.now = 0.0
        self.clock = lambda: self.now
        self.bus = RecordingBus()
        self.n_workers = n_workers
        self.mitigations: Dict[int, int] = {}
        self._coordinator_cls = m.coordinator_cls
        self._loop_cls = m.loop_cls
        self.alive = {w: True for w in range(n_workers)}
        self.steps = {w: 0 for w in range(n_workers)}
        self.clients = {
            w: m.client_cls(self.bus, w) for w in range(n_workers)}
        self.leases = {
            w: CoordinatorLease(self.bus, w, timeout=LEASE_TIMEOUT,
                                clock=self.clock)
            for w in range(n_workers)}
        self.loops: Dict[int, CoordinatorLoop] = {}
        # epoch -> workers that settled as holder of that epoch
        self.settled: Dict[int, set] = {}
        # workers ever declared dead + re-planned away: excluded from the
        # cursor-safety property for good (their old cursor may straddle a
        # compaction; the protocol makes them bootstrap, not continue)
        self.ever_mitigated: set = set()
        self.violations: List[Violation] = []

    # -- actions ------------------------------------------------------------

    def act_beat(self, w: int) -> None:
        if not self.alive[w]:
            return
        self.clients[w].poll_reconfig()
        self.steps[w] += 1
        self.clients[w].beat(self.steps[w])

    def _ensure_loop(self, w: int) -> CoordinatorLoop:
        loop = self.loops.get(w)
        if loop is None:
            loop = self._loop_cls(
                self.bus,
                HeartbeatMonitor(self.n_workers, HB_TIMEOUT,
                                 clock=self.clock),
                coordinator=self._coordinator_cls(
                    self.n_workers, self.mitigations),
            )
            loop.bootstrap_from_log()
            self.loops[w] = loop
        return loop

    def act_tick(self, w: int) -> None:
        if not self.alive[w]:
            return
        if self.leases[w].tick() and self.leases[w].acquired:
            self.loops.pop(w, None)   # fresh holder: fresh coordinator
            self._ensure_loop(w)

    def act_pump(self, w: int) -> None:
        if not self.alive[w]:
            return
        lease = self.leases[w]
        if not lease.tick():
            return
        if lease.acquired:
            self.loops.pop(w, None)
        self._ensure_loop(w).pump()

    def act_gc(self, w: int) -> None:
        if not self.alive[w]:
            return
        lease = self.leases[w]
        if lease.holder == w and w in self.loops:
            self.loops[w].gc()

    def act_silence(self, w: int) -> None:
        self.alive[w] = False  # beats, ticks and pumps stop forever

    def act_advance(self, dt: float) -> None:
        self.now += dt

    def actions(self) -> Dict[str, Callable[[], None]]:
        acts: Dict[str, Callable[[], None]] = {}
        for w in range(self.n_workers):
            acts[f"beat{w}"] = lambda w=w: self.act_beat(w)
            acts[f"tick{w}"] = lambda w=w: self.act_tick(w)
            acts[f"pump{w}"] = lambda w=w: self.act_pump(w)
            acts[f"gc{w}"] = lambda w=w: self.act_gc(w)
        # silencing worker 0 (the deterministic first lease winner) is the
        # coordinator-failover case; higher workers dying is the plain
        # worker-loss case — include both, but keep the alphabet small by
        # silencing only the extremes
        acts["silence0"] = lambda: self.act_silence(0)
        acts[f"silence{self.n_workers - 1}"] = \
            lambda: self.act_silence(self.n_workers - 1)
        acts["adv"] = lambda: self.act_advance(DT_SMALL)
        acts["ADV"] = lambda: self.act_advance(DT_BIG)
        return acts

    # -- properties ---------------------------------------------------------

    def check(self, where: str) -> None:
        v = self.violations
        rc_lw = self.bus.low_water(RECONFIG_TOPIC)
        hb_lw = self.bus.low_water(HEARTBEAT_TOPIC)
        lease_head = max(self.bus.published.get(LEASE_TOPIC, [-1])) + 1
        self.ever_mitigated.update(
            d for d, c in self.mitigations.items() if c > 0)
        # cursor safety is guaranteed only while the control plane considers
        # the worker live: once a failure was mitigated for it (declared
        # dead, re-planned away, acks dropped from GC aggregation) it must
        # bootstrap, not continue its cursor — exclude it from P1
        for w, c in self.clients.items():
            if w in self.ever_mitigated:
                continue
            seqs = c.delivered
            for a, b in zip(seqs, seqs[1:]):
                if b != a + 1:
                    kind = ("re-read" if b <= a else "skipped")
                    v.append(Violation(
                        "proto-cursor", f"{where} worker {w}",
                        f"delivered reconfig seqs {seqs} — {kind} "
                        f"(consecutive delivery violated)"))
                    break
            if self.alive[w] and c._seen_reconfig < rc_lw:
                v.append(Violation(
                    "proto-gc-cursor", f"{where} worker {w}",
                    f"live consumer cursor {c._seen_reconfig} below the "
                    f"compacted low-water {rc_lw} — GC passed a live ack"))
        # the hb-cursor bound holds for the *acting* holder only: a deposed
        # coordinator's loop legitimately falls behind once the new holder
        # compacts, and the lease gate keeps it from ever pumping again
        for w, loop in self.loops.items():
            lease = self.leases[w]
            if (self.alive[w] and lease.holder == w
                    and lease._cursor >= lease_head
                    and loop._seen_beats < hb_lw):
                v.append(Violation(
                    "proto-gc-cursor", f"{where} holder {w}",
                    f"beat cursor {loop._seen_beats} below hb low-water "
                    f"{hb_lw}"))
        # lease: a worker is *settled* when it believes it holds after
        # consuming the full lease log; per epoch at most one may ever
        for w, lease in self.leases.items():
            if (self.alive[w] and lease.holder == w
                    and lease._cursor >= lease_head):
                self.settled.setdefault(lease.epoch, set()).add(w)
        for epoch, holders in self.settled.items():
            if len(holders) > 1:
                v.append(Violation(
                    "proto-lease", where,
                    f"epoch {epoch} settled holders {sorted(holders)} — "
                    f"split brain"))
        for dev, count in self.mitigations.items():
            if count > 1:
                v.append(Violation(
                    "proto-mitigation", where,
                    f"device {dev} mitigated {count} times — a failover "
                    f"re-fired an adopted mitigation"))
        published = self.bus.published.get(RECONFIG_TOPIC, [])
        if published:
            newest = published[-1]
            retained = [s for s, _ in self.bus.poll(RECONFIG_TOPIC, rc_lw)]
            if newest not in retained:
                v.append(Violation(
                    "proto-pool-of-record", where,
                    f"newest reconfig seq {newest} compacted away "
                    f"(retained: {retained}) — a failover would restore a "
                    f"stale pool"))

    def run_schedule(self, schedule: Sequence[str]) -> List[Violation]:
        acts = self.actions()
        for i, name in enumerate(schedule):
            try:
                acts[name]()
            except Exception as e:  # a replay crash is itself a finding
                self.violations.append(Violation(
                    "proto-crash", f"step {i} ({name})",
                    f"{type(e).__name__}: {e} "
                    f"[schedule: {' '.join(schedule[:i + 1])}]"))
                return self.violations
            self.check(f"after {' '.join(schedule[:i + 1])}")
            if self.violations:
                return self.violations
        return self.violations


# -- the explorer -----------------------------------------------------------


@dataclass
class CheckReport:
    schedules: int = 0
    violations: List[Violation] = field(default_factory=list)
    failing_schedule: Optional[Tuple[str, ...]] = None

    @property
    def ok(self) -> bool:
        return not self.violations


def _action_weight(name: str) -> int:
    """Sampling weights for the random-walk phase.  ``silence`` is
    permanent (a silenced worker never returns), so uniform sampling kills
    every worker within a few dozen steps and the walk explores nothing —
    keep deaths rare and ordinary protocol activity common."""
    if name.startswith("silence"):
        return 1
    if name in ("adv", "ADV"):
        return 10
    return 8


def explore(n_workers: int = 2, depth: int = 4, samples: int = 2000,
            sample_len: int = 40, seed: int = 0,
            mutant: Optional[str] = None,
            stop_on_first: bool = True) -> CheckReport:
    """Exhaustive schedules to ``depth``, then ``samples`` seeded random
    walks of ``sample_len`` weighted actions (long walks reach the deep
    temporal patterns — mitigate, fail over, re-detect — that bounded
    exhaustion cannot).  Deterministic for fixed parameters — no wall
    clock, no global RNG."""
    mut = MUTANTS[mutant] if mutant else None
    names = sorted(ProtocolModel(n_workers, mut).actions())
    weights = [_action_weight(n) for n in names]
    report = CheckReport()

    def run(schedule: Tuple[str, ...]) -> bool:
        report.schedules += 1
        vs = ProtocolModel(n_workers, mut).run_schedule(schedule)
        if vs:
            report.violations.extend(vs)
            report.failing_schedule = schedule
            return True
        return False

    for d in range(1, depth + 1):
        for schedule in itertools.product(names, repeat=d):
            if run(schedule) and stop_on_first:
                return report
    rng = random.Random(seed)
    for _ in range(samples):
        schedule = tuple(rng.choices(names, weights=weights, k=sample_len))
        if run(schedule) and stop_on_first:
            return report
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.protocheck",
        description="bounded-interleaving model checker for the transport "
                    "control plane")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--depth", type=int, default=4,
                    help="exhaustive interleaving depth")
    ap.add_argument("--samples", type=int, default=2000,
                    help="seeded-random longer schedules")
    ap.add_argument("--sample-len", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mutant", choices=sorted(MUTANTS), default=None,
                    help="run against a seeded bug; exit 1 if NOT detected")
    args = ap.parse_args(argv)
    report = explore(args.workers, args.depth, args.samples,
                     args.sample_len, args.seed, mutant=args.mutant)
    if args.mutant:
        m = MUTANTS[args.mutant]
        if report.ok:
            print(f"mutant {args.mutant} ({m.bug_class}) NOT detected "
                  f"after {report.schedules} schedules", file=sys.stderr)
            return 1
        print(f"mutant {args.mutant} ({m.bug_class}) detected after "
              f"{report.schedules} schedules:", file=sys.stderr)
        for v in report.violations[:3]:
            print(f"  {v}", file=sys.stderr)
        print(f"  schedule: {' '.join(report.failing_schedule)}",
              file=sys.stderr)
        return 0
    for v in report.violations:
        print(v)
    if report.failing_schedule:
        print(f"failing schedule: {' '.join(report.failing_schedule)}",
              file=sys.stderr)
    print(f"protocheck: {report.schedules} schedules, "
          f"{len(report.violations)} violation(s)", file=sys.stderr)
    return 1 if report.violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
