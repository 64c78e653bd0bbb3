"""Fault & straggler detection (paper §3.2: fault-tolerant re-planning).

The port of ``repro/dist/faults.py``: three small, injectable-clock
primitives the training loop and the cluster coordinator compose:

  - ``StepTimer``: per-step deadline from an EMA of observed step times —
    a step slower than ``deadline_factor x EMA`` is a straggler step.
  - ``HeartbeatMonitor``: per-worker liveness (timeout => failed) and
    step-lag (behind the front-runner => straggler) classification.
  - ``MitigationLog``: append-only record of mitigations taken, consumed by
    ``TrainReport`` and the coordinator event stream.

Detection feeds ``ClusterCoordinator.handle_failure`` /
``handle_join`` which re-plan the foreground job on the surviving
device subset (elastic scaling falls out of the planner).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class StepTimer:
    """EMA-deadline straggler detection over observed step durations."""

    def __init__(self, deadline_factor: float = 2.0, warmup_steps: int = 3,
                 ema_alpha: float = 0.2):
        if deadline_factor <= 1.0:
            raise ValueError(f"deadline_factor must exceed 1, got {deadline_factor}")
        self.deadline_factor = deadline_factor
        self.warmup_steps = warmup_steps
        self.ema_alpha = ema_alpha
        self.ema: Optional[float] = None
        self.n = 0

    def record(self, dt: float) -> None:
        # Over-deadline (straggler) samples are excluded from the EMA:
        # folding them in would inflate the deadline after one slow step
        # and mask a persistently slow worker from then on.
        if not self.is_straggler_step(dt):
            self.ema = dt if self.ema is None else (
                (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
            )
        self.n += 1

    def deadline(self) -> Optional[float]:
        if self.ema is None or self.n < self.warmup_steps:
            return None
        return self.deadline_factor * self.ema

    def is_straggler_step(self, dt: float) -> bool:
        deadline = self.deadline()
        return deadline is not None and dt > deadline


class HeartbeatMonitor:
    """Per-worker heartbeat tracking with timeout + step-lag classification.

    ``clock`` is injectable for tests.  A worker is *failed* once its last
    beat is older than ``timeout``; a live worker more than ``lag`` steps
    behind the front-runner is a *straggler*.
    """

    def __init__(self, n_workers: int, timeout: float, lag: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.n_workers = n_workers
        self.timeout = timeout
        self.lag = lag
        self.clock = clock
        t0 = clock()
        self.last: Dict[int, Tuple[float, int]] = {
            w: (t0, 0) for w in range(n_workers)
        }

    def beat(self, worker: int, step: int) -> None:
        # Unknown worker ids must go through join(): silently accepting
        # them grows `last` past n_workers with no join semantics and the
        # coordinator never learns a device appeared.
        if worker not in self.last:
            raise KeyError(
                f"beat from unknown worker {worker}; call join({worker}) first"
            )
        self.last[worker] = (self.clock(), step)

    def join(self, worker: int) -> bool:
        """Register a worker (explicit join semantics).

        Returns True if the worker was new; re-joining a tracked worker is
        a no-op (False) so re-delivered join announcements are idempotent.
        """
        if worker in self.last:
            return False
        self.last[worker] = (self.clock(), 0)
        self.n_workers = len(self.last)
        return True

    def forget(self, worker: int) -> bool:
        """Stop tracking a worker (acknowledge a detected failure).

        Without this, ``failed()`` re-reports the same dead worker every
        poll; the consumption loop forgets each failure it acts on so
        detection fires exactly once per loss.
        """
        if worker not in self.last:
            return False
        del self.last[worker]
        self.n_workers = len(self.last)
        return True

    def failed(self) -> List[int]:
        now = self.clock()
        return sorted(w for w, (t, _) in self.last.items()
                      if now - t >= self.timeout)

    def stragglers(self) -> List[int]:
        dead = set(self.failed())
        live = {w: s for w, (_, s) in self.last.items() if w not in dead}
        if not live:
            return []
        front = max(live.values())
        return sorted(w for w, s in live.items() if front - s > self.lag)


@dataclass
class MitigationLog:
    """Append-only record of mitigations (straggler/failure/replan/...)."""

    events: List[dict] = field(default_factory=list)

    def log(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, **info})

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e["kind"] == kind)

    def __len__(self) -> int:
        return len(self.events)
