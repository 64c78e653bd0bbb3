"""Straggler detection and the mitigation log (paper §3.2).

The port of the framework-neutral half of ``repro/dist/faults.py``:

  - ``StepTimer``: per-step deadline from an EMA of observed step times —
    a step slower than ``deadline_factor x EMA`` is a straggler step.
  - ``MitigationLog``: append-only record of mitigations taken, consumed by
    ``TrainReport``.

``HeartbeatMonitor`` waits for the control-plane layer (ROADMAP Queue 1,
item 12).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


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


@dataclass
class MitigationLog:
    """Append-only record of mitigations (straggler/failure/...)."""

    events: List[dict] = field(default_factory=list)

    def log(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, **info})

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e["kind"] == kind)

    def __len__(self) -> int:
        return len(self.events)
