"""Continuous-batching scheduler.

The port of ``repro/serve/scheduler.py`` without request-level admission
(``ServingAdmission`` needs the planner stack, which is not ported yet):
the scheduler admits every ready request a free lane and the page pool can
take.  It owns request bookkeeping and the serving timeline; the engine
(``serve/engine.py``) owns device state.  Per tick it (1) moves trace
arrivals into the ready queue, (2) slots ready requests into free batch
lanes (prefill + page alloc), and (3) advances every live lane one decode
step, retiring finished requests so their lanes and pages free up
mid-decode.

Requests that page exhaustion defers stay queued — they are never
dropped — and time is a *virtual clock* advanced by the measured duration
(``time.perf_counter``) of each engine operation, so a trace replays
deterministically against real compute costs without wall-clock sleeps.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclass
class Request:
    """One serving request: a prompt, a decode budget, and its timeline.

    ``arrival`` is trace time (seconds).  The scheduler fills the
    ``admitted_at``/``first_token_at``/``finished_at`` marks and the engine
    appends generated token ids to ``tokens``.
    """

    rid: Any
    prompt: np.ndarray  # (P,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0
    eos_id: Optional[int] = None
    # filled during serving
    tokens: List[int] = field(default_factory=list)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid!r}: max_new_tokens < 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_tokens(self) -> int:
        """Upper bound on KV positions this request ever occupies."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    def decoding_done(self) -> bool:
        """Token budget exhausted or EOS emitted (engine finish condition)."""
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and len(self.tokens) > 0
                and self.tokens[-1] == self.eos_id)

    @property
    def latency(self) -> float:
        """Arrival -> last token (inf while unfinished)."""
        if self.finished_at is None:
            return float("inf")
        return self.finished_at - self.arrival

    @property
    def ttft(self) -> float:
        """Arrival -> first token (inf while unstarted)."""
        if self.first_token_at is None:
            return float("inf")
        return self.first_token_at - self.arrival


class VirtualClock:
    """Serving timeline advanced by measured op durations (no sleeps)."""

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def advance(self, dt: float) -> None:
        if dt < 0.0:
            raise ValueError(f"clock can't run backwards (dt={dt})")
        self.now += dt

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, float(t))


@dataclass
class ServeReport:
    """Outcome of one trace replay: per-request records + aggregates."""

    completed: List[Request]
    makespan: float
    stats: Any  # engine ServeStats
    page_deferrals: int = 0

    def latencies(self) -> np.ndarray:
        return np.array([r.latency for r in self.completed], np.float64)

    def latency_percentile(self, q: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, q)) if lat.size else 0.0

    def ttft_percentile(self, q: float) -> float:
        t = np.array([r.ttft for r in self.completed], np.float64)
        return float(np.percentile(t, q)) if t.size else 0.0

    def goodput(self, slo: float) -> float:
        """SLO-satisfying completed requests per second of makespan."""
        if self.makespan <= 0.0:
            return 0.0
        good = sum(1 for r in self.completed if r.latency <= slo)
        return good / self.makespan

    def tokens_out(self) -> int:
        return sum(len(r.tokens) for r in self.completed)


class ContinuousScheduler:
    """Drives an engine over a request trace with continuous batching.

    The engine contract (see ``ContinuousBatchingEngine``):
      ``has_free_lane()``, ``live_count()``, ``can_fit(req)``,
      ``admit(req) -> bool`` (False = pages exhausted, request stays
      queued), ``step() -> list[Request]`` (one decode tick over all live
      lanes; returns newly finished, already retired).
    """

    def __init__(self, engine, clock: Optional[VirtualClock] = None):
        self.engine = engine
        self.clock = clock or VirtualClock()
        self.page_deferrals = 0

    def run(self, requests: Sequence[Request]) -> ServeReport:
        pending = deque(sorted(requests, key=lambda r: (r.arrival, str(r.rid))))
        for r in pending:
            self.engine.can_fit(r, check=True)  # oversize prompt = config error
        ready: deque = deque()
        completed: List[Request] = []
        clk = self.clock
        while pending or ready or self.engine.live_count():
            while pending and pending[0].arrival <= clk.now + 1e-12:
                ready.append(pending.popleft())
            while ready and self.engine.has_free_lane():
                req = ready[0]
                t0 = time.perf_counter()
                ok = self.engine.admit(req)
                dt = time.perf_counter() - t0
                if not ok:
                    self.page_deferrals += 1
                    break  # pool exhausted: wait for a retirement
                clk.advance(dt)
                ready.popleft()
                req.admitted_at = clk.now
                req.first_token_at = clk.now  # prefill emits the first token
                if req.decoding_done():
                    req.finished_at = clk.now
                    completed.append(req)
                    self.engine.retire(req)
            if self.engine.live_count():
                t0 = time.perf_counter()
                finished = self.engine.step()
                clk.advance(time.perf_counter() - t0)
                for req in finished:
                    req.finished_at = clk.now
                    completed.append(req)
            elif not ready and pending:
                clk.advance_to(pending[0].arrival)  # idle until next arrival
            elif ready:
                # nothing live, nothing admitted (pages exhausted with zero
                # live lanes can't resolve itself)
                raise RuntimeError(
                    "scheduler stalled: ready requests but no lane/page "
                    "capacity and nothing running"
                )
        return ServeReport(
            completed=completed,
            makespan=clk.now,
            stats=self.engine.stats,
            page_deferrals=self.page_deferrals,
        )
