"""Continuous-batching scheduler + request-level admission.

The port of ``repro/serve/scheduler.py``.  The scheduler owns request
bookkeeping and the serving timeline; the engine (``serve/engine.py``)
owns device state.  Per tick it (1) moves trace arrivals into the ready
queue, (2) runs the admission sweep when one is given —
``ServingAdmission`` casts serving as a one-stage ``serving_plan`` and
reuses ``Collocator.admit()`` with the TTFT SLO as the slowdown bound, so
decode requests pack into the prefill stage's burst gap exactly like
training tenants pack into a foreground plan's gaps — (3) slots admitted
requests into freed batch lanes (prefill + page alloc), and (4) advances
every live lane one decode step, retiring finished requests so their
lanes and pages free up mid-decode.

Requests an admission sweep or page exhaustion defers stay queued — they
are never dropped — and time is a *virtual clock* advanced by the
measured duration (``time.perf_counter``) of each engine operation, so a
trace replays deterministically against real compute costs without
wall-clock sleeps.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.multiplex import (
    AdmissionDecision,
    BgTenant,
    Collocator,
    InterferenceModel,
    MultiplexConfig,
)
from repro_torch.core.plan import serving_plan


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


class ServingAdmission:
    """Request-level admission: ``Collocator.admit()`` over a serving plan.

    The serving plan casts prefill as the latency-critical foreground
    (``n_prefill`` of ``n_devices``) and the decode carving as its burst
    gap; every candidate decode request becomes a ``BgTenant`` packed into
    that gap.  The QoS bound is the latency SLO expressed as allowed
    prefill inflation — ``ttft_slo / prefill_time`` — the serving analogue
    of the paper's 1.33x training bound: admit the largest request roster
    whose predicted interference keeps time-to-first-token inside the SLO.
    The Collocator is built once and re-rostered per sweep via
    ``set_tenants`` (keeping its calibrated interference model), and its
    ``density_slope`` is what lets the sweep reject the *marginal* request
    rather than all-or-nothing.  Analytic: nothing here touches a device.
    """

    def __init__(self, n_devices: int, n_prefill: int, *,
                 prefill_time: float, decode_step_time: float,
                 ttft_slo: float,
                 interference: Optional[InterferenceModel] = None,
                 max_inflight: int = 8):
        if ttft_slo < prefill_time:
            raise ValueError(
                f"ttft_slo {ttft_slo:g}s is below the isolated prefill "
                f"latency {prefill_time:g}s — no roster can meet it"
            )
        self.plan = serving_plan(n_devices, n_prefill, prefill_time)
        self.bound = ttft_slo / prefill_time
        cfg = MultiplexConfig(
            bg_step_time=decode_step_time,
            bg_min_step_time=min(decode_step_time, 0.25e-3),
            max_inflight=max_inflight,
        )
        self.collocator = Collocator(
            self.plan, cfg,
            interference=interference or InterferenceModel(),
        )

    @staticmethod
    def fit_interference(
        prefill_iso: float,
        measured: Sequence[Tuple[float, float]],
    ) -> InterferenceModel:
        """Fit (gap_inflation, density_slope) from measured prefill
        latencies under load: ``measured`` is (decode-tenant density,
        prefill latency) pairs.  base = mean inflation at density 1; slope
        = mean of ``((t_d/iso - 1)/(base - 1) - 1)/(d - 1)`` over d > 1.
        """
        iso = max(prefill_iso, 1e-12)
        at1 = [t / iso for d, t in measured if d <= 1.0]
        base = max(1.0, float(np.mean(at1))) if at1 else 1.0
        slope = 0.0
        if base > 1.0 + 1e-9:
            rest = [
                ((t / iso - 1.0) / (base - 1.0) - 1.0) / (d - 1.0)
                for d, t in measured if d > 1.0
            ]
            if rest:
                slope = float(np.clip(np.mean(rest), 0.0, 10.0))
        return InterferenceModel(gap_inflation=base, density_slope=slope)

    def max_concurrent(self, n_candidates: int) -> AdmissionDecision:
        """How many of ``n_candidates`` requests may run concurrently."""
        n = max(0, int(n_candidates))
        self.collocator.set_tenants(
            BgTenant(f"req{i}") for i in range(n)
        )
        return self.collocator.admit(max_fg_slowdown=self.bound)


@dataclass
class ServeReport:
    """Outcome of one trace replay: per-request records + aggregates."""

    completed: List[Request]
    makespan: float
    stats: Any  # engine ServeStats
    admission_deferrals: int = 0
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
      lanes; returns newly finished, already retired), and optionally
      ``agreed_now(now) -> now`` (the clock at the top of each tick, as an
      engine over several ranks agrees it).
    """

    def __init__(self, engine, admission: Optional[ServingAdmission] = None,
                 clock: Optional[VirtualClock] = None):
        self.engine = engine
        self.admission = admission
        self.clock = clock or VirtualClock()
        self.last_decision: Optional[AdmissionDecision] = None
        self.admission_deferrals = 0
        self.page_deferrals = 0

    def _admit_budget(self, n_ready: int) -> int:
        """Concurrency headroom this tick under the admission sweep."""
        if self.admission is None or n_ready == 0:
            return n_ready
        live = self.engine.live_count()
        # candidates beyond the engine's lane count can't run concurrently
        # anyway — capping keeps the admit() sweep O(lanes), not O(queue)
        cap = getattr(self.engine, "lanes", None)
        n_cand = live + n_ready if cap is None else min(live + n_ready, cap)
        dec = self.admission.max_concurrent(n_cand)
        self.last_decision = dec
        allow = max(0, dec.n_admitted - live)
        if allow == 0 and live == 0:
            # an idle engine must make progress: with nothing running there
            # is no foreground to protect, so the SLO bound is moot
            allow = 1
        return allow

    def run(self, requests: Sequence[Request]) -> ServeReport:
        pending = deque(sorted(requests, key=lambda r: (r.arrival, str(r.rid))))
        for r in pending:
            self.engine.can_fit(r, check=True)  # oversize prompt = config error
        ready: deque = deque()
        completed: List[Request] = []
        clk = self.clock
        # an engine over rank slices agrees the clock across its ranks once a
        # tick, so every rank queues the same arrivals (its ops' measured
        # times differ from rank to rank)
        agree = getattr(self.engine, "agreed_now", None)
        while pending or ready or self.engine.live_count():
            if agree is not None:
                clk.now = agree(clk.now)
            while pending and pending[0].arrival <= clk.now + 1e-12:
                ready.append(pending.popleft())
            allow = self._admit_budget(len(ready))
            if ready and allow < len(ready):
                self.admission_deferrals += len(ready) - allow
            while ready and allow > 0 and self.engine.has_free_lane():
                req = ready[0]
                t0 = time.perf_counter()
                ok = self.engine.admit(req)
                dt = time.perf_counter() - t0
                if not ok:
                    self.page_deferrals += 1
                    break  # pool exhausted: wait for a retirement
                clk.advance(dt)
                ready.popleft()
                allow -= 1
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
            admission_deferrals=self.admission_deferrals,
            page_deferrals=self.page_deferrals,
        )
