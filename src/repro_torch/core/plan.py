"""Burst-parallel plan representation + mapping to mesh shardings.

The port of ``repro/core/plan.py``, line for line: framework-neutral
pure Python.

``BurstPlan`` is the planner's output: per layer, the number of devices it
runs on, its time along the chosen path and its GPU-sec amplification.
``stages()`` groups contiguous equal-scale layers — the unit at which the
executor applies sharding re-maps and the multiplexer finds gaps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class LayerPlan:
    index: int
    name: str
    gpus: int
    time: float       # T[i][g]: comm_in + comp + sync along the chosen path
    comp: float
    sync: float
    comm_in: float
    amp: float        # GPU-sec amplification of this layer
    kind: str = "generic"


@dataclass(frozen=True)
class StagePlan:
    first: int
    last: int
    gpus: int
    start: float
    duration: float

    @property
    def n_layers(self) -> int:
        return self.last - self.first + 1


@dataclass(frozen=True)
class GapWindow:
    """Idle devices during one stage of the foreground plan."""

    start: float
    duration: float
    free_gpus: int
    stage_index: int


@dataclass(frozen=True)
class BranchPlacement:
    """Placement of one ParallelBlock branch inside the block's device window.

    The critical branch occupies devices [0, gpus); branches that run
    *parallel* to it are stacked onto disjoint ranges above it (the idle
    devices of the block's GapWindow); *sequential* branches reuse the
    critical branch's range after it finishes.  ``scales`` is the backtraced
    per-layer device count along the branch's top-level chain.
    """

    block: str
    branch: int
    critical: bool
    parallel: bool         # placed on disjoint devices concurrently
    time: float
    gpus: int              # peak devices used by this branch
    device_start: int
    device_end: int        # exclusive
    scales: Tuple[int, ...]
    demoted: bool = False  # reduction decided parallel, but the gap window
                           # was full — the planned block time is optimistic
                           # by up to this branch's ``time``
    layer_index: int = -1  # plan-layer whose ``comm_in`` folds this block:
                           # the branch devices are busy only during the
                           # stage containing that layer (-1: unknown ->
                           # excluded for the whole iteration, conservative)

    @property
    def devices(self) -> Tuple[int, int]:
        return (self.device_start, self.device_end)


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (the planner's scale set is powers of two)."""
    g = 1
    while g * 2 <= n:
        g *= 2
    return g


# -- device-index range arithmetic (used by gap collocation) ----------------


def merge_ranges(ranges) -> List[Tuple[int, int]]:
    """Sort + coalesce half-open [start, end) index ranges."""
    out: List[List[int]] = []
    for s, e in sorted((int(s), int(e)) for s, e in ranges if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def complement_ranges(busy, total: int) -> List[Tuple[int, int]]:
    """Free [start, end) ranges inside [0, total) not covered by ``busy``."""
    free: List[Tuple[int, int]] = []
    cur = 0
    for s, e in merge_ranges(busy):
        s, e = max(0, min(s, total)), max(0, min(e, total))
        if s > cur:
            free.append((cur, s))
        cur = max(cur, e)
    if cur < total:
        free.append((cur, total))
    return free


def normalize_quanta(quanta, n: int) -> List[int]:
    """Per-tenant quantum vector, normalized: ints clamped >= 1, truncated
    to ``n`` entries and padded with the last value (1 when empty).  Shared
    by ``pack_ranges`` and the submesh carving so the two can never diverge
    on the padding rule."""
    q = [max(1, int(v)) for v in quanta][:n]
    q += [q[-1] if q else 1] * (n - len(q))
    return q


def pack_ranges(free, n: int, quantum=1, shares=None):
    """Carve up to ``n`` disjoint chunks out of free [start, end) ranges for
    priority-ordered tenants.

    ``quantum`` is either a single int (every chunk size a multiple of it —
    the tenant submesh's model width) or a *per-tenant sequence* of ints
    (slot-aware mode: each tenant sizes its chunk to its own quantum).

    Scalar mode (back-compat): chunks never overlap, each lies inside one
    input range, and the result is a dense largest-first list (ties: lower
    start) of at most ``n`` chunks, so chunk *i* goes to the *i*-th
    highest-priority tenant.  While there are fewer chunks than tenants, the
    largest chunk is split in half (quantum-aligned) — two tenants share one
    big gap rather than one tenant hoarding it.

    Per-tenant mode: the result has exactly ``n`` entries where entry *i* is
    slot *i*'s chunk — size a multiple of ``quantum[i]`` — or ``None`` when
    the remaining free devices cannot satisfy that tenant's quantum.
    Candidate chunks are carved (and halved toward ``n`` shares) at gcd
    alignment, then slots claim greedily in priority order: slot *i* takes
    the ``quantum[i]``-aligned prefix of the candidate with the largest such
    prefix (ties: lower start), returning the unclaimed remainder to the
    pool; when no single candidate fits, adjacent unclaimed fragments of
    the same free range re-coalesce — a wide-quantum (high-priority) tenant
    is never starved by the sharing split when the unsplit range would have
    satisfied it.  A sequence shorter than ``n`` is padded with its last
    value.

    ``shares`` (per-tenant mode only) sizes chunks by weighted share instead
    of equal halving: slot *i*'s claim is capped at its ``quantum[i]``-
    aligned proportional share ``total_free * shares[i] / sum(shares)``
    (floor: one quantum), and earlier slots leave the un-taken surplus to
    later ones.  This is the deficit-sizing hook: a lagging tenant's share
    grows with its fair-share deficit, so it claims a *wider* chunk instead
    of rotating into the same equal-split chunk forever.  ``shares=None``
    (or uniform shares over a single free run) reproduces the equal-halving
    layout exactly.
    """
    if n <= 0:
        return []
    per_tenant = not isinstance(quantum, int)
    if per_tenant:
        quanta = normalize_quanta(quantum, n)
        base = math.gcd(*quanta)
    else:
        quanta = [quantum] * n
        base = quantum
    if shares is not None and not per_tenant:
        raise ValueError("shares requires the per-tenant quantum mode")
    chunks: List[Tuple[int, int]] = []
    for s, e in merge_ranges(free):
        m = (e - s) - (e - s) % base
        if m > 0:
            chunks.append((s, s + m))
    if not chunks:
        return [None] * n if per_tenant else []
    key = lambda r: (-(r[1] - r[0]), r[0])
    chunks.sort(key=key)
    caps = [None] * n
    if shares is not None:
        w = [max(0.0, float(v)) for v in shares][:n]
        w += [1.0] * (n - len(w))
        wsum = sum(w)
        if wsum > 0.0:
            total = sum(e - s for s, e in chunks)
            caps = [
                max(q, int(total * wi / wsum) // q * q)
                for q, wi in zip(quanta, w)
            ]
        else:
            shares = None
    if shares is None:
        while len(chunks) < n:
            s, e = chunks[0]
            if e - s < 2 * base:  # largest can't split -> none can
                break
            half = ((e - s) // 2 // base) * base
            chunks[0:1] = [(s, s + half), (s + half, e)]
            chunks.sort(key=key)
    if not per_tenant:
        return sorted(chunks[:n], key=key)
    out: List[Optional[Tuple[int, int]]] = []
    pool = list(chunks)
    for q, cap in zip(quanta, caps):
        cand = [
            (-((e - s) - (e - s) % q), s, i)
            for i, (s, e) in enumerate(pool)
            if (e - s) >= q
        ]
        if not cand:
            # no single candidate fits: adjacent unclaimed fragments of one
            # free range re-coalesce (the sharing split must not starve a
            # wide-quantum tenant the unsplit range could satisfy)
            pool = merge_ranges(pool)
            cand = [
                (-((e - s) - (e - s) % q), s, i)
                for i, (s, e) in enumerate(pool)
                if (e - s) >= q
            ]
        if not cand:
            out.append(None)
            continue
        negsz, s, i = min(cand)  # largest aligned size, then lowest start
        e = pool[i][1]
        take = -negsz
        if cap is not None:
            # share-sized claim: take the proportional cap, leave the rest
            take = min(take, cap)
        # claim the aligned prefix; the remainder returns to the pool
        pool[i:i + 1] = [(s + take, e)] if e > s + take else []
        out.append((s, s + take))
    return out


@dataclass(frozen=True)
class BurstPlan:
    layers: Tuple[LayerPlan, ...]
    num_gpus: int
    amp_limit: float
    single_gpu_time: float  # sum_i comp(i, 1)
    block_details: Dict[str, object] = field(default_factory=dict)

    @property
    def total_time(self) -> float:
        return sum(l.time for l in self.layers)

    @property
    def gpu_sec(self) -> float:
        return sum(l.time * l.gpus for l in self.layers)

    @property
    def amplification(self) -> float:
        return self.gpu_sec / max(self.single_gpu_time, 1e-30)

    @property
    def speedup(self) -> float:
        """vs the same job on a single device (paper Fig 10 x-axis)."""
        return self.single_gpu_time / max(self.total_time, 1e-30)

    @cached_property
    def _stages(self) -> Tuple[StagePlan, ...]:
        # layers are immutable, so the stage grouping is computed once per
        # plan (cached_property writes to __dict__, bypassing frozen) — the
        # per-stage gap scheduling paths call stages() in tight loops
        out: List[StagePlan] = []
        t = 0.0
        cur_first, cur_g, cur_t0 = 0, self.layers[0].gpus, 0.0
        for i, l in enumerate(self.layers):
            if l.gpus != cur_g:
                out.append(StagePlan(cur_first, i - 1, cur_g, cur_t0, t - cur_t0))
                cur_first, cur_g, cur_t0 = i, l.gpus, t
            t += l.time
        out.append(StagePlan(cur_first, len(self.layers) - 1, cur_g, cur_t0, t - cur_t0))
        return tuple(out)

    def stages(self) -> List[StagePlan]:
        return list(self._stages)

    def gaps(self) -> List[GapWindow]:
        """Idle-device windows the multiplexer can fill (paper §3.1)."""
        return [
            GapWindow(s.start, s.duration, self.num_gpus - s.gpus, idx)
            for idx, s in enumerate(self._stages)
            if s.gpus < self.num_gpus and s.duration > 0.0
        ]

    def idle_gpu_sec(self) -> float:
        return sum(g.duration * g.free_gpus for g in self.gaps())

    def branch_device_ranges(
        self, stage_index: Optional[int] = None
    ) -> List[Tuple[int, int]]:
        """Device ranges hosting *parallel-placed* ParallelBlock branches.

        The critical branch of each block lives in [0, peak) — inside the
        stage's own device window — so only non-critical branches placed on
        disjoint devices widen the busy set.  Demoted branches time-multiplex
        the critical range and occupy nothing extra.

        With ``stage_index``, only branches whose block is folded into that
        stage (``BranchPlacement.layer_index`` within the stage's layer
        span) count as busy — a stage whose branches are idle returns its
        window to the gap.  Placements with unknown provenance
        (``layer_index < 0``) stay excluded for every stage, conservative."""
        st = self._stages[stage_index] if stage_index is not None else None
        out = []
        for v in self.block_details.values():
            if not isinstance(v, tuple):
                continue
            for p in v:
                if getattr(p, "parallel", False) and not getattr(p, "critical", False):
                    li = getattr(p, "layer_index", -1)
                    if st is None or li < 0 or st.first <= li <= st.last:
                        out.append((p.device_start, p.device_end))
        return merge_ranges(out)

    def busy_device_ranges(self, stage_index: int) -> List[Tuple[int, int]]:
        """Devices a background job must avoid during ``stage_index``: the
        stage's own [0, gpus) plus the parallel branch placements whose block
        executes during this stage (per-stage exclusion)."""
        st = self._stages[stage_index]
        return merge_ranges(
            [(0, st.gpus)] + self.branch_device_ranges(stage_index)
        )

    def free_device_ranges(self, stage_index: int) -> List[Tuple[int, int]]:
        """Device ranges a background job may occupy during ``stage_index``."""
        return complement_ranges(self.busy_device_ranges(stage_index), self.num_gpus)

    def placement_slack(self) -> float:
        """Total time of branches the reduction decided to run in parallel
        but the placement had to demote (gap window full).  ``total_time``
        is optimistic by up to this much; 0.0 when every parallel decision
        was physically placeable."""
        slack = 0.0
        for v in self.block_details.values():
            if isinstance(v, tuple):
                slack += sum(p.time for p in v if getattr(p, "demoted", False))
        return slack

    def summary(self) -> str:
        st = self.stages()
        lines = [
            f"BurstPlan G={self.num_gpus} amp_limit={self.amp_limit:g} "
            f"iter={self.total_time*1e3:.3f} ms speedup={self.speedup:.1f}x "
            f"amp={self.amplification:.2f} stages={len(st)}"
        ]
        for s in st:
            lines.append(
                f"  layers {s.first:>3}-{s.last:<3} g={s.gpus:<5} "
                f"dur={s.duration*1e3:.3f} ms"
            )
        return "\n".join(lines)


def serving_plan(n_devices: int, n_prefill: int,
                 prefill_time: float = 1.0) -> BurstPlan:
    """Cast disaggregated serving as a one-stage BurstPlan.

    Prefill is the latency-critical foreground: a single stage occupying
    devices [0, n_prefill) for ``prefill_time``.  The remaining
    ``n_devices - n_prefill`` devices are that stage's burst gap — exactly
    where the decode stage (and each decode request, as a ``BgTenant``)
    packs.  Casting it this way means the whole gap machinery applies
    unchanged to serving: ``gaps()``/``free_device_ranges`` locate the
    decode carving, ``split_mesh_for_plan`` builds the disjoint submeshes,
    and ``Collocator.admit()`` becomes request-level admission under a
    latency SLO instead of the training QoS bound.
    """
    if not 0 < n_prefill < n_devices:
        raise ValueError(
            f"serving plan needs 0 < n_prefill < n_devices, got "
            f"n_prefill={n_prefill}, n_devices={n_devices}"
        )
    if prefill_time <= 0.0:
        raise ValueError(f"prefill_time must be > 0, got {prefill_time}")
    layer = LayerPlan(
        index=0, name="prefill", gpus=n_prefill, time=prefill_time,
        comp=prefill_time, sync=0.0, comm_in=0.0, amp=1.0, kind="prefill",
    )
    return BurstPlan(
        layers=(layer,), num_gpus=n_devices, amp_limit=1.0,
        single_gpu_time=prefill_time * n_prefill,
    )


# ---------------------------------------------------------------------------
# Plan -> mesh sharding re-maps (DESIGN.md §2: burst = per-stage axis re-map)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageSharding:
    """How one stage maps onto the fixed production mesh.

    batch_axes: mesh axes carrying the sample dimension for this stage.
    model_active: whether the 'model' axis does TP work in this stage; if
    False the model axis is a *gap* the multiplexer may fill.
    free_ranges: device-index ranges a background job may occupy during this
    stage — the complement of the stage's own devices AND of the parallel
    ParallelBlock branch placements executing *during this stage*
    (``plan.block_details``; per-stage exclusion — an idle branch window is
    returned to the gap), so collocated work never lands on devices hosting
    a concurrent branch.
    """

    stage: StagePlan
    batch_axes: Tuple[str, ...]
    model_active: bool
    free_ranges: Tuple[Tuple[int, int], ...] = ()


def map_plan_to_mesh(plan: BurstPlan, mesh_axes: Dict[str, int]) -> List[StageSharding]:
    """Quantize each stage's device count onto the mesh factorization.

    With a (data=Nd, model=Nm[, pod=Np]) mesh, a stage using g devices maps
    to one of:
      g >= Nd*Nm(*Np): full DP over all batch-capable axes  -> ('pod','data','model')
      g >= Nd(*Np):    DP over ('pod','data'), TP over 'model'
      else:            DP over 'data' only; 'model' (and 'pod') idle -> gap
    """
    nd = mesh_axes.get("data", 1)
    nm = mesh_axes.get("model", 1)
    np_ = mesh_axes.get("pod", 1)
    total = nd * nm * np_
    out = []
    for idx, s in enumerate(plan.stages()):
        free = tuple(plan.free_device_ranges(idx))  # per-stage branch windows
        if s.gpus >= total:
            axes = tuple(a for a in ("pod", "data", "model") if a in mesh_axes)
            out.append(StageSharding(s, axes, model_active=True, free_ranges=free))
        elif s.gpus >= nd * np_:
            axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
            out.append(StageSharding(s, axes, model_active=True, free_ranges=free))
        else:
            out.append(StageSharding(s, ("data",), model_active=False,
                                     free_ranges=free))
    return out
