"""Static plan verifier: prove burst-plan invariants from pure metadata.

The port of ``repro/analysis/verify.py`` (ranges and shapes only).

The planner, the collocator, and the serving carving all rely on the same
family of invariants — per stage, the foreground window, each tenant's bg
chunk, every parallel ``BranchPlacement`` window, and the prefill/decode
carving occupy *disjoint* device-index ranges that stay inside the pool —
but the runtime only checks them piecemeal (``submesh_from_range`` bounds,
the serving ``disjoint()`` probe).  A violation anywhere silently burns
cluster throughput instead of crashing: two tenants sharing a device look
like "interference", a branch window leaking into a bg chunk looks like a
slow background step.

``verify_plan`` checks a ``BurstPlan`` in O(layers + stages·branches) with
no framework import and no devices, so the coordinator can run it on every
installed or re-planned plan (debug-gated in hot paths) and CI can sweep
it over randomized plans plus every committed golden plan.  Violations are
structured ``Violation`` records, never asserts — callers decide whether
to raise (``verify_plan_or_raise``) or report.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.plan import (
    BurstPlan,
    StageSharding,
    merge_ranges,
    normalize_quanta,
    pack_ranges,
)

# matches the planner's soft-limit contract (tests/test_plan_regression.py):
# the aggregate amplification honors amp_limit exactly; a single layer may
# exceed it by <= 10% when the soft-limit fallback admits it
EPS = 1e-9
LAYER_AMP_SLACK = 1.1


@dataclass(frozen=True)
class Violation:
    """One broken invariant: a machine-readable check code, the locus
    (layer/stage/slot), and a human-readable detail string."""

    check: str
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.where}: {self.detail}"


class PlanVerificationError(AssertionError):
    """Raised by ``verify_plan_or_raise`` — carries the violation list."""

    def __init__(self, violations: Sequence[Violation], context: str = "plan"):
        self.violations = list(violations)
        lines = "\n".join(f"  {v}" for v in self.violations)
        super().__init__(
            f"{context} failed static verification "
            f"({len(self.violations)} violation(s)):\n{lines}"
        )


# -- range helpers ----------------------------------------------------------


def _span(ranges) -> int:
    return sum(e - s for s, e in ranges)


def _disjoint(ranges) -> bool:
    """True when no two [start, end) ranges overlap."""
    return _span(merge_ranges(ranges)) == _span(
        [(s, e) for s, e in ranges if e > s]
    )


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


# -- the plan verifier ------------------------------------------------------


def verify_plan(plan: BurstPlan, *,
                pool_size: Optional[int] = None,
                strict_layer_amp: bool = False) -> List[Violation]:
    """All invariants a ``BurstPlan`` must satisfy, as structured reports.

    ``pool_size`` is the surviving device pool the plan was built for; when
    given, the plan must target *exactly* that many devices (the non-pow2
    survivor-pool contract: 7 survivors plan as 7, never 4).

    ``strict_layer_amp`` additionally enforces the per-layer soft limit
    (``amp <= amp_limit * 1.1``).  That bound is a property of the *chain*
    planner's transition rule, not of BurstPlan itself — the joint enc-dec
    planner only bounds per-chain aggregates (a tiny decoder embed layer
    may amplify more at the jointly-chosen scale), and block-folding layers
    carry a whole ParallelBlock's gpu-sec — so it is opt-in, used by the
    chain-graph regression sweep.
    """
    out: List[Violation] = []
    if not plan.layers:
        return [Violation("plan-empty", "plan", "no layers")]
    n = plan.num_gpus
    if n < 1:
        out.append(Violation("plan-pool", "plan", f"num_gpus={n} < 1"))
        return out

    # layers that fold a whole ParallelBlock into their time carry the
    # block's aggregate gpu-sec, so the per-layer amp contract does not
    # apply to them (only the aggregate limit does); unknown provenance
    # (layer_index < 0) disables the per-layer check plan-wide
    folded = {
        getattr(p, "layer_index", -1)
        for v in plan.block_details.values() if isinstance(v, tuple)
        for p in v
    }
    skip_layer_amp = -1 in folded

    # layer bounds + per-layer amp (soft-limit contract)
    for l in plan.layers:
        loc = f"layer {l.index} ({l.name})"
        if not 1 <= l.gpus <= n:
            out.append(Violation(
                "layer-bounds", loc,
                f"gpus={l.gpus} outside [1, {n}]"))
        for fname in ("time", "comp", "sync", "comm_in"):
            v = getattr(l, fname)
            if not (math.isfinite(v) and v >= 0.0):
                out.append(Violation(
                    "layer-bounds", loc, f"{fname}={v!r} not finite >= 0"))
        if not (math.isfinite(l.amp) and l.amp >= 0.0):
            out.append(Violation(
                "layer-amp", loc, f"amp={l.amp!r} not finite >= 0"))
        elif (strict_layer_amp and not skip_layer_amp
              and l.index not in folded
              and l.amp > plan.amp_limit * LAYER_AMP_SLACK + EPS):
            out.append(Violation(
                "layer-amp", loc,
                f"amp={l.amp:g} > amp_limit*{LAYER_AMP_SLACK:g}="
                f"{plan.amp_limit * LAYER_AMP_SLACK:g}"))

    # aggregate amp limit
    if plan.amplification > plan.amp_limit + EPS:
        out.append(Violation(
            "plan-amp", "plan",
            f"amplification={plan.amplification:g} > "
            f"amp_limit={plan.amp_limit:g}"))

    # pool exactness (non-pow2 survivor contract)
    if pool_size is not None and n != pool_size:
        out.append(Violation(
            "pool-exact", "plan",
            f"plan targets {n} devices but the pool has {pool_size} — "
            f"survivors must be planned exactly"))

    # stages partition the layer list contiguously, with matching scales
    stages = plan.stages()
    expect_first = 0
    for si, st in enumerate(stages):
        loc = f"stage {si}"
        if st.first != expect_first or st.last < st.first:
            out.append(Violation(
                "stage-cover", loc,
                f"layers [{st.first}, {st.last}] break the contiguous "
                f"partition (expected first={expect_first})"))
            break
        expect_first = st.last + 1
        for li in range(st.first, min(st.last + 1, len(plan.layers))):
            if plan.layers[li].gpus != st.gpus:
                out.append(Violation(
                    "stage-cover", loc,
                    f"layer {li} has gpus={plan.layers[li].gpus} != "
                    f"stage gpus={st.gpus}"))
    else:
        if stages and expect_first != len(plan.layers):
            out.append(Violation(
                "stage-cover", f"stage {len(stages) - 1}",
                f"stages end at layer {expect_first - 1}, plan has "
                f"{len(plan.layers)} layers"))

    # gap windows must mirror their stage
    for g in plan.gaps():
        loc = f"gap@stage {g.stage_index}"
        if not 0 <= g.stage_index < len(stages):
            out.append(Violation(
                "gap-stage", loc, "stage_index out of range"))
            continue
        st = stages[g.stage_index]
        if g.free_gpus != n - st.gpus:
            out.append(Violation(
                "gap-stage", loc,
                f"free_gpus={g.free_gpus} != num_gpus - stage.gpus="
                f"{n - st.gpus}"))

    # branch placements: bounds, then disjointness at the true concurrency
    # granularity — the chain executes layer by layer, so two *different*
    # blocks are never live at once (they may legally reuse the same device
    # window); only parallel non-critical branches of the SAME block run
    # concurrently with each other and with that block's critical branch in
    # [0, stage.gpus).  Demoted/sequential branches time-multiplex the
    # critical range and occupy nothing extra.
    for block, v in plan.block_details.items():
        if not isinstance(v, tuple):
            continue
        par = [
            p for p in v
            if getattr(p, "parallel", False)
            and not getattr(p, "critical", False)
        ]
        for p in par:
            loc = f"branch {p.block}[{p.branch}]"
            if not 0 <= p.device_start < p.device_end <= n:
                out.append(Violation(
                    "branch-bounds", loc,
                    f"devices [{p.device_start}, {p.device_end}) outside "
                    f"[0, {n})"))
        # the fg window while this block executes: the stage containing the
        # block's fold layer (unknown provenance -> check every stage the
        # busy-range logic would exclude it from, i.e. all of them)
        for p in par:
            li = getattr(p, "layer_index", -1)
            hosts = [
                st for st in stages
                if li < 0 or st.first <= li <= st.last
            ]
            for st in hosts:
                if _overlap((0, st.gpus), p.devices):
                    out.append(Violation(
                        "branch-overlap", f"block {block}",
                        f"branch [{p.branch}] devices {p.devices} overlap "
                        f"the fg window [0, {st.gpus}) of its host stage"))
        for i, a in enumerate(par):
            for b in par[i + 1:]:
                if _overlap(a.devices, b.devices):
                    out.append(Violation(
                        "branch-overlap", f"block {block}",
                        f"branches [{a.branch}] {a.devices} and "
                        f"[{b.branch}] {b.devices} overlap"))

    # free/busy must partition the pool exactly, every stage
    for si in range(len(stages)):
        busy = plan.busy_device_ranges(si)
        free = plan.free_device_ranges(si)
        loc = f"stage {si}"
        if not _disjoint(list(busy) + list(free)):
            out.append(Violation(
                "free-busy", loc, f"free {free} overlaps busy {busy}"))
        if _span(merge_ranges(list(busy) + list(free))) != n or \
                _span(busy) + _span(free) != n:
            out.append(Violation(
                "free-busy", loc,
                f"free {free} + busy {busy} do not cover [0, {n}) exactly"))
    return out


def verify_plan_or_raise(plan: BurstPlan, *,
                         pool_size: Optional[int] = None,
                         context: str = "plan") -> None:
    vs = verify_plan(plan, pool_size=pool_size)
    if vs:
        raise PlanVerificationError(vs, context=context)


# -- the bg carving (pure ranges — mirrors split_mesh_for_plan, no meshes) --


def verify_carving(plan: BurstPlan, *, tenants: int = 1,
                   bg_model: int = 1,
                   tenant_quanta: Optional[Sequence[int]] = None,
                   ) -> List[Violation]:
    """Re-derive the per-gap tenant carving from ranges alone and check it.

    This is the same ``pack_ranges`` call ``split_mesh_for_plan`` makes,
    verified against the invariants the collocator assumes: chunks pairwise
    disjoint, each inside one free range (never touching the fg window or a
    branch placement), every chunk quantum-aligned to its slot, and never
    more chunks than tenants.  Because it never builds a Mesh it runs on a
    plan for 1024 devices in microseconds.
    """
    out: List[Violation] = []
    quanta = (normalize_quanta(tenant_quanta, tenants)
              if tenant_quanta is not None else [bg_model] * tenants)
    for gap in plan.gaps():
        si = gap.stage_index
        free = plan.free_device_ranges(si)
        chunks = pack_ranges(
            free, tenants,
            quantum=(normalize_quanta(tenant_quanta, tenants)
                     if tenant_quanta is not None else bg_model))
        live = [c for c in chunks if c is not None]
        loc = f"carving@stage {si}"
        if len(chunks) > tenants:
            out.append(Violation(
                "carve-count", loc,
                f"{len(chunks)} chunks for {tenants} tenants"))
        if not _disjoint(live):
            out.append(Violation(
                "carve-overlap", loc, f"chunks overlap: {live}"))
        for slot, c in enumerate(chunks):
            if c is None:
                continue
            s, e = c
            q = quanta[slot] if tenant_quanta is not None else bg_model
            if e <= s:
                out.append(Violation(
                    "carve-bounds", f"{loc} slot {slot}",
                    f"empty chunk {c}"))
                continue
            if (e - s) % q:
                out.append(Violation(
                    "carve-quantum", f"{loc} slot {slot}",
                    f"chunk {c} size {e - s} not a multiple of "
                    f"quantum {q}"))
            if not any(fs <= s and e <= fe for fs, fe in free):
                out.append(Violation(
                    "carve-free", f"{loc} slot {slot}",
                    f"chunk {c} escapes the free ranges {free} — it "
                    f"touches the fg window or a branch placement"))
    return out


# -- real carved submeshes (PlanSubmeshes / ServingSubmeshes) ---------------


def verify_submeshes(plan: BurstPlan, submeshes) -> List[Violation]:
    """Check a carved ``PlanSubmeshes`` against its plan.

    Works on positional ranges and mesh *shapes* only — never touches the
    device objects — so it holds for real, forced-host, and virtual device
    sets alike.
    """
    out: List[Violation] = []
    n = plan.num_gpus
    stages = plan.stages()
    fs, fe = submeshes.fg_range
    peak = max(s.gpus for s in stages)
    if (fs, fe) != (0, peak):
        out.append(Violation(
            "submesh-fg", "fg", f"fg_range {(fs, fe)} != (0, peak={peak})"))
    if submeshes.fg_mesh is not None and \
            int(submeshes.fg_mesh.devices.size) != fe - fs:
        out.append(Violation(
            "submesh-size", "fg",
            f"fg mesh has {int(submeshes.fg_mesh.devices.size)} devices, "
            f"range {(fs, fe)} spans {fe - fs}"))
    for si, slots in submeshes.bg_tenants.items():
        if not 0 <= si < len(stages):
            out.append(Violation(
                "submesh-stage", f"stage {si}", "not a plan stage"))
            continue
        busy = plan.busy_device_ranges(si)
        live = [c for c, _mesh in (s for s in slots if s is not None)]
        loc = f"submesh@stage {si}"
        if not _disjoint(live):
            out.append(Violation(
                "submesh-overlap", loc, f"tenant ranges overlap: {live}"))
        for slot, hit in enumerate(slots):
            if hit is None:
                continue
            (s, e), mesh = hit
            sloc = f"{loc} slot {slot}"
            if not 0 <= s < e <= n:
                out.append(Violation(
                    "submesh-bounds", sloc,
                    f"range {(s, e)} outside [0, {n})"))
            for b in busy:
                if _overlap((s, e), b):
                    out.append(Violation(
                        "submesh-overlap", sloc,
                        f"tenant range {(s, e)} overlaps busy range {b} "
                        f"(fg window or branch placement)"))
            if mesh is not None and int(mesh.devices.size) != e - s:
                out.append(Violation(
                    "submesh-size", sloc,
                    f"mesh has {int(mesh.devices.size)} devices, range "
                    f"{(s, e)} spans {e - s}"))
        hit = submeshes.bg.get(si)
        if hit is not None and all(
                hit[0] != c for c, _m in
                (s for s in slots if s is not None)):
            out.append(Violation(
                "submesh-slot0", loc,
                f"bg range {hit[0]} is not one of the tenant slots"))
    return out


def verify_serving_submeshes(sub, n_devices: int) -> List[Violation]:
    """Check a ``ServingSubmeshes`` prefill/decode carving."""
    out: List[Violation] = []
    (ps, pe), (ds, de) = sub.prefill_range, sub.decode_range
    for name, (s, e) in (("prefill", (ps, pe)), ("decode", (ds, de))):
        if not 0 <= s < e <= n_devices:
            out.append(Violation(
                "serving-bounds", name,
                f"range {(s, e)} outside [0, {n_devices})"))
    if _overlap((ps, pe), (ds, de)):
        out.append(Violation(
            "serving-overlap", "prefill/decode",
            f"prefill {(ps, pe)} overlaps decode {(ds, de)}"))
    for name, mesh, (s, e) in (
            ("prefill", sub.prefill_mesh, (ps, pe)),
            ("decode", sub.decode_mesh, (ds, de))):
        if mesh is not None and int(mesh.devices.size) != e - s:
            out.append(Violation(
                "serving-size", name,
                f"mesh has {int(mesh.devices.size)} devices, range "
                f"{(s, e)} spans {e - s}"))
    return out


# -- stage shardings (map_plan_to_mesh output) ------------------------------


_MESH_AXIS_VOCAB = ("pod", "data", "model")


def verify_stage_shardings(plan: BurstPlan,
                           shardings: Sequence[StageSharding],
                           mesh_axes: Dict[str, int]) -> List[Violation]:
    """Check ``map_plan_to_mesh`` output against its plan and mesh."""
    out: List[Violation] = []
    stages = plan.stages()
    if len(shardings) != len(stages):
        out.append(Violation(
            "sharding-count", "plan",
            f"{len(shardings)} stage shardings for {len(stages)} stages"))
    for si, sh in enumerate(shardings):
        loc = f"sharding@stage {si}"
        for ax in sh.batch_axes:
            if ax not in _MESH_AXIS_VOCAB:
                out.append(Violation(
                    "sharding-axis", loc,
                    f"batch axis {ax!r} outside the mesh vocabulary "
                    f"{_MESH_AXIS_VOCAB}"))
            elif ax not in mesh_axes:
                out.append(Violation(
                    "sharding-axis", loc,
                    f"batch axis {ax!r} not on this mesh "
                    f"(axes: {sorted(mesh_axes)})"))
        if not sh.batch_axes:
            out.append(Violation(
                "sharding-axis", loc, "no batch axes — samples unplaced"))
        if si < len(stages):
            expect = tuple(plan.free_device_ranges(si))
            if tuple(sh.free_ranges) != expect:
                out.append(Violation(
                    "sharding-free", loc,
                    f"free_ranges {sh.free_ranges} != plan's {expect}"))
    return out
