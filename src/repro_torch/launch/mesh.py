"""Plan-driven device slices (executable gap collocation, paper §5).

The port of the plan carving of ``repro/launch/mesh.py``:
``submesh_from_range``, ``PlanSubmeshes`` and ``split_mesh_for_plan``.
The reference's JAX ``Mesh`` becomes a frozen ``DeviceSlice``: the index
range ``[start, end)``, the ``torch.device`` at each of those positions,
the ``(data, model)`` shape, the ids of the positions (what the
executable cache keys on) and the CUDA stream its work is issued on
(``None`` on the CPU).

Devices are taken by position, so two disjoint index ranges always give
disjoint slices of the plan.  Where the positions are distinct cards
(the reference's TPU submesh mode) that is disjoint hardware.  On one
card, the paper's own GPU mode (``MultiplexConfig.collocate_same_device``),
every position is that card, and the slices differ only by their streams:
the foreground on one of the greatest priority, each background tenant on
its own of the least.

``make_mesh``, ``largest_pow2_mesh``, ``remesh_for_pool``,
``split_mesh_for_serving`` and the process groups a step over several
cards would need wait for the multi-device layer (ROADMAP Queue 1, item
11); ``DeviceSlice.device`` raises, naming that item, for a slice that
spans more than one card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.plan import normalize_quanta, pack_ranges


def host_devices(device: DeviceLike = None) -> List[torch.device]:
    """The process's devices of ``device``'s type: every card (the
    default, which raises without one), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


@dataclass(frozen=True)
class DeviceSlice:
    """The positions ``[start, end)`` of a device list, as a
    ``(data, model)`` grid, with the stream their work is issued on."""

    start: int
    end: int
    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]  # (data, model)
    ids: Tuple[int, ...]    # the positions' ids: the executable cache's key
    stream: Optional[object] = None  # torch.cuda.Stream; None on the CPU

    @property
    def size(self) -> int:
        return self.end - self.start

    @property
    def device(self) -> torch.device:
        """The one device every position of the slice is on."""
        distinct = list(dict.fromkeys(self.devices))
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a step over positions [{self.start}, {self.end}) spans "
                f"{len(distinct)} devices {[str(d) for d in distinct]}: steps over more "
                "than one card wait for process groups (ROADMAP Queue 1, item 11)")
        return distinct[0]


def submesh_from_range(start: int, end: int, *, model: int = 1,
                       devices: Optional[Sequence] = None,
                       ids: Optional[Sequence[int]] = None,
                       stream=None) -> DeviceSlice:
    """A (data, model) slice over the device-index range [start, end).

    Devices are taken positionally from ``devices`` (default: the
    process's cards), so two non-overlapping index ranges always yield
    disjoint slices — the invariant the collocator relies on.  ``ids``
    names each position of ``devices`` (default: its index); the slice
    keeps the ids of its own.
    """
    devs = list(devices) if devices is not None else host_devices()
    n = end - start
    if n <= 0:
        raise ValueError(f"empty device range [{start}, {end})")
    if start < 0 or end > len(devs):
        raise ValueError(
            f"device range [{start}, {end}) outside the {len(devs)}-device set"
        )
    if n % model:
        raise ValueError(f"range size {n} not divisible by model={model}")
    pos_ids = tuple(range(len(devs))) if ids is None else tuple(ids)
    return DeviceSlice(start, end, tuple(devs[start:end]), (n // model, model),
                       pos_ids[start:end], stream)


@dataclass(frozen=True)
class PlanSubmeshes:
    """Disjoint fg/bg slices for one BurstPlan.

    ``fg_range``/``fg_mesh`` span the plan's peak foreground device usage;
    ``bg`` maps each gap stage to the largest free device range (after
    excluding parallel-branch placements active in that stage) and its slice.
    ``bg_tenants`` maps each gap stage to the per-tenant carving: up to
    ``tenants`` disjoint (range, slice) slots in priority order (slot 0 =
    largest chunk = highest-priority tenant); ``bg`` is always slot 0.
    ``stage_fg_range`` gives the foreground's *actual* device window per
    stage — during a gap stage the fg occupies a strict prefix of
    ``fg_range``, and every bg range is disjoint from it.
    """

    fg_range: Tuple[int, int]
    fg_mesh: DeviceSlice
    bg: Dict[int, Tuple[Tuple[int, int], DeviceSlice]]
    stage_fg_range: Dict[int, Tuple[int, int]]
    bg_tenants: Dict[int, Tuple[Optional[Tuple[Tuple[int, int], DeviceSlice]], ...]] = field(
        default_factory=dict
    )

    def bg_mesh(self, stage_index: int) -> Optional[DeviceSlice]:
        hit = self.bg.get(stage_index)
        return hit[1] if hit else None

    def tenant_mesh(self, stage_index: int, slot: int) -> Optional[DeviceSlice]:
        slots = self.bg_tenants.get(stage_index, ())
        if slot >= len(slots) or slots[slot] is None:
            return None
        return slots[slot][1]


def split_mesh_for_plan(plan, *, devices: Optional[Sequence] = None,
                        ids: Optional[Sequence[int]] = None,
                        fg_model: int = 1, bg_model: int = 1,
                        tenants: int = 1,
                        tenant_quanta: Optional[Sequence[int]] = None,
                        ) -> PlanSubmeshes:
    """Carve the device set into the plan's fg slice + per-gap bg slices.

    For each ``GapWindow`` the free set is ``plan.free_device_ranges(stage)``
    — the gap's idle devices minus any ``BranchPlacement`` ranges hosting
    parallel block branches *during that stage* — packed into up to
    ``tenants`` disjoint ``bg_model``-aligned chunks (``pack_ranges``,
    largest chunk first for the highest-priority tenant).  Raises when the
    device list is shorter than the plan assumes.

    ``tenant_quanta`` switches to the slot-aware per-tenant mode: slot *i*'s
    chunk is aligned to (and its slice's model width is) ``tenant_quanta[i]``
    instead of the global ``bg_model``; a slot whose quantum no chunk can
    satisfy gets ``None`` in ``bg_tenants`` (the tenant is dropped from that
    gap — admission control / the starvation rotation decide what to do).
    """
    devs = list(devices) if devices is not None else host_devices()
    if len(devs) < plan.num_gpus:
        raise ValueError(
            f"plan wants {plan.num_gpus} devices, process has {len(devs)}"
        )
    stages = plan.stages()
    fg_peak = max(s.gpus for s in stages)
    if fg_peak % fg_model:
        fg_model = 1
    fg_mesh = submesh_from_range(0, fg_peak, model=fg_model, devices=devs, ids=ids)
    bg: Dict[int, Tuple[Tuple[int, int], DeviceSlice]] = {}
    bg_tenants: Dict[int, Tuple[Optional[Tuple[Tuple[int, int], DeviceSlice]], ...]] = {}
    stage_fg: Dict[int, Tuple[int, int]] = {
        i: (0, s.gpus) for i, s in enumerate(stages)
    }
    quanta = (normalize_quanta(tenant_quanta, tenants)
              if tenant_quanta is not None else None)
    for gap in plan.gaps():
        free = plan.free_device_ranges(gap.stage_index)
        chunks = pack_ranges(free, tenants,
                             quantum=quanta if quanta is not None else bg_model)
        if not chunks or all(c is None for c in chunks):
            continue
        slots = tuple(
            None if c is None else (
                c, submesh_from_range(
                    c[0], c[1],
                    model=quanta[slot] if quanta is not None else bg_model,
                    devices=devs, ids=ids,
                )
            )
            for slot, c in enumerate(chunks)
        )
        bg_tenants[gap.stage_index] = slots
        bg[gap.stage_index] = next(s for s in slots if s is not None)
    return PlanSubmeshes(fg_range=(0, fg_peak), fg_mesh=fg_mesh, bg=bg,
                         stage_fg_range=stage_fg, bg_tenants=bg_tenants)
