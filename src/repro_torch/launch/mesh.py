"""Meshes and device slices (multi-device, and executable gap collocation).

The port of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, one process per position (SPMD), with the reference's axis
names (``pod``, ``data``, ``model``): gloo on the CPU, NCCL on cards.
``make_mesh`` builds one over every rank (or a list of ranks);
``make_production_mesh`` builds the reference's (16, 16) or (2, 16, 16)
mesh, or an ``AbstractMesh`` of that shape when the world is smaller, for
the rules to read.  ``fake_world`` is a process group whose collectives
move nothing, where this process plays any one rank of a world of any
size: the meshes built on it are of the device type a dry-run models
(``launch/dryrun.py``).  ``pow2_mesh_shape``/``largest_pow2_mesh`` and
``remesh_for_pool`` are the elastic re-carving over a surviving pool of
ranks, and ``split_mesh_for_serving`` the prefill/decode carving.

The plan carving (``submesh_from_range``, ``PlanSubmeshes``,
``split_mesh_for_plan``) gives frozen ``DeviceSlice``s: the index range
``[start, end)``, the ``torch.device`` at each of those positions, the
``(data, model)`` shape, the ids of the positions (what the executable
cache keys on), the CUDA stream its work is issued on (``None`` on the
CPU) and, for a slice over several ranks, the ``DeviceMesh`` over them.

Devices are taken by position, so two disjoint index ranges always give
disjoint slices of the plan.  The positions are one of three kinds:

  - the ranks of the process group (``ranks=``): each slice is a rank
    slice, a ``DeviceMesh`` over its ranks, and each rank issues its own
    share of the slice's work on its own device (``DeviceSlice.member``
    says whether this rank holds the slice).  Building a ``DeviceMesh``
    is collective over the whole group, so every rank carves, in the same
    order; the meshes are kept by ``(ranks, shape)`` for the life of the
    group, so carving the same slice again builds no new communicators.
    This is the reference's TPU submesh mode: one card per position;
  - one card listed once per position (the paper's own GPU mode,
    ``MultiplexConfig.collocate_same_device``): the slices differ only by
    their streams, the foreground on one of the greatest priority, each
    background tenant on its own of the least;
  - devices of this process (the CPU, or a list of cards).  A step runs
    in one process on one device, so a slice over several cards here
    raises ``NotImplementedError`` when a step asks for its device: carve
    it over ranks instead.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.plan import normalize_quanta, pack_ranges, pow2_floor, serving_plan
from repro_torch.dist.sharding import mesh_axis_sizes  # noqa: F401 (re-export)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no ranks behind it: what the
    sharding rules read (``axis_names`` and ``devices.shape``), for meshes
    larger than the process group."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def devices(self) -> np.ndarray:
        return np.zeros(self.shape, dtype=np.int8)

    def __repr__(self) -> str:
        return "x".join(f"{a}={n}" for a, n in zip(self.axis_names, self.shape))


# the device types the meshes of the innermost ``fake_world`` are built on
_FAKE_DEVICE_TYPE: List[str] = []


@contextmanager
def fake_world(world_size: int, device_type: str, rank: int = 0):
    """A fake process group of ``world_size`` ranks in which this process is
    ``rank``: its collectives return at once and move nothing
    (``torch.testing._internal.distributed.fake_pg``), so a step runs as
    that rank of a world no machine here has.  The meshes built on it are of
    ``device_type``, the device a dry-run models; for ``meta`` they are CPU
    meshes holding meta tensors (DTensor asks a mesh's device module how
    many devices a host has, and meta has none).  The group is destroyed
    on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process group")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    _FAKE_DEVICE_TYPE.append("cpu" if device_type == "meta" else device_type)
    try:
        yield
    finally:
        _FAKE_DEVICE_TYPE.pop()
        dist.destroy_process_group()


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed.init_process_group first "
                           "(gloo on the CPU, nccl on cards)")
    return dist.get_world_size()


def _device_type() -> str:
    """The device type of this process group's meshes: cards under NCCL,
    the modelled device in a ``fake_world``, else the CPU (gloo)."""
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend == "fake":
        return _FAKE_DEVICE_TYPE[-1] if _FAKE_DEVICE_TYPE else "cpu"
    return "cuda" if backend == "nccl" else "cpu"


def _rank_mesh(ranks: Sequence[int], shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A DeviceMesh of ``shape`` over ``ranks`` (row-major).  Every rank of
    the process group takes part in building it."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = [int(r) for r in ranks]
    if len(ranks) != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {math.prod(shape)} ranks, "
                         f"got {len(ranks)}")
    world = _world()
    bad = [r for r in ranks if not 0 <= r < world]
    if bad:
        raise ValueError(f"ranks {bad} outside the {world}-rank process group")
    return DeviceMesh(_device_type(), torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) ``(data, model)`` or (2,
    16, 16) ``(pod, data, model)``; a ``DeviceMesh`` when the process group
    has exactly that many ranks, else an ``AbstractMesh`` of that shape."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return _rank_mesh(range(math.prod(shape)), shape, axes)
    return AbstractMesh(shape, axes)


def make_mesh(data: int, model: int, pod: int = 1, devices: Optional[Sequence[int]] = None):
    """A (data, model) mesh, or (pod, data, model) when ``pod > 1``, over
    ``devices``: ranks of the process group (default: every rank, in
    order).  Every rank of the process group must call it."""
    ranks = list(devices) if devices is not None else list(range(_world()))
    if pod > 1:
        return _rank_mesh(ranks, (pod, data, model), ("pod", "data", "model"))
    return _rank_mesh(ranks, (data, model), ("data", "model"))


def pow2_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """The (data, model) shape ``largest_pow2_mesh`` would build — pure
    arithmetic, so every mesh shape reachable after a failure can be
    enumerated without building one."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    cap = 1
    while cap * cap * 4 <= pow2_floor(n_devices):
        cap *= 2
    candidates = []
    m = 1
    while m <= cap:
        candidates.append(m)
        m *= 2
    # widest model axis within the 4:1 bound that maximizes device coverage
    model = max(candidates, key=lambda m: (n_devices // m * m, m))
    return n_devices // model, model


def largest_pow2_mesh(n_devices: int, devices: Optional[Sequence[int]] = None):
    """Elastic re-mesh: the largest (data, model) mesh that fits n_devices,
    favoring the data axis 4:1 (used after failures).  The model axis stays
    a power of two — sharding rules genuinely need it to divide head/hidden
    dims — but the data axis is just a batch split, so a non-power-of-two
    survivor count keeps every rank the model width allows (7 survivors
    -> 7x1, not 4x1).  ``devices`` are ranks (default: every rank)."""
    data, model = pow2_mesh_shape(n_devices)
    ranks = list(devices) if devices is not None else list(range(_world()))
    return make_mesh(data, model, devices=ranks[: data * model])


def remesh_for_pool(device_ids, *, devices: Optional[Sequence[int]] = None):
    """Re-carve a mesh onto a surviving pool (applied reconfig).

    ``device_ids`` is the healthy pool from a reconfiguration event.  Ids
    map positionally onto ``devices`` (default: the ranks of the process
    group) and ids beyond it are skipped; the carving itself is
    ``largest_pow2_mesh``, so a non-pow2 survivor count keeps every rank
    the model width allows.
    """
    devs = list(devices) if devices is not None else list(range(_world()))
    local = [devs[int(i)] for i in device_ids if 0 <= int(i) < len(devs)]
    if not local:
        raise ValueError(
            f"reconfig pool {sorted(int(i) for i in device_ids)} has no "
            f"local devices (process has {len(devs)})"
        )
    return largest_pow2_mesh(len(local), devices=local)


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
    mesh: Optional[object] = None    # DeviceMesh over the ranks (a rank slice)

    @property
    def size(self) -> int:
        return self.end - self.start

    @property
    def ranks(self) -> Optional[Tuple[int, ...]]:
        """A rank slice's ranks, row-major; None for a slice of devices."""
        if self.mesh is None:
            return None
        return tuple(int(r) for r in self.mesh.mesh.flatten().tolist())

    @property
    def member(self) -> bool:
        """Whether this process issues the slice's work: always for a slice
        of devices; for a rank slice, when this rank is one of its ranks."""
        return self.mesh is None or self.mesh.get_coordinate() is not None

    @property
    def device(self) -> torch.device:
        """The one device this process issues the slice's work on: every
        position's, or for a rank slice this rank's own.  A slice of
        several cards in one process raises ``NotImplementedError``: a
        step over several cards runs one process per card, on the rank
        slice that carving the positions as ranks (``ranks=``) gives."""
        distinct = list(dict.fromkeys(self.devices))
        if len(distinct) > 1:
            raise NotImplementedError(
                f"positions [{self.start}, {self.end}) span {len(distinct)} devices "
                f"{[str(d) for d in distinct]} in one process: a step over several cards "
                "runs one process per card, so carve the positions as the ranks of a "
                "process group (ranks=), which gives a rank slice")
        return distinct[0]


def rank_device() -> torch.device:
    """This rank's device: its current card under NCCL, else the CPU."""
    if _device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# the rank slices' meshes by (ranks, shape), for the process group they were
# built in (the first entry of _SLICE_WORLD)
_SLICE_MESHES: Dict[tuple, object] = {}
_SLICE_WORLD: List[object] = []


def _slice_mesh(ranks: Sequence[int], shape: Tuple[int, int]):
    """The (data, model) DeviceMesh of ``shape`` over ``ranks``, built once
    per process group: every rank of the group takes part in the first
    build, and every later call returns that mesh without communicating."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if not _SLICE_WORLD or _SLICE_WORLD[0] is not world:
        _SLICE_MESHES.clear()
        _SLICE_WORLD[:] = [world]
    key = (tuple(int(r) for r in ranks), tuple(shape))
    if key not in _SLICE_MESHES:
        _SLICE_MESHES[key] = _rank_mesh(key[0], key[1], ("data", "model"))
    return _SLICE_MESHES[key]


def rank_slice(start: int, end: int, *, model: int = 1, stream=None) -> DeviceSlice:
    """A (data, model) slice over the ranks [start, end) of the process
    group, with the ``DeviceMesh`` over them; every rank calls it (building
    a mesh is collective).  Each rank issues its share of the slice's work
    on its own device."""
    return submesh_from_range(start, end, model=model, ranks=range(_world()), stream=stream)


def submesh_from_range(start: int, end: int, *, model: int = 1,
                       devices: Optional[Sequence] = None,
                       ids: Optional[Sequence[int]] = None,
                       stream=None,
                       ranks: Optional[Sequence[int]] = None) -> DeviceSlice:
    """A (data, model) slice over the position range [start, end).

    The positions are ``devices`` (default: the process's cards) or, with
    ``ranks``, ranks of the process group, taken positionally, so two
    non-overlapping index ranges always yield disjoint slices — the
    invariant the collocator relies on.  Over ranks the slice is a rank
    slice (its ``DeviceMesh`` over ``ranks[start:end]``), and every rank
    of the group must carve it.  ``ids`` names each position (default: its
    index, or its rank); the slice keeps the ids of its own.
    """
    if ranks is not None and devices is not None:
        raise ValueError("the positions are devices or ranks, not both")
    devs = list(ranks) if ranks is not None else (
        list(devices) if devices is not None else host_devices())
    n = end - start
    if n <= 0:
        raise ValueError(f"empty device range [{start}, {end})")
    if start < 0 or end > len(devs):
        raise ValueError(
            f"device range [{start}, {end}) outside the {len(devs)}-device set"
        )
    if n % model:
        raise ValueError(f"range size {n} not divisible by model={model}")
    shape = (n // model, model)
    if ids is not None:
        pos_ids = tuple(ids)
    else:
        pos_ids = tuple(int(r) for r in devs) if ranks is not None else tuple(range(len(devs)))
    if ranks is None:
        return DeviceSlice(start, end, tuple(devs[start:end]), shape, pos_ids[start:end],
                           stream)
    return DeviceSlice(start, end, (rank_device(),) * n, shape, pos_ids[start:end], stream,
                       _slice_mesh(devs[start:end], shape))


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
                        ranks: Optional[Sequence[int]] = None,
                        ) -> PlanSubmeshes:
    """Carve the device set into the plan's fg slice + per-gap bg slices.

    The positions are ``devices`` (default: the process's cards) or, with
    ``ranks``, ranks of the process group, whose slices are rank slices
    (``submesh_from_range``): every rank carves, in this order — the
    foreground's peak range, then each gap's slots.

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
    if ranks is None and devices is None:
        devices = host_devices()
    n_pos = len(ranks if ranks is not None else devices)
    if n_pos < plan.num_gpus:
        raise ValueError(
            f"plan wants {plan.num_gpus} devices, process has {n_pos}"
        )
    where = dict(devices=devices, ids=ids, ranks=ranks)
    stages = plan.stages()
    fg_peak = max(s.gpus for s in stages)
    if fg_peak % fg_model:
        fg_model = 1
    fg_mesh = submesh_from_range(0, fg_peak, model=fg_model, **where)
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
                    **where,
                )
            )
            for slot, c in enumerate(chunks)
        )
        bg_tenants[gap.stage_index] = slots
        bg[gap.stage_index] = next(s for s in slots if s is not None)
    return PlanSubmeshes(fg_range=(0, fg_peak), fg_mesh=fg_mesh, bg=bg,
                         stage_fg_range=stage_fg, bg_tenants=bg_tenants)


# ---------------------------------------------------------------------------
# Serving submeshes (prefill/decode disaggregation)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingSubmeshes:
    """Disjoint prefill/decode slices for a disaggregated serving engine.

    Built by carving a ``serving_plan`` with ``split_mesh_for_plan``:
    prefill is the plan's foreground stage on [0, n_prefill), decode is the
    gap's largest bg chunk.  The ranges are positional indices, so
    ``disjoint`` is checkable without touching the devices.
    """

    prefill_range: Tuple[int, int]
    prefill_mesh: DeviceSlice
    decode_range: Tuple[int, int]
    decode_mesh: DeviceSlice

    def disjoint(self) -> bool:
        (ps, pe), (ds, de) = self.prefill_range, self.decode_range
        return pe <= ds or de <= ps

    def device_sets_disjoint(self) -> bool:
        """The ground-truth check: no physical device in both slices (false
        on one card, where both are that card on streams of their own)."""
        return not (set(self.prefill_mesh.devices) & set(self.decode_mesh.devices))


def split_mesh_for_serving(n_prefill: int, *,
                           devices: Optional[Sequence] = None,
                           prefill_model: int = 1,
                           decode_model: int = 1,
                           ranks: Optional[Sequence[int]] = None) -> ServingSubmeshes:
    """Carve the device list into disjoint prefill + decode slices.

    Reuses the ``split_mesh_for_plan`` carving over a ``serving_plan`` —
    prefill as the foreground stage, decode as its burst gap — so the
    positional-disjointness invariant of ``submesh_from_range`` carries
    over.  ``devices`` defaults to the process's cards; on one card pass
    it twice (``[card, card]``): two positions of the same card.  With
    ``ranks`` the positions are ranks of the process group and both
    slices are rank slices (every rank carves them).
    """
    if ranks is not None:
        n_pos, where = len(ranks), dict(ranks=list(ranks))
    else:
        devs = list(devices) if devices is not None else host_devices()
        n_pos, where = len(devs), dict(devices=devs)
    plan = serving_plan(n_pos, n_prefill)
    split = split_mesh_for_plan(plan, fg_model=prefill_model, bg_model=decode_model,
                                **where)
    hit = split.bg.get(0)
    if hit is None:
        raise ValueError(
            f"no decode carving: {n_pos - n_prefill} free devices can't "
            f"fit a decode submesh with model={decode_model}"
        )
    (ds, de), dmesh = hit
    return ServingSubmeshes(
        prefill_range=split.fg_range, prefill_mesh=split.fg_mesh,
        decode_range=(ds, de), decode_mesh=dmesh,
    )
