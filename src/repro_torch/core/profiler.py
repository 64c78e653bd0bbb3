"""Layer profiler: LayerGraph -> per-layer cost tables for the planner.

The port of ``repro/core/profiler.py``.  The paper profiles each layer on
real hardware at every batch size; here, as in the reference, the same
tables come from the analytical hardware model (costmodel.py), optionally
*calibrated* by measured microbenchmarks: ``calibrate_kinds`` times one
small op per layer kind on a device and returns per-kind speed ratios, so
relative layer heterogeneity — the thing the planner exploits — is
measurement-driven.  ``measure_kernel_overhead`` times one empty launch on
the card (``costmodel.H100.kernel_overhead``).

``CostedLayer`` is exactly the paper's interface: comp(i,g), sync(i,g) plus
the activation payload used by comm((i,g)→(j,h)).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.costmodel import (
    Hardware,
    comp_time,
    comp_time_batch,
    sync_time_batch,
)
from repro_torch.models.graph import LayerNode, ParallelBlock


def powers_of_two(G: int) -> list:
    """Planner search space (paper §7.4: 'only considers GPU counts that are
    powers of two')."""
    out, g = [], 1
    while g <= G:
        out.append(g)
        g *= 2
    return out


def plan_scales(G: int) -> list:
    """Planner search space for a G-device pool.

    A power-of-two pool keeps the paper's §7.4 pow2-only search space, so
    every pre-existing configuration plans bit-identically.  A non-power-of
    -two pool — the elastic case after device failures — used to round down
    via ``pow2_floor`` and silently discard up to ~half the survivors (a
    1024-device pool with 3 dead devices planned as 512).  Here the scale
    set is extended with the exact pool size plus the 3·2^k midpoints that
    fit, so the DP can place layers on all surviving devices wherever
    amplification allows, falling back to smaller scales only where the
    amp limit genuinely binds."""
    out = powers_of_two(G)
    if out[-1] != G:
        mids = [3 * p // 2 for p in out if p >= 2 and 3 * p // 2 <= G]
        out = sorted(set(out) | set(mids) | {G})
    return out


@dataclass(frozen=True)
class CostedLayer:
    name: str
    comp: Dict[int, float]  # g -> fwd+bwd seconds
    sync: Dict[int, float]  # g -> gradient all-reduce seconds
    act_bytes: float
    comp1: float  # single-device iteration time (Amp denominator)
    kind: str = "generic"


@dataclass(frozen=True)
class CostedBlock:
    name: str
    branches: tuple  # tuple of tuples of CostedLayer/CostedBlock


def profile_node(node: LayerNode, scales: Sequence[int], hw: Hardware) -> CostedLayer:
    # Batched over the scale vector (costmodel.*_batch): one numpy evaluation
    # per layer instead of one Python call per (layer, scale); bit-identical
    # to the scalar formulas.
    sg = max(getattr(node, "sync_groups", 1), 1)
    comp_v = comp_time_batch(node, list(scales), hw)
    sync_v = sync_time_batch(
        node.param_bytes / sg, [max(g // sg, 1) for g in scales], hw
    )
    comp = {g: float(c) for g, c in zip(scales, comp_v)}
    sync = {g: float(s) for g, s in zip(scales, sync_v)}
    return CostedLayer(
        name=node.name,
        comp=comp,
        sync=sync,
        act_bytes=node.act_out_bytes,
        comp1=comp_time(node, 1, hw),
        kind=node.kind,
    )


def profile_graph(graph, G: int, hw: Hardware) -> list:
    """LayerGraph -> chain of CostedLayer / CostedBlock."""
    scales = plan_scales(G)
    out = []
    for el in graph:
        if isinstance(el, LayerNode):
            out.append(profile_node(el, scales, hw))
        elif isinstance(el, ParallelBlock):
            branches = tuple(
                tuple(profile_graph(list(br), G, hw)) for br in el.branches
            )
            out.append(CostedBlock(name=el.name, branches=branches))
        else:
            raise TypeError(type(el))
    return out


# ---------------------------------------------------------------------------
# Optional measured calibration (microbenchmarks on a device; keeps
# *relative* layer heterogeneity measurement-driven)
# ---------------------------------------------------------------------------


def _timer(device: torch.device):
    """``time(fn) -> seconds`` of one call: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        def cuda_time(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return cuda_time

    def host_time(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return host_time


def calibrate_kinds(graph, repeats: int = 3, device: DeviceLike = None) -> Dict[str, float]:
    """Measure a tiny representative op per layer kind on ``device`` (the
    card unless the caller asks for the CPU) and return per-kind speed
    ratios (1.0 = the fastest kind). Used by benchmarks to show the
    feedback loop the paper runs manually (§3.2).  The reference's three
    probes: a (2,128,64) attention-score einsum, a 256² matmul and a 3×3
    conv of 16 channels over 32×32 (NHWC there, NCHW here)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    kinds = {n.kind for n in graph if isinstance(n, LayerNode)}
    probe = {
        "attention": (lambda a, b: torch.einsum("bsh,bth->bst", a, b),
                      (normal(2, 128, 64), normal(2, 128, 64))),
        "mlp": (lambda a, b: a @ b, (normal(256, 256), normal(256, 256))),
        "conv": (lambda x, w: F.conv2d(x, w, padding="same"),
                 (normal(1, 16, 32, 32), normal(16, 16, 3, 3))),
    }
    clock = _timer(dev)
    ratios: Dict[str, float] = {}
    for kind in kinds:
        fn, args = probe.get(kind, probe["mlp"])
        run = lambda: fn(*args)  # noqa: E731
        clock(run)  # warmup
        ratios[kind] = sum(clock(run) for _ in range(repeats)) / repeats
    base = min(ratios.values()) or 1.0
    return {k: v / base for k, v in ratios.items()}


def measure_kernel_overhead(device: DeviceLike = None, reps: int = 200) -> float:
    """Median seconds of one launch of a one-element kernel, from CUDA
    events around the launch (the host's launch latency included): the
    per-op cost ``Hardware.kernel_overhead`` models."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"kernel overhead is measured on a CUDA card, not {dev}")
    x = torch.zeros(1, device=dev)
    clock = _timer(dev)
    for _ in range(10):
        clock(x.zero_)
    times = sorted(clock(x.zero_) for _ in range(reps))
    return times[len(times) // 2]
