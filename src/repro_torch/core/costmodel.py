"""Hardware + cost model (paper §4.1), for NVIDIA cards.

The port of ``repro/core/costmodel.py``.  The paper profiles comp(i,g) on
A100s and models comm as payload/bandwidth + propagation delay over
NVSwitch; the same three cost terms are kept here:

  comp(i,g)              fwd+bwd compute time of layer i at scale g
  comm((i,g) -> (j,h))   activation/grad resharding when scale changes
  sync(i,g)              ring all-reduce of layer i's gradients at scale g

``Hardware()`` is an H100 SXM5 node (``H100``); ``A100`` is the paper's
card, as in the reference.  The reference's TPU entry is not carried over:
tests that hold the two packages to each other pass its fields in.
``kernel_overhead`` is the per-op launch cost (whose elimination via CUDA
graphs the paper measures).

Efficiency model: a device processing u = parallel_units/g independent work
units runs at eff = u/(u+1) of peak (≈50% at one unit — matches the paper's
Fig 4 utilization collapse at small per-GPU batches) with a hard cap of
min(g, parallel_units) useful devices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.models.graph import LayerNode


@dataclass(frozen=True)
class Hardware:
    """Defaults: one H100 SXM5 in an 8-card NVSwitch node."""

    name: str = "h100-sxm5"
    # 989.4 TFLOP/s dense bf16 tensor-core peak: NVIDIA H100 Tensor Core
    # GPU datasheet, SXM5 column (1979 with sparsity)
    peak_flops: float = 989.4e12
    hbm_bw: float = 3.35e12  # HBM3, same datasheet, SXM5 column
    # NVLink 4 over NVSwitch: 900 GB/s per card both ways (same datasheet)
    # -> 450 GB/s each way
    link_bw: float = 450.0e9
    links_per_chip: int = 1
    prop_delay: float = 2.0e-6  # the A100/NVSwitch entry's; not measured
    # one 400 Gb/s ConnectX-7 NIC per card (NVIDIA DGX H100 datasheet)
    dcn_bw: float = 50.0e9
    # median CUDA-event time around one launch of a one-element PyTorch
    # kernel, the host's dispatch of an eager op included, measured by
    # ``profiler.measure_kernel_overhead`` (chip_smoke.py, phase 2b) on an
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit
    kernel_overhead: float = 19.07e-6

    @property
    def chip_bw(self) -> float:
        return self.link_bw * self.links_per_chip


H100 = Hardware()

# A100 + NVSwitch variant used by the paper-fidelity benchmarks (Fig 1/3);
# every field the reference's A100 entry has.
A100 = Hardware(
    name="a100-nvswitch",
    peak_flops=312.0e12,  # bf16 tensor core
    hbm_bw=2.0e12,
    link_bw=300.0e9,  # NVSwitch 600 GB/s bidirectional → 300 each way
    links_per_chip=1,
    prop_delay=2.0e-6,
    dcn_bw=25.0e9,
    kernel_overhead=5.0e-6,
)


def efficiency(units_per_device: float) -> float:
    """MXU/SM utilization vs per-device independent work units."""
    u = max(units_per_device, 1e-9)
    return u / (u + 1.0)


def comp_time(node: LayerNode, g: int, hw: Hardware, bwd: bool = True) -> float:
    """fwd(+bwd) seconds for `node` when strong-scaled to g devices."""
    g_eff = min(g, max(node.parallel_units, 1))
    mult = 1.0 + (node.bwd_mult if bwd else 0.0)
    flops = node.flops * mult / g_eff
    eff = efficiency(node.parallel_units / g_eff)
    t_flops = flops / (hw.peak_flops * eff)
    bytes_hbm = (node.param_bytes + 2.0 * node.act_out_bytes / g_eff) * (
        1.5 if bwd else 1.0
    )
    t_mem = bytes_hbm / hw.hbm_bw
    t_seq = node.seq_flops * mult / hw.peak_flops  # not divisible
    passes = 2 if bwd else 1
    return max(t_flops, t_mem) + t_seq + passes * hw.kernel_overhead


def comm_time(act_bytes: float, g: int, h: int, hw: Hardware) -> float:
    """Activation (and, in bwd, gradient) resharding when scale changes g→h.

    Paper §4.1: payload / bandwidth + propagation delay.  Payload per device
    is bounded by the smaller group, which must redistribute everything it
    holds beyond what it keeps."""
    if g == h:
        return 0.0
    lo, hi = min(g, h), max(g, h)
    payload_per_dev = act_bytes * (1.0 / lo - 1.0 / hi)
    t = payload_per_dev / hw.chip_bw + hw.prop_delay
    return 2.0 * t  # fwd activations + bwd gradients


def sync_time(param_bytes: float, g: int, hw: Hardware) -> float:
    """Ring all-reduce of gradients across g data-parallel replicas
    (not overlapped with backward, per the paper)."""
    if g <= 1:
        return 0.0
    t = 2.0 * (g - 1) / g * param_bytes / hw.chip_bw
    return t + hw.prop_delay * math.log2(g)


def allreduce_time(bytes_total: float, n: int, hw: Hardware, bw: float = 0.0) -> float:
    """Generic ring all-reduce estimate (used by roofline + multi-pod model)."""
    if n <= 1:
        return 0.0
    bw = bw or hw.chip_bw
    return 2.0 * (n - 1) / n * bytes_total / bw + hw.prop_delay * math.log2(n)


# ---------------------------------------------------------------------------
# Batched cost evaluation over scale vectors (vectorized planner hot path).
#
# Each *_batch function evaluates the scalar formula above elementwise in
# float64, in the same operation order, so values are bit-identical to the
# scalar path — a requirement of the differential test harness
# (tests/test_planner_diff.py), which pins vectorized == reference exactly.
# ---------------------------------------------------------------------------


def comp_time_batch(node: LayerNode, scales, hw: Hardware, bwd: bool = True) -> np.ndarray:
    """``comp_time`` evaluated at a vector of scales; returns float64 array."""
    g = np.asarray(scales, dtype=np.float64)
    g_eff = np.minimum(g, float(max(node.parallel_units, 1)))
    mult = 1.0 + (node.bwd_mult if bwd else 0.0)
    flops = node.flops * mult / g_eff
    u = np.maximum(node.parallel_units / g_eff, 1e-9)
    eff = u / (u + 1.0)
    t_flops = flops / (hw.peak_flops * eff)
    bytes_hbm = (node.param_bytes + 2.0 * node.act_out_bytes / g_eff) * (
        1.5 if bwd else 1.0
    )
    t_mem = bytes_hbm / hw.hbm_bw
    t_seq = node.seq_flops * mult / hw.peak_flops
    passes = 2 if bwd else 1
    return np.maximum(t_flops, t_mem) + t_seq + passes * hw.kernel_overhead


def sync_time_batch(param_bytes: float, scales, hw: Hardware) -> np.ndarray:
    """``sync_time`` evaluated at a vector of replica counts.

    Scales are powers of two, so ``log2`` is exact and matches math.log2.
    """
    g = np.asarray(scales, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = 2.0 * (g - 1.0) / g * param_bytes / hw.chip_bw
        out = t + hw.prop_delay * np.log2(g)
    return np.where(g <= 1.0, 0.0, out)


def comm_matrix(act_bytes: float, src_scales, dst_scales, hw: Hardware) -> np.ndarray:
    """``comm_time`` for every (src, dst) pair: the planner's per-edge S×S
    transition-cost matrix, indexed [src][dst]."""
    g = np.asarray(src_scales, dtype=np.float64)[:, None]
    h = np.asarray(dst_scales, dtype=np.float64)[None, :]
    lo = np.minimum(g, h)
    hi = np.maximum(g, h)
    payload_per_dev = act_bytes * (1.0 / lo - 1.0 / hi)
    t = payload_per_dev / hw.chip_bw + hw.prop_delay
    return np.where(g == h, 0.0, 2.0 * t)
