"""Operation and byte counts of the port's hand-written kernels, and the
card's peaks: the yardstick the roofline and utilisation metrics divide by.

The FLOP formulas are frozen copies of those the kernel modules register
for ``torch.utils.flop_counter`` (``repro_torch/kernels/wkv6.py``'s
``chunk_flops``, ``repro_torch/kernels/flash_attention.py``'s
``attention_pairs``, ``flops_fwd`` and ``flops_bwd``), so a later change to
the program cannot move the yardstick; ``bench/tests/test_bench_counts.py``
holds the copies to the originals.  The byte counts take each input read
once and each output written once, whatever a kernel reads again.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

WKV_KCHUNK = 64  # the bf16 WKV-6 kernels' chunk (csrc/wkv6.cu: L)


def peak_flops(dtype: str = "bfloat16") -> float:
    return float(PEAKS["flops_per_s"][dtype])


def peak_bytes_per_s() -> float:
    return float(PEAKS["bytes_per_s"])


def least_seconds(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops(dtype), nbytes / peak_bytes_per_s())


# --- WKV-6 (bf16 chunked kernels) ------------------------------------------


def wkv6_chunk_flops(B: int, S: int, H: int, N: int, backward: bool = False) -> int:
    """Frozen copy of ``wkv6.chunk_flops``: forward ``4 L N^2 + 2 L^2 N`` a
    chunk, backward ``10 L N^2 + 2 L^2 N``, taken per step."""
    L = WKV_KCHUNK
    return B * H * S * ((10 if backward else 4) * N * N + 2 * L * N)


def wkv6_bytes(B: int, S: int, H: int, N: int) -> tuple:
    """(forward, backward) bytes of the bf16 WKV-6 kernels: r, k, v, w in
    and o out (bf16), u (fp32) and the final state (fp32) forward; r, k, v,
    w, do in and dr, dk, dv, dw out, u and du backward.  A copy of
    ``chip_smoke._wkv_bytes``."""
    elem = 2 * B * S * H * N
    fwd = 5 * elem + 4 * H * N + 4 * B * H * N * N
    bwd = 9 * elem + 2 * 4 * H * N
    return fwd, bwd


# --- flash attention (bf16 Hopper kernels) ---------------------------------


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """Frozen copy of ``flash_attention.attention_pairs``: the live (query,
    key) pairs."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full_like(i, Skv)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.clip(hi - lo, 0, None).sum())


def flash_flops(B: int, Sq: int, Skv: int, H: int, d: int, causal: bool, window: int,
                backward: bool = False) -> int:
    """Frozen copies of ``flash_attention.flops_fwd`` (Q K^T and P V over
    the live pairs) and ``flops_bwd`` (five products, 2.5 times that)."""
    return (10 if backward else 4) * B * H * d * attention_pairs(Sq, Skv, causal, window)


def flash_bytes(B: int, Sq: int, Skv: int, H: int, KV: int, d: int) -> tuple:
    """(forward, backward) bytes of the bf16 flash kernels: q, k, v in, o
    and the rows' log-sum-exp (fp32) out forward; q, k, v, o, dO and the
    log-sum-exp in, dq, dk, dv out backward."""
    q = 2 * B * Sq * H * d
    kv = 2 * B * Skv * KV * d
    lse = 4 * B * H * Sq
    fwd = q + 2 * kv + q + lse
    bwd = 3 * q + 2 * kv + lse + q + 2 * kv
    return fwd, bwd
