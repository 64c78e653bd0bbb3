"""Dispatch wrappers over the port's kernels.

``attention``, ``ssd`` and ``wkv`` mirror ``repro/kernels/ops.py``: a CUDA
tensor launches the hand-written kernel (flash attention, the Mamba-2 SSD
scan, WKV-6; each with its backward under autograd), a CPU tensor takes
the kernel's plain PyTorch version.  There is no fallback from the card to
the plain path.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import wkv6 as _wkv


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def ssd(x, dt, A, Bm, Cm, init_state=None):
    """-> ``(y, final_state)``; unlike the reference's ``ssd`` it takes an
    initial state and returns the final one, as ``ssd_chunked`` does."""
    return _ssd.ssd(x, dt, A, Bm, Cm, init_state)


def wkv(r, k, v, w, u, init_state=None):
    """-> ``(o, final_state)``; unlike the reference's ``wkv`` it takes an
    initial state and returns the final one, as ``wkv6_chunked`` does."""
    return _wkv.wkv6(r, k, v, w, u, init_state)
