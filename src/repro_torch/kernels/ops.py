"""Dispatch wrappers over the port's kernels.

``attention`` mirrors ``repro/kernels/ops.py::attention``: a CUDA tensor
launches the hand-written flash-attention kernel, a CPU tensor takes the
kernel's plain PyTorch version.  There is no fallback from the card to the
plain path.  ``ssd`` and ``wkv`` (the Mamba-2 and RWKV-6 kernels) are not
ported yet.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
