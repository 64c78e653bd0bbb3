"""Device selection shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: with no
explicit ``device`` they take ``"cuda"``, and they raise when there is no
card.  They never fall back to the CPU on their own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"``/``"float32"``/... (the configs' spelling) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out
