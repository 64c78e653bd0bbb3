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


_streams: list = []  # every stream made by priority_stream; see there


def priority_stream(device: torch.device, urgent: bool):
    """A CUDA stream of its own on ``device`` (``None`` on the CPU): of the
    greatest priority in ``torch.cuda.Stream.priority_range()`` when
    ``urgent``, else of the least, which is CUDA's default.  Work on the
    default stream has that least priority too, so a foreground meant to
    win the card must leave it.

    The stream is made by ``kernels/csrc/streams.cu``
    (``cudaStreamCreateWithPriority``) and wrapped in
    ``torch.cuda.ExternalStream``: ``torch.cuda.Stream`` draws from a fixed
    pool of 32 streams per priority in turn, so its 33rd stream is its
    first again and two live slices would share one without a sign.  A
    stream made here is never destroyed, since the caching allocator may
    still hold blocks recorded on it."""
    if device.type != "cuda":
        return None
    import ctypes

    from repro_torch.kernels import _build

    index = torch.cuda.current_device() if device.index is None else device.index
    least, greatest = torch.cuda.Stream.priority_range()
    handle = ctypes.c_void_p()
    rc = _build.load("streams").stream_create(index, greatest if urgent else least,
                                               ctypes.byref(handle))
    if rc != 0:
        raise RuntimeError(f"cudaStreamCreateWithPriority on cuda:{index} failed "
                           f"with cudaError {rc}")
    stream = torch.cuda.ExternalStream(handle.value, device=torch.device("cuda", index))
    _streams.append(stream)
    return stream


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
