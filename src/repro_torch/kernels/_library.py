"""The port's kernels as ``torch.library`` operators (``torch.ops.repro_torch``).

``define`` registers one C entry as an operator: its schema, the real
implementation for CUDA tensors (which checks the pointers, launches and
counts the launch), a fake one for fake and meta tensors (empty outputs of
the right shapes and dtypes: what ``launch/dryrun.py`` runs) and a FLOP
formula for ``torch.utils.flop_counter``.  The operators are defined on a
``Library`` fragment rather than through ``torch.library.custom_op``, whose
Python wrappers around every call cost several times the dispatcher's own
few microseconds.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("repro_torch", "FRAGMENT")


def define(schema: str, real: Callable, fake: Callable, flops: Callable):
    """Register ``repro_torch::<schema>`` and return its ``OpOverload``.
    ``flops`` takes the operator's arguments with each tensor replaced by
    its shape."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, real, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    register_flop_formula(packet)(flops)
    return packet.default
