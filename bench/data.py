"""The one traffic generator: a training batch drawn from the seed, on the
device, by the parameters of a traffic file.

Token ids follow a skewed unigram law, ``id = min(floor(u^exponent * V),
V - 1)`` for ``u`` uniform on ``[0, 1)`` (``exponent`` 3 gives ``p(i)``
proportional to ``i^(-2/3)``: a copy of the port's synthetic data law,
``data/pipeline._skewed_tokens``), and each label is the next token of its
row (the last wraps to the first).  Every step of a seed draws its own
batch from a generator of its own, so any step's batch can be made again.
"""
from __future__ import annotations

import torch

from bench.reference.common import sub_seed


def train_batch(traffic: dict, vocab: int, seed: int, step: int, device) -> dict:
    B, S = traffic["batch"], traffic["seq"]
    law = traffic["tokens"]
    if law["law"] != "power":
        raise ValueError(f"token law {law['law']!r}: only 'power' is known")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "batch", step))
    u = torch.rand((B, S), generator=g, device=device, dtype=torch.float64)
    tokens = torch.clamp((u ** law["exponent"] * vocab).long(), max=vocab - 1)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
