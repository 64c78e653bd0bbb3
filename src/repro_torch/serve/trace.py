"""Request-arrival traces for the serving benchmark.

A serving trace is a seeded, replayable stream of requests: Poisson
arrivals at a base QPS, each with a prompt length and a decode budget.
Prompt *token ids* are not stored — they are re-derived deterministically
from ``(seed, request id)`` at load time, so the committed JSON stays tiny
while replays are bit-identical.  ``load_requests`` can rescale the
arrival process to a different QPS (the benchmark sweeps load by replaying
one committed trace at increasing QPS), which preserves the arrival
*pattern* while compressing or stretching the timeline.

JSON schema (see ``benchmarks/traces/README.md``):

    {"name": "...", "seed": 7, "qps": 20.0, "vocab_size": 512,
     "requests": [{"id": 0, "t": 0.031, "prompt_len": 6, "max_new": 8}, ...]}
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request


@dataclass
class RequestTrace:
    name: str
    seed: int
    qps: float
    vocab_size: int
    requests: List[dict] = field(default_factory=list)  # schema rows

    def to_json(self) -> dict:
        return {
            "name": self.name, "seed": self.seed, "qps": self.qps,
            "vocab_size": self.vocab_size, "requests": self.requests,
        }


def generate_request_trace(
    n_requests: int, *, seed: int = 7, qps: float = 20.0,
    vocab_size: int = 512,
    prompt_len: Tuple[int, int] = (4, 12),
    max_new: Tuple[int, int] = (4, 12),
    name: str = "requests",
) -> RequestTrace:
    """Seeded trace: exponential inter-arrivals at ``qps``, uniform prompt
    lengths and decode budgets."""
    rng = np.random.default_rng(seed)
    t = 0.0
    rows = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / qps))
        rows.append({
            "id": i,
            "t": round(t, 6),
            "prompt_len": int(rng.integers(prompt_len[0], prompt_len[1] + 1)),
            "max_new": int(rng.integers(max_new[0], max_new[1] + 1)),
        })
    return RequestTrace(name=name, seed=seed, qps=qps,
                        vocab_size=vocab_size, requests=rows)


def save_request_trace(trace: RequestTrace, path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace.to_json(), f, indent=1)
        f.write("\n")


def load_request_trace(path: str) -> RequestTrace:
    with open(path) as f:
        d = json.load(f)
    return RequestTrace(name=d["name"], seed=int(d["seed"]),
                        qps=float(d["qps"]), vocab_size=int(d["vocab_size"]),
                        requests=list(d["requests"]))


def _prompt_for(trace: RequestTrace, rid: int, length: int,
                vocab_size: int) -> np.ndarray:
    """Deterministic prompt ids from (trace seed, request id)."""
    rng = np.random.default_rng((trace.seed, rid))
    return rng.integers(0, vocab_size, (length,), dtype=np.int32)


def materialize_requests(
    trace: RequestTrace, *, qps: Optional[float] = None,
    vocab_size: Optional[int] = None,
    eos_id: Optional[int] = None,
) -> List[Request]:
    """Turn a trace into scheduler ``Request``s.

    ``qps`` rescales the arrival timeline (same pattern, different load);
    ``vocab_size`` overrides the trace's vocab (prompts must stay inside
    the serving model's vocab).
    """
    scale = trace.qps / qps if qps else 1.0
    V = vocab_size if vocab_size is not None else trace.vocab_size
    return [
        Request(
            rid=r["id"],
            prompt=_prompt_for(trace, r["id"], r["prompt_len"], V),
            max_new_tokens=r["max_new"],
            arrival=r["t"] * scale,
            eos_id=eos_id,
        )
        for r in trace.requests
    ]


def load_requests(path: str, *, qps: Optional[float] = None,
                  vocab_size: Optional[int] = None,
                  eos_id: Optional[int] = None) -> List[Request]:
    return materialize_requests(load_request_trace(path), qps=qps,
                                vocab_size=vocab_size, eos_id=eos_id)
