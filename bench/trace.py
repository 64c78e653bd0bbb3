"""Reading a ``torch.profiler`` trace of the timed steps: the device's
operations (kernels, copies, fills) by name and class, the union of their
intervals (the time the device was busy), and the idle gaps, each named by
the host operation that was running when it began.

Two traces serve a run: one of the device alone over the timed steps
(busy and idle time, time by kernel: the host's own events stay out of it,
since recording them slows the host several-fold where the host sets the
pace), whose window is the host clock's; and one of host and device over a
step or two, whose window is the span of the benchmark's ``bench.window``
annotation, for the idle gaps and what the host was doing in each.
Events are read from the profiler's raw event list, not from
``key_averages``, which a full training step's tens of thousands of host
events make slow.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

WINDOW = "bench.window"
ANNOTATIONS = ("gpu_user_annotation", "user_annotation")  # spans, not device work
RUNTIME = ("cuda_runtime", "cuda_driver")  # launches: named by the operator around them
RULES = json.loads((Path(__file__).resolve().parent / "kernel_classes.json").read_text())


def kernel_class(name: str) -> str:
    for cls, keys in RULES["classes"]:
        if any(k in name for k in keys):
            return cls
    return RULES["otherwise"]


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list, at most 160
    characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i][:160]
    return name[:160]


@dataclass
class Trace:
    ops: List[Tuple[str, float]]  # (device operation's name, seconds), in start order
    busy_s: float  # union of the operations' intervals within the window
    window_s: float
    gaps: List[Tuple[str, float]]  # (host operation, idle seconds), longest first
    by_class: Dict[str, float] = field(default_factory=dict)
    issue_s: List[float] = field(default_factory=list)  # the traced steps' step calls

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for name, s in self.ops:
            key = short_name(name)
            total[key] = total.get(key, 0.0) + s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _activity(e, on_dev: bool) -> str:
    """The kind of a raw event (``activity_type`` where the release has it)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if name == WINDOW or (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
        return "gpu_user_annotation" if on_dev else "user_annotation"
    if on_dev:
        return "kernel"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) and "::" not in name else "cpu_op"


def _events(prof):
    """(name, device?, activity, start_ns, end_ns) of every event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == cuda
        yield (e.name(), on_dev, _activity(e, on_dev), e.start_ns(),
               e.start_ns() + e.duration_ns())


def read(prof, window_s: float = None, gaps: int = 10) -> Trace:
    """The trace's device operations within its window: the
    ``bench.window`` annotation's span, or, given ``window_s`` (a trace of
    the device alone), every operation, the window ``window_s`` long."""
    dev, host = [], []
    w0 = w1 = None
    for name, on_dev, act, s, e in _events(prof):
        if on_dev:
            if act not in ANNOTATIONS and e > s:
                dev.append((s, e, name))
        elif name == WINDOW:
            w0, w1 = s, e
        elif act not in RUNTIME:
            host.append((s, e, name))
    if window_s is not None:
        w0 = min((s for s, _, _ in dev), default=0)
        w1 = max(max((e for _, e, _ in dev), default=0), w0 + int(window_s * 1e9))
    elif w0 is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} annotation")
    dev = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1)
    busy, spans, cur = 0, [], None
    for s, e, _ in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                spans.append(cur)
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        spans.append(cur)
    busy = sum(e - s for s, e in spans)
    idle, prev = [], w0
    for s, e in spans + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:gaps]
    by_class: Dict[str, float] = {}
    for s, e, n in dev:
        c = kernel_class(n)
        by_class[c] = by_class.get(c, 0.0) + (e - s) * 1e-9
    return Trace(ops=[(n, (e - s) * 1e-9) for s, e, n in dev], busy_s=busy * 1e-9,
                 window_s=(w1 - w0) * 1e-9 if window_s is None else window_s,
                 gaps=[(_host_at(host, g0), (g1 - g0) * 1e-9) for g0, g1 in idle],
                 by_class=by_class)


def _host_at(host, t) -> str:
    """The innermost host operation running at ``t`` (the shortest that
    covers it), or ``idle host``."""
    best = None
    for s, e, name in host:
        if s <= t < e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "idle host"
