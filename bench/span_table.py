"""The port's spans (``repro_torch.spans``: ``train.step`` and inside it
``train.forward``, ``train.backward``, ``train.optimizer`` with
``optim.clip`` and ``optim.update``) read beside a device-only profile of
the same steps.

Two passes over a cell's steps, each of ``trace_steps`` steps issued as the
window issues them, with the program's recording on:

(a) without a profiler: the host's time in each span;
(b) under the device-only profiler of the harness's first traced pass:
    each device operation goes to the innermost span open when its launch
    was issued (the ``cuda_runtime`` event with the operation's
    correlation id; spans and profile share the clock ``time.time_ns()``),
    so the launches autograd's own thread issues during ``train.backward``
    go to that span by time; each idle gap of the device goes to the
    innermost span open at its start, or to ``outside train.step``.

For each span the table gives, per step, its self time (its duration less
its children's) in each pass, the device time and the number of the operations
launched while it was the innermost span open, that device time by
kernel class (``kernel_classes.json``) and the idle time named by it.
The quantities of the step's phases:

- ``forward_issue_ms``, ``backward_issue_ms``: the mean self time of
  ``train.forward`` and ``train.backward``, pass (a);
- ``optimizer_issue_ms``: the mean duration of ``train.optimizer``, pass (a);
- ``optimizer_device_ms``: device time per step of the operations launched
  inside ``train.optimizer``, pass (b);
- ``step_launches``: device operations launched inside ``train.step`` per
  step, pass (b) (a count; ``None`` if the steps' counts differ).

    python3 bench/span_table.py --workload <name> --seed <n> --seconds <s>

runs the cell's set-up and window as ``bench/run.py`` does, then both
passes, prints the table on stderr and one JSON line on stdout.  Needs the
port's ``repro_torch.spans``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench import program  # noqa: E402
from bench import trace as trace_lib  # noqa: E402
from bench.harness import SPEC, Files, _steps, batches, free, load_cell, setup  # noqa: E402

STEP = "train.step"
OUTSIDE = "outside train.step"


def recording():
    """The port's ``repro_torch.spans.recording()``."""
    if str(program.SRC) not in sys.path:
        sys.path.insert(0, str(program.SRC))
    from repro_torch.spans import recording as port_recording

    return port_recording()


def events(prof) -> list:
    """(name, device?, activity, start_ns, end_ns, correlation id) of every
    raw event of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == cuda
        out.append((e.name(), on_dev, trace_lib._activity(e, on_dev), e.start_ns(),
                    e.start_ns() + e.duration_ns(), e.correlation_id()))
    return out


class Spans:
    """Recorded spans (anything with ``name``, ``id``, ``parent``, ``step``,
    ``start_ns``, ``end_ns``), looked up by time."""

    def __init__(self, recorded):
        self.spans = sorted(recorded, key=lambda s: s.start_ns)
        self.starts = [s.start_ns for s in self.spans]
        self.by_id = {s.id: s for s in recorded}

    def at(self, t: int):
        """The innermost span open at ``t``: of the spans that cover it, the
        one that started last (spans nest), or ``None``."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if t < self.spans[i].end_ns:
                return self.spans[i]
        return None

    def within(self, s, name: str) -> bool:
        """Whether ``s`` is the span ``name`` or lies inside one."""
        while s is not None:
            if s.name == name:
                return True
            s = self.by_id.get(s.parent)
        return False

    def self_ns(self, s) -> int:
        kids = sum(c.end_ns - c.start_ns for c in self.spans if c.parent == s.id)
        return s.end_ns - s.start_ns - kids

    @property
    def steps(self) -> int:
        return sum(s.name == STEP for s in self.spans)


def host_times(recorded) -> Dict[str, Dict[str, float]]:
    """Per span name, the mean per step of its duration and of its self
    time, in milliseconds."""
    sp = Spans(recorded)
    n = max(sp.steps, 1)
    out: Dict[str, Dict[str, float]] = {}
    for s in sp.spans:
        row = out.setdefault(s.name, {"ms": 0.0, "self_ms": 0.0})
        row["ms"] += (s.end_ns - s.start_ns) * 1e-6 / n
        row["self_ms"] += sp.self_ns(s) * 1e-6 / n
    return out


@dataclass
class Row:
    self_ms: float = 0.0
    device_ms: float = 0.0
    launches: float = 0.0
    classes: Dict[str, float] = field(default_factory=dict)  # device ms by kernel class
    idle_ms: float = 0.0


@dataclass
class Reading:
    """Pass (b) read against its spans; every number per step but the
    totals."""

    steps: int
    rows: Dict[str, Row]  # by span name, and OUTSIDE
    device_s: float  # every device operation's time in the window
    in_step_s: float  # that of the operations launched inside a train.step span
    step_launches: List[int]  # operations launched inside each train.step, in step order
    optimizer_device_ms: float


def read(evs: list, recorded, w0: int = None, w1: int = None) -> Reading:
    """Attribute pass (b)'s device operations and idle gaps to its spans;
    the window ``[w0, w1]`` (host clock, ns) defaults to the first device
    operation's start and the last one's end."""
    sp = Spans(recorded)
    n = max(sp.steps, 1)
    launch = {c: s for _, on_dev, act, s, _, c in evs
              if not on_dev and act in trace_lib.RUNTIME}
    dev = sorted((s, e, name, c) for name, on_dev, act, s, e, c in evs
                 if on_dev and act not in trace_lib.ANNOTATIONS and e > s)
    if w0 is None:
        w0 = min((s for s, *_ in dev), default=0)
        w1 = max((e for _, e, *_ in dev), default=0)
    dev = [(max(s, w0), min(e, w1), name, c) for s, e, name, c in dev if e > w0 and s < w1]
    rows: Dict[str, Row] = {}
    for s in sp.spans:
        rows.setdefault(s.name, Row()).self_ms += sp.self_ns(s) * 1e-6 / n
    rows.setdefault(OUTSIDE, Row())
    per_step: Dict[int, int] = {s.step: 0 for s in sp.spans if s.name == STEP}
    in_step = opt = 0
    for s, e, name, c in dev:
        owner = sp.at(launch[c]) if c in launch else None
        row = rows[owner.name if owner is not None and owner.step is not None else OUTSIDE]
        ms = (e - s) * 1e-6
        row.device_ms += ms / n
        row.launches += 1 / n
        cls = trace_lib.kernel_class(name)
        row.classes[cls] = row.classes.get(cls, 0.0) + ms / n
        if owner is not None and owner.step is not None:
            in_step += e - s
            per_step[owner.step] += 1
            if sp.within(owner, "train.optimizer"):
                opt += e - s
    prev = w0
    for s, e, _, _ in dev + [(w1, w1, None, None)]:
        if s > prev:
            owner = sp.at(prev)
            rows[owner.name if owner is not None else OUTSIDE].idle_ms += (s - prev) * 1e-6 / n
        prev = max(prev, e)
    return Reading(steps=sp.steps, rows=rows, device_s=sum(e - s for s, e, *_ in dev) * 1e-9,
                   in_step_s=in_step * 1e-9, step_launches=[per_step[k] for k in sorted(per_step)],
                   optimizer_device_ms=opt * 1e-6 / n)


def quantities(host: Dict[str, Dict[str, float]], dev: Optional[Reading]) -> Dict[str, float]:
    """The step's phases' quantities; the device ones only where pass (b)
    saw device operations."""
    q = {"forward_issue_ms": host.get("train.forward", {}).get("self_ms"),
         "backward_issue_ms": host.get("train.backward", {}).get("self_ms"),
         "optimizer_issue_ms": host.get("train.optimizer", {}).get("ms")}
    if dev is not None and dev.device_s > 0:
        q["optimizer_device_ms"] = dev.optimizer_device_ms
        if len(set(dev.step_launches)) == 1:
            q["step_launches"] = dev.step_launches[0]
    return {k: v for k, v in q.items() if v is not None}


def table(host: Dict[str, Dict[str, float]], dev: Reading) -> str:
    """One line per span, per step: its self time in pass (a) and in pass
    (b) (under the profiler), then pass (b)'s device time, launches, device
    time by kernel class and idle time."""
    classes = sorted({c for r in dev.rows.values() for c in r.classes})
    head = (f"{'span':<20} {'self ms':>9} {'(b)':>9} {'device ms':>10} {'launches':>9} "
            + " ".join(f"{c:>11}" for c in classes) + f" {'idle ms':>9}")
    lines = [head]
    for name, r in dev.rows.items():
        lines.append(f"{name:<20} {host.get(name, {}).get('self_ms', 0.0):9.3f} "
                     f"{r.self_ms:9.3f} {r.device_ms:10.3f} {r.launches:9.1f} "
                     + " ".join(f"{r.classes.get(c, 0.0):11.3f}" for c in classes)
                     + f" {r.idle_ms:9.3f}")
    return "\n".join(lines)


def passes(step, state, batch, first: int, count: int, cuda: bool):
    """Passes (a) and (b) from batch ``first`` on, ``count`` steps each:
    ``(state, pass (a)'s spans and issue times, pass (b)'s events, spans,
    window (ns) and issue times)``."""
    from torch.profiler import ProfilerActivity, profile

    with recording() as spans_a:
        state, _, issue_a, _, _ = _steps(step, state, batch, first, count=count)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with recording() as spans_b:
            w0 = time.time_ns()
            state, _, issue_b, _, _ = _steps(step, state, batch, first + count, count=count)
            w1 = time.time_ns()
    return state, spans_a, issue_a, events(prof), spans_b, (w0, w1), issue_b


def run(workload: str, seed: int, seconds: float, device: str = "cuda", spec_path: Path = None,
        files=None, err=None) -> dict:
    """A cell's set-up, window and both passes: the JSON record."""
    err = err or sys.stderr
    spec = json.loads(Path(spec_path or SPEC).read_text())
    cell = load_cell(spec, workload, files or Files())
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    batch = batches(cell, seed, dev)
    step, state, _ = setup(cell, seed, dev)
    checked, n = cell.settings["checked_steps"], cell.settings["trace_steps"]
    state, times, issue, _, window_s = _steps(step, state, batch, checked, seconds=seconds)
    state, spans_a, issue_a, evs, spans_b, (w0, w1), issue_b = passes(
        step, state, batch, checked + len(times), n, cuda)
    del step, state
    free(dev)
    host = host_times(spans_a)
    dev_read = read(evs, spans_b, w0, w1)
    step_spans_s = sum(s.end_ns - s.start_ns for s in spans_a if s.name == STEP) * 1e-9
    mean = lambda xs: 1e3 * sum(xs) / len(xs)
    record = {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "window": {"steps": len(times), "seconds": window_s, "issue_ms": mean(issue),
                   "issue_ms_quartiles": [1e3 * q for q in statistics.quantiles(issue, n=4)]
                   if len(issue) > 1 else None},
        "pass_a": {"issue_ms": mean(issue_a), "issue_ms_each": [1e3 * x for x in issue_a],
                   "step_span_ms": 1e3 * step_spans_s / n,
                   "spans_over_issue": step_spans_s / sum(issue_a), "host": host},
        "pass_b": {"issue_ms": mean(issue_b), "device_s": dev_read.device_s,
                   "in_step_share": (dev_read.in_step_s / dev_read.device_s
                                     if dev_read.device_s > 0 else None),
                   "step_launches": dev_read.step_launches,
                   "rows": {k: vars(r) for k, r in dev_read.rows.items()}},
        "quantities": quantities(host, dev_read),
    }
    print(f"{workload} seed {seed}: window {len(times)} steps, issue {mean(issue):.3f} ms; "
          f"pass (a) issue {mean(issue_a):.3f} ms, train.step spans "
          f"{1e3 * step_spans_s / n:.3f} ms; pass (b) {dev_read.device_s:.4f} s of device time, "
          f"{100 * (record['pass_b']['in_step_share'] or 0):.2f}% launched inside train.step",
          file=err)
    print(table(host, dev_read), file=err)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
