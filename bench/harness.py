"""One run of one cell: set-up, the timed window (or the traced steps),
the check against the plain reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the names ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``flops/<config>.py``, ``traffic/<traffic>.json``,
``cells/<workload>.json``, ``metrics/<metric>.py`` (``read(run) -> value or
None``) under this directory.

Set-up builds the port's training step and state from weights made from
the seed, and drives the step through the cell's ``checked_steps`` (the
window's own call and batches), reading after the first the first moment
AdamW holds (the first gradient as the optimizer got it) and after the
last each parameter's change.  Those steps compile and warm every shape
the window uses.  The window then issues steps as
``repro_torch.train.loop.train`` does (the next batch, ``step(state,
batch)``, ``float(loss)``) until ``--seconds`` have passed.  After it the
program's state is freed and the reference follows the checked steps in
float32 on the same device.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench import check, data, program
from bench import trace as trace_lib
from bench.reference.common import Precision, make_leaf
from bench.reference.train import follow, model_module

HERE = Path(__file__).resolve().parent
SPEC = HERE.parent / "BENCHMARK.json"
FOREIGN = ("jax", "jaxlib", "flax", "repro")  # top-level names the run may not load


class Files:
    """The benchmark's files of one kind, found by name, in ``dirs`` in turn."""

    def __init__(self, *dirs: Path):
        self.dirs = list(dirs) or [HERE]

    def path(self, kind: str, name: str, ext: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {[str(d) for d in self.dirs]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py``; for a metric ``<quantity>.<variant>`` (one
        quantity split over cells that report different end-to-end
        metrics) without a file of its own, the quantity's reader."""
        try:
            p = self.path(kind, name, ".py")
        except FileNotFoundError:
            if kind != "metrics" or "." not in name:
                raise
            p = self.path(kind, name.split(".", 1)[0], ".py")
        spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_")
                                                      .replace("-", "_"), p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict  # cells/<name>.json

    @property
    def tokens_per_step(self) -> int:
        return self.traffic["batch"] * self.traffic["seq"]


def load_cell(spec: dict, workload: str, files: Files) -> Cell:
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return Cell(workload, entry["chips"], files.json("configs", entry["config"]),
                files.json("traffic", entry["traffic"]), files.json("cells", workload))


def applicable(spec: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with ``workloads`` in its
    cells alone, a per-layer one without them wherever its ``moves`` is."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    step_s: List[float]  # issue to loss read, each step of the window
    issue_s: List[float]  # the step call alone, each step of the window (the traced
    # steps' are the trace's)
    model_flops_per_step: float
    peak_bytes: int
    trace: Optional[trace_lib.Trace] = None


def model_flops_per_step(cell: Cell, files: Files) -> float:
    """Three times the forward's model FLOPs (``flops/<config>.py``)."""
    fwd = files.module("flops", cell.config["name"]).forward_flops
    return 3.0 * fwd(cell.config["model"], cell.traffic["batch"], cell.traffic["seq"])


def foreign_modules() -> List[str]:
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)} & set(FOREIGN))


def _steps(step, state, batch, first: int, seconds: float = math.inf, count: int = 0):
    """Issue steps from batch ``first`` on, as the train loop does, until
    ``seconds`` have passed (``count`` steps, given one): ``(state, step
    times, issue times, losses, window seconds)``."""
    times, issue, losses = [], [], []
    i = first
    start = time.perf_counter()
    while True:
        b = batch(i)
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        t1 = time.perf_counter()
        losses.append(float(metrics["loss"]))
        t2 = time.perf_counter()
        times.append(t2 - t0)
        issue.append(t1 - t0)
        i += 1
        if (count and i - first >= count) or (not count and t2 - start >= seconds):
            break
    return state, times, issue, losses, t2 - start


def batches(cell: Cell, seed: int, dev):
    """Step ``i``'s batch of the cell's traffic for ``seed``."""
    vocab = cell.config["model"]["vocab_size"]
    return lambda i: data.train_batch(cell.traffic, vocab, seed, i, dev)


def setup(cell: Cell, seed: int, dev) -> tuple:
    """The port's step and state from the seed's weights, driven through
    the cell's checked steps: ``(step, state, readings)``, the readings
    each step's loss, each leaf's norm of the first gradient as AdamW got
    it (its first moment over ``1 - b1``) and of the parameters' change."""
    config = cell.config
    batch = batches(cell, seed, dev)
    clock = [("start", time.time())]
    specs = model_module(config).schema(config["model"])
    weights = {p: make_leaf(s, seed, p, dev) for p, s in specs.items()}
    clock.append(("weights", time.time()))
    step, state = program.build(config, weights)
    del weights
    clock.append(("build", time.time()))
    b1 = config["optimizer"]["b1"]
    prog = {"loss": [], "setup": clock}
    for i in range(cell.settings["checked_steps"]):
        state, metrics = step(state, batch(i))
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norm"] = {p: float(torch.linalg.vector_norm(m)) / (1 - b1)
                                 for p, m in program.first_moments(state).items()}
        clock.append((f"step {i + 1}", time.time()))
    with torch.no_grad():
        prog["change_norm"] = {
            p: float(torch.linalg.vector_norm(x - make_leaf(specs[p], seed, p, dev)))
            for p, x in program.parameters(state).items()}
    clock.append(("change", time.time()))
    return step, state, prog


def half_batch(b: dict) -> dict:
    """Half of the batch: its first half of the rows, or of the positions
    of a single row."""
    B, S = b["tokens"].shape
    return {k: (v[: B // 2] if B > 1 else v[:, : S // 2]) for k, v in b.items()}


def reference(cell: Cell, seed: int, dev, prec: str = "fp32", fault=None) -> dict:
    """The plain reference through the cell's checked steps, on the same
    weights and batches; ``fault`` transforms each batch first."""
    batch = batches(cell, seed, dev)
    bs = [batch(i) for i in range(cell.settings["checked_steps"])]
    return follow(cell.config, seed, [fault(b) if fault else b for b in bs], dev,
                  Precision(prec))


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
             spec_path: Path = SPEC, files: Files = None, t_start: float = None,
             out=None, err=None) -> int:
    """One run; prints the result line on ``out`` and returns the exit
    code (0 whenever a result was printed, ``correct`` or not)."""
    out, err = out or sys.stdout, err or sys.stderr
    t_start = time.time() if t_start is None else t_start
    files = files or Files()
    spec = json.loads(Path(spec_path).read_text())
    cell = load_cell(spec, workload, files)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{workload} needs {cell.chips} CUDA device(s); this machine has {n}",
                  file=err)
            return 3
        torch.cuda.set_device(0)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    settings = cell.settings
    checked = settings["checked_steps"]
    batch = batches(cell, seed, dev)
    t_setup = time.time()
    step, state, prog = setup(cell, seed, dev)
    sync()
    setup_s = time.time() - t_start
    clock = [("imports", t_setup)] + prog.pop("setup")[1:]
    phases = ", ".join(f"{n} {t - p:.2f}" for (n, t), p in
                       zip(clock, [t_start] + [t for _, t in clock[:-1]]))

    # the window; in a traced run then the traced steps
    state, times, issue, losses, window_s = _steps(step, state, batch, checked, seconds=seconds)
    tr = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        first = checked + len(times)
        dev_only = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        with profile(activities=dev_only) as prof:
            state, _, traced_issue, more, traced_s = _steps(
                step, state, batch, first, count=settings["trace_steps"])
        tr = trace_lib.read(prof, window_s=traced_s)
        tr.issue_s = traced_issue
        both = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=both) as prof:
            with record_function(trace_lib.WINDOW):
                state, *_, last, _ = _steps(step, state, batch, first + len(more),
                                            count=settings["label_steps"])
        tr.gaps = trace_lib.read(prof).gaps
        losses += more + last
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prog["nonfinite"] = sum(not math.isfinite(x) for x in prog["loss"] + losses)
    del step, state
    free(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # the check
    t_ref = time.time()
    ref = reference(cell, seed, dev)
    correct, table = check.judge(check.numbers(prog, ref), settings["limits"])
    where = check.worst_leaves(prog, ref)
    print(f"{workload} seed {seed}: set-up {setup_s:.2f} s ({phases}), window {window_s:.2f} s "
          f"({len(times)} steps), reference {time.time() - t_ref:.2f} s"
          + (f", reference peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
             if cuda else "")
          + f"; worst leaves {where}", file=err)

    foreign = foreign_modules()
    if foreign:
        print(f"the run loaded {foreign}: the benchmark runs the port alone", file=err)
        return 4

    run = Run(cell, setup_s, window_s, times, issue, model_flops_per_step(cell, files), peak, tr)
    metrics_out = {}
    for m in applicable(spec, workload, traced):
        value = files.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(losses),
        "failed": sum(not math.isfinite(x) for x in losses),
        "metrics": metrics_out,
        "device": device_record(dev, cell.chips, peak, tr),
    }
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": [[n, s] for n, s in tr.gaps]}
    result["checks"] = table
    for name, row in table.items():
        verdict = "ok" if row["value"] <= row["limit"] else "FAILED"
        print(f"check {name} {row['value']!r} limit {row['limit']!r} {verdict}", file=err)
    err.flush()
    print(json.dumps(_finite_json(result)), file=out)
    out.flush()
    return 0


def device_record(dev: torch.device, chips: int, peak: int, tr) -> Dict[str, object]:
    if dev.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if tr is not None:
        rec["busy_s"] = tr.busy_s
        rec["window_s"] = tr.window_s
    return rec


def _finite_json(x):
    """Infinite readings as the largest float, which strict JSON can carry."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1.7976931348623157e308
    if isinstance(x, dict):
        return {k: _finite_json(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite_json(v) for v in x]
    return x
