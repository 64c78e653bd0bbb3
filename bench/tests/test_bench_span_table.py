"""The span table (``bench/span_table.py``): its reading of a hand-built
profile against hand-built spans, the two passes over the test cells on the
CPU, and on the card a reduced qwen2 step whose every launch lies inside
its ``train.step`` span."""
import io
import json
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from bench import harness, span_table
from bench.span_table import OUTSIDE

BENCH = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures"
Span = namedtuple("Span", "name id parent step start_ns end_ns")
US = 1000  # ns


def _step(k: int, at: int, extra: bool = False):
    """Step ``k``'s spans and events, ``at`` microseconds on: forward,
    backward, the optimizer's clip and update, a launch in the step's own
    time and a loss read after it."""
    o, i = at * US, 10 * k
    spans = [Span("train.step", i, None, k, o + 100 * US, o + 1000 * US),
             Span("train.forward", i + 1, i, k, o + 110 * US, o + 300 * US),
             Span("train.backward", i + 2, i, k, o + 300 * US, o + 700 * US),
             Span("train.optimizer", i + 3, i, k, o + 700 * US, o + 950 * US),
             Span("optim.clip", i + 4, i + 3, k, o + 700 * US, o + 750 * US),
             Span("optim.update", i + 5, i + 3, k, o + 760 * US, o + 940 * US)]
    ops = [  # (launch, device start, device end, name)
        (150, 200, 260, "nvjet_tst_256x128"), (400, 400, 600, "elementwise_kernel"),
        (720, 720, 730, "Memset (Device)"), (800, 800, 900, "vectorized_elementwise_kernel"),
        (960, 960, 980, "wkv6_chunk_out_kernel"), (1050, 1050, 1060, "Memcpy DtoH")]
    if extra:
        ops.append((810, 900, 905, "vectorized_elementwise_kernel"))
    events = [("cudaGetDevice", False, "cuda_runtime", o + 500 * US, o + 501 * US, 1000 * k + 99),
              ("bench.window", True, "gpu_user_annotation", o + 100 * US, o + 1000 * US, 0)]
    for j, (t, s, e, name) in enumerate(ops):
        c = 1000 * k + j
        events.append(("cudaLaunchKernel", False, "cuda_runtime", o + t * US, o + t * US + 5, c))
        events.append((name, True, "kernel", o + s * US, o + e * US, c))
    return spans, events


def test_the_reading_of_one_step():
    spans, events = _step(0, 0)
    r = span_table.read(events, spans, 100 * US, 1100 * US)
    want = {  # self ms, device ms, launches, {class: device ms}, idle ms
        "train.step": (0.06, 0.02, 1, {"handwritten": 0.02}, 0.1 + 0.07),
        "train.forward": (0.19, 0.06, 1, {"gemm": 0.06}, 0.14),
        "train.backward": (0.4, 0.2, 1, {"elementwise": 0.2}, 0.12),
        "train.optimizer": (0.02, 0.0, 0, {}, 0.0),
        "optim.clip": (0.05, 0.01, 1, {"copy": 0.01}, 0.07),
        "optim.update": (0.18, 0.1, 1, {"elementwise": 0.1}, 0.06),
        OUTSIDE: (0.0, 0.01, 1, {"copy": 0.01}, 0.04),
    }
    assert list(r.rows) == list(want)
    for name, (self_ms, dev_ms, launches, classes, idle) in want.items():
        row = r.rows[name]
        assert row.self_ms == pytest.approx(self_ms), name
        assert row.device_ms == pytest.approx(dev_ms), name
        assert row.launches == launches, name
        assert row.classes == pytest.approx(classes), name
        assert row.idle_ms == pytest.approx(idle), name
    assert r.steps == 1 and r.step_launches == [5]
    assert r.device_s == pytest.approx(400e-6) and r.in_step_s == pytest.approx(390e-6)
    assert r.optimizer_device_ms == pytest.approx(0.11)
    host = span_table.host_times(spans)
    assert host["train.optimizer"] == pytest.approx({"ms": 0.25, "self_ms": 0.02})
    assert span_table.quantities(host, r) == pytest.approx({
        "forward_issue_ms": 0.19, "backward_issue_ms": 0.4, "optimizer_issue_ms": 0.25,
        "optimizer_device_ms": 0.11, "step_launches": 5})


@pytest.mark.parametrize("extra", [False, True])
def test_three_steps_read_per_step(extra):
    spans, events = [], []
    for k in range(3):
        s, e = _step(k, 2000 * k, extra=extra and k == 2)
        spans += s
        events += e
    r = span_table.read(events, spans)
    assert r.steps == 3 and r.step_launches == [5, 5, 6 if extra else 5]
    assert r.rows["train.forward"].device_ms == pytest.approx(0.06)
    assert r.rows["train.forward"].launches == pytest.approx(1)
    q = span_table.quantities(span_table.host_times(spans), r)
    assert ("step_launches" in q) is not extra
    assert q["forward_issue_ms"] == pytest.approx(0.19)


def test_spans_lookup_takes_the_innermost():
    spans, _ = _step(0, 0)
    sp = span_table.Spans(spans)
    assert sp.at(720 * US).name == "optim.clip"
    assert sp.at(755 * US).name == "train.optimizer"
    assert sp.at(990 * US).name == "train.step"
    assert sp.at(50 * US) is None and sp.at(1000 * US) is None
    assert sp.within(sp.at(800 * US), "train.optimizer")
    assert not sp.within(sp.at(400 * US), "train.optimizer")


@pytest.mark.parametrize("workload", ["tiny-rwkv6.train-b2s32", "tiny-qwen2.train-b2s32"])
def test_both_passes_on_the_cpu(workload):
    """The CPU runs no device operation: the host quantities are read, the
    device ones are absent."""
    err = io.StringIO()
    rec = span_table.run(workload, 2 ** 31 + 77, 0.3, device="cpu",
                         spec_path=FIXTURES / "BENCHMARK.json",
                         files=harness.Files(FIXTURES, BENCH), err=err)
    json.dumps(rec)
    assert set(rec["quantities"]) == {"forward_issue_ms", "backward_issue_ms",
                                      "optimizer_issue_ms"}
    a = rec["pass_a"]
    assert 0 < a["spans_over_issue"] <= 1
    assert set(a["host"]) == {"train.step", "train.forward", "train.backward",
                              "train.optimizer", "optim.clip", "optim.update"}
    assert rec["pass_b"]["in_step_share"] is None
    assert "train.forward" in err.getvalue()


@pytest.mark.chip
def test_every_launch_of_a_step_lies_inside_its_span(chip):
    """A reduced qwen2 step under the device-only profiler, its batches
    made before: every launch of a device operation lies inside a
    ``train.step`` span, and at least 98% of the device time goes to one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.api import make_batch
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step

    cfg = get_config("qwen2-1.5b").reduced()
    api, opt = get_model(cfg), make_optimizer(cfg)
    state = init_state(api, opt, torch.Generator(device=chip).manual_seed(0), chip)
    batches = [make_batch(cfg, 2, 128, torch.Generator(device=chip).manual_seed(i + 1), chip)
               for i in range(4)]
    step = make_train_step(api, opt)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with span_table.recording() as recorded:
            for b in batches[1:]:
                state, _ = step(state, b)
            torch.cuda.synchronize()
    evs = span_table.events(prof)
    sp = span_table.Spans(recorded)
    ops = {c for _, on_dev, act, s, e, c in evs
           if on_dev and act not in span_table.trace_lib.ANNOTATIONS and e > s}
    launches = [s for _, on_dev, act, s, _, c in evs
                if not on_dev and act in span_table.trace_lib.RUNTIME and c in ops]
    assert launches and sp.steps == 3
    assert all(sp.within(sp.at(t), "train.step") for t in launches)
    r = span_table.read(evs, recorded)
    assert r.in_step_s >= 0.98 * r.device_s > 0
    assert len(set(r.step_launches)) == 1 and r.optimizer_device_ms > 0
