"""The port's spans (``repro_torch.spans``) on the CPU: the off path, the
tree a training step records, steps bit-identical with recording on and
off, and the clock, which must be the one ``torch.profiler``'s events
carry."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.api import make_batch
from repro_torch.models.layers import tree_leaves
from repro_torch.optim.optimizer import adafactor, constant_schedule, make_optimizer
from repro_torch.spans import recording, span
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step

TREE = {"train.step": {"train.forward": {}, "train.backward": {},
                       "train.optimizer": {"optim.clip": {}, "optim.update": {}}}}
CASES = [("rwkv6-1.6b", "adamw"), ("qwen2-1.5b", "adamw"), ("qwen2-1.5b", "adafactor")]


def _tiny(arch, optimizer="adamw", seed=0):
    """A reduced config's step, a fresh state and three batches, on the CPU."""
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    opt = make_optimizer(cfg) if optimizer == "adamw" else adafactor(constant_schedule(1e-3))
    state = init_state(api, opt, torch.Generator().manual_seed(seed), "cpu")
    batches = [make_batch(cfg, 2, 16, torch.Generator().manual_seed(seed + 1 + i), "cpu")
               for i in range(3)]
    return make_train_step(api, opt), state, batches


def _tree(recorded, parent=None):
    return {s.name: _tree(recorded, s.id) for s in recorded if s.parent == parent}


def test_off_returns_one_object_and_records_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("an unrecorded span took the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    first = span("train.step")
    assert span("train.forward") is first
    with first as inside:
        assert inside is None
    step, state, batches = _tiny("rwkv6-1.6b")
    step(state, batches[0])
    monkeypatch.undo()
    assert spans._active is None
    with recording() as recorded:
        pass
    assert recorded == []


@pytest.mark.parametrize("arch,optimizer", CASES)
def test_a_step_records_its_tree(arch, optimizer):
    step, state, batches = _tiny(arch, optimizer)
    with recording() as recorded:
        step(state, batches[0])
    assert _tree(recorded) == TREE
    assert {s.step for s in recorded} == {0}
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            outer = by_id[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
    phases = sorted((s for s in recorded if s.parent == recorded[-1].id),
                    key=lambda s: s.start_ns)
    assert [s.name for s in phases] == ["train.forward", "train.backward", "train.optimizer"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))


def test_steps_are_numbered_within_a_recording():
    step, state, batches = _tiny("qwen2-1.5b")
    with recording() as recorded:
        for b in batches:
            state, _ = step(state, b)
    steps = {s.id: s.step for s in recorded if s.name == spans.STEP}
    assert sorted(steps.values()) == [0, 1, 2]
    assert all(s.step == steps[s.parent] for s in recorded if s.parent in steps)


@pytest.mark.parametrize("arch,optimizer", CASES)
def test_recording_changes_no_bit(arch, optimizer):
    def three(record):
        step, state, batches = _tiny(arch, optimizer)
        losses = []
        with recording() if record else spans._OFF:
            for b in batches:
                state, metrics = step(state, b)
                losses.append(metrics["loss"])
        return torch.stack(losses), tree_leaves(state["params"])

    loss_off, params_off = three(False)
    loss_on, params_on = three(True)
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))


def test_a_span_ends_on_an_exception():
    with recording() as recorded:
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError
        with span("after"):
            pass
    assert [(s.name, s.parent) for s in recorded] == [("inner", recorded[1].id),
                                                      ("outer", None), ("after", None)]
    assert all(s.end_ns >= s.start_ns > 0 for s in recorded)


def _aten(prof):
    """(name, start_ns, end_ns) of every ``aten::`` event and autograd node
    the profiler recorded."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("aten::", "autograd::engine::evaluate_function"))]


def test_spans_share_the_profilers_clock():
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as recorded:
            torch.flip(x, (0,))
            time.sleep(0.002)
            with span("marked"):
                torch.cumsum(x, 0)
            time.sleep(0.002)
            torch.flip(x, (1,))
    (marked,) = recorded
    events = _aten(prof)
    inside = [(s, e) for n, s, e in events if n == "aten::cumsum"]
    outside = [(s, e) for n, s, e in events if n == "aten::flip"]
    assert inside and len(outside) == 2
    assert all(marked.start_ns <= s and e <= marked.end_ns for s, e in inside)
    assert all(e < marked.start_ns or s > marked.end_ns for s, e in outside)


def test_a_steps_operations_lie_inside_its_spans():
    """Every operation of a profiled step lies inside ``train.step``, and
    every autograd node, which autograd's own thread runs, inside
    ``train.backward``."""
    step, state, batches = _tiny("qwen2-1.5b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as recorded:
            step(state, batches[0])
    whole = {s.name: s for s in recorded}
    events = _aten(prof)
    nodes = [(s, e) for n, s, e in events if n.startswith("autograd::")]
    assert len(events) > 100 and nodes
    assert all(whole["train.step"].start_ns <= s and e <= whole["train.step"].end_ns
               for _, s, e in events)
    back = whole["train.backward"]
    assert all(back.start_ns <= s and e <= back.end_ns for s, e in nodes)
