"""The comparison that decides ``correct``, and the plain references held
to the port's own float32 path on the CPU: the same equations, so only
the precision may part them on the card."""
import json
import math
from pathlib import Path

import pytest
import torch

from bench import check, harness
from bench.reference.common import AdamW, cosine_lr

FIXTURES = Path(__file__).resolve().parent / "fixtures"
LIMITS = {"loss_gap": 1e-3, "grad_norm_gap": 0.05, "change_norm_gap": 0.05,
          "nonfinite_losses": 0}


def _readings(scale=1.0, nonfinite=0):
    grads = {"a": 1.0, "b": 2.0, "c": 3.0, "quiet": 1e-9}
    return {"loss": [10.0 * scale, 9.9, 9.8], "grad_norm": {k: v * scale for k, v in grads.items()},
            "change_norm": {"a": 0.1, "b": 0.2, "c": 0.3, "quiet": 0.3 * scale},
            "nonfinite": nonfinite}


def test_equal_readings_are_correct():
    ok, table = check.judge(check.numbers(_readings(), _readings()), LIMITS)
    assert ok and all(row["value"] == 0 for row in table.values())


def test_each_number_fails_its_limit():
    ref = _readings()
    prog = _readings(scale=1.01)
    values = check.numbers(prog, ref)
    assert values["loss_gap"] == pytest.approx(0.01)
    assert values["grad_norm_gap"] == pytest.approx(0.01)
    assert check.judge(values, LIMITS)[0] is False
    assert check.judge(check.numbers(_readings(nonfinite=1), ref), LIMITS)[0] is False


def test_a_quiet_leaf_moves_by_round_off_and_is_left_out_of_the_change():
    ref = _readings()
    prog = _readings()
    prog["change_norm"]["quiet"] = 100.0
    assert check.numbers(prog, ref)["change_norm_gap"] == 0.0


def test_a_nan_is_never_correct():
    ref = _readings()
    for key in ("grad_norm", "change_norm"):
        prog = _readings()
        prog[key]["b"] = math.nan
        assert check.judge(check.numbers(prog, ref), LIMITS)[0] is False
    prog = _readings()
    prog["loss"][1] = math.nan
    assert math.isinf(check.numbers(prog, ref)["loss_gap"])


def test_the_schedule_is_the_ports():
    from repro_torch.optim.optimizer import cosine_schedule

    opt = json.loads((Path(harness.HERE) / "configs" / "rwkv6-1.6b.json").read_text())["optimizer"]
    port = cosine_schedule(opt["peak_lr"], warmup=min(2000, opt["total_steps"] // 10),
                           total=opt["total_steps"])
    for step in (1, 2, 3, 999, 1000, 1001, 5000, 10000, 12000):
        assert cosine_lr(step, opt) == pytest.approx(port(step), rel=1e-12)


def test_adamw_is_the_ports():
    from repro_torch.optim.optimizer import adamw, cosine_schedule

    opt = json.loads((Path(harness.HERE) / "configs" / "qwen2-1.5b.json").read_text())["optimizer"]
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((3, 4), generator=g), "b": torch.randn((4,), generator=g)}
    mine = {k: v.clone() for k, v in p.items()}
    port = adamw(cosine_schedule(opt["peak_lr"], warmup=opt["warmup_steps"],
                                 total=opt["total_steps"]))
    state = port.init(p)
    ref = AdamW(mine, opt)
    for _ in range(3):
        grads = {k: 5 * torch.randn(v.shape, generator=g) for k, v in p.items()}
        p, state = port.update(grads, state, p)
        ref.update(mine, grads)
    for k in p:
        torch.testing.assert_close(mine[k], p[k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("workload", ["tiny-rwkv6.train-b2s32", "tiny-qwen2.train-b2s32"])
def test_the_reference_is_the_ports_float32_path(workload):
    """The port run in float32 on the CPU (its plain versions of the
    kernels) against the reference: the same equations, to float32
    rounding."""
    spec = json.loads((FIXTURES / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, workload, harness.Files(FIXTURES, harness.HERE))
    cell.config["model"]["dtype"] = "float32"
    dev = torch.device("cpu")
    _, _, prog = harness.setup(cell, 11, dev)
    prog["nonfinite"] = 0
    values = check.numbers(prog, harness.reference(cell, 11, dev))
    assert values["loss_gap"] < 1e-6
    assert values["grad_norm_gap"] < 1e-4
    assert values["change_norm_gap"] < 1e-3
