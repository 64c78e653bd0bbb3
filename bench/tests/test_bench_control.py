"""The control: the plain reference computed in float8 where the program
computes in bfloat16, put in the program's place, must come out not
correct, where the sound program comes out correct.  On the CPU at the
test cells' size (their limits set from CPU readings, as the cells' from
the card's); on the card at each cell's own size."""
import json
from pathlib import Path

import pytest
import torch

from bench import check, harness

FIXTURES = Path(__file__).resolve().parent / "fixtures"
SEED = 2 ** 31 + 4242


def _judge(cell, readings, dev):
    truth = harness.reference(cell, SEED, dev)
    return check.judge(check.numbers(dict(readings, nonfinite=0), truth),
                       cell.settings["limits"])[0]


@pytest.mark.parametrize("workload", ["tiny-rwkv6.train-b2s32", "tiny-qwen2.train-b2s32"])
def test_the_control_is_not_correct_where_the_program_is(workload):
    spec = json.loads((FIXTURES / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, workload, harness.Files(FIXTURES, harness.HERE))
    dev = torch.device("cpu")
    _, _, prog = harness.setup(cell, SEED, dev)
    assert _judge(cell, prog, dev) is True
    assert _judge(cell, harness.reference(cell, SEED, dev, prec="fp8"), dev) is False


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["rwkv6-1.6b.train-b4s4096", "qwen2-1.5b.train-b4s4096",
                                      "rwkv6-1.6b.train-b1s4096"])
def test_the_control_is_not_correct_at_the_cells_size(workload, chip):
    spec = json.loads(harness.SPEC.read_text())
    cell = harness.load_cell(spec, workload, harness.Files())
    assert _judge(cell, harness.reference(cell, SEED, chip, prec="fp8"), chip) is False
