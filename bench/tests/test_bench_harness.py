"""The harness, driven on the CPU at a size a test holds: every cell,
configuration and metric found by its file, a new one picked up from a new
file alone, whole runs (timed and traced) with their result line, runs
with the timed path broken that must come out not correct, and what a run
may not load."""
import copy
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness, program

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"
TINY = ["tiny-rwkv6.train-b2s32", "tiny-qwen2.train-b2s32"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(workload, traced=False, seed=2 ** 31 + 77, spec_path=FIXTURES / "BENCHMARK.json",
         dirs=(FIXTURES,)):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(workload, seed, 0.3, traced, device="cpu", spec_path=spec_path,
                          files=harness.Files(*dirs, BENCH), out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_every_name_has_its_file():
    spec = _spec()
    files = harness.Files()
    for c in spec["configs"]:
        config = files.json("configs", c["name"])
        assert (ROOT / c["file"]) == files.path("configs", c["name"], ".json")
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert callable(files.module("flops", c["name"]).forward_flops)
        program.model_config(config)  # every size is a field of the port's config
    for w in spec["workloads"]:
        cell = harness.load_cell(spec, w["name"], files)
        numbers = {"loss_gap", "grad_norm_gap", "grad_norm_gap_median", "change_norm_gap",
                   "change_norm_gap_median", "nonfinite_losses"}
        assert set(cell.settings["limits"]) <= numbers
        assert cell.settings["limits"]["nonfinite_losses"] == 0
        assert cell.settings["checked_steps"] >= 2 and cell.settings["trace_steps"] >= 1
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(files.module("metrics", m["name"]).read)


def test_the_spec_keeps_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"] and spec["command"] == ["python3", "bench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        reported = [m["name"] for m in harness.applicable(spec, w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.applicable(spec, w["name"], True)
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in [x["name"] for x in harness.applicable(spec, w, False)]


@pytest.mark.parametrize("workload", TINY)
@pytest.mark.parametrize("traced", [False, True])
def test_a_whole_run_prints_its_result(workload, traced):
    res, err = _run(workload, traced)
    assert res["correct"] is True
    assert list(res)[-1] == "checks" and list(res)[:5] == ["correct", "attempted", "failed",
                                                           "metrics", "device"]
    spec = json.loads((FIXTURES / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.applicable(spec, workload, traced)}
    assert set(res["metrics"]) <= want
    if traced:  # the CPU runs no device operation: no share of device time to read
        assert {"step_issue_ms", "device_idle_pct"} <= set(res["metrics"])
        assert "busy_s" in res["device"] and "breakdown" in res
    else:
        # no peak on the CPU; no 90th percentile of fewer than ten steps
        assert want - {"peak_mem_gib", "step_ms_p90"} <= set(res["metrics"])
        assert res["attempted"] >= 1 and res["failed"] == 0
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in last] == list(res["checks"])


def test_a_new_cell_and_metric_are_picked_up_from_new_files(tmp_path):
    spec = json.loads((FIXTURES / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-qwen2.train-b1s16", "config": "tiny-qwen2",
                              "traffic": "train-b1s16", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "answer_metric", "unit": "1", "better": "higher",
                              "source": "host_clock", "layer": "test",
                              "moves": "train_tokens_per_s",
                              "workloads": ["tiny-qwen2.train-b1s16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for kind, name, body in (
            ("traffic", "train-b1s16.json", {"kind": "train", "batch": 1, "seq": 16,
                                             "tokens": {"law": "power", "exponent": 3}}),
            ("cells", "tiny-qwen2.train-b1s16.json",
             json.loads((FIXTURES / "cells" / "tiny-qwen2.train-b2s32.json").read_text()))):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / name).write_text(json.dumps(body))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "answer_metric.py").write_text(
        "def read(run):\n    return 42.0 + 0 * len(run.issue_s)\n")
    res, _ = _run("tiny-qwen2.train-b1s16", traced=True, spec_path=tmp_path / "BENCHMARK.json",
                  dirs=(tmp_path, FIXTURES))
    assert res["metrics"]["answer_metric"] == {"value": 42.0, "unit": "1"}
    assert res["correct"] is True


def _unchanged(step):
    def broken(state, batch):
        kept = copy.deepcopy(state)
        _, metrics = step(state, batch)
        return kept, metrics

    return broken


def _half(step):
    return lambda state, batch: step(state, harness.half_batch(batch))


@pytest.mark.parametrize("workload", TINY)
@pytest.mark.parametrize("fault", [_unchanged, _half], ids=["state-unchanged", "half-batch"])
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    build = program.build
    monkeypatch.setattr(program, "build", lambda *a: (lambda s, st: (fault(s), st))(*build(*a)))
    res, err = _run(workload)
    assert res["correct"] is False, err
    assert "FAILED" in err


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """In a process of its own: a whole tiny run, then the top-level names
    in ``sys.modules`` (compared whole: the port's ``repro_torch`` is not
    the JAX package ``repro``)."""
    code = (
        "import io, sys; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from bench import harness\n"
        "fx = Path(%r)\n"
        "rc = harness.run_cell('tiny-rwkv6.train-b2s32', 5, 0.2, False, device='cpu', "
        "spec_path=fx / 'BENCHMARK.json', files=harness.Files(fx, Path(%r)), out=io.StringIO(), "
        "err=io.StringIO())\n"
        "tops = {n.split('.')[0] for n in sys.modules}\n"
        "print(rc, sorted(tops & {'jax', 'jaxlib', 'flax', 'repro'}), 'repro_torch' in tops)\n"
    ) % (str(ROOT), str(ROOT / "src"), str(FIXTURES), str(BENCH))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 [] True"


def test_without_a_card_a_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "rwkv6-1.6b.train-b1s4096", "--seed", str(2 ** 31 + 9), "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
