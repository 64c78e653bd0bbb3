"""The port's protocol model checker and trace validator
(``repro_torch.analysis.protocheck`` / ``tracecheck``) against the
reference's, on the CPU.

``explore()`` drives each package's own transport, lease, loop and monitor
through the same seeded schedules: the reports (schedule counts,
violations, witnesses) must be equal, the clean protocol must pass, and
each of the three mutants must be detected.  ``tracecheck`` must report
the same violations on the committed traces, the corpus and mutated
copies written under ``tmp_path``.
"""
import json
import pathlib

import pytest

from repro.analysis import protocheck as ref_protocheck
from repro.analysis import tracecheck as ref_tracecheck
from repro_torch.analysis import protocheck, tracecheck
from repro_torch.dist.faults import HeartbeatMonitor
from repro_torch.dist.transport import (
    HEARTBEAT_TOPIC,
    CoordinatorLoop,
    WorkerClient,
    fake_transport_pair,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
TRACES = REPO / "benchmarks" / "traces"
CORPUS = REPO / "tests" / "analysis_corpus" / "traces"


def _record(report):
    return (report.schedules, report.failing_schedule,
            [(v.check, v.where, v.detail) for v in report.violations])


def _explore_both(**kw):
    want = _record(ref_protocheck.explore(**kw))
    report = protocheck.explore(**kw)
    assert _record(report) == want
    return report


@pytest.mark.parametrize("n_workers,depth,samples", [(2, 3, 300), (3, 2, 150)])
def test_clean_protocol_matches_reference(n_workers, depth, samples):
    report = _explore_both(n_workers=n_workers, depth=depth, samples=samples)
    assert report.ok, "\n".join(str(v) for v in report.violations)
    assert report.schedules > 100


@pytest.mark.parametrize("name", sorted(protocheck.MUTANTS))
def test_mutant_is_detected_as_by_the_reference(name):
    assert sorted(protocheck.MUTANTS) == sorted(ref_protocheck.MUTANTS)
    report = _explore_both(n_workers=2, depth=2, samples=2000, mutant=name)
    assert not report.ok, f"mutant {name} survived {report.schedules} schedules"
    expect = {"cursor-reread": "proto-cursor", "adopt-skip": "proto-mitigation",
              "gc-head": "proto-pool-of-record"}[name]
    assert expect in {v.check for v in report.violations}
    assert report.failing_schedule is not None


def test_failing_schedule_replays():
    report = protocheck.explore(n_workers=2, depth=2, samples=2000, mutant="cursor-reread")
    replay = protocheck.ProtocolModel(2, protocheck.MUTANTS["cursor-reread"]).run_schedule(
        report.failing_schedule)
    assert {v.check for v in replay} == {v.check for v in report.violations}
    ref_replay = ref_protocheck.ProtocolModel(
        2, ref_protocheck.MUTANTS["cursor-reread"]).run_schedule(report.failing_schedule)
    assert [(v.check, v.where, v.detail) for v in replay] == \
        [(v.check, v.where, v.detail) for v in ref_replay]


def test_cli_exit_codes(capsys):
    assert protocheck.main(["--workers", "2", "--depth", "2", "--samples", "20"]) == 0
    assert protocheck.main(["--workers", "2", "--depth", "2", "--samples", "2000",
                            "--mutant", "gc-head"]) == 0  # detected: exit 0
    capsys.readouterr()


def test_bootstrap_after_full_hb_compaction_regression():
    worker_end, coord_end = fake_transport_pair()
    WorkerClient(worker_end, 0).beat(1)
    old = CoordinatorLoop(coord_end, HeartbeatMonitor(1, timeout=10.0))
    old.pump()
    old.gc()  # hb log fully compacted to the old holder's cursor
    assert coord_end.low_water(HEARTBEAT_TOPIC) == 1
    new = CoordinatorLoop(coord_end, HeartbeatMonitor(1, timeout=10.0))
    new.bootstrap_from_log()
    assert new._seen_beats >= coord_end.low_water(HEARTBEAT_TOPIC)
    new.pump()  # a strict transport raised before the fix


# -- tracecheck ------------------------------------------------------------------


def _codes(violations):
    return [(v.check, v.where.replace(str(REPO), ""), v.detail) for v in violations]


def test_committed_traces_are_clean_in_both():
    got = tracecheck.check_paths([str(TRACES)])
    assert got == [] and ref_tracecheck.check_paths([str(TRACES)]) == []


@pytest.mark.parametrize("fname", sorted(p.name for p in CORPUS.glob("*.json")))
def test_corpus_trace_flagged_as_by_the_reference(fname):
    got = tracecheck.check_trace_file(CORPUS / fname)
    assert got, fname
    assert _codes(got) == _codes(ref_tracecheck.check_trace_file(CORPUS / fname))


@pytest.mark.parametrize("name,mutate,code", [
    ("heartbeat_loss_128", lambda d: next(e for e in d["events"]
                                          if e["kind"] == "heartbeat_loss").update(
        device=d["n_devices"]), "trace-device-range"),
    ("trace_128", lambda d: d.update(version=2), "trace-version"),
    ("lease_churn_128", lambda d: next(e for e in d["events"]
                                       if e["kind"] == "lease_churn").update(device=0),
     "trace-field"),
    ("trace_512", lambda d: d["events"].reverse(), "trace-order"),
    ("failure_storm_128", lambda d: d["events"][0].update(kind="meteor"), "trace-event-kind"),
    ("requests_smoke", lambda d: d["requests"][1].update(id=7), "req-id"),
])
def test_mutated_committed_trace_is_caught_as_by_the_reference(tmp_path, name, mutate, code):
    doc = json.loads((TRACES / f"{name}.json").read_text())
    mutate(doc)
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(doc))
    got = tracecheck.check_trace_file(p)
    assert code in {v.check for v in got}
    assert _codes(got) == _codes(ref_tracecheck.check_trace_file(p))


def test_unknown_shape_is_flagged(tmp_path):
    p = tmp_path / "mystery.json"
    p.write_text('{"data": []}')
    assert {v.check for v in tracecheck.check_trace_file(p)} == {"trace-kind"}
    p.write_text("not json at all {")
    assert {v.check for v in tracecheck.check_trace_file(p)} == {"trace-json"}


def test_generator_and_request_trace_output_validates(tmp_path):
    from repro_torch.serve.trace import generate_request_trace, save_request_trace
    from repro_torch.sim.trace import (
        generate_failure_storm,
        generate_heartbeat_loss,
        generate_lease_churn,
        generate_trace,
        save_trace,
    )

    for fname, trace in {"gen.json": generate_trace(16, seed=3, horizon=60.0),
                         "storm.json": generate_failure_storm(16, seed=5),
                         "hb.json": generate_heartbeat_loss(16, seed=7),
                         "lease.json": generate_lease_churn(16, seed=9)}.items():
        save_trace(trace, tmp_path / fname)
    save_request_trace(generate_request_trace(seed=11, qps=5.0, n_requests=20, vocab_size=64),
                       tmp_path / "reqs.json")
    violations = tracecheck.check_paths([str(tmp_path)])
    assert violations == [], "\n".join(str(v) for v in violations)
    assert tracecheck.main([str(tmp_path)]) == 0
