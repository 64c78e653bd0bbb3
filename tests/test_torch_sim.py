"""The port's trace-driven cluster simulator (``repro_torch.sim``) against
the reference's (``repro.sim``), on the CPU.

Both replay the same traces through their own control plane (coordinator,
planner, admission, executable cache, transport, lease); the reports must
serialize to the same JSON string, segments included.  The committed
traces under ``benchmarks/traces/`` are read, not copied.  Each scenario
of ``tests/test_cluster_sim.py`` runs on both packages from one script:
its assertions hold on each, and what it returns must be equal.  Also the
coordinator's ``verify_plans=`` / ``REPRO_VERIFY_PLANS`` gate, as
``tests/test_analysis_verify.py`` holds the reference's.
"""
import dataclasses
import json
import pathlib
import types

import pytest

import repro.configs.vgg16 as ref_vgg
import repro.core.costmodel as ref_costmodel
import repro.core.coordinator as ref_coordinator
import repro.core.multiplex as ref_multiplex
import repro.core.planner as ref_planner
import repro.models.graph as ref_graph
import repro.sim as ref_sim
import repro_torch.configs.vgg16 as port_vgg
import repro_torch.core.coordinator as port_coordinator
import repro_torch.core.costmodel as port_costmodel
import repro_torch.core.multiplex as port_multiplex
import repro_torch.core.planner as port_planner
import repro_torch.models.graph as port_graph
import repro_torch.sim as port_sim
from repro_torch.analysis.verify import PlanVerificationError

TRACES = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "traces"
AMP = 1.5


def _pkg(sim, costmodel, multiplex, graph, vgg, planner, coordinator):
    return types.SimpleNamespace(sim=sim, A100=costmodel.A100, multiplex=multiplex,
                                 planner=planner, coordinator=coordinator,
                                 graph=graph.build_vgg_graph(vgg.CONFIG, 32))


REF = _pkg(ref_sim, ref_costmodel, ref_multiplex, ref_graph, ref_vgg, ref_planner,
           ref_coordinator)
PORT = _pkg(port_sim, port_costmodel, port_multiplex, port_graph, port_vgg, port_planner,
            port_coordinator)


def _sim(m, trace, **kw):
    kw.setdefault("interference", m.multiplex.InterferenceModel(gap_inflation=1.12))
    return m.sim.ClusterSim(trace, m.graph, hw=m.A100, amp_limit=AMP, **kw)


def _text(rep) -> str:
    return json.dumps(rep.to_json(with_segments=True), sort_keys=True)


def both(scenario, *args):
    """The scenario's result on the reference and on the port, equal."""
    want, got = scenario(REF, *args), scenario(PORT, *args)
    assert got == want
    return got


# -- committed traces: bit-identical reports ---------------------------------


@pytest.mark.parametrize("name", ["trace_128", "failure_storm_128", "heartbeat_loss_128",
                                  "lease_churn_128", "trace_512", "trace_1024"])
def test_committed_trace_report_equals_reference(name):
    """The benchmark's settings (``bench_cluster_sim.py``): lease-churn
    traces replay with a 2 s lease and per-pump GC."""
    kw = dict(lease_timeout=2.0, gc_every=1) if name.startswith("lease_churn") else {}

    def replay(m):
        return _text(_sim(m, m.sim.load_trace(TRACES / f"{name}.json"), **kw).run())

    both(replay)


@pytest.mark.parametrize("gen,kw", [
    ("generate_trace", dict(n=64, seed=3, horizon=120.0)),
    ("generate_trace", dict(n=128, seed=17, horizon=600.0)),
    ("generate_failure_storm", dict(n=64, seed=11, dead_fraction=0.25)),
    ("generate_heartbeat_loss", dict(n=64, seed=5, n_losses=3, n_jobs=2)),
    ("generate_lease_churn", dict(n=64, seed=5, n_churns=3, n_jobs=2)),
])
def test_generators_match_reference(gen, kw):
    kw = dict(kw)
    n = kw.pop("n")
    both(lambda m: json.dumps(getattr(m.sim, gen)(n, **kw).to_json(), sort_keys=True))


# -- the scenarios of tests/test_cluster_sim.py, on both packages --------------


def test_trace_generation_is_seed_deterministic():
    def scenario(m):
        a = m.sim.generate_trace(64, seed=3, horizon=120.0)
        assert a.to_json() == m.sim.generate_trace(64, seed=3, horizon=120.0).to_json()
        assert a.to_json() != m.sim.generate_trace(64, seed=4, horizon=120.0).to_json()
        ts = [e.t for e in a.events]
        assert ts == sorted(ts)
        assert all(0 <= e.device < 64 for e in a.events if e.device is not None)
        return a.to_json()

    both(scenario)


def test_trace_json_roundtrip(tmp_path):
    def scenario(m):
        tr = m.sim.generate_trace(32, seed=9, horizon=90.0)
        p = tmp_path / f"{m.sim.__name__}.json"
        m.sim.save_trace(tr, p)
        assert m.sim.load_trace(p).to_json() == tr.to_json()
        bad = tr.to_json()
        bad["version"] = 2
        with pytest.raises(ValueError):
            m.sim.Trace.from_json(bad)
        with pytest.raises(ValueError):
            m.sim.TraceEvent.from_json({"t": 0.0, "kind": "meteor_strike"})
        return p.read_text()

    both(scenario)


def test_replay_is_bit_identical_across_serialization(tmp_path):
    def scenario(m):
        tr = m.sim.generate_trace(64, seed=7, horizon=150.0)
        rep1 = _sim(m, tr).run()
        p = tmp_path / f"{m.sim.__name__}.json"
        m.sim.save_trace(tr, p)
        rep2 = _sim(m, m.sim.load_trace(p)).run()
        assert _text(rep1) == _text(rep2)
        assert json.loads(json.dumps(rep1.to_json(with_segments=True))) == \
            rep1.to_json(with_segments=True)
        return _text(rep1)

    both(scenario)


def test_replay_tracks_cluster_state():
    def scenario(m):
        tr = m.sim.generate_trace(64, seed=7, horizon=150.0)
        rep = _sim(m, tr).run()
        assert rep.n_epochs >= 1 and rep.n_events == len(tr.events)
        assert rep.horizon == tr.horizon
        assert rep.n_replans >= 1 and rep.fg_goodput > 0.0
        assert 0.0 < rep.jain_time_avg <= 1.0 + 1e-12
        assert rep.mean_fg_slowdown >= 1.0 - 1e-9
        segs = rep.segments
        assert segs[0].t0 == 0.0 and segs[-1].t1 == pytest.approx(rep.horizon)
        for a, b in zip(segs, segs[1:]):
            assert a.t1 == pytest.approx(b.t0)
            assert a.plan_gpus == a.n_healthy  # exact-survivor planning
        return _text(rep)

    both(scenario)


def test_failure_storm_keeps_cache_bounded_and_plans_on_survivors():
    def scenario(m):
        storm = m.sim.generate_failure_storm(64, seed=11, dead_fraction=0.25)
        n_failures = sum(1 for e in storm.events if e.kind == "device_failure")
        assert n_failures >= 16
        rep = _sim(m, storm).run()
        assert rep.n_replans == n_failures
        assert rep.cache_final_size <= 64 and rep.cache_evictions > 0
        assert rep.segments[-1].n_healthy == rep.segments[-1].plan_gpus == 64 - n_failures
        return _text(rep)

    both(scenario)


def test_pessimistic_interference_rejects_tenants():
    def scenario(m):
        ev = [m.sim.TraceEvent(t=1.0 + i, kind="job_arrival", job=f"bg{i}", priority=1,
                               weight=1.0, quantum=1) for i in range(4)]
        tr = m.sim.Trace(n_devices=32, events=ev, horizon=50.0)
        rep = _sim(m, tr, interference=m.multiplex.InterferenceModel(gap_inflation=2.0)).run()
        assert rep.rejected_total > 0
        assert rep.mean_fg_slowdown <= 1.33 + 1e-9
        return _text(rep)

    both(scenario)


def test_departures_shrink_roster_and_service_accrues_per_job():
    def scenario(m):
        E = m.sim.TraceEvent
        ev = [E(t=1.0, kind="job_arrival", job="bgA", priority=1, weight=1.0, quantum=1),
              E(t=2.0, kind="job_arrival", job="bgB", priority=1, weight=1.0, quantum=1),
              E(t=30.0, kind="job_departure", job="bgA")]
        rep = _sim(m, m.sim.Trace(n_devices=16, events=ev, horizon=60.0)).run()
        assert set(rep.per_job_service) == {"fg", "bgA", "bgB"}
        assert rep.per_job_service["bgB"] > rep.per_job_service["bgA"] > 0.0
        assert rep.segments[-1].n_tenants == 1
        return _text(rep)

    both(scenario)


def test_committed_traces_replay_and_gate():
    def scenario(m):
        tr = m.sim.load_trace(TRACES / "trace_128.json")
        assert tr.n_devices == 128
        rep = _sim(m, tr).run()
        assert rep.mean_goodput_rate > m.planner.plan_data_parallel(m.graph, 128,
                                                                    hw=m.A100).speedup
        return rep.mean_goodput_rate

    both(scenario)


def test_heartbeat_loss_generator_deterministic_and_well_formed():
    def scenario(m):
        a = m.sim.generate_heartbeat_loss(64, seed=5, n_losses=3, n_jobs=2)
        assert a.to_json() == m.sim.generate_heartbeat_loss(64, seed=5, n_losses=3,
                                                            n_jobs=2).to_json()
        losses = [e for e in a.events if e.kind == "heartbeat_loss"]
        assert len(losses) == len({e.device for e in losses}) == 3
        assert all(0 <= e.device < 64 for e in losses)
        assert sum(1 for e in a.events if e.kind == "job_arrival") == 2
        assert [e.t for e in a.events] == sorted(e.t for e in a.events)
        return a.to_json()

    both(scenario)


def test_heartbeat_loss_detected_by_live_consumption_path():
    def scenario(m):
        tr = m.sim.generate_heartbeat_loss(16, seed=3, n_losses=3, n_jobs=2)
        rep = _sim(m, tr, hb_timeout=5.0).run()
        assert rep.mitigations == {"failure_detected": 3, "replan": 3}
        assert rep.n_replans == 3
        assert rep.segments[-1].n_healthy == rep.segments[-1].plan_gpus == 13
        bounds = {round(s.t0, 6) for s in rep.segments}
        for e in tr.events:
            if e.kind == "heartbeat_loss":
                assert round(e.t + 5.0, 6) in bounds
        assert _text(rep) == _text(_sim(m, tr, hb_timeout=5.0).run())
        return _text(rep)

    both(scenario)


def test_heartbeat_loss_roundtrips_through_json(tmp_path):
    def scenario(m):
        tr = m.sim.generate_heartbeat_loss(32, seed=9, n_losses=2, n_jobs=1)
        p = tmp_path / f"{m.sim.__name__}.json"
        m.sim.save_trace(tr, p)
        rep1 = _sim(m, tr, hb_timeout=4.0).run()
        assert _text(rep1) == _text(_sim(m, m.sim.load_trace(p), hb_timeout=4.0).run())
        assert rep1.mitigations["failure_detected"] == 2
        return _text(rep1)

    both(scenario)


def test_committed_heartbeat_loss_trace_gates_mitigations():
    def scenario(m):
        tr = m.sim.load_trace(TRACES / "heartbeat_loss_128.json")
        n_losses = sum(1 for e in tr.events if e.kind == "heartbeat_loss")
        assert tr.n_devices == 128 and n_losses == 3
        rep = _sim(m, tr).run()
        assert rep.mitigations["failure_detected"] == rep.mitigations["replan"] == n_losses
        assert rep.segments[-1].n_healthy == rep.segments[-1].plan_gpus == 128 - n_losses
        assert rep.mean_fg_slowdown <= 1.33 + 1e-9
        return rep.mitigations

    both(scenario)


def test_lease_churn_generator_deterministic_and_well_formed(tmp_path):
    def scenario(m):
        a = m.sim.generate_lease_churn(64, seed=5, n_churns=3, n_jobs=2)
        assert a.to_json() == m.sim.generate_lease_churn(64, seed=5, n_churns=3,
                                                         n_jobs=2).to_json()
        churns = [e for e in a.events if e.kind == "lease_churn"]
        assert len(churns) == 3 and all(e.device is None for e in churns)
        assert sum(1 for e in a.events if e.kind == "job_arrival") == 2
        p = tmp_path / f"{m.sim.__name__}.json"
        m.sim.save_trace(a, p)
        assert m.sim.load_trace(p).to_json() == a.to_json()
        return a.to_json()

    both(scenario)


def test_lease_churn_replays_real_failover_path():
    def scenario(m):
        tr = m.sim.generate_lease_churn(16, seed=3, n_churns=3, n_jobs=2)
        kw = dict(hb_timeout=5.0, lease_timeout=2.0, gc_every=1)
        rep = _sim(m, tr, **kw).run()
        assert rep.n_failovers == rep.n_replans == 3
        assert rep.mitigations["coordinator_failover"] == 3
        assert rep.mitigations["failure_detected"] == rep.mitigations["replan"] == 3
        assert rep.segments[-1].n_healthy == rep.segments[-1].plan_gpus == 13
        bounds = {round(s.t0, 6) for s in rep.segments}
        for e in tr.events:
            if e.kind == "lease_churn":
                assert round(e.t + 2.0, 6) in bounds and round(e.t + 7.0, 6) in bounds
        assert sum(rep.topic_backlog.values()) <= 4
        assert _text(rep) == _text(_sim(m, tr, **kw).run())
        return _text(rep)

    both(scenario)


def test_lease_churn_without_gc_grows_backlog():
    def scenario(m):
        tr = m.sim.generate_lease_churn(16, seed=3, n_churns=3, n_jobs=2)
        rep = _sim(m, tr, hb_timeout=5.0, lease_timeout=2.0, gc_every=0).run()
        assert rep.n_failovers == 3
        assert sum(rep.topic_backlog.values()) > 50
        return rep.topic_backlog

    both(scenario)


def test_committed_lease_churn_trace_gates_failovers():
    def scenario(m):
        tr = m.sim.load_trace(TRACES / "lease_churn_128.json")
        assert tr.n_devices == 128
        assert sum(1 for e in tr.events if e.kind == "lease_churn") == 3
        rep = _sim(m, tr, lease_timeout=2.0, gc_every=1).run()
        assert rep.n_failovers == 3
        assert rep.mitigations["coordinator_failover"] == 3
        assert rep.mitigations["failure_detected"] == rep.mitigations["replan"] == 3
        assert rep.segments[-1].n_healthy == rep.segments[-1].plan_gpus == 125
        assert sum(rep.topic_backlog.values()) <= 4
        assert rep.mean_fg_slowdown <= 1.33 + 1e-9
        return rep.mitigations

    both(scenario)


# -- the coordinator's plan verification gate (test_analysis_verify.py) --------


def _fg(m):
    return m.coordinator.Job("fg", "foreground", m.graph, amp_limit=2.0)


def test_coordinator_verifies_installed_plans():
    """On the paper's A100 entry (the default ``Hardware`` of each package
    is its own card) a plan cut to 3 devices breaks the same invariants."""
    def scenario(m):
        coord = m.coordinator.ClusterCoordinator(8, m.A100)
        assert coord.verify_plans  # on by default
        bp = coord.submit_foreground(_fg(m))  # verified on install: no raise
        assert bp.num_gpus == 8
        bad = dataclasses.replace(bp, num_gpus=3)  # layers now exceed the pool
        with pytest.raises(AssertionError) as ei:
            coord._verify_installed(bad, "test")
        m.coordinator.ClusterCoordinator(8, m.A100, verify_plans=False)._verify_installed(
            bad, "test")  # gated off: no raise
        return sorted({v.check for v in ei.value.violations})

    assert "layer-bounds" in both(scenario)
    with pytest.raises(PlanVerificationError):
        coord = PORT.coordinator.ClusterCoordinator(8, PORT.A100)
        coord._verify_installed(dataclasses.replace(coord.submit_foreground(_fg(PORT)),
                                                    num_gpus=3), "test")


def test_coordinator_verify_env_gate(monkeypatch):
    for m in (REF, PORT):
        monkeypatch.setenv("REPRO_VERIFY_PLANS", "0")
        assert not m.coordinator.ClusterCoordinator(4).verify_plans
        monkeypatch.delenv("REPRO_VERIFY_PLANS")
        assert m.coordinator.ClusterCoordinator(4).verify_plans
        # explicit flag beats the environment
        monkeypatch.setenv("REPRO_VERIFY_PLANS", "0")
        assert m.coordinator.ClusterCoordinator(4, verify_plans=True).verify_plans
        monkeypatch.delenv("REPRO_VERIFY_PLANS")


def test_coordinator_failure_join_cycle_verifies():
    def scenario(m):
        coord = m.coordinator.ClusterCoordinator(8, m.A100)
        coord.submit_foreground(_fg(m))
        p7 = coord.handle_failure(3)
        assert p7 is not None and p7.num_gpus == 7  # survivors planned exactly
        p8 = coord.handle_join([3])
        assert p8 is not None and p8.num_gpus == 8
        return [(e.kind, e.detail) for e in coord.events]

    both(scenario)
