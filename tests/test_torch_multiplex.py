"""The port's multiplexing, coordinator and plan verifier against the
reference's, on the CPU.

``MultiplexSim.run``, ``Collocator`` scheduling, calibration, prediction and
admission on seeded tenant rosters, the coordinator's elasticity round
trip and admission, and ``verify_plan`` on mutated plans.  All of it is
pure Python in both packages, so every field must be equal (floats
exactly).  The executable path is held against the reference in
``tests/test_torch_collocation.py``.
"""
import dataclasses
import random

import pytest

from repro.analysis import verify as ref_verify
from repro.configs import TRAIN_4K as REF_TRAIN_4K
from repro.configs import get_config as ref_get_config
from repro.configs.vgg16 import CONFIG as REF_VGG
from repro.core import coordinator as ref_coord
from repro.core import costmodel as ref_costmodel
from repro.core import multiplex as ref_mx
from repro.core import planner as ref_planner
from repro.models import graph as ref_graph
from repro_torch.analysis import verify
from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.configs.vgg16 import CONFIG as VGG
from repro_torch.core import coordinator, costmodel, multiplex as mx, planner
from repro_torch.models import graph
from test_torch_planner import plain

AMP_LIMIT = 2.0
A100_FIELDS = dataclasses.asdict(ref_costmodel.A100)


def _hw():
    return ref_costmodel.Hardware(**A100_FIELDS), costmodel.Hardware(**A100_FIELDS)


PLANS = {  # name -> (graph builders per package, device count, amp limit)
    "llama3-8b@256": (lambda: ref_graph.build_lm_graph(ref_get_config("llama3-8b"), REF_TRAIN_4K),
                      lambda: graph.build_lm_graph(get_config("llama3-8b"), TRAIN_4K), 256, 2.0),
    "qwen2-1.5b@64": (lambda: ref_graph.build_lm_graph(ref_get_config("qwen2-1.5b"),
                                                       REF_TRAIN_4K),
                      lambda: graph.build_lm_graph(get_config("qwen2-1.5b"), TRAIN_4K), 64, 2.0),
    "vgg16@8": (lambda: ref_graph.build_vgg_graph(REF_VGG, 32),
                lambda: graph.build_vgg_graph(VGG, 32), 8, 1.5),
    "inception@8": (lambda: ref_graph.build_inception_like_graph(32, n_blocks=3),
                    lambda: graph.build_inception_like_graph(32, n_blocks=3), 8, 2.0),
}


def _plans(name):
    ref_g, port_g, G, amp = PLANS[name]
    ref_hw, port_hw = _hw()
    return (ref_planner.plan(ref_g(), G, amp_limit=amp, hw=ref_hw),
            planner.plan(port_g(), G, amp_limit=amp, hw=port_hw))


def _interference(rnd):
    """Equal InterferenceModels for both packages from a seeded stream."""
    f = dict(gap_inflation=rnd.choice([1.0, 1.0 + rnd.random()]),
             density_slope=rnd.choice([0.0, 2.0 * rnd.random()]),
             paced_inflation=1.0 + rnd.random())
    return ref_mx.InterferenceModel(**f), mx.InterferenceModel(**f)


def _mcfg(rnd):
    f = dict(use_priorities=rnd.random() < 0.8, use_pacing=rnd.random() < 0.8,
             use_feedback=rnd.random() < 0.7, use_granularity=rnd.random() < 0.8,
             collocate_same_device=rnd.random() < 0.3, max_inflight=rnd.randint(1, 4))
    return ref_mx.MultiplexConfig(**f), mx.MultiplexConfig(**f)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_multiplex_sim_run(name, seed):
    rnd = random.Random(seed)
    ref_plan, port_plan = _plans(name)
    ref_cfg, port_cfg = _mcfg(rnd)
    ref_im, port_im = _interference(rnd)
    ref_mon, port_mon = ref_mx.QoSMonitor(), mx.QoSMonitor()
    ref_sim = ref_mx.MultiplexSim(ref_plan, ref_cfg, ref_im, monitor=ref_mon)
    port_sim = mx.MultiplexSim(port_plan, port_cfg, port_im, monitor=port_mon)
    assert port_sim.bg_step_time() == ref_sim.bg_step_time()
    for iterations in (1, 20):
        ref, port = ref_sim.run(iterations), port_sim.run(iterations)
        assert plain(port) == plain(ref)
        assert port.row() == ref.row()
    assert plain(port_mon) == plain(ref_mon)  # baselines, EMAs, bans


def _roster(rnd, pkg):
    """Seeded tenants (priorities, weights, quanta); the same draws for
    both packages.  No step factories: the signatures name the steps."""
    n = rnd.randint(1, 5)
    draws = [(rnd.randint(0, 2), rnd.choice([1.0, 0.5, 2.0]), rnd.choice([None, None, 1, 2]))
             for _ in range(n)]
    return [pkg.BgTenant(f"job{i}", p, None, signature=f"sig{i}", weight=w, quantum=q)
            for i, (p, w, q) in enumerate(draws)]


def _results(rnd, pkg, plan):
    """Hand-built measured CollocationResults at two tenant densities (the
    input of ``Collocator.calibrate``)."""
    stages = [g.stage_index for g in plan.gaps()]
    out = []
    for k in range(rnd.randint(1, 3)):
        tenants = tuple(pkg.TenantResult(f"job{j}", 0, float(rnd.randint(0, 6)), 1.0,
                                         gap_stages=tuple(stages[: 1 + j]))
                        for j in range(1 + k))
        out.append(pkg.CollocationResult(
            fg_iter_time=1.0, fg_iter_time_isolated=0.9, fg_slowdown=1.0 + 0.2 * rnd.random(),
            bg_steps_per_iter=3.0, bg_throughput=3.0, iterations=3, tenants=tenants,
            stage_slowdowns=tuple((si, 1.0 + 0.3 * rnd.random()) for si in stages[:2])))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_collocator_schedule_predict_admit(name, seed):
    rnd = random.Random(1000 + seed)
    ref_plan, port_plan = _plans(name)
    ref_cfg, port_cfg = _mcfg(rnd)
    ref_im, port_im = _interference(rnd)
    state = rnd.getstate()
    ref_t = _roster(rnd, ref_mx)
    rnd.setstate(state)
    port_t = _roster(rnd, mx)
    ref_c = ref_mx.Collocator(ref_plan, ref_cfg, tenants=ref_t, interference=ref_im)
    port_c = mx.Collocator(port_plan, port_cfg, tenants=port_t, interference=port_im)
    assert port_c.bg_step_quantum == ref_c.bg_step_quantum
    assert port_c.schedule() == ref_c.schedule()
    bg_model = rnd.choice([1, 2])
    for it in range(3):  # the fair-share rotation and its deficits
        ref_s = ref_c.schedule_tenants(bg_model=bg_model)
        port_s = port_c.schedule_tenants(bg_model=bg_model)
        assert port_s == ref_s
        assert (port_c.predicted_cache_keys(bg_model=bg_model, device_ids=list(range(3, 900)))
                == ref_c.predicted_cache_keys(bg_model=bg_model, device_ids=list(range(3, 900))))
        launched = [rnd.randint(0, 3) for _ in range(len(ref_t))]
        ref_c.note_launched(launched)
        port_c.note_launched(launched)
        assert dict(port_c._deficits) == dict(ref_c._deficits)
    state = rnd.getstate()
    ref_res = _results(rnd, ref_mx, ref_plan)
    rnd.setstate(state)
    port_res = _results(rnd, mx, port_plan)
    assert plain(port_c.calibrate(port_res)) == plain(ref_c.calibrate(ref_res))
    for k in (None, 0, 1, len(ref_t) + 1):
        assert plain(port_c.predict(k, bg_model)) == plain(ref_c.predict(k, bg_model))
    for bound in (1.0, 1.05, 1.33, 3.0):
        ref_d = ref_c.admit(max_fg_slowdown=bound, bg_model=bg_model)
        port_d = port_c.admit(max_fg_slowdown=bound, bg_model=bg_model)
        assert plain(port_d) == plain(ref_d)
        assert port_d.row() == ref_d.row()


def test_executable_cache_bookkeeping():
    ref_cache, port_cache = ref_mx.ExecutableCache(max_entries=3), mx.ExecutableCache(max_entries=3)
    keys = [("sig", tuple(range(s, s + 2)), (1, 2)) for s in (0, 2, 4, 0, 6, 2)]
    for cache in (ref_cache, port_cache):
        for k in keys:
            cache.get_or_build(k, lambda k=k: k)
        cache.evict_stale(range(0, 5))
    assert list(port_cache.entries) == list(ref_cache.entries)
    assert ((port_cache.hits, port_cache.misses, port_cache.evictions)
            == (ref_cache.hits, ref_cache.misses, ref_cache.evictions))


def _coordinators(G, **kw):
    ref_hw, port_hw = _hw()
    return (ref_coord.ClusterCoordinator(G, ref_hw, clock=lambda: 0.0, **kw),
            coordinator.ClusterCoordinator(G, port_hw, clock=lambda: 0.0, **kw))


def _events(c):
    return [(e.kind, e.detail) for e in c.events]


def _decision(d):
    """An AdmissionDecision without its tenants' step factories (each
    package rosters jobs with its own placeholder)."""
    return (d.bound, d.n_admitted, [t.job for t in d.admitted], [t.job for t in d.rejected],
            d.curve, d.row())


def test_coordinator_failure_join_roundtrip():
    """As tests/test_plan_regression.py: a failure re-plans onto the 15
    survivors, a join restores the 16-device plan bit for bit; every plan
    equals the reference coordinator's."""
    ref_c, port_c = _coordinators(16)
    ref_g, port_g, _, _ = PLANS["llama3-8b@256"]
    p16 = port_c.submit_foreground(coordinator.Job("fg", "foreground", port_g(), AMP_LIMIT))
    r16 = ref_c.submit_foreground(ref_coord.Job("fg", "foreground", ref_g(), AMP_LIMIT))
    assert plain(p16) == plain(r16) and p16.num_gpus == 16
    p15, r15 = port_c.handle_failure(0), ref_c.handle_failure(0)
    assert plain(p15) == plain(r15) and p15.num_gpus == 15
    assert p15.total_time >= p16.total_time - 1e-12
    p16b, r16b = port_c.handle_join([16]), ref_c.handle_join([16])
    assert plain(p16b) == plain(r16b)
    assert plain(p16b) == plain(p16)  # restored bit for bit
    assert port_c.handle_join([16]) is None  # idempotent
    assert _events(port_c) == _events(ref_c)
    assert port_c.foreground().devices == ref_c.foreground().devices


def test_coordinator_admission_and_churn():
    ref_c, port_c = _coordinators(8, virtual_devices=True)
    ref_g, port_g, _, _ = PLANS["vgg16@8"]
    ref_c.submit_foreground(ref_coord.Job("fg", "foreground", ref_g(), 1.5))
    port_c.submit_foreground(coordinator.Job("fg", "foreground", port_g(), 1.5))
    im = dict(gap_inflation=1.3, density_slope=0.8)
    ref_c.interference = ref_mx.InterferenceModel(**im)
    port_c.interference = mx.InterferenceModel(**im)
    for i, (prio, w) in enumerate([(2, 1.0), (1, 2.0), (1, 1.0), (0, 1.0)]):
        ref_c.submit_background(ref_coord.Job(f"bg{i}", "background", [], priority=prio, weight=w))
        port_c.submit_background(coordinator.Job(f"bg{i}", "background", [], priority=prio,
                                                 weight=w))
    for bound in (1.33, 1.05):
        assert _decision(port_c.readmit(bound)) == _decision(ref_c.readmit(bound))
    assert port_c.handle_departure("bg1") and ref_c.handle_departure("bg1")
    assert not port_c.handle_departure("bg1")
    assert (_decision(port_c.readmit(reason="churn"))
            == _decision(ref_c.readmit(reason="churn")))
    assert plain(port_c.simulate_collocation()) == plain(ref_c.simulate_collocation())
    cfg = dict(max_inflight=3, use_feedback=False)
    assert (plain(port_c.collocate(mx.MultiplexConfig(**cfg)))
            == plain(ref_c.collocate(ref_mx.MultiplexConfig(**cfg))))
    # the executable cache evicts by simulated ids in virtual-device mode
    for c in (ref_c, port_c):
        c.exec_cache.get_or_build(("s", (6, 7), (1, 2)), lambda: None)
        c.handle_failure(7)
        c.restore_pool(range(8))
    assert _events(port_c) == _events(ref_c)
    assert port_c.exec_cache.evictions == ref_c.exec_cache.evictions == 1
    assert plain(port_c.foreground().plan) == plain(ref_c.foreground().plan)


def test_executable_path_raises_with_its_roadmap_item():
    """The executable path runs on 8 CPU positions (the reference's
    results, field for field, are in ``tests/test_torch_collocation.py``);
    only a step over more than one card in one process still raises,
    naming the rank carving that runs it."""
    import torch

    from repro_torch.launch.mesh import submesh_from_range

    _, port_plan = _plans("vgg16@8")
    cpu8 = [torch.device("cpu")] * 8
    col = mx.Collocator(port_plan, mx.MultiplexConfig(), devices=cpu8)
    split = col.submeshes()
    assert split.fg_range == (0, 8) and split.bg
    res = col.run_executable(lambda stage, mesh: (lambda: None),
                             lambda mesh: (lambda: None), iterations=1)
    assert res.iterations > 0 and [t.job for t in res.tenants] == ["bg0"]
    assert col.run_iteration([lambda: None] * len(port_plan.stages()), lambda: None,
                             lambda: 0.0) == {"iter_time": 0.0}
    c = coordinator.ClusterCoordinator(8, costmodel.A100)
    c.submit_foreground(coordinator.Job("fg", "foreground", graph.build_vgg_graph(VGG, 32)))
    got = c.collocate(mx.MultiplexConfig(collocate_same_device=True), executable=True,
                      make_fg_stage_fn=lambda s, m: (lambda: None),
                      make_bg_step_fn=lambda m: (lambda: None), iterations=1, device="cpu")
    assert isinstance(got, mx.CollocationResult) and got.iterations > 0
    two_cards = submesh_from_range(0, 2, devices=[torch.device("cuda", 0),
                                                  torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="as the ranks of a process group"):
        two_cards.device  # noqa: B018


def test_coordinator_evicts_by_cuda_device_count(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    c = coordinator.ClusterCoordinator(4, costmodel.A100)
    c.exec_cache.get_or_build(("s", (0, 1), (1, 2)), lambda: None)
    c.exec_cache.get_or_build(("s", (2, 3), (1, 2)), lambda: None)  # not on this host
    assert c._evict_stale_executables() == 1
    assert list(c.exec_cache.entries) == [("s", (0, 1), (1, 2))]
    c.handle_failure(1)  # the process's device 1 is gone
    assert len(c.exec_cache) == 0


# -- the verifier on mutated plans --------------------------------------------


def _mutations(pkg_plan, pkg_verify):
    """Deliberately broken copies of a real plan (the same edits for both
    packages) and the verifier's report on each."""
    p = pkg_plan
    L = p.layers
    bad_scale = dataclasses.replace(p, layers=(dataclasses.replace(L[0], gpus=p.num_gpus + 3),)
                                    + L[1:])
    bad_amp = dataclasses.replace(p, layers=L[:-1] + (dataclasses.replace(L[-1], amp=9.0),))
    bad_zero = dataclasses.replace(p, layers=(dataclasses.replace(L[0], gpus=0),) + L[1:])
    bad_time = dataclasses.replace(p, layers=(dataclasses.replace(L[0], time=-1.0),) + L[1:])
    return [
        pkg_verify.verify_plan(p, pool_size=p.num_gpus + 1),
        pkg_verify.verify_plan(bad_scale),
        pkg_verify.verify_plan(bad_amp, strict_layer_amp=True),
        pkg_verify.verify_plan(bad_zero),
        pkg_verify.verify_plan(bad_time),
        pkg_verify.verify_plan(dataclasses.replace(p, amp_limit=0.5)),
        pkg_verify.verify_carving(p, tenants=3, tenant_quanta=[1, 2, 4]),
    ]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_verify_plan_on_mutated_plans(name):
    ref_plan, port_plan = _plans(name)
    got, want = _mutations(port_plan, verify), _mutations(ref_plan, ref_verify)
    assert plain(got) == plain(want)
    # each edit is caught (the per-layer amp contract is the chain planner's)
    edits = range(6) if not port_plan.block_details else (0, 1, 3, 4, 5)
    assert all(got[i] for i in edits), [len(v) for v in got]
    with pytest.raises(verify.PlanVerificationError):
        verify.verify_plan_or_raise(port_plan, pool_size=port_plan.num_gpus + 1)
