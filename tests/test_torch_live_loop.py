"""The port's live training loop against the reference's, on the CPU.

Each scenario of ``tests/test_transport.py:594-745`` (a silent worker
detected from live beats, continuous admission, applied reconfiguration
whose carving is unchanged, the lease gating the pump) builds its control
plane on a scripted clock and runs three times: the
reference's ``train()`` on an Auto-axis (1, 1) ``jax.sharding.Mesh`` (its
``make_mesh`` builds Explicit axes, where its step raises; ROADMAP Queue
3), the port's ``train(..., device="cpu")`` and the port's ``train(...,
mesh=)`` on a one-rank gloo group.  Reduced qwen2-1.5b in fp32; both sides
start from the reference's initial state, written as a step-0 checkpoint
that each restores.  The losses agree to 1e-5 relative (the port's two runs
bit for bit), the mitigation events are equal with only ``dt`` and ``err``
masked, and so are ``remeshes`` and what the coordinator ends with.  The
EMA straggler deadline is set out of reach on every side: it reads the
wall clock, which no two runs share.  Every scenario runs 8 steps of the
same shape, so the reference's coordinators share one ``ExecutableCache``
and its step is compiled once, not once a scenario.  The fail-stop path,
phase 12a's scripts and the CLI are in ``tests/test_torch_live_script.py``.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import repro.core.coordinator as ref_coordinator
import repro.dist.faults as ref_faults
import repro.dist.transport as ref_transport
import repro.models.graph as ref_graph
import repro.train.loop as ref_loop
import repro_torch.core.coordinator as port_coordinator
import repro_torch.dist.faults as port_faults
import repro_torch.dist.transport as port_transport
import repro_torch.models.graph as port_graph
import repro_torch.train.loop as port_loop
from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import TRAIN_4K as REF_TRAIN_4K
from repro.configs import get_config as ref_get_config
from repro.configs.vgg16 import CONFIG as REF_VCFG
from repro.core.costmodel import A100 as REF_A100
from repro.core.multiplex import ExecutableCache as RefExecutableCache
from repro.core.multiplex import InterferenceModel as RefInterference
from repro.models import get_model as ref_get_model
from repro.optim.optimizer import make_optimizer as ref_make_optimizer
from repro.train.state import init_state as ref_init_state
from repro_torch.configs import TRAIN_4K as PORT_TRAIN_4K
from repro_torch.configs.vgg16 import CONFIG as PORT_VCFG
from repro_torch.core.costmodel import A100 as PORT_A100
from repro_torch.core.multiplex import InterferenceModel as PortInterference
from test_torch_bridge import port_config


LOSS_RTOL = 1e-5
STEPS = 8
REF_CFG = dataclasses.replace(ref_get_config("qwen2-1.5b").reduced(), dtype="float32")
REF_STEPS = RefExecutableCache()  # the reference's built train steps, shared
PORT_CFG = port_config(REF_CFG)


def _pkg(loop, transport, faults, coordinator, graph, vcfg, interference, train_4k, a100):
    return types.SimpleNamespace(
        loop=loop, tr=transport, faults=faults, coordinator=coordinator, A100=a100,
        graph=graph.build_vgg_graph(vcfg, 32), Interference=interference,
        shape=dataclasses.replace(train_4k, seq_len=64, global_batch=4, name="smoke"),
        # live_script's names
        KVStoreTransport=transport.KVStoreTransport,
        ClusterCoordinator=coordinator.ClusterCoordinator, Job=coordinator.Job,
        build_lm_graph=graph.build_lm_graph, TRAIN_4K=train_4k,
        HeartbeatMonitor=faults.HeartbeatMonitor, CoordinatorLoop=transport.CoordinatorLoop,
        CoordinatorLease=transport.CoordinatorLease, WorkerClient=transport.WorkerClient,
        TrainConfig=loop.TrainConfig)


REF = _pkg(ref_loop, ref_transport, ref_faults, ref_coordinator, ref_graph, REF_VCFG,
           RefInterference, REF_TRAIN_4K, REF_A100)
PORT = _pkg(port_loop, port_transport, port_faults, port_coordinator, port_graph, PORT_VCFG,
            PortInterference, PORT_TRAIN_4K, PORT_A100)


@pytest.fixture(scope="module")
def ckpt0(tmp_path_factory):
    """The reference's initial state as a step-0 checkpoint, restored by
    every run of both packages."""
    d = tmp_path_factory.mktemp("ckpt0")
    api = ref_get_model(REF_CFG)
    state = ref_init_state(jax.random.PRNGKey(0), api, ref_make_optimizer(REF_CFG, STEPS))
    ref_ckpt.save(str(d), state, 0, extra_meta={"data": {"seed": 0, "step": 0}},
                  async_=False)
    return str(d)


@pytest.fixture(scope="module")
def world_of_one():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _run(m, side, tc, injector, mesh):
    if m is REF:
        tc.coordinator.exec_cache = REF_STEPS
        ref_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
        return REF.loop.train(REF_CFG, m.shape, ref_mesh, tc, fault_injector=injector)
    return PORT.loop.train(PORT_CFG, m.shape, tc, fault_injector=injector, device="cpu",
                           mesh=mesh if side == "mesh" else None)


def _masked(report):
    return [{k: ("*" if k in ("dt", "err") else v) for k, v in e.items()}
            for e in report.mitigations.events]


def three_ways(scenario, mesh, *, n_losses=None):
    """Runs ``scenario(m) -> (tc, injector, after)`` on the reference and
    twice on the port; holds the records equal, and the first ``n_losses``
    losses (default: all).  Returns the reference's report and
    ``after()``."""
    out = {}
    for side, m in (("ref", REF), ("cpu", PORT), ("mesh", PORT)):
        tc, injector, after = scenario(m)
        rep = _run(m, side, tc, injector, mesh)
        out[side] = (rep, after())
    ref, ref_after = out["ref"]
    for rep, after in (out["cpu"], out["mesh"]):
        assert _masked(rep) == _masked(ref)
        assert (rep.steps_done, rep.restarts, rep.remeshes) == \
            (ref.steps_done, ref.restarts, ref.remeshes)
        assert after == ref_after
        np.testing.assert_allclose(rep.losses[:n_losses], ref.losses[:n_losses],
                                   rtol=LOSS_RTOL)
    return ref, ref_after


def _coord(m, n, clk):
    coord = m.coordinator.ClusterCoordinator(n, m.A100, clock=lambda: clk["t"],
                                             virtual_devices=True)
    coord.submit_foreground(m.coordinator.Job("fg", "foreground", m.graph, amp_limit=1.5))
    return coord


def _silent_worker(ckpt_dir, **kw):
    """A phantom worker (id 1) beats once at t=0, then falls silent; the
    real worker (id 0) beats each step; the clock is the step."""
    def scenario(m):
        clk = {"t": 0.0}
        worker_end, coord_end = m.tr.fake_transport_pair()
        coord = _coord(m, 8, clk)
        mon = m.faults.HeartbeatMonitor(2, timeout=5.0, clock=lambda: clk["t"])
        loop = m.tr.CoordinatorLoop(coord_end, mon, coordinator=coord)
        m.tr.WorkerClient(worker_end, 1).beat(0)

        def advance_clock(step):
            clk["t"] = float(step)

        tc = m.loop.TrainConfig(steps=STEPS, coordinator=coord, heartbeat=mon,
                                transport=worker_end, control_loop=loop, ckpt_dir=ckpt_dir,
                                straggler_factor=1e6, **kw)
        return tc, advance_clock, lambda: (sorted(coord.healthy),
                                           coord.foreground().plan.num_gpus)

    return scenario


def test_train_loop_detects_silent_worker_from_live_beats(ckpt0, world_of_one):
    rep, (healthy, gpus) = three_ways(_silent_worker(ckpt0), world_of_one)
    assert rep.steps_done == STEPS
    assert rep.mitigations.count("failure_detected") == rep.mitigations.count("replan") == 1
    assert rep.mitigations.count("failure") == 0  # not the except path
    assert healthy == [0, 2, 3, 4, 5, 6, 7] and gpus == 7
    ev = next(e for e in rep.mitigations.events if e["kind"] == "reconfig")
    assert ev["reason"] == "failure" and ev["gpus"] == 7


def test_train_loop_apply_reconfig_noop_when_carving_unchanged(ckpt0, world_of_one):
    rep, (healthy, _) = three_ways(_silent_worker(ckpt0, apply_reconfig=True), world_of_one)
    assert rep.steps_done == STEPS
    assert rep.mitigations.count("reconfig") == 1
    assert rep.remeshes == 0 and rep.mitigations.count("reconfig_applied") == 0
    assert healthy == [0, 2, 3, 4, 5, 6, 7]


def test_train_loop_continuous_admission_resweeps_roster(ckpt0, world_of_one):
    def scenario(m):
        coord = m.coordinator.ClusterCoordinator(8, m.A100, virtual_devices=True,
                                                 clock=lambda: 0.0)
        coord.submit_foreground(m.coordinator.Job("fg", "foreground", m.graph, amp_limit=1.5))
        coord.interference = m.Interference(gap_inflation=1.28, density_slope=3.0)
        for i in range(3):
            coord.submit_background(m.coordinator.Job(
                f"bg{i}", "background", [], priority=1,
                step_fn_factory=lambda mesh: (lambda: None)))
        tc = m.loop.TrainConfig(steps=STEPS, coordinator=coord, admit_every=2, ckpt_dir=ckpt0,
                                straggler_factor=1e6)
        return tc, None, lambda: (coord.last_admission.n_admitted, coord.last_admission.row(),
                                  [(e.kind, e.detail) for e in coord.events])

    rep, (n_admitted, row, events) = three_ways(scenario, world_of_one)
    assert rep.steps_done == STEPS
    assert 0 < n_admitted < 3, row  # marginal rejection
    assert [k for k, _ in events].count("admission") == 1  # logged once: stable roster


def test_train_loop_lease_gates_pump_and_bootstraps_on_acquire(ckpt0, world_of_one):
    def scenario(m):
        clk = {"t": 0.0}
        worker_end, coord_end = m.tr.fake_transport_pair()
        coord = _coord(m, 2, clk)
        mon = m.faults.HeartbeatMonitor(2, timeout=5.0, clock=lambda: clk["t"])
        loop = m.tr.CoordinatorLoop(coord_end, mon, coordinator=coord)
        lease = m.tr.CoordinatorLease(coord_end, 0, timeout=5.0, clock=lambda: clk["t"])
        m.tr.WorkerClient(worker_end, 1).beat(0)

        def advance_clock(step):
            clk["t"] = float(step)

        tc = m.loop.TrainConfig(steps=STEPS, coordinator=coord, heartbeat=mon,
                                transport=worker_end, control_loop=loop, lease=lease,
                                ckpt_dir=ckpt0, straggler_factor=1e6)
        return tc, advance_clock, lambda: (lease.holder, lease.epoch, sorted(coord.healthy),
                                           coord.foreground().plan.num_gpus)

    rep, after = three_ways(scenario, world_of_one)
    assert rep.steps_done == STEPS and after == (0, 1, [0], 1)
    for kind in ("coordinator_failover", "failure_detected", "replan"):
        assert rep.mitigations.count(kind) == 1, kind
