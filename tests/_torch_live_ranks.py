"""Applied reconfiguration over four ranks: the reference's live loop and
the port's, each writing its record as JSON.

    python tests/_torch_live_ranks.py ckpt OUT_DIR
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_live_ranks.py reference OUT_DIR
    python tests/_torch_live_ranks.py ranks OUT_DIR

Run by ``tests/test_torch_live_reconfig.py``.  ``ckpt`` writes the
reference's initial state as a step-0 checkpoint under ``OUT_DIR/ckpt0``,
which both sides restore.  The script: a coordinator of 4 virtual devices
on a clock that reads the step, ``HeartbeatMonitor(1, timeout=5)``,
phantoms 2 and 3 that beat once over the fake pair and fall silent, the
co-hosted ``CoordinatorLoop`` and ``apply_reconfig``.  Both phantoms are
detected after step 5, the pool becomes [0, 1], and at the next epoch
boundary the (4, 1) mesh is re-carved to (2, 1).

``reference`` runs the reference's ``train()`` on an Auto-axis (4, 1)
``jax.sharding.Mesh`` of forced host devices, its ``remesh_for_pool``
replaced by the same carving over Auto axes (its own builds Explicit
axes, where the step raises; ROADMAP Queue 3).  ``ranks`` spawns four gloo
ranks of the port, which meet through a file under ``OUT_DIR``; rank 0
holds the control plane, every rank runs ``train(..., mesh=)``, and each
writes ``rank-<r>.json`` (a failing rank writes ``error-<r>.txt``).
"""
import dataclasses
import json
import os
import sys
import traceback

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
STEPS, BATCH, SEQ = 8, 8, 64
PHANTOMS = (2, 3)


def _cfg(get_config):
    return dataclasses.replace(get_config("qwen2-1.5b").reduced(), dtype="float32")


def _shape(train_4k):
    return dataclasses.replace(train_4k, seq_len=SEQ, global_batch=BATCH, name="smoke")


def _control_plane(pkg):
    """(coordinator, monitor, worker end, loop, injector) of package
    ``pkg`` (``repro`` or ``repro_torch``) on a clock that reads the step;
    the foreground is VGG-16's graph on the paper's A100."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    coordinator, faults, transport = mod("core.coordinator"), mod("dist.faults"), \
        mod("dist.transport")
    clk = {"t": 0.0}
    coord = coordinator.ClusterCoordinator(4, mod("core.costmodel").A100,
                                           clock=lambda: clk["t"], virtual_devices=True)
    coord.submit_foreground(coordinator.Job(
        "fg", "foreground", mod("models.graph").build_vgg_graph(mod("configs.vgg16").CONFIG, 32),
        amp_limit=1.5))
    worker_end, coord_end = transport.fake_transport_pair()
    mon = faults.HeartbeatMonitor(1, timeout=5.0, clock=lambda: clk["t"])
    loop = transport.CoordinatorLoop(coord_end, mon, coordinator=coord)
    for w in PHANTOMS:
        transport.WorkerClient(worker_end, w).beat(0)

    def advance_clock(step):
        clk["t"] = float(step)

    return coord, mon, worker_end, loop, advance_clock


def _record(report, coord=None):
    return {"losses": report.losses, "steps_done": report.steps_done,
            "remeshes": report.remeshes, "left_mesh": getattr(report, "left_mesh", False),
            "events": [{k: ("*" if k in ("dt", "err") else v) for k, v in e.items()}
                       for e in report.mitigations.events],
            "healthy": sorted(coord.healthy) if coord is not None else None}


def write_ckpt(out):
    import jax

    from repro.checkpoint import ckpt
    from repro.configs import get_config
    from repro.models import get_model
    from repro.optim.optimizer import make_optimizer
    from repro.train.state import init_state

    cfg = _cfg(get_config)
    state = init_state(jax.random.PRNGKey(0), get_model(cfg), make_optimizer(cfg, STEPS))
    ckpt.save(os.path.join(out, "ckpt0"), state, 0,
              extra_meta={"data": {"seed": 0, "step": 0}}, async_=False)


def run_reference(out):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import repro.train.loop as loop_mod
    from repro.configs import TRAIN_4K, get_config
    from repro.launch.mesh import pow2_mesh_shape

    devs = jax.devices()
    assert len(devs) == 4, devs

    def auto_remesh(device_ids, devices=None):
        local = [devs[int(i)] for i in device_ids if 0 <= int(i) < len(devs)]
        data, model = pow2_mesh_shape(len(local))
        return Mesh(np.array(local[: data * model]).reshape(data, model), ("data", "model"))

    loop_mod.remesh_for_pool = auto_remesh
    coord, mon, worker_end, cloop, injector = _control_plane("repro")
    tc = loop_mod.TrainConfig(steps=STEPS, coordinator=coord, heartbeat=mon,
                              transport=worker_end, control_loop=cloop, apply_reconfig=True,
                              ckpt_dir=os.path.join(out, "ckpt0"), straggler_factor=1e6)
    mesh = Mesh(np.array(devs).reshape(4, 1), ("data", "model"))
    rep = loop_mod.train(_cfg(get_config), _shape(TRAIN_4K), mesh, tc,
                         fault_injector=injector)
    with open(os.path.join(out, "reference.json"), "w") as f:
        json.dump(_record(rep, coord), f)


def _rank(rank, out):
    try:
        import torch.distributed as dist

        from repro_torch.configs import TRAIN_4K, get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.train.loop import TrainConfig, train

        dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'pg')}",
                                rank=rank, world_size=4)
        mesh = make_mesh(4, 1)
        tc = TrainConfig(steps=STEPS, apply_reconfig=True,
                         ckpt_dir=os.path.join(out, "ckpt0"), straggler_factor=1e6)
        coord, injector = None, None
        if rank == 0:
            coord, mon, worker_end, cloop, injector = _control_plane("repro_torch")
            tc = dataclasses.replace(tc, coordinator=coord, heartbeat=mon,
                                     transport=worker_end, control_loop=cloop)
        rep = train(_cfg(get_config), _shape(TRAIN_4K), tc, fault_injector=injector,
                    device="cpu", mesh=mesh)
        with open(os.path.join(out, f"rank-{rank}.json"), "w") as f:
            json.dump(_record(rep, coord), f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(out):
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(out,), nprocs=4)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    mode, out_dir = sys.argv[1], sys.argv[2]
    {"ckpt": write_ckpt, "reference": run_reference, "ranks": run_ranks}[mode](out_dir)
