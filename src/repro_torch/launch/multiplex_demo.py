"""Real fg/bg multiplexed execution: the foreground plan's stages run on
their slice while REAL background LM training steps from TWO prioritized
tenants are paced into the plan's gaps through the Collocator (the
executable multi-tenant path of paper §5 — the cluster-throughput
setting).

  python -m repro_torch.launch.multiplex_demo [--device cuda|cpu]

The port of ``examples/multiplex_demo.py``: VGG-16's burst plan on 8
positions (the paper's setting, ``A100`` cost model), two tenants from
``bg_step_factory``, the admission sweep, the carving, ``run_executable``
and the calibrated prediction.  It runs the paper's GPU mode
(``MultiplexConfig.collocate_same_device``): every position is the one
card, the foreground stages on a stream of the greatest priority and each
tenant chunk on its own stream of the least.  ``--device cpu`` runs the
same loop on the CPU.
"""
from __future__ import annotations

import argparse

# the two prioritized tenants: (job, priority, seed), each training a
# reduced TENANT_ARCH on TENANT_SEQ tokens, TENANT_BATCH sequences per
# position of its gap chunk
ROSTER = (("bg-hi", 2, 0), ("bg-lo", 1, 1))
TENANT_ARCH, TENANT_SEQ, TENANT_BATCH = "qwen2-1.5b", 8, 2


def demo_plan():
    """VGG-16's burst plan on 8 devices (the paper's setting, ``A100``)."""
    from repro_torch.configs.vgg16 import CONFIG as VCFG
    from repro_torch.core.costmodel import A100
    from repro_torch.core.planner import plan
    from repro_torch.models.graph import build_vgg_graph

    return plan(build_vgg_graph(VCFG, 32), 8, amp_limit=1.5, hw=A100)


def demo_tenants(on_loss=None):
    """``ROSTER``'s tenants, each with its ``bg_step_factory``."""
    from repro_torch.core.multiplex import BgTenant
    from repro_torch.train.step import bg_step_factory

    return [BgTenant(job, prio, bg_step_factory(TENANT_ARCH, seq=TENANT_SEQ, seed=seed,
                                                on_loss=on_loss,
                                                per_device_batch=TENANT_BATCH))
            for job, prio, seed in ROSTER]


def stand_in_stage(stage, mesh):
    """A foreground stage: stand-in compute kernels on the stage's slice
    and stream (the input is made on that stream, as every stage call is
    issued there)."""
    import torch

    with torch.cuda.stream(mesh.stream):  # no-op for None (the CPU)
        x = torch.full((256, 256), 0.01, dtype=torch.float32, device=mesh.device)

    def f():
        y = x
        for _ in range(8):
            y = torch.tanh(y @ y) * 0.1 + 0.01
        return y

    return f


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.multiplex_demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    args = ap.parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core.multiplex import Collocator, MultiplexConfig

    device = resolve_device(args.device)  # no card: raise before any work
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    # foreground plan (VGG-16 @ 8 devices, the paper's setting)
    fg_plan = demo_plan()
    print(fg_plan.summary())

    # two prioritized background tenants: each gap's free positions are
    # packed largest-chunk-to-highest-priority, every tenant training a REAL
    # tiny LM on its own slice and stream with a private state replica.
    # Each tenant's step is sized to its own chunk width (per-device batch)
    # instead of one global gap-minimum quantum.
    losses = []
    tenants = demo_tenants(on_loss=losses.append)
    col = Collocator(fg_plan, MultiplexConfig(max_inflight=2, collocate_same_device=True),
                     tenants=tenants, devices=[device] * fg_plan.num_gpus)
    # admission control: sweep candidate tenant counts through predict()
    # BEFORE building anything — the argmax-cluster-throughput roster under
    # the paper's 1.33x QoS bound is what actually runs
    decision = col.admit()
    print("admission:", decision.row())
    print("tenant schedule (stage, tenant, bg steps):",
          col.schedule_tenants())
    split = col.submeshes()
    for si, slots in sorted(split.bg_tenants.items()):
        carve = " ".join(
            f"{tenants[i].job}=[{rng[0]},{rng[1]})"
            for i, entry in enumerate(slots) if entry is not None
            for rng, _m in (entry,)
        )
        print(f"  stage {si}: fg devices {split.stage_fg_range[si]} "
              f"bg {carve}")

    res = col.run_executable(stand_in_stage, iterations=5,
                             tenants=list(decision.admitted))
    print(res.row())
    print(f"fg iter {res.fg_iter_time*1e3:.1f} ms "
          f"(isolated {res.fg_iter_time_isolated*1e3:.1f} ms) "
          f"jain_fairness={res.jain_fairness():.3f}")
    for t in res.tenants:
        print(f"  {t.row()} (weight {t.weight:g}, deficit {t.deficit:.1f})")
    n_submeshes = sum(
        sum(1 for e in s if e is not None) for s in split.bg_tenants.values()
    )
    print(f"{len(losses)} real bg train steps dispatched across "
          f"{n_submeshes} tenant gap submeshes (independent model replicas; "
          f"includes one warmup step per replica)")
    # per-stage calibration: fit the per-gap-op inflation vector from the
    # measured result and show the (device-free) prediction tracking it
    model = col.calibrate([res])
    pred = col.predict()
    print(f"calibrated gap_inflation={model.gap_inflation:.3f} "
          f"per-stage={dict(model.gap_inflation_stages)} -> "
          f"predict fg_slowdown={pred.fg_slowdown:.3f} "
          f"(measured {max(res.fg_slowdown, 1.0):.3f})")
    return col, res, pred, losses


if __name__ == "__main__":
    main()
