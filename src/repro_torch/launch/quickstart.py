"""Quickstart of the port: plan a burst-parallel schedule for an assigned
architecture, inspect its gaps, simulate collocation, then train the
reduced model for a few real steps.

  python -m repro_torch.launch.quickstart [--arch llama3-8b] [--device cuda|cpu]

Step for step ``examples/quickstart.py`` (the JAX reference): the burst
plan of the production shape (``TRAIN_4K``) on 256 simulated H100s
(``costmodel.H100``) at amplification limit 2.0, the idle gap it leaves,
the discrete-event collocation of a background job into those gaps, and
10 training steps of ``cfg.reduced()`` at 4 x 64 tokens through
``train.loop.train``.  The steps run on the card; ``--device cpu`` runs
them on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses

N_DEVICES = 256


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quickstart")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the training steps; the default needs a CUDA card")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.core.coordinator import ClusterCoordinator, Job
    from repro_torch.core.costmodel import H100
    from repro_torch.core.multiplex import MultiplexConfig
    from repro_torch.models.graph import build_lm_graph
    from repro_torch.train.loop import TrainConfig, train

    device = resolve_device(args.device)  # no card: raise before any work
    cfg = get_config(args.arch)
    print(f"=== {cfg.name}: {cfg.n_params()/1e9:.1f}B params ===\n")

    # 1. burst-parallel plan for the production shape on 256 cards
    coord = ClusterCoordinator(N_DEVICES, H100)
    plan = coord.submit_foreground(
        Job(args.arch, "foreground", build_lm_graph(cfg, TRAIN_4K), amp_limit=2.0)
    )
    print(plan.summary())
    print(f"idle gaps: {plan.idle_gpu_sec():.3f} GPU-s/iter "
          f"({100*plan.idle_gpu_sec()/(plan.total_time*N_DEVICES):.1f}% of the cluster)\n")

    # 2. multiplex a background job into the gaps (discrete-event model)
    res = coord.simulate_collocation(MultiplexConfig())
    print(f"collocation: fg_slowdown={res.fg_slowdown:.3f} "
          f"bg_steps/iter={res.bg_steps_per_iter:.1f} "
          f"cluster_util={res.cluster_throughput:.2f}\n")

    # 3. real training of the reduced config on the device
    shape = dataclasses.replace(TRAIN_4K, seq_len=64, global_batch=4)
    report = train(cfg.reduced(), shape, TrainConfig(steps=10), device=device)
    print(f"smoke train on {device.type}: loss {report.losses[0]:.3f} -> "
          f"{report.losses[-1]:.3f} ({report.steps_done} steps)")
    return plan, res, report


if __name__ == "__main__":
    main()
