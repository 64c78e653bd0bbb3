"""Burst-parallel planning across every assigned architecture: plans, stage
structure, gaps, amplification, and the DP-vs-BP comparison.

  python -m repro_torch.launch.burst_plan_demo

Step for step ``examples/burst_plan_demo.py`` (the JAX reference), with the
port's planner: the production shape (``TRAIN_4K``) of each assigned
architecture on 256 simulated devices, data-parallel against burst-parallel
at amplification limit 2.0; zamba2-2.7b's stages; the branch placement of
an Inception-style DAG on 64 devices; seamless-m4t-large-v2's encoder /
decoder join on 64.  The planner only: nothing runs on a device.  Plans use
the port's default ``Hardware()``, the H100 (``costmodel.H100``); the
reference's default is its TPU entry, which the port does not carry, so the
two print the same text when both plan on the same hardware (the paper's
``A100`` is in both).
"""
from __future__ import annotations

import dataclasses

G = 256


def main(argv=None):
    from repro_torch.configs import ASSIGNED_ARCHS, TRAIN_4K, get_config
    from repro_torch.core.planner import _dp_plan, plan
    from repro_torch.models.graph import build_lm_graph

    print(f"{'arch':24s} {'DP iter':>9s} {'BP iter':>9s} {'gain':>6s} "
          f"{'amp':>5s} {'stages':>6s} {'idle%':>6s}")
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        g = build_lm_graph(cfg, TRAIN_4K)
        dp = _dp_plan(g, G, None)
        bp = plan(g, G, amp_limit=2.0)
        idle = 100 * bp.idle_gpu_sec() / (bp.total_time * G)
        print(f"{arch:24s} {dp.total_time*1e3:8.1f}ms {bp.total_time*1e3:8.1f}ms "
              f"{dp.total_time/bp.total_time:5.2f}x {bp.amplification:5.2f} "
              f"{len(bp.stages()):6d} {idle:5.1f}%")
    print("\nper-stage detail for zamba2-2.7b (SSM scan limits sample-split):")
    bp = plan(build_lm_graph(get_config("zamba2-2.7b"), TRAIN_4K), G, amp_limit=2.0)
    print(bp.summary())

    dag_demo()
    encdec_demo()


def dag_demo():
    """Branch-parallel DAG placement: Inception-style blocks get per-branch
    device ranges (critical branch at [0, peak), parallel branches stacked
    onto the block's idle devices)."""
    from repro_torch.core.planner import plan
    from repro_torch.models.graph import build_inception_like_graph

    print("\nDAG placement for an Inception-style graph @ 64 devices:")
    bp = plan(build_inception_like_graph(32, n_blocks=3), 64, amp_limit=2.0)
    for name, placements in sorted(bp.block_details.items()):
        print(f"  {name}:")
        for p in placements:
            tag = "critical" if p.critical else ("parallel" if p.parallel else "sequential")
            print(f"    branch {p.branch} [{tag:>10s}] devices "
                  f"[{p.device_start},{p.device_end}) scales={p.scales} "
                  f"t={p.time*1e6:.1f}us")


def encdec_demo():
    """Two-chain DAG: encoder + decoder joined by a resharding cross-edge."""
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.core.planner import plan
    from repro_torch.models.graph import build_encdec_graph

    cfg = get_config("seamless-m4t-large-v2")
    shape = dataclasses.replace(TRAIN_4K, seq_len=1024, global_batch=16, name="demo")
    eg = build_encdec_graph(cfg, shape)
    bp = plan(eg, 64, amp_limit=2.0)
    j = bp.block_details["encdec_join"]
    print(f"\nenc-dec cross-edge plan for {cfg.name} @ 64 devices:")
    print(f"  encoder exits at g={j['encoder_exit_gpus']}, decoder enters at "
          f"g={j['decoder_entry_gpus']}, reshard join "
          f"{j['reshard_time']*1e6:.1f}us over "
          f"{j['cross_act_bytes']/2**20:.1f} MiB of encoder memory")
    print(f"  iter={bp.total_time*1e3:.2f} ms amp={bp.amplification:.2f} "
          f"stages={len(bp.stages())}")


if __name__ == "__main__":
    main()
