"""Training entrypoint of the port.

  python -m repro_torch.launch.train --arch ARCH [--steps N] [--batch B]
      [--seq S] [--ckpt-dir DIR] [--amp-limit A] [--device cuda|cpu]
      [--bg-arch qwen2-1.5b [--bg-arch minicpm-2b ...]]
      [--data N --model M] [--hb-timeout S] [--admit-every N]

Mirrors ``repro/launch/train.py --smoke``: first the burst plan of the
FULL config (``TRAIN_4K`` on 256 devices, ``--amp-limit``), what
production would run, then the arch's ``reduced()`` config trained by
``train.loop.train`` on the skewed-unigram synthetic data, with
checkpoint/restart when ``--ckpt-dir`` is given.  Trains every family —
``attn_mlp`` (pixtral-12b on vision batches of patches and text),
``moe``, ``rwkv6``, ``mamba2`` and the encoder-decoder seamless-m4t-large-v2
(frames in, decoder tokens out) — with the config's optimizer (AdamW, or
Adafactor for qwen2-72b and grok-1).  Runs on the card; ``--device cpu``
runs on the CPU.  The full config is trained by calling ``train()``
directly (as ``chip_smoke.py`` does).

``--data N --model M`` trains through the sharded step on an (N, M)
mesh, one process per position:

  python -m torch.distributed.run --nproc-per-node N*M \
      -m repro_torch.launch.train --arch ARCH --data N --model M

(NCCL and one card per process; with ``--device cpu``, gloo).  A world
of one needs no launcher: ``--data 1 --model 1`` alone runs the sharded
step on one card.  Rank 0 prints.

``--bg-arch`` (repeatable) enables DeepPool multiplexing: each background
job's steps are paced beside the foreground's, the first --bg-arch the
highest-priority tenant.  The foreground holds this process's card, so
on a one-card host every tenant takes the reference's same-device branch:
it shares the card, on a stream of its own of the least priority while
the foreground's has the greatest.

The live control plane is co-hosted, as in the reference: the worker
beats over a fake transport pair, a ``CoordinatorLoop`` consumes the beats
into a ``HeartbeatMonitor(1, timeout=--hb-timeout)`` and drives the
coordinator, so a silent worker is detected from live beats, and tenant
admission is re-swept every ``--admit-every`` steps (0 disables it).
Under ``--data N --model M`` the control plane is rank 0's.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools

# every --bg-arch tenant trains its arch's reduced config on BG_SEQ tokens,
# BG_PER_DEVICE_BATCH sequences per card of its slice
BG_SEQ, BG_PER_DEVICE_BATCH = 32, 2


def _bg_submeshes(fg_devices: int, amp_limit: float, hw, cfg, n: int, device):
    """Per-tenant plan-gap slices disjoint from the fg training card.

    The production plan assumes 256 devices, so the foreground graph is
    re-planned at the host's card count and its per-stage free device
    ranges — clipped to clear the fg prefix [0, fg_devices) — are packed
    into up to ``n`` disjoint chunks (``pack_ranges``, largest chunk to the
    first --bg-arch).  Falls back to the raw spare cards when the host plan
    leaves no usable gap.

    Returns (meshes, dropped): ``meshes`` has ``n`` entries where tenants
    beyond the packable chunk count get None (same-device fallback), and
    ``dropped`` lists those tenant indices explicitly — the caller must
    surface them, never silently vanish a requested tenant.
    """
    from repro_torch.configs import TRAIN_4K
    from repro_torch.core.plan import pack_ranges
    from repro_torch.core.planner import plan as make_plan
    from repro_torch.launch.mesh import host_devices, submesh_from_range
    from repro_torch.models.graph import build_lm_graph

    devs = host_devices(device)
    n_dev = len(devs)
    if n_dev <= fg_devices:
        return [None] * n, list(range(n))
    host_plan = make_plan(build_lm_graph(cfg, TRAIN_4K), n_dev, amp_limit, hw)
    free = []
    for si in range(len(host_plan.stages())):
        for lo, hi in host_plan.free_device_ranges(si):
            lo = max(lo, fg_devices)
            if hi - lo > 0:
                free.append((lo, hi))
    if not free:
        free = [(fg_devices, n_dev)]
    chunks = pack_ranges(free, n)
    meshes = [submesh_from_range(lo, hi, devices=devs) for lo, hi in chunks]
    dropped = list(range(len(meshes), n))
    return meshes + [None] * (n - len(meshes)), dropped


def _register_bg_jobs(coord, archs, meshes, fg_device):
    """Register each --bg-arch as a background Job WITH its step factory,
    and build its step.

    The factory goes through ``Job.step_fn_factory`` — ``background_tenants()``
    rosters only jobs carrying one — and its ``signature`` feeds the
    executable-cache key, scoping built steps per (arch, batch, seed).
    Tenants with a gap slice build ``bg_step_factory``'s step there;
    tenants without one (mesh None) build it on the foreground's card, on a
    stream of their own of the least priority, under a same-device
    factory that ignores its slice argument but carries a distinct
    signature.  Returns the per-tenant zero-arg bg step fns for the train
    loop's paced slot, in CLI (priority) order.
    """
    from repro_torch._device import priority_stream
    from repro_torch.core.coordinator import Job
    from repro_torch.launch.mesh import submesh_from_range
    from repro_torch.train.step import bg_step_factory

    bg_fns = []
    for i, (bg_arch, bg_mesh) in enumerate(zip(archs, meshes)):
        # the step's global batch is sized to the tenant's own chunk width
        # (per-device batch), not a one-size-fits-all quantum
        build = bg_step_factory(bg_arch, seq=BG_SEQ, seed=1 + i,
                                per_device_batch=BG_PER_DEVICE_BATCH)
        if bg_mesh is not None:
            own = dataclasses.replace(
                bg_mesh, stream=priority_stream(bg_mesh.device, urgent=False))
            bg_fns.append(build(own))
            factory = build
            ids = sorted(d.index for d in own.devices)
            print(f"bg tenant {i} ({bg_arch}) on disjoint submesh "
                  f"devices {ids} (batch {BG_PER_DEVICE_BATCH}/device)")
        else:
            same = submesh_from_range(0, 1, devices=[fg_device],
                                      stream=priority_stream(fg_device, urgent=False))
            same_device_fn = build(same)

            def factory(mesh, fn=same_device_fn):
                return fn

            factory.signature = (f"{bg_arch}-samedev-b{BG_PER_DEVICE_BATCH}-s{BG_SEQ}"
                                 f"-r{1 + i}")
            bg_fns.append(same_device_fn)
            print(f"bg tenant {i} ({bg_arch}) same-device fallback")
        # register the tenant with the coordinator (priority: CLI order,
        # first --bg-arch highest) so collocate()/re-plans/admission
        # actually roster it
        coord.submit_background(
            Job(f"bg{i}-{bg_arch}", "background", [],
                priority=len(archs) - i, step_fn_factory=factory)
        )
    return bg_fns


def round_robin(bg_fns):
    """One zero-arg bg step fn for the train loop's single paced slot:
    the tenants in turn, highest priority first within each cycle."""
    if len(bg_fns) == 1:
        return bg_fns[0]
    cycle = itertools.cycle(bg_fns)

    def bg_fn():
        return next(cycle)()

    return bg_fn


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--bg-arch", action="append", default=None,
                    help="background tenant arch; repeat for multiple "
                         "tenants (first = highest priority)")
    ap.add_argument("--amp-limit", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--data", type=int, default=None,
                    help="data axis of the mesh (with --model): the sharded step")
    ap.add_argument("--model", type=int, default=None, help="model axis of the mesh")
    ap.add_argument("--hb-timeout", type=float, default=10.0,
                    help="heartbeat timeout (s) before a silent worker is "
                         "declared failed by the live control plane")
    ap.add_argument("--admit-every", type=int, default=5,
                    help="re-sweep tenant admission every N steps "
                         "(continuous admission; 0 disables)")
    args = ap.parse_args(argv)
    if (args.data is None) != (args.model is None):
        ap.error("--data and --model go together")

    import torch

    from repro_torch._device import resolve_device

    device = resolve_device(args.device)  # no card: raise before any work
    mesh = None
    if args.data is not None:
        mesh, device = _process_mesh(args.data, args.model, device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        _run(args, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _process_mesh(data: int, model: int, device):
    """This process's rank joins the group (``torch.distributed.run``'s
    environment, or a world of one without it) and the (data, model) mesh
    is built over every rank.  Returns (mesh, this rank's device)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group(backend)
    elif data * model == 1:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise SystemExit(f"--data {data} --model {model} needs {data * model} processes: "
                         f"run it under python -m torch.distributed.run "
                         f"--nproc-per-node {data * model}")
    if dist.get_world_size() != data * model:
        raise SystemExit(f"--data {data} --model {model} needs {data * model} ranks, "
                         f"got {dist.get_world_size()}")
    return make_mesh(data, model), device


def _run(args, device, mesh):
    import torch.distributed as dist

    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.core.coordinator import ClusterCoordinator, Job
    from repro_torch.dist.faults import HeartbeatMonitor
    from repro_torch.dist.transport import CoordinatorLoop, fake_transport_pair
    from repro_torch.models.graph import build_lm_graph
    from repro_torch.train.loop import TrainConfig, train

    lead = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch)
    # burst-parallel plan for the FULL config (what production would run)
    coord = ClusterCoordinator(256)
    plan = coord.submit_foreground(
        Job(args.arch, "foreground", build_lm_graph(cfg, TRAIN_4K),
            amp_limit=args.amp_limit))
    if lead:
        print(plan.summary())

    bg_fn = None
    if args.bg_arch:
        archs = list(args.bg_arch)
        meshes, dropped = _bg_submeshes(1, args.amp_limit, coord.hw, cfg, len(archs),
                                        device)
        if dropped:
            # a requested tenant must never vanish silently: say exactly
            # which --bg-arch lost its gap submesh and what happens instead
            print(
                "WARNING: no gap submesh for bg tenant(s) "
                + ", ".join(f"{i} ({archs[i]})" for i in dropped)
                + f" — the plan's gaps packed only {len(archs) - len(dropped)}"
                f" chunk(s); dropped tenants fall back to same-device jit "
                f"(they share the fg devices instead of a disjoint submesh)"
            )
        bg_fn = round_robin(_register_bg_jobs(coord, archs, meshes, device))

    shape = dataclasses.replace(TRAIN_4K, seq_len=args.seq, global_batch=args.batch,
                                name="cli")
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, bg_step_fn=bg_fn)
    if lead:
        # live control plane: this entrypoint co-hosts both sides — the
        # worker beats over the transport, the CoordinatorLoop consumes
        # them, so a stalled worker is detected from live beats (handle_failure
        # + re-plan + reconfig event) instead of only via the fail-stop path.
        # Multi-host runs swap the fake pair for KVStoreTransport over a store
        worker_end, coord_end = fake_transport_pair()
        hb = HeartbeatMonitor(1, timeout=args.hb_timeout)
        tc = dataclasses.replace(
            tc, coordinator=coord, heartbeat=hb, transport=worker_end,
            control_loop=CoordinatorLoop(coord_end, hb, coordinator=coord),
            admit_every=max(0, args.admit_every))
    report = train(cfg.reduced(), shape, tc, device=device, mesh=mesh)
    if not lead:
        return
    print(f"control plane: worker 0 last beat at step {hb.last[0][1]}, "
          f"{len(coord.healthy)} of {coord.num_devices} devices healthy")
    if mesh is not None:
        print(f"sharded step on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    print(f"done on {args.device}: steps={report.steps_done} loss "
          f"{report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"restarts={report.restarts} mitigations={len(report.mitigations)} "
          f"mean_step={1e3 * sum(report.step_times) / len(report.step_times):.1f} ms "
          f"bg_steps={report.bg_steps}")


if __name__ == "__main__":
    main()
