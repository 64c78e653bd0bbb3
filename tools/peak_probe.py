#!/usr/bin/env python3
"""What moves a rank's peak memory: the counters or the allocator's cache.

    python3 tools/peak_probe.py [--arch ARCH] [--shape SHAPE] [OVERRIDE ...]

Runs rank 0's step of ``ARCH`` x ``SHAPE`` (default seamless-m4t-large-v2
``train_4k``) on the (16, 16) production mesh on one card, as
``chip_smoke.py`` phases 14b, 15b and 17 do (rank 0 of a fake 256-rank
world, full width and depth), once for each OVERRIDE (a JSON object of
config fields; default ``{}`` and ``{"sequence_parallel": true}``).  Each
takes six steps in turn and prints ``torch.cuda.max_memory_allocated`` of
each, net of what was allocated before the state was built:

  - plain steps (the step function alone) and counted steps (under
    ``launch.op_analysis.analyze_step``, as the held steps run; these also
    print the counter's own peak);
  - each from an emptied cache (``chip_smoke._fresh_allocator``, as the
    held steps start) or from the cache the previous step left (warm).

Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def probe(cfg, shape, smi) -> list:
    """The six steps' ``(what, peak bytes net[, the counter's peak])``."""
    import torch

    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.op_analysis import analyze_step

    c._free_card()
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    with fake_world(256, "cuda"):
        base = torch.cuda.memory_allocated()
        fn, first, batch = c.rank_step(cfg, shape, make_production_mesh(), "cuda", gen)

        def step(what, fresh, counted):
            if fresh:
                c._fresh_allocator()
            else:
                torch.cuda.reset_peak_memory_stats()
            if counted:
                costs = analyze_step(fn, first, batch)
                torch.cuda.synchronize()
                rows.append((what, torch.cuda.max_memory_allocated() - base, costs.peak_bytes))
                costs.out = None
            else:
                out = fn(first, batch)
                torch.cuda.synchronize()
                rows.append((what, torch.cuda.max_memory_allocated() - base))
                del out

        step("plain, emptied cache", True, False)
        step("plain, warm", False, False)
        step("counted, emptied cache", True, True)
        step("plain after counted, warm", False, False)
        step("counted, warm", False, True)
        step("plain, emptied cache again", True, False)
        del first, batch
    c._free_card()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="seamless-m4t-large-v2")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("overrides", nargs="*", default=["{}", '{"sequence_parallel": true}'])
    args = ap.parse_args()
    _, smi = c.phase_device()
    c.phase_build()
    import torch

    from repro_torch.configs import SHAPES, get_config

    for dt in (torch.bfloat16, torch.float32):  # the library's workspaces first
        a = torch.ones(64, 64, device="cuda", dtype=dt, requires_grad=True)
        (a @ a).sum().backward()
    del a
    for over in args.overrides:
        cfg = dataclasses.replace(get_config(args.arch), **json.loads(over))
        rows = probe(cfg, SHAPES[args.shape], smi)
        print(f"peak_probe {args.arch} {args.shape} {over} on {smi}: " + json.dumps(rows),
              flush=True)


if __name__ == "__main__":
    main()
