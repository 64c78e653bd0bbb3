"""Multi-pod dry-run: every (arch x shape x mesh) cell run once on fake
tensors, counted as it runs.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell for 256 or 512 forced host devices.  The port compiles nothing,
so it runs the cell instead, as rank 0 of a fake process group
(``launch.mesh.fake_world``) of 256 (``single``, the (16, 16) mesh) or 512
(``multi``, (2, 16, 16)) ranks whose collectives move nothing, on fake
tensors (``FakeTensorMode``) that hold shapes and no memory.  For each
cell it builds the production mesh, places fake state and inputs by the
step's shardings, and calls the port's real step once: ``jit_train_step``
(the loss, its gradient and the optimizer) for train shapes,
``jit_forward`` for prefill, ``jit_decode_step`` for decode.  The
counters of ``launch/op_analysis.py`` record FLOPs (the kernels' formulas
included), bytes written, collective bytes by kind and the peak of live
memory, all per device.

The fake tensors are of the device the dry-run models (``--device``):
``cuda`` where torch is built with CUDA, so every branch the card takes is
taken, and the kernels' registered operators answer with their fake
implementations; ``meta`` on a build without CUDA, where autograd cannot
hold a fake CUDA tensor: the port sends meta tensors down the card's path
(the flash, SSD and WKV-6 operators), so the counts are the card's.

The JSONL record keeps the reference's keys where the meaning carries over:
``arch``, ``shape``, ``mesh``, ``n_devices``, ``kind``,
``argument_bytes`` (state or parameters, and inputs; recorded also as
``argument_bytes_state`` and ``argument_bytes_batch``), ``output_bytes``
(outputs in storages of their own: an update in place writes into its
argument), ``temp_bytes`` (the peak less both), ``peak_bytes`` (the
largest sum of live storages, each rounded up to the CUDA caching
allocator's 512-byte block: what ``torch.cuda.max_memory_allocated``
would read), ``collective_bytes`` (per kind), ``collective_bytes_total``,
``collective_diag`` (operator counts), ``n_params``, ``dropped_rules``,
``rules_override``, ``cfg_override``.  The reference's ``hlo_flops_raw``
and ``hlo_dot_flops`` become ``flops`` (``FlopCounterMode``, which counts
what the step dispatched) with ``flops_by_op``; ``hlo_bytes_written``
becomes ``bytes_written``; ``hlo_bytes_raw`` (bytes accessed) has no
counterpart; ``scan_trip_count`` has none either, since eager execution
dispatches every layer; ``lower_s`` and ``compile_s`` become ``run_s``, the
wall time of the fake call.  ``device`` names the modelled device.

Every production cell runs, and so does every layout the overrides give
(``--cfg-override '{"sequence_parallel": true}'``, ``--rules-override
'{"norm": ["model"]}'``, ...).  A layout no model computes on (an input
split along its sequence over another axis than 'model', a batch split
over 'model': ``ValueError``) fails: its message is printed and the
command exits 1, as do ``--all`` sweeps with a failed cell.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results.jsonl]

``--all`` runs each cell in a fresh subprocess (one failing cell does not
stop the sweep) and appends JSONL records.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

WORLD = {"single": 256, "multi": 512}
DEVICES = ("cuda", "meta")  # what a dry-run models: the card, or meta tensors on its path


def default_device() -> str:
    """``cuda`` where torch is built with CUDA, else ``meta``."""
    import torch

    return "cuda" if torch.backends.cuda.is_built() else "meta"


def _fake_tree(tree, device, requires_grad=False):
    """Fake tensors of ``tree``'s shapes and dtypes on ``device`` (call
    inside ``FakeTensorMode``)."""
    import torch

    from repro_torch.models.layers import tree_map

    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
                    .requires_grad_(requires_grad), tree)


def run_step(cfg, shape, mesh, device, rules=None, report=None) -> dict:
    """One cell on ``mesh`` (a ``DeviceMesh`` of a ``fake_world``): the
    step of ``shape.kind`` on fake state and inputs placed by its
    shardings, under the counters.  Returns the record's measured fields."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.sharding import device_put
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.models.api import get_model, input_specs
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.step import jit_decode_step, jit_forward, jit_train_step

    api = get_model(cfg)
    specs = input_specs(cfg, shape)
    with FakeTensorMode():
        if shape.kind == "train":
            opt = make_optimizer(cfg)
            fn, st_sh, bt_sh = jit_train_step(api, opt, mesh, shape, rules=rules, report=report)
            params = _fake_tree(api.abstract(), device, requires_grad=True)
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32, device=device)}
            first = device_put(state, st_sh)
        else:
            make = jit_forward if shape.kind == "prefill" else jit_decode_step
            fn, p_sh, bt_sh = make(api, mesh, shape, rules=rules, report=report)
            first = device_put(_fake_tree(api.abstract(), device), p_sh)
        batch = device_put(_fake_tree(specs, device), bt_sh)
        t0 = time.perf_counter()
        costs = analyze_step(fn, first, batch)
        run_s = time.perf_counter() - t0
    state_bytes, batch_bytes = costs.argument_bytes
    return {
        "argument_bytes": state_bytes + batch_bytes,
        "argument_bytes_state": state_bytes,
        "argument_bytes_batch": batch_bytes,
        "output_bytes": costs.output_bytes,
        "temp_bytes": max(0, costs.peak_bytes - state_bytes - batch_bytes
                          - costs.output_bytes),
        "peak_bytes": costs.peak_bytes,
        "flops": costs.flops,
        "flops_by_op": costs.flops_by_op,
        "bytes_written": costs.bytes_written,
        "collective_bytes": costs.collectives,
        "collective_bytes_total": costs.collective_bytes,
        "collective_diag": costs.diag,
        "run_s": round(run_s, 2),
    }


def _record(arch: str, shape_name: str, mesh_kind: str, rules_override=None,
            cfg_override=None, device=None) -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist.sharding import RuleReport, sharding_rules
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    device = device or default_device()
    if device not in DEVICES:  # CPU tensors take the plain versions, not the card's kernels
        raise ValueError(f"a dry-run models the card: device cuda or meta, not {device}")
    if device == "cuda" and default_device() != "cuda":
        raise SystemExit("--device cuda needs torch built with CUDA (autograd cannot hold "
                         "fake CUDA tensors without it): use --device meta")
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = SHAPES[shape_name]
    with fake_world(WORLD[mesh_kind], device):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        n_dev = mesh.size()
        report = RuleReport()
        rules = sharding_rules(cfg, mesh, shape)
        if rules_override:
            rules.update({k: tuple(v) for k, v in rules_override.items()})
        rec = run_step(cfg, shape, mesh, device, rules=rules, report=report)

    print(f"=== {arch} × {shape_name} × {mesh_kind} ({n_dev} devices, fake {device}) ===")
    print(f"memory: args={rec['argument_bytes'] / 1e9:.3f} GB "
          f"out={rec['output_bytes'] / 1e9:.3f} GB temp={rec['temp_bytes'] / 1e9:.3f} GB "
          f"peak={rec['peak_bytes'] / 1e9:.3f} GB per device")
    print(f"ops: flops={rec['flops']:.3e} bytes_written={rec['bytes_written']:.3e} "
          f"in {rec['run_s']} s")
    print(f"collectives (per-device bytes/step): "
          f"{ {k: f'{v:.3e}' for k, v in rec['collective_bytes'].items()} }")
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "n_devices": int(n_dev),
        "kind": shape.kind, "device": device, **rec,
        "n_params": int(cfg.n_params()),
        "dropped_rules": [list(map(str, d)) for d in report.dropped],
        "rules_override": rules_override or {}, "cfg_override": cfg_override or {},
    }


def run_cell(arch, shape_name, mesh_kind, out_path=None, rules_override=None,
             cfg_override=None, device=None):
    rec = _record(arch, shape_name, mesh_kind, rules_override, cfg_override, device)
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def enumerate_cells(mesh_kinds):
    from repro_torch.configs import ASSIGNED_ARCHS, get_config, shapes_for

    for arch in ASSIGNED_ARCHS:
        for shape in shapes_for(get_config(arch)):
            for mk in mesh_kinds:
                yield arch, shape.name, mk


def _done_cells(out_path):
    done = set()
    try:
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass
    except FileNotFoundError:
        pass
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun.jsonl")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--rules-override", default=None,
                    help="JSON dict of logical-axis rule overrides (hillclimb)")
    ap.add_argument("--cfg-override", default=None,
                    help="JSON dict of ModelConfig field overrides (hillclimb)")
    ap.add_argument("--device", default=None, choices=DEVICES,
                    help="device type of the fake tensors (default: cuda where torch is "
                         "built with CUDA, else meta)")
    args = ap.parse_args(argv)
    if args.out and os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)

    if args.all:
        mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        done = _done_cells(args.out)
        cells = [c for c in enumerate_cells(mesh_kinds) if c not in done]
        print(f"dry-run sweep: {len(cells)} cells to go ({len(done)} done)")
        failures = []
        for arch, shape, mk in cells:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", mk, "--out", args.out]
            if args.device:
                cmd += ["--device", args.device]
            print(f"--> {arch} × {shape} × {mk}", flush=True)
            try:
                r = subprocess.run(cmd, timeout=args.timeout, capture_output=True, text=True)
                if r.returncode != 0:
                    failures.append((arch, shape, mk, r.stderr[-2000:]))
                    print(f"FAILED: {arch} × {shape} × {mk}\n{r.stderr[-2000:]}", flush=True)
                else:
                    print(r.stdout.strip().splitlines()[-3] if r.stdout.strip() else "",
                          flush=True)
            except subprocess.TimeoutExpired:
                failures.append((arch, shape, mk, "timeout"))
                print(f"TIMEOUT: {arch} × {shape} × {mk}", flush=True)
        print(f"sweep done: {len(cells) - len(failures)} ok, {len(failures)} failed")
        for f in failures:
            print("FAIL:", f[0], f[1], f[2])
        return 1 if failures else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    if args.mesh == "both":
        ap.error("--mesh both needs --all")
    override = json.loads(args.rules_override) if args.rules_override else None
    cfg_over = json.loads(args.cfg_override) if args.cfg_override else None
    try:
        run_cell(args.arch, args.shape, args.mesh, args.out, override, cfg_over, args.device)
    except (NotImplementedError, ValueError) as e:
        print(f"FAILED: {args.arch} × {args.shape} × {args.mesh}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
