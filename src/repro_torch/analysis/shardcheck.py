"""Static sharding sweep: every config x every post-failure mesh shape.

The port of ``repro/analysis/shardcheck.py``.  ``sharding_rules``/``pspec``
are pure functions of a mesh's axis names and shape, so the whole rule
surface is checked on ``launch.mesh.AbstractMesh`` stand-ins: no ranks, no
process group.  The sweep enumerates every (data, model) shape
``largest_pow2_mesh``/``remesh_for_pool`` can produce for pool sizes 1-64
(the shapes the elastic control plane re-carves onto after failures) and,
for every registered config and shape kind, checks that the produced spec
tuples uphold the engine's invariants by their output, not by trusting the
derivation:

  - every sharded dim is divisible by its mesh-axes product
    (``shard-divisibility``);
  - no mesh axis shards two dims of one array (``shard-reuse``);
  - specs never exceed the array rank (``shard-rank``), and only name axes
    on the mesh (``shard-axis``);
  - every spec turns into DTensor placements (``dist.sharding.placements``,
    which refuses a dim split over mesh axes out of the mesh's order):
    ``shard-placement``, a check the reference has no counterpart for,
    since a ``PartitionSpec`` needs no placements.

It also cross-checks the vocabulary both ways: rules may only map to the
declared mesh axes {pod, data, model} (``shard-vocab``), and every logical
axis a model schema names must be known to the rules (``shard-logical``: a
typo'd logical axis silently replicates).  Divisibility *drops* recorded by
``RuleReport`` are expected degradation (the guard working), reported as
statistics, not violations.  Check codes and cell names
(``{cfg}/{kind}@data=..xmodel=..``) are the reference's.

Run as ``python -m repro_torch.analysis.shardcheck`` (exit 1 on violations).
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.verify import Violation

MESH_AXIS_VOCAB = frozenset({"pod", "data", "model"})
DEFAULT_POOL_RANGE = range(1, 65)


def reachable_mesh_shapes(
        pool_sizes: Iterable[int] = DEFAULT_POOL_RANGE,
) -> List[Tuple[int, int]]:
    """Every (data, model) shape the elastic re-carve can produce."""
    from repro_torch.launch.mesh import pow2_mesh_shape

    return sorted({pow2_mesh_shape(n) for n in pool_sizes})


def _spec_entries(spec) -> List[Tuple[int, Tuple[str, ...]]]:
    """(dim_index, mesh_axes) for each sharded dim of a spec tuple."""
    out = []
    for i, part in enumerate(tuple(spec)):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        out.append((i, axes))
    return out


def check_spec(spec, shape: Sequence[int], sizes: Dict[str, int], where: str,
               mesh=None) -> List[Violation]:
    """Validate one produced spec against the engine invariants; with
    ``mesh``, also that it turns into DTensor placements on it."""
    from repro_torch.dist.sharding import placements

    out: List[Violation] = []
    entries = _spec_entries(spec)
    if len(tuple(spec)) > len(shape):
        out.append(Violation(
            "shard-rank", where,
            f"spec {spec} has {len(tuple(spec))} entries for rank-"
            f"{len(shape)} array"))
        return out
    used: List[str] = []
    for dim_idx, axes in entries:
        for a in axes:
            if a not in sizes:
                out.append(Violation(
                    "shard-axis", where,
                    f"spec {spec} names mesh axis {a!r} not on the mesh "
                    f"(axes: {sorted(sizes)})"))
            elif a in used:
                out.append(Violation(
                    "shard-reuse", where,
                    f"mesh axis {a!r} shards two dims of one array "
                    f"(spec {spec})"))
            used.append(a)
        total = int(math.prod(sizes.get(a, 1) for a in axes))
        if total > 1 and shape[dim_idx] % total != 0:
            out.append(Violation(
                "shard-divisibility", where,
                f"dim {dim_idx} (size {shape[dim_idx]}) sharded over "
                f"{axes} (product {total}) without dividing"))
    if mesh is not None and not out:
        try:
            placements(tuple(spec), mesh)
        except ValueError as e:
            out.append(Violation("shard-placement", where, str(e)))
    return out


def _keystr(path: Tuple[str, ...]) -> str:
    """A key path as the reference prints it (``jax.tree_util.keystr``)."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path=()) -> List[Tuple[Tuple[str, ...], object]]:
    """(key path, leaf) of nested dicts, keys sorted as JAX flattens them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def check_cell(cfg, shape_cfg, mesh) -> Tuple[List[Violation], int]:
    """One (config, shape kind, mesh shape) cell.

    Returns (violations, n_dropped) — drops are the divisibility guard
    declining to shard, which is expected degradation at odd pool sizes.
    """
    from repro_torch.dist.sharding import (RuleReport, batch_pspecs, mesh_axis_sizes,
                                           pspec, sharding_rules)
    from repro_torch.models.api import get_model, input_specs

    sizes = mesh_axis_sizes(mesh)
    rules = sharding_rules(cfg, mesh, shape_cfg)
    kind = shape_cfg.kind if shape_cfg is not None else "train"
    cell = f"{cfg.name}/{kind}@{mesh!r}"
    out: List[Violation] = []

    # rule vocabulary: only declared mesh axes may appear on the RHS
    for logical, axes in rules.items():
        for a in axes:
            if a not in MESH_AXIS_VOCAB:
                out.append(Violation(
                    "shard-vocab", f"{cell} rule {logical!r}",
                    f"maps to undeclared mesh axis {a!r}"))

    api = get_model(cfg)
    report = RuleReport()

    for path, s in _flatten(api.schema):
        where = f"{cell} params{_keystr(path)}"
        for ax in s.axes:
            if ax is not None and ax not in rules:
                out.append(Violation(
                    "shard-logical", where,
                    f"schema names unknown logical axis {ax!r} — it "
                    f"would silently replicate"))
        spec = pspec(s.axes, s.shape, rules, mesh, report)
        out.extend(check_spec(spec, s.shape, sizes, where, mesh))

    # model inputs (and, for decode, the paged cache schema) go through the
    # same machinery batch_pspecs uses when a step places its batch
    if shape_cfg is not None:
        specs = input_specs(cfg, shape_cfg)
        bspecs = batch_pspecs(cfg, shape_cfg, rules, mesh, specs, report)
        spec_shapes = {_keystr(p): tuple(v.shape) for p, v in _flatten(specs)}
        for path, spec in _flatten(bspecs):
            key = _keystr(path)
            shp = spec_shapes.get(key)
            if shp is None:
                continue
            out.extend(check_spec(spec, shp, sizes, f"{cell} inputs{key}", mesh))
    return out, len(report.dropped)


def sweep(config_names: Optional[Sequence[str]] = None,
          pool_sizes: Iterable[int] = DEFAULT_POOL_RANGE,
          ) -> Tuple[List[Violation], Dict[str, int]]:
    """The full static sweep.  Returns (violations, stats)."""
    from repro_torch.configs import get_config, list_configs, shapes_for
    from repro_torch.launch.mesh import AbstractMesh

    names = list(config_names) if config_names else list_configs()
    shapes = reachable_mesh_shapes(pool_sizes)
    violations: List[Violation] = []
    stats = {"cells": 0, "dropped": 0, "mesh_shapes": len(shapes),
             "configs": len(names)}
    for name in names:
        cfg = get_config(name)
        shape_cfgs = [None] + list(shapes_for(cfg))
        for (data, model) in shapes:
            mesh = AbstractMesh((data, model), ("data", "model"))
            for sc in shape_cfgs:
                vs, dropped = check_cell(cfg, sc, mesh)
                violations.extend(vs)
                stats["cells"] += 1
                stats["dropped"] += dropped
    return violations, stats


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.shardcheck",
        description="static sharding sweep over every config x every "
                    "post-failure mesh shape (1-64 devices)")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="subset of config names (default: all registered)")
    ap.add_argument("--max-pool", type=int, default=64)
    args = ap.parse_args(argv)
    violations, stats = sweep(args.configs,
                              pool_sizes=range(1, args.max_pool + 1))
    for v in violations:
        print(v)
    print(
        f"shardcheck: {stats['configs']} configs x "
        f"{stats['mesh_shapes']} mesh shapes, {stats['cells']} cells, "
        f"{stats['dropped']} divisibility drops (expected degradation), "
        f"{len(violations)} violation(s)", file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
