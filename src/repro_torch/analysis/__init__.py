"""Static analysis over the burst-parallel runtime, the port of
``repro/analysis``: five passes, all runnable with no card.

- ``verify``     — pure-metadata plan/submesh verifier (device-range
                   disjointness, coverage, quantum alignment, amp limits).
- ``shardcheck`` — sharding-rule sweep over every config x every mesh shape
                   reachable by ``largest_pow2_mesh`` after a failure, with
                   the port's own ``shard-placement`` check.
- ``protocheck`` — bounded-interleaving model checker for the transport
                   control plane (lease election, cursor safety, GC).
- ``tracecheck`` — schema validator for the simulator's JSON traces.
- ``lint``       — AST linter for the PyTorch hazards of the port (compiles
                   in hot paths, wall-clock in virtual-clock modules,
                   asserts on tensors, unknown sharding axes).

Each pass is a module with a ``main()`` CLI (``python -m
repro_torch.analysis.<pass>``) and a library entry point returning
structured reports.
"""
from repro_torch.analysis.lint import LintFinding, lint_file, lint_paths  # noqa: F401
from repro_torch.analysis.protocheck import MUTANTS, CheckReport, explore  # noqa: F401
from repro_torch.analysis.shardcheck import check_cell, check_spec, sweep  # noqa: F401
from repro_torch.analysis.tracecheck import check_paths, check_trace_file  # noqa: F401
from repro_torch.analysis.verify import (  # noqa: F401
    PlanVerificationError,
    Violation,
    verify_carving,
    verify_plan,
    verify_plan_or_raise,
    verify_serving_submeshes,
    verify_stage_shardings,
    verify_submeshes,
)
