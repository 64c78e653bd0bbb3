"""Static analysis over the burst-parallel runtime, the port of
``repro/analysis``: the plan verifier (``verify``), the transport
protocol's model checker (``protocheck``) and the trace schema validator
(``tracecheck``).  ``shardcheck`` and ``lint`` are not ported yet (ROADMAP
Queue 1, item 13)."""
from repro_torch.analysis.protocheck import MUTANTS, CheckReport, explore  # noqa: F401
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
