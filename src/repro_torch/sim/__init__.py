"""Trace-driven cluster simulation at deployment scale (the port of
``repro/sim``).

Replays seeded or hand-written cluster event traces (job churn, device
failures, elastic rejoins, heartbeat losses — JSON schema in
``repro_torch.sim.trace``) through the real control plane: ``ClusterCoordinator``
on a virtual clock, the vectorized matrix-DP planner for every re-plan,
``Collocator.admit()`` under the measurement-calibrated
``InterferenceModel``, the ``ExecutableCache`` via the prediction-only
collocation path, and the live transport consumption loop
(``repro_torch.dist.transport.CoordinatorLoop`` detecting silenced devices from
missing beats) — no accelerator or compilation anywhere, so 1024 simulated
devices replay in seconds on a laptop.  The committed traces live under
``benchmarks/traces/``; ``SimReport.to_json()`` on them is bit-identical
to the reference's (``tests/test_torch_sim.py``).
"""
from repro_torch.sim.cluster_sim import ClusterSim, Segment, SimReport
from repro_torch.sim.trace import (
    Trace,
    TraceEvent,
    generate_failure_storm,
    generate_heartbeat_loss,
    generate_lease_churn,
    generate_trace,
    load_trace,
    save_trace,
)

__all__ = [
    "ClusterSim",
    "Segment",
    "SimReport",
    "Trace",
    "TraceEvent",
    "generate_failure_storm",
    "generate_heartbeat_loss",
    "generate_lease_churn",
    "generate_trace",
    "load_trace",
    "save_trace",
]
