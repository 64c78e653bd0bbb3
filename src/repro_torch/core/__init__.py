"""The burst-parallel system (paper §3-5): cost model, profiler, planner,
graph reduction, plan representation, multiplexing and the coordinator.
The port of ``repro/core``."""
