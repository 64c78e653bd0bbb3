"""Hand-written Hopper kernels (``csrc/``), their plain versions and dispatch."""
