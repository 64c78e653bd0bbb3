"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Same module layout as ``repro``, one port module per reference module.
The package imports ``torch`` and never ``jax`` or ``repro``; its CUDA
kernels build from ``kernels/csrc`` at first use.
"""
