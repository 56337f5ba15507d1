"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Same module names and public signatures as ``repro``; the Pallas TPU
kernels on the serving path are hand-written CUDA kernels for Hopper
(``kernels/csrc``). Nothing here imports JAX or ``repro``.
"""
