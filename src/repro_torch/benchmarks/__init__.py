"""The paper's tables and figures and the kernel bench, on the port's
``core`` copy and its Hopper kernels (counterparts of ``benchmarks/``)."""
