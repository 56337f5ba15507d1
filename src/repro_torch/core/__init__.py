"""Hardware targets, capacity-aware tiling and the kernel planner (copied
framework-free from ``repro.core``)."""
