"""Benchmark entry point: one section per paper table/figure, the kernel
bench and the serving bench. The counterpart of ``benchmarks/run.py``;
its two roofline sections need the dry-run (``launch/dryrun.py``), which
is not ported yet (ROADMAP A14), and are reported as waiting, not as
failures. A section that fails makes the exit code 1.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]
        [--target NAME]
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    import argparse

    from repro_torch.benchmarks import (fig6_bandwidth, fig789_energy,
                                        kernel_bench, serve_bench,
                                        table1_tile, table2_group)
    from repro_torch.benchmarks.common import add_target_arg, target_scope
    from repro_torch.launch.serve import serving_target
    from repro_torch.models.api import resolve_device
    ap = argparse.ArgumentParser(description=__doc__)
    add_target_arg(ap)
    ap.add_argument("--device", default=None,
                    help="torch device for the kernel and serving benches "
                         "(default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    target = args.target or serving_target(dev)
    sections = [
        ("Table I (tile partitioning)", table1_tile.run),
        ("Table II (group PPA)", table2_group.run),
        ("Fig. 6 (bandwidth sweep)", fig6_bandwidth.run),
        ("Figs. 7-9 (perf/efficiency/EDP)", fig789_energy.run),
        # the kernel bench plans for a GPU target (its CLI's h100 default)
        ("Kernel bench",
         lambda: kernel_bench.run(args.target or "h100", device=dev)),
        ("Serve bench (continuous batching)",
         lambda: serve_bench.run(target, device=dev)),
    ]
    failures = 0
    with target_scope(target):
        for name, fn in sections:
            t0 = time.time()
            print(f"\n{'=' * 72}\n{name}\n{'=' * 72}")
            try:
                print(fn())
            except Exception as e:  # keep reporting the rest
                failures += 1
                print(f"SECTION FAILED: {type(e).__name__}: {e}")
            print(f"[{time.time() - t0:.1f}s]")
    print("\nRoofline (single-pod, multi-pod): waiting for the dry-run port "
          "(ROADMAP A14); not run")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
