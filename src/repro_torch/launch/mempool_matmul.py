"""The paper's own experiment (§VI) on the H100, end to end.

The counterpart of ``examples/mempool_matmul.py``:

1. the SPM-capacity sweep from the calibrated models (tile sizes, cycle
   counts, Fig. 6/7/8/9 numbers), printed as the reference prints it;
2. the capacity-planned matmul kernel (``kernels/csrc/matmul3d.cu``) at each
   tile the planner sizes from the target's scratchpad at the fractions
   0.125 / 0.25 / 0.5 / 0.75 (the part the paper's 1/2/4/8 MiB span plays),
   for bf16 inputs (f32 out) and f32 inputs: max |d| against the plain
   version, the median time over CUDA events, TFLOP/s, the planned HBM
   traffic and arithmetic intensity. On the card it runs at M = 8192 (the
   size the reference's section 3 plans for: the paper's M = 326400 needs
   426 GB for each f32 operand); with ``--device cpu`` it runs the
   reference's M = 512 through the plain version, and times nothing;
3. the reference's TPU translation (planning only), then the same table
   for the target.

    PYTHONPATH=src python -m repro_torch.launch.mempool_matmul
    PYTHONPATH=src python -m repro_torch.launch.mempool_matmul --device cpu

``--target NAME`` plans the sweep from another target (default ``h100``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

import torch

from repro_torch.benchmarks.common import median_ms
from repro_torch.core import energy, perf_model, tiling
from repro_torch.core.hw_profiles import MiB
from repro_torch.core.target import (HardwareTarget, available_targets,
                                     get_target, use_target)
from repro_torch.kernels import ops, ref
from repro_torch.models.api import resolve_device

FRACTIONS = (0.125, 0.25, 0.5, 0.75)
M_CARD = 8192
M_CPU = 512
DTYPES = (("bf16", torch.bfloat16), ("f32", torch.float32))
#: max |d| / max |plain| at K = 8192 on the card: f32 sums in two orders
#: differ by ~sqrt(K) ulp of the partial sums; bf16 products are exact in
#: f32, so bf16 inputs with f32 out differ by the same order
REL_TOL = {"bf16": 1e-3, "f32": 1e-4}
N_TIMED = 5


def section(title):
    print(f"\n{'=' * 64}\n{title}\n{'=' * 64}")


def capacity_sweep() -> None:
    section("1. The paper's capacity sweep (calibrated reproduction)")
    print(f"{'SPM':>6} {'tile t':>7} {'loads/elem':>11} "
          f"{'cycles @16B/c':>14} {'perf 2D':>8} {'perf 3D':>8} "
          f"{'eff 3D':>7} {'EDP 3D':>7}")
    for mib in (1, 2, 4, 8):
        # the registered 3D target's cluster-SPM capacity drives the t-rule
        target = get_target(f"mempool-3d-{mib}mib")
        t = tiling.mempool_tile_size(target.scratchpad_bytes)
        cyc = perf_model.matmul_cycles(spm_bytes=mib * MiB,
                                       bw_bytes_per_cycle=16).total
        d2, d3 = energy.derive("2D", mib), energy.derive("3D", mib)
        print(f"{mib:>4}Mi {t:>7} {perf_model.PAPER_M // t:>11} "
              f"{cyc:>14.3e} {d2.performance:>8.3f} {d3.performance:>8.3f} "
              f"{d3.efficiency:>7.3f} {d3.edp:>7.3f}")
    print("\npaper checkpoints: t=256/384/544/800; 3D@4MiB perf +9.1% vs 2D;"
          "\n3D@1MiB best EDP (-15.6%); speedups 43%/16%/8% at 4/16/64 B/c:")
    for bw in (4, 16, 64):
        s = perf_model.speedup_vs_baseline(8 * MiB, bw)
        print(f"  8MiB vs 1MiB @ {bw:>2} B/cyc: {(s - 1) * 100:+.1f}%")


def _fmt_bytes(n: float) -> str:
    for unit, size in (("Gi", 1024 * MiB), ("Mi", MiB)):
        if n >= size:
            return f"{n / size:.2f}{unit}"
    return f"{n / 1024:.1f}Ki"


def kernel_sweep(target: HardwareTarget, device: torch.device
                 ) -> List[Dict[str, Any]]:
    on_card = device.type == "cuda"
    m = M_CARD if on_card else M_CPU
    where = (f"matmul3d on {torch.cuda.get_device_name(device)}" if on_card
             else "the plain version on the CPU, not timed")
    section(f"2. The kernel at each planned tile ({target.name}, M = {m}, "
            f"{where})")
    print(f"{'in':>4} {'budget':>9} {'blocks (bm,bk,bn)':>18} {'max|d|':>9} "
          f"{'rel':>8} {'ms':>9} {'TFLOP/s':>8} {'HBM plan':>10} "
          f"{'arith.int.':>10}")
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for name, dtype in DTYPES:
        a = torch.randn((m, m), generator=gen, device=device).to(dtype)
        b = torch.randn((m, m), generator=gen, device=device).to(dtype)
        want = ref.matmul_ref(a, b, torch.float32)
        peak = want.abs().max().item()
        in_bytes = a.element_size()
        for frac in FRACTIONS:
            part = target.partition(fraction=frac)
            plan = tiling.plan_matmul(m, m, m, partition=part,
                                      in_bytes=in_bytes)
            got = ops.matmul(a, b, plan=plan, out_dtype=torch.float32)
            err = (got - want).abs().max().item()
            ms = (median_ms(lambda: ops.matmul(a, b, plan=plan,
                                               out_dtype=torch.float32),
                            N_TIMED) if on_card else None)
            traffic = plan.hbm_traffic_bytes(m, m, m, in_bytes, out_bytes=4)
            ai = plan.arithmetic_intensity(m, m, m, in_bytes)
            row = dict(dtype=name, fraction=frac,
                       budget_bytes=part.budget_bytes,
                       plan=[plan.bm, plan.bk, plan.bn], m=m,
                       max_abs_err=err, rel_err=err / peak, ms=ms,
                       tflops=2.0 * m ** 3 / ms / 1e9 if ms else None,
                       hbm_bytes=traffic, intensity=ai)
            rows.append(row)
            times = (f"{ms:>9.3f} {row['tflops']:>8.2f}" if on_card
                     else f"{'-':>9} {'-':>8}")
            print(f"{name:>4} {_fmt_bytes(row['budget_bytes']):>9} "
                  f"{str(tuple(row['plan'])):>18} {err:>9.2e} "
                  f"{row['rel_err']:>8.1e} {times} "
                  f"{_fmt_bytes(traffic):>10} {ai:>10.0f}")
            if on_card:
                assert row["rel_err"] <= REL_TOL[name], row
            else:
                assert err < 1e-3
        del a, b, want
    return rows


def translation(target: HardwareTarget, m: int = M_CARD) -> None:
    """The reference's section 3 for ``target``: planned blocks, HBM
    traffic and arithmetic intensity at each fraction (planning only)."""
    print(f"\n{target.name} ({target.scratchpad_level}, M = {m}, bf16)")
    print(f"{'budget':>12} {'blocks (bm,bk,bn)':>20} "
          f"{'HBM traffic':>12} {'arith.int.':>10}")
    for frac in FRACTIONS:
        part = target.partition(fraction=frac)
        plan = tiling.plan_matmul(m, m, m, partition=part)
        tr = plan.hbm_traffic_bytes(m, m, m)
        ai = plan.arithmetic_intensity(m, m, m)
        print(f"{_fmt_bytes(part.budget_bytes):>12} "
              f"{str((plan.bm, plan.bk, plan.bn)):>20} "
              f"{tr / 2**30:>9.2f}Gi {ai:>10.0f}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--target", default="h100", metavar="NAME",
                    help=f"hardware target whose scratchpad the sweep plans "
                         f"from (default h100; "
                         f"{', '.join(available_targets())})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain version at M = 512)")
    return ap


def run(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, run the three sections; return the kernel sweep."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    capacity_sweep()
    with use_target(args.target) as target:
        rows = kernel_sweep(target, device)
        section("3. The translation (same law, a chip's scratchpad instead "
                "of the SPM)")
        for name in ("tpu-v5e", target.name):
            translation(get_target(name))
    print("\nbigger scratchpad -> bigger tiles -> less off-chip traffic:"
          "\nthe paper's insight, on the TPU's VMEM and on the H100's shared "
          "memory.", flush=True)
    return {"target": target.name, "device": str(device), "sweep": rows}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
