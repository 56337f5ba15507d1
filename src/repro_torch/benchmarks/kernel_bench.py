"""Kernel micro-benchmarks on a GPU target: the device time of each kernel
at its capacity-planned blocks beside the PyTorch yardstick and the
target's roofline. The counterpart of ``benchmarks/kernel_bench.py``, at the
reference's shapes.

  * matmul (f32) through the ``matmul3d`` kernel at the target's planned
    blocks; yardstick ``torch.matmul`` with TF32 off;
  * causal attention (bf16, D = 128, group 1) through the flash kernel;
    yardstick ``scaled_dot_product_attention``;
  * the selective scan (f32) through the ``mamba_scan`` kernel at the
    target's planned chunk; no yardstick (no PyTorch call computes a
    selective scan). Its roofline counts each input and output byte once
    against the ``B * L * Di * Ds`` exponentials at the special function
    units' rate.

Times are medians over CUDA events on the card. Each kernel row is held to
its plain version and raises past its limit: matmul at
``tests/test_kernels.py``'s f32 2e-4, as max|d| / max|plain|; attention at
atol = rtol = 2e-2 (bf16); the scan at atol = rtol = 2e-4 (f32, the
tolerance of ``test_mamba_scan_sweep``). With ``--device cpu`` the plain
versions run on the CPU and no time is reported: a CPU time is not a
device metric.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --target h100
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.benchmarks.common import (add_target_arg, fmt_table,
                                           median_ms, save_artifact)
from repro_torch.core import planner
from repro_torch.core.target import HardwareTarget, get_target
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba_scan import scan_work
from repro_torch.models.api import resolve_device

MATMUL_SHAPES = [(512, 512, 512), (1024, 2048, 1024), (2048, 2048, 2048)]
ATTENTION_SHAPES = [(1, 8, 1024, 128), (1, 8, 4096, 128)]
SCAN_SHAPES = [(1, 2048, 4096, 16), (1, 8192, 4096, 16)]
SCAN_LABEL = "mamba_scan"
N_TIMED = 5
MATMUL_REL_TOL = 2e-4     # f32, max|d| / max|plain|
ATTENTION_TOL = 2e-2      # bf16, atol = rtol
SCAN_TOL = 2e-4           # f32, atol = rtol

Timer = Optional[Callable[[Callable[[], object], int], float]]


def _randn(gen, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _time(timer: Timer, fn, n: int = N_TIMED) -> Optional[float]:
    return timer(fn, n) if timer is not None else None


def matmul_row(target: HardwareTarget, m: int, k: int, n: int, device,
               timer: Timer = None) -> Dict:
    gen = torch.Generator(device=device).manual_seed(0)
    a, b = _randn(gen, (m, k), device), _randn(gen, (k, n), device)
    prof = target.profile
    plan = planner.matmul_kernel_plan(m, k, n, in_bytes=4, target=target)
    got, want = ops.matmul(a, b, plan=plan), ref.matmul_ref(a, b)
    err = (got - want).abs().max()
    if not (torch.isfinite(got).all()
            and err <= MATMUL_REL_TOL * want.abs().max()):
        raise RuntimeError(f"matmul3d {m}x{k}x{n} plan {plan}: max|d| "
                           f"{float(err):.3e} beyond {MATMUL_REL_TOL} of "
                           f"max|plain| {float(want.abs().max()):.3e}")
    ms = _time(timer, lambda: ops.matmul(a, b, plan=plan))
    lib_ms = _time(timer, lambda: torch.matmul(a, b))
    traffic = plan.hbm_traffic_bytes(m, k, n, in_bytes=4, out_bytes=4)
    roof_s = max(2 * m * k * n / prof.peak_flops_f32, traffic / prof.hbm_bw)
    return dict(kind="matmul", shape=[m, k, n], route="matmul3d",
                plan=[plan.bm, plan.bk, plan.bn], max_abs_err=float(err),
                ms=ms, library_ms=lib_ms, hbm_bytes=traffic,
                intensity=plan.arithmetic_intensity(m, k, n, 4),
                roofline_ms=roof_s * 1e3)


def attention_row(target: HardwareTarget, b_: int, h: int, s: int, d: int,
                  device, timer: Timer = None) -> Dict:
    gen = torch.Generator(device=device).manual_seed(0)
    q, kk, v = (_randn(gen, (b_, h, s, d), device, torch.bfloat16)
                for _ in range(3))
    prof = target.profile
    plan = planner.attention_plan(s, s, d, target=target)
    got = ops.attention(q, kk, v, causal=True).float()
    want = ref.attention_ref(q, kk, v).float()
    err = (got - want).abs().max()
    if not (torch.isfinite(got).all() and torch.allclose(
            got, want, atol=ATTENTION_TOL, rtol=ATTENTION_TOL)):
        raise RuntimeError(f"flash attention {tuple(q.shape)}: max|d| "
                           f"{float(err):.3e} beyond atol = rtol = "
                           f"{ATTENTION_TOL}")
    ms = _time(timer, lambda: ops.attention(q, kk, v, causal=True))
    lib_ms = _time(timer, lambda: F.scaled_dot_product_attention(
        q, kk, v, is_causal=True))
    flops = 4.0 * b_ * h * s * s * d * 0.5          # causal half
    kv_bytes = b_ * h * s * d * 2 * 2 * (s // (2 * plan.block_q) + 1)
    roof_s = max(flops / prof.peak_flops_bf16, kv_bytes / prof.hbm_bw)
    return dict(kind="attention", shape=[b_, h, s, d], route="flash_attention",
                plan=[plan.block_q, plan.block_kv], max_abs_err=float(err),
                ms=ms, library_ms=lib_ms, hbm_bytes=kv_bytes,
                intensity=flops / kv_bytes, roofline_ms=roof_s * 1e3)


def scan_row(target: HardwareTarget, b_: int, length: int, di: int, ds: int,
             device, timer: Timer = None) -> Dict:
    gen = torch.Generator(device=device).manual_seed(0)
    x = _randn(gen, (b_, length, di), device) * 0.1
    dt = F.softplus(_randn(gen, (b_, length, di), device)) * 0.1
    a = -torch.exp(_randn(gen, (di, ds), device) * 0.1)
    bb = _randn(gen, (b_, length, ds), device) * 0.1
    c = _randn(gen, (b_, length, ds), device) * 0.1
    dd = torch.ones((di,), device=device)
    plan = planner.scan_kernel_plan(length, di, ds, target=target)
    got = ops.selective_scan(x, dt, a, bb, c, dd, plan=plan)
    want = ref.selective_scan_ref(x, dt, a, bb, c, dd)
    err = (got - want).abs().max()
    if not (torch.isfinite(got).all() and torch.allclose(
            got, want, atol=SCAN_TOL, rtol=SCAN_TOL)):
        raise RuntimeError(f"mamba_scan {tuple(x.shape)} chunk {plan.chunk}: "
                           f"max|d| {float(err):.3e} beyond atol = rtol = "
                           f"{SCAN_TOL}")
    ms = _time(timer, lambda: ops.selective_scan(x, dt, a, bb, c, dd,
                                                 plan=plan))
    n_bytes, exps = scan_work(x, dt, a, bb, c, dd)
    prof = target.profile
    roof_s = max(n_bytes / prof.hbm_bw, exps / prof.special_ops)
    return dict(kind="mamba_scan", shape=[b_, length, di, ds],
                route=SCAN_LABEL, plan=[plan.chunk], max_abs_err=float(err),
                ms=ms, library_ms=None, hbm_bytes=n_bytes,
                intensity=exps / n_bytes, roofline_ms=roof_s * 1e3)


def _cell(x: Optional[float], fmt: str = "{:.4f}") -> str:
    return "-" if x is None else fmt.format(x)


def table(target: HardwareTarget, rows: List[Dict], device) -> str:
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU (plain versions, not timed)")
    out = []
    for r in rows:
        out.append([r["kind"], "x".join(map(str, r["shape"])), r["route"],
                    str(tuple(r["plan"])), _cell(r["max_abs_err"], "{:.1e}"),
                    _cell(r["ms"]), _cell(r["library_ms"]),
                    _cell(r["roofline_ms"]), f"{r['hbm_bytes'] / 2**20:.1f}",
                    _cell(r["intensity"], "{:.0f}")])
    return fmt_table(
        ["kernel", "shape", "route", "planned blocks", "max|d|", "ms",
         "torch ms", f"{target.name} roofline ms", "HBM MiB (plan)",
         "arith.int."], out,
        title=f"Kernel bench on {where} — blocks planned for {target.name}")


def run(target_name: Optional[str] = None, device=None,
        shapes: Optional[Dict[str, List[Tuple[int, ...]]]] = None) -> str:
    """Every row at the reference's shapes (or ``shapes``), timed on the
    card; returns the table and saves ``kernel_bench.json``."""
    target = get_target(target_name)
    if target.kind != "gpu":
        raise ValueError(f"the port's kernel bench needs a GPU target, got "
                         f"{target.name} ({target.kind})")
    dev = resolve_device(device)
    shapes = shapes or dict(matmul=MATMUL_SHAPES, attention=ATTENTION_SHAPES,
                            scan=SCAN_SHAPES)
    timer = median_ms if dev.type == "cuda" else None
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 yardstick
    try:
        rows = [matmul_row(target, *s, dev, timer) for s in shapes["matmul"]]
        rows += [attention_row(target, *s, dev, timer)
                 for s in shapes["attention"]]
        rows += [scan_row(target, *s, dev, timer) for s in shapes["scan"]]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    save_artifact("kernel_bench.json", dict(
        target=target.name, device=str(dev),
        device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"), rows=rows))
    return table(target, rows, dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_target_arg(ap, default="h100")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions and times nothing)")
    args = ap.parse_args(argv)
    print(run(args.target, args.device), flush=True)


if __name__ == "__main__":
    main()
