"""Shared benchmark helpers: table formatting, artifact IO, target CLI,
CUDA-event timing. The counterpart of ``benchmarks/common.py``."""

from __future__ import annotations

import contextlib
import json
import os
import statistics
from typing import Any, Callable, Iterable, Sequence

ARTIFACT_ROOT = os.path.join(os.path.dirname(__file__), "artifacts")


def add_target_arg(ap, default=None) -> None:
    """Uniform ``--target <name>`` flag: every benchmark script accepts it
    and resolves the name through the process-wide registry."""
    shown = default or "current/REPRO_TARGET/tpu-v5e"
    ap.add_argument("--target", default=default, metavar="NAME",
                    help="hardware target name (see repro_torch.core.target; "
                         f"default: {shown})")


def target_scope(name):
    """Context manager applying ``--target`` (no-op when None)."""
    if name is None:
        return contextlib.nullcontext()
    from repro_torch.core.target import use_target
    return use_target(name)


def run_cli(run_fn, doc: str, argv=None) -> None:
    """Standard benchmark entry point: ``--target``-only CLI around a
    zero-argument ``run_fn``."""
    import argparse
    ap = argparse.ArgumentParser(description=doc)
    add_target_arg(ap)
    args = ap.parse_args(argv)
    with target_scope(args.target):
        print(run_fn())


def fmt_table(headers: Sequence[str], rows: Iterable[Sequence[Any]],
              title: str = "") -> str:
    rows = [[str(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    out = []
    if title:
        out.append(f"== {title} ==")
    out.append(" | ".join(h.ljust(w) for h, w in zip(headers, widths)))
    out.append("-+-".join("-" * w for w in widths))
    for r in rows:
        out.append(" | ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def pct(x: float) -> str:
    return f"{100.0 * x:+.1f}%"


def save_artifact(name: str, obj: Any) -> str:
    os.makedirs(ARTIFACT_ROOT, exist_ok=True)
    path = os.path.join(ARTIFACT_ROOT, name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


def median_ms(fn: Callable[[], Any], n: int) -> float:
    """Median device time of ``fn`` over ``n`` calls after one warm-up,
    each call between two CUDA events (card only)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
