"""The speculative head-to-head's outputs gate under both attention paths
of the paged verify forward.

``serve_bench.run_speculate`` runs once with the verify forward's paged
attention on gather + oracle (the reference's multi-token dispatch,
``paged_decode_attention(impl="ref")``: f32 P·V) and once on the port's
path (on the card the paged kernel once per query column, whose P·V
rounds P to bf16 as prefill and decode do), each after its warm-up
pass, so the two are timed in one process alike. For each: wall tok/s, the
gate's rule, parted requests and worst gap, and per parted request the
step where the two runs part and each run's gap to the teacher-forced
best logit (``repro_torch.serve.checks``). On the CPU both paths are the
oracle and the gate is exact.

    PYTHONPATH=src python -m repro_torch.benchmarks.spec_gate --full
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, List

from repro_torch.benchmarks import common, serve_bench
from repro_torch.core.target import use_target
from repro_torch.launch.serve import serving_target
from repro_torch.models import attention
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.checks import teacher_forced_gap


@contextlib.contextmanager
def _oracle_verify():
    """Multi-token paged attention on gather + oracle for the block."""
    entry = attention.paged_decode_attention

    def gathered(q, *args, **kwargs):
        if q.shape[2] > 1:
            kwargs["impl"] = "ref"
        return entry(q, *args, **kwargs)

    attention.paged_decode_attention = gathered
    try:
        yield
    finally:
        attention.paged_decode_attention = entry


def _partings(reports: List, params, cfg) -> List[Dict]:
    """Per request that parts between the baseline and the speculative
    serve: the step, and each run's worst teacher-forced gap."""
    off, on = reports[-2:]
    out = []
    for req in off.requests:
        a, b = off.outputs[req.rid], on.outputs[req.rid]
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if step is not None:
            out.append({"rid": req.rid, "step": step,
                        "gap_off": teacher_forced_gap(cfg, params,
                                                      req.prompt, a),
                        "gap_on": teacher_forced_gap(cfg, params,
                                                     req.prompt, b)})
    return out


def run(target_name=None, *, n_requests: int = 16, full: bool = False,
        device=None) -> str:
    lines = []
    for label, path in (("gather + oracle", _oracle_verify),
                        ("port", contextlib.nullcontext)):
        reports, engines = [], []
        serve = engine_mod.Engine.serve

        def recording(self, *args, **kwargs):
            engines.append(self)
            reports.append(serve(self, *args, **kwargs))
            return reports[-1]

        engine_mod.Engine.serve = recording
        try:
            with path():
                try:
                    text = serve_bench.run_speculate(
                        target_name, n_requests=n_requests, full=full,
                        device=device)
                except SystemExit as e:         # a failed gate: report it
                    text = f"gate failed: {e}"
                with open(os.path.join(common.ARTIFACT_ROOT,
                                       "serve_speculate.json")) as f:
                    art = json.load(f)
                eng = engines[-1]
                name = target_name or serving_target(eng.core.device)
                with use_target(name) if name else contextlib.nullcontext():
                    parts = _partings(reports, eng.params, eng.model.cfg)
        finally:
            engine_mod.Engine.serve = serve
        lines += [f"== verify attention: {label} ==", text,
                  f"gate {art['speculate_gate']}; tok/s off "
                  f"{art['baseline']['tok_per_s']:.1f}, on "
                  f"{art['speculate']['tok_per_s']:.1f}"]
        lines += [f"  rid {p['rid']}: parts at step {p['step']}, gap off "
                  f"{p['gap_off']:.4f}, on {p['gap_on']:.4f}"
                  for p in parts]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_target_arg(ap)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: REDUCED)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    args = ap.parse_args(argv)
    print(run(args.target, n_requests=args.requests, full=args.full,
              device=args.device), flush=True)


if __name__ == "__main__":
    main()
