"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The counterpart of ``src/repro/launch/serve.py``, on the card by default
(``--device cpu`` runs on the CPU). Two modes through the same Engine:

  * default — one-shot batched greedy decode (prefill + fixed batch),
    reporting total latency and throughput.
  * ``--stream N --paged`` — continuous batching of N synthetic requests
    with mixed prompt/output lengths over the paged two-tier pool:
    admission by pages, preempt-and-spill to the layer-1 tier when layer 0
    runs out. ``--page-tokens`` / ``--layer0-bytes`` / ``--layer1-bytes``
    shape the pool; per-request latency percentiles and the
    preemption/spill counters are reported.

Weights are random, made on the device from a fixed seed. Hardware target
selection (``--target`` or ``REPRO_TARGET``) sizes the slot and page
budgets from that target's CapacityPartition, as in the reference, and the
kernels' plans: ``--arch falcon-mamba-7b`` on the card takes
``--target h100``, whose scan chunks fit the kernel's shared memory. An
attention-free model keeps no KV bytes, so its ``--layer0-bytes`` /
``--layer1-bytes`` count pages.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.target import available_targets, use_target
from repro_torch.models.api import build_model
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import (DRAINED, Scheduler, derive_n_slots,
                                         derive_page_geometry, percentile,
                                         synthetic_stream)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stream(engine: Engine, scheduler: Scheduler, stream: list) -> dict:
    """Drive a prepared request stream; return counters."""
    for spec in stream:
        scheduler.submit(spec["prompt"], spec["max_new_tokens"])
    t0 = time.monotonic()
    report = engine.serve(scheduler=scheduler)
    _wait(engine.core.device)
    dt = time.monotonic() - t0
    stats = report.stats
    n_tokens = sum(len(r.tokens) for r in report.requests)
    served = [r for r in report.requests if r.status == DRAINED]
    decode_steps = [r.finish_step - r.admit_step for r in served
                    if r.finish_step >= 0]
    return {
        "n_requests": len(stream),
        "completed": stats["drained"],
        "n_tokens": n_tokens,
        "wall_s": dt,
        "tok_per_s": n_tokens / dt if dt else 0.0,
        "host_syncs": stats["host_syncs"],
        "chunks": stats["chunks"],
        "admissions": stats["admissions"],
        "decode_steps_total": stats["decode_steps"],
        "n_slots": stats["n_slots"],
        "max_slot_reuse": stats["max_slot_reuse"],
        "ttft_steps_p50": percentile(stats["ttft_steps"], 50),
        "ttft_steps_p95": percentile(stats["ttft_steps"], 95),
        "e2e_steps_p50": percentile(stats["e2e_steps"], 50),
        "e2e_steps_p95": percentile(stats["e2e_steps"], 95),
        "decode_steps_p50": percentile(decode_steps, 50),
        "decode_steps_p95": percentile(decode_steps, 95),
        "preemptions": stats["preemptions"],
        "spilled_pages": stats["spilled_pages"],
        "restores": stats["restores"],
        **{k: stats[k] for k in ("page_tokens", "n_pages", "n_spill_pages",
                                 "pages_high_water", "spill_high_water",
                                 "pool_bytes", "spill_bytes")},
        "outputs": report.outputs,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: the "
                         "REDUCED smoke config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--target", default=None, metavar="NAME",
                    help=f"hardware target ({', '.join(available_targets())})")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="continuous batching over N synthetic requests "
                         "(requires --paged)")
    ap.add_argument("--slots", type=int, default=None,
                    help="override the CapacityPartition-derived slot count")
    ap.add_argument("--sync-interval", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="serve --stream over the paged two-tier KV pool")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--layer0-bytes", type=int, default=None,
                    help="override the layer-0 (hot tier) page-pool budget")
    ap.add_argument("--layer1-bytes", type=int, default=None,
                    help="override the layer-1 (spill tier) budget")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    return ap


def run(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, serve, print the report; return its record."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.paged and not args.stream:
        ap.error("--paged applies to --stream serving")
    if args.stream and not args.paged:
        ap.error("--stream needs --paged: the dense slot-slab stream is not "
                 "ported yet")
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    tgt_ctx = use_target(args.target) if args.target else contextlib.nullcontext()
    with tgt_ctx:
        model = build_model(cfg, device=args.device)
        dev = model.device
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        max_len = args.prompt_len + args.gen_len
        engine = Engine(model, params,
                        EngineConfig(max_len=max_len,
                                     sync_interval=args.sync_interval))
        del params
        if args.stream:
            pages = derive_page_geometry(
                cfg, max_len, page_tokens=args.page_tokens,
                max_slots=max(2, args.batch),
                layer0_bytes=args.layer0_bytes,
                layer1_bytes=args.layer1_bytes)
            n_slots = args.slots or derive_n_slots(
                cfg, max_len, max_slots=max(2, args.batch), pages=pages)
            sched = Scheduler(n_slots=n_slots, pages=pages)
            stream = synthetic_stream(args.stream, args.prompt_len,
                                      args.gen_len, cfg.vocab_size)
            rec = run_stream(engine, sched, stream)
            print(f"arch={cfg.name} stream={args.stream} mode=paged "
                  f"slots={rec['n_slots']} (max reuse {rec['max_slot_reuse']})"
                  f" device={dev}")
            print(f"completed {rec['completed']}/{rec['n_requests']} "
                  f"({rec['n_tokens']} tokens) in {rec['wall_s']*1e3:.0f} ms "
                  f"-> {rec['tok_per_s']:.1f} tok/s")
            print(f"host syncs {rec['host_syncs']} over "
                  f"{rec['decode_steps_total']} decode steps")
            print(f"latency (decode steps): ttft p50/p95 "
                  f"{rec['ttft_steps_p50']:.0f}/{rec['ttft_steps_p95']:.0f}, "
                  f"e2e p50/p95 {rec['e2e_steps_p50']:.0f}/"
                  f"{rec['e2e_steps_p95']:.0f}, decode p50/p95 "
                  f"{rec['decode_steps_p50']:.0f}/"
                  f"{rec['decode_steps_p95']:.0f}")
            print(f"pages: {rec['pages_high_water']}/{rec['n_pages']} "
                  f"layer-0 high water ({rec['pool_bytes']} B), "
                  f"{rec['preemptions']} preemptions -> "
                  f"{rec['spilled_pages']} pages spilled, "
                  f"{rec['restores']} restores "
                  f"(layer-1 high water {rec['spill_high_water']}/"
                  f"{rec['n_spill_pages']})", flush=True)
            return rec

        rng = np.random.RandomState(1)
        tokens = torch.as_tensor(
            rng.randint(2, cfg.vocab_size, size=(args.batch, args.prompt_len)),
            dtype=torch.int32, device=dev)
        t0 = time.monotonic()
        out, _ = engine.generate({"tokens": tokens}, n_steps=args.gen_len)
        _wait(dev)
        dt = time.monotonic() - t0
        out = out.cpu()
        n_generated = int(out.shape[0] * out.shape[1])
        stats = engine.last_stats
        print(f"arch={cfg.name} batch={args.batch} "
              f"prompt={args.prompt_len} gen={out.shape[1]} device={dev}")
        print(f"tokens (first row): {out[0].tolist()}")
        print(f"total {dt*1e3:.0f} ms, {n_generated/dt:.1f} tok/s "
              f"(prefill amortized; {stats['host_syncs']} host "
              f"syncs / {stats['decode_steps']} steps)", flush=True)
        return {"tokens": out, "wall_s": dt, "tok_per_s": n_generated / dt,
                "host_syncs": stats["host_syncs"],
                "decode_steps": stats["decode_steps"]}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
