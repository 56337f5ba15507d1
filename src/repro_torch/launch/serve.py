"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The counterpart of ``src/repro/launch/serve.py``, on the card by default
(``--device cpu`` runs on the CPU). Modes through the same Engine:

  * default — one-shot batched greedy decode (prefill + fixed batch),
    reporting total latency and throughput.
  * ``--stream N`` — continuous batching of N synthetic requests with mixed
    prompt/output lengths over the dense slot slab: per-request latency
    percentiles (the scheduler's clocks) and tokens/s.
  * ``--stream N --paged`` — the same stream over the paged two-tier pool:
    admission by pages, preempt-and-spill to the layer-1 tier when layer 0
    runs out. ``--page-tokens`` / ``--layer0-bytes`` / ``--layer1-bytes``
    shape the pool; the preemption/spill counters join the report.
  * ``--stream N --paged --prefix-share`` — every prompt is one common
    ``--system-len`` prefix plus a unique tail; admissions serve the shared
    prefix from ref-counted resident pages and prefill only the tail
    (copy-on-write at the frontier page). Prefix hit, shared-token, COW and
    mapped-vs-physical page counters join the report.
  * ``--chunk-prefill-tokens N`` (either pool) — chunked prefill: at most
    N prompt tokens per drain boundary, interleaved with decode; ``0``
    derives N from the target (``derive_prefill_chunk``) and prints it.
  * ``--speculate-tokens K`` (either pool) — self-drafting speculative
    decoding: each drain boundary proposes up to K draft tokens a live
    slot by prompt lookup and scores them all in ONE verify forward,
    emitting the accepted prefix + 1; ``0`` derives K from the target
    (``derive_speculate_tokens``) and prints it. Without
    ``--prefix-share`` the stream becomes the repetitive (motif-tiled)
    workload the proposer is built for. Proposed / accepted / rejected
    drafts and the acceptance rate join the report.
  * ``--stream N --paged --disaggregate`` — prefill and decode roles over
    the same paged pool: admissions and prompt chunks on the prefill
    role, decode on the decode role, and at each request's final prefill
    chunk its pages hand over by a zero-copy ownership flip. Handover and
    per-role host-sync counters join the report; outputs are the
    combined engine's.
  * ``--kv-quant {fp16,fp8,int8}`` (paged) — the tier codecs: fp16 is the
    bit-exact identity; fp8 / int8 store about twice the pages in the same
    layer-0 bytes at a bounded logit error, and the spill tier quantizes
    at least as hard (fp8 spills as int8). Quantized pools decode by
    gather + oracle, as the reference dispatches them.
  * ``--park-idle N`` (paged) — after N decode steps, park every decoding
    resident to the host tier, requeue mid-prefill ones, resume the
    parked sessions and serve to the end; the counters of both phases are
    summed, and the park counters join the report.

Weights are random, made on the device from a fixed seed. The hardware
target (``--target``, else ``REPRO_TARGET`` or the registry default) sizes
the slot and page budgets from its CapacityPartition, as in the reference,
and the kernels' plans. On the card with no ``--target`` it serves
under ``h100`` (:func:`serving_target`), whose plans fit the kernels'
shared memory; ``--device cpu`` keeps the registry default. An
attention-free model keeps no KV bytes, so its ``--layer0-bytes`` /
``--layer1-bytes`` count pages.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.target import (available_targets, get_target,
                                     use_target)
from repro_torch.models.api import build_model, resolve_device
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import (DECODING, DRAINED, PREFILLING,
                                         Scheduler, derive_n_slots,
                                         derive_page_geometry,
                                         derive_prefill_chunk,
                                         derive_speculate_tokens, percentile,
                                         repetitive_stream,
                                         shared_prefix_stream,
                                         synthetic_stream)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serving_target(device: torch.device) -> Optional[str]:
    """The target the launcher serves under when ``--target`` is not given:
    ``h100`` on the card, so slot and page budgets and the kernels' plans
    come from the card's own memory hierarchy; None (the registry default,
    or ``REPRO_TARGET``) on the CPU."""
    return "h100" if device.type == "cuda" else None


def mesh_size(spec: str) -> int:
    """The device count of a ``--mesh`` spec ('2', '1x2', ...); raises
    ``ValueError`` for a malformed one."""
    n = 1
    for part in spec.split("x"):
        n *= int(part)
    return n


def run_stream(engine: Engine, scheduler: Scheduler, stream: list, *,
               park_idle: int = 0) -> dict:
    """Drive a prepared request stream; return counters.

    With ``park_idle`` the stream runs in two phases: serve ``park_idle``
    decode steps, park every decoding resident to the host tier
    (mid-prefill residents requeue from scratch: they have nothing to
    resume), resume the parked blobs into the SAME scheduler and serve to
    the end. The host syncs, decode steps, chunks and admissions of both
    phases are summed. ``outputs`` maps each request's submission rid to
    its tokens (a resumed session is queued under a new rid)."""
    rids = [scheduler.submit(spec["prompt"], spec["max_new_tokens"]).rid
            for spec in stream]
    rid_map = {r: r for r in rids}
    t0 = time.monotonic()
    pre_stats = None
    if park_idle:
        engine.serve(scheduler=scheduler, max_steps=park_idle)
        pre_stats = dict(engine.last_stats)
        blobs = []
        for slot in sorted(scheduler.active):
            req = scheduler.active[slot]
            if req.status == DECODING:
                blobs.append((req.rid, engine.park_request(scheduler,
                                                           req.rid)))
            elif req.status == PREFILLING:
                scheduler.requeue(slot)
        for old, blob in blobs:
            rid_map[old] = engine.resume_parked(scheduler, blob).rid
    report = engine.serve(scheduler=scheduler)
    _wait(engine.core.device)
    dt = time.monotonic() - t0
    stats = report.stats
    if pre_stats:
        for k in ("host_syncs", "decode_steps", "chunks", "admissions"):
            stats[k] = stats.get(k, 0) + pre_stats.get(k, 0)
    outputs = report.outputs
    n_tokens = sum(len(r.tokens) for r in report.requests)
    served = [r for r in report.requests if r.status == DRAINED]
    decode_steps = [r.finish_step - r.admit_step for r in served
                    if r.finish_step >= 0]
    rec = {
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
        # chunked prefill: TTFT to the first OUTPUT token (under chunking
        # the final chunk's boundary, later than slot admission) and how
        # much prompt work any single boundary booked
        "ttft_emit_steps_p50": percentile(stats["ttft_emit_steps"], 50),
        "ttft_emit_steps_p95": percentile(stats["ttft_emit_steps"], 95),
        "chunk_prefill_tokens": stats["chunk_prefill_tokens"],
        "prefill_chunks": stats["prefill_chunks"],
        "max_boundary_prefill_tokens": stats["max_boundary_prefill_tokens"],
        "paged": stats["paged"],
        "outputs": {r: outputs[rid_map[r]] for r in rids},
    }
    if stats.get("speculate_tokens"):
        rec.update({k: stats[k] for k in (
            "speculate_tokens", "spec_proposed", "spec_accepted",
            "spec_rejected", "spec_acceptance_rate")})
    if stats.get("disaggregate"):
        rec.update({
            "disaggregate": True,
            "handovers": stats["handovers"],
            "handover_pages": stats["handover_pages"],
            "host_syncs_by_role": dict(stats["host_syncs_by_role"]),
            "decode_tokens": stats["decode_tokens"],
        })
    if stats["paged"]:
        rec.update({k: stats[k] for k in (
            "page_tokens", "n_pages", "n_spill_pages", "pages_high_water",
            "spill_high_water", "pool_bytes", "spill_bytes",
            "layer0_codec", "layer1_codec", "parks", "park_resumes",
            "resident_high_water")})
        if stats["prefix_sharing"]:
            rec.update({k: stats[k] for k in (
                "prefix_hits", "prefix_misses", "shared_prefix_tokens",
                "cow_copies", "mapped_high_water")})
    return rec


def _print_stream(cfg, args, rec: dict, dev: torch.device) -> None:
    mode = ("paged+share" if args.prefix_share
            else "paged" if args.paged else "dense")
    if args.disaggregate:
        mode += "+disagg"
    if args.kv_quant:
        mode += f"+{args.kv_quant}"
    print(f"arch={cfg.name} stream={args.stream} mode={mode} "
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
    if rec["chunk_prefill_tokens"]:
        print(f"chunked prefill: {rec['chunk_prefill_tokens']} "
              f"tokens/boundary budget, {rec['prefill_chunks']} chunks, max "
              f"boundary prefill {rec['max_boundary_prefill_tokens']} "
              f"tokens, ttft-to-first-token p50/p95 "
              f"{rec['ttft_emit_steps_p50']:.0f}/"
              f"{rec['ttft_emit_steps_p95']:.0f}")
    if rec.get("speculate_tokens"):
        print(f"speculative decoding: k={rec['speculate_tokens']}, "
              f"{rec['spec_proposed']} proposed -> "
              f"{rec['spec_accepted']} accepted / "
              f"{rec['spec_rejected']} rejected "
              f"(acceptance {rec['spec_acceptance_rate']:.2f}); "
              f"{rec['n_tokens']} tokens over "
              f"{rec['decode_steps_total']} verify forwards")
    if rec.get("disaggregate"):
        roles = rec["host_syncs_by_role"]
        print(f"disaggregated roles: {rec['handovers']} handovers "
              f"({rec['handover_pages']} pages moved, 0 bytes copied); "
              f"host syncs prefill {roles.get('prefill', 0)} / decode "
              f"{roles.get('decode', 0)}; {rec['decode_tokens']} "
              f"decode-role tokens")
    if not rec["paged"]:
        print(f"preemptions {rec['preemptions']} (dense pool)", flush=True)
        return
    print(f"pages: {rec['pages_high_water']}/{rec['n_pages']} "
          f"layer-0 high water ({rec['pool_bytes']} B), "
          f"{rec['preemptions']} preemptions -> "
          f"{rec['spilled_pages']} pages spilled, "
          f"{rec['restores']} restores "
          f"(layer-1 high water {rec['spill_high_water']}/"
          f"{rec['n_spill_pages']})", flush=True)
    if args.kv_quant:
        print(f"tier codecs: layer0={rec['layer0_codec']} "
              f"layer1={rec['layer1_codec']}; "
              f"{rec['resident_high_water']} residents high water in "
              f"{rec['pool_bytes']} B", flush=True)
    if args.park_idle is not None:
        print(f"host parking: {rec['parks']} parked at step "
              f"{args.park_idle}, {rec['park_resumes']} resumed "
              f"(re-admitted as resumes, not re-prefills)", flush=True)
    if args.prefix_share:
        hw = max(rec["pages_high_water"], 1)
        print(f"prefix sharing: {rec['prefix_hits']} hits / "
              f"{rec['prefix_misses']} misses, "
              f"{rec['shared_prefix_tokens']} prompt tokens served from "
              f"cache, {rec['cow_copies']} COW copies; residency "
              f"{rec['mapped_high_water']} mapped vs "
              f"{rec['pages_high_water']} physical pages "
              f"({rec['mapped_high_water'] / hw:.2f}x)", flush=True)


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
                    help="continuous batching over N synthetic requests")
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
    ap.add_argument("--prefix-share", action="store_true",
                    help="share cached prompt prefixes across requests "
                         "(paged mode; drives a shared-system-prompt stream)")
    ap.add_argument("--system-len", type=int, default=None,
                    help="shared system-prompt length for --prefix-share "
                         "(default: half of --prompt-len)")
    ap.add_argument("--chunk-prefill-tokens", type=int, default=None,
                    metavar="N",
                    help="chunked prefill: cap prompt prefill at N tokens "
                         "per drain boundary, interleaved with decode "
                         "(0: derive N from the target's CapacityPartition; "
                         "default: whole-prompt admission)")
    ap.add_argument("--speculate-tokens", type=int, default=None,
                    metavar="K",
                    help="self-drafting speculative decoding: propose up to "
                         "K draft tokens per slot per drain boundary and "
                         "verify them in one batched forward "
                         "(0: derive K from the target's CapacityPartition; "
                         "default: off)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="split serving into prefill-role and decode-role "
                         "engines over the shared paged pool; pages hand "
                         "over at the final prefill chunk (requires "
                         "--paged; bit-identical outputs)")
    ap.add_argument("--kv-quant", choices=["fp16", "fp8", "int8"],
                    default=None,
                    help="per-tier KV page codec (paged mode): fp16 is the "
                         "bit-exact identity; fp8/int8 store more pages in "
                         "the same layer-0 bytes at a bounded logit error, "
                         "and the spill tier quantizes at least as hard "
                         "(fp8 spills as int8)")
    ap.add_argument("--park-idle", type=int, default=None, metavar="N",
                    help="after N decode steps, park every decoding "
                         "resident to the layer-2 host tier (zlib-coded "
                         "page bytes + scheduler residue), then resume "
                         "and serve to completion — bit-identical outputs "
                         "at fp16 (paged mode)")
    ap.add_argument("--mesh", default="1",
                    help="device mesh: one int or DxM sizes matching "
                         "--mesh-axes; 1 (the default) is the single-device "
                         "path, any size > 1 raises NotImplementedError "
                         "(sharded serving is not ported yet: ROADMAP A13)")
    ap.add_argument("--mesh-axes", default="data,model",
                    help="comma-separated axis names the --mesh sizes bind "
                         "to (default data,model)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    return ap


def run(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, serve, print the report; return its record."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.speculate_tokens is not None and not args.stream:
        ap.error("--speculate-tokens applies to --stream serving")
    if args.paged and not args.stream:
        ap.error("--paged applies to --stream serving")
    if args.prefix_share and not args.paged:
        ap.error("--prefix-share requires --paged (shared pages live in "
                 "the paged pool)")
    if args.disaggregate and not args.paged:
        ap.error("--disaggregate requires --paged (page handover moves "
                 "block-table rows, which the dense pool does not have)")
    if args.kv_quant and not args.paged:
        ap.error("--kv-quant requires --paged (tier codecs apply to the "
                 "paged pool's page bytes)")
    if args.park_idle is not None and not args.paged:
        ap.error("--park-idle requires --paged (the layer-2 host tier "
                 "serializes pages, which the dense pool does not have)")
    try:
        mesh_n = mesh_size(args.mesh)
    except ValueError:
        ap.error(f"--mesh {args.mesh!r}: expected one int or 'DxM' sizes")
    if mesh_n != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded serving needs the port of "
            f"distributed/ and launch/mesh.py, which is not done yet "
            f"(ROADMAP A13); --mesh 1 is the single-device path")
    system_len = args.system_len or max(1, args.prompt_len // 2)
    if args.prefix_share and system_len >= args.prompt_len:
        ap.error("--system-len must leave room for a unique tail "
                 "(< --prompt-len)")
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    dev = resolve_device(args.device)
    target = args.target or serving_target(dev)
    tgt_ctx = use_target(target) if target else contextlib.nullcontext()
    with tgt_ctx:
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        max_len = args.prompt_len + args.gen_len
        spec_k = args.speculate_tokens
        if spec_k == 0:
            spec_k = derive_speculate_tokens(cfg)
            print(f"derived --speculate-tokens {spec_k} "
                  f"(target {get_target().name})")
        engine = Engine(model, params,
                        EngineConfig(max_len=max_len,
                                     sync_interval=args.sync_interval,
                                     speculate_tokens=spec_k or 0,
                                     disaggregate=args.disaggregate))
        del params
        if args.stream:
            pages = None
            if args.paged:
                pages = derive_page_geometry(
                    cfg, max_len, page_tokens=args.page_tokens,
                    max_slots=max(2, args.batch),
                    layer0_bytes=args.layer0_bytes,
                    layer1_bytes=args.layer1_bytes,
                    kv_quant=args.kv_quant)
            n_slots = args.slots or derive_n_slots(
                cfg, max_len, max_slots=max(2, args.batch), pages=pages)
            chunk = args.chunk_prefill_tokens
            if chunk == 0:
                chunk = derive_prefill_chunk(cfg)
                print(f"derived --chunk-prefill-tokens {chunk} "
                      f"(target {get_target().name})")
            sched = Scheduler(n_slots=n_slots, pages=pages,
                              prefix_share=args.prefix_share,
                              chunk_prefill_tokens=chunk,
                              disaggregate=args.disaggregate)
            if args.prefix_share:
                stream = shared_prefix_stream(
                    args.stream, system_len, args.prompt_len - system_len,
                    args.gen_len, cfg.vocab_size)
            elif spec_k:
                # the motif-tiled workload the prompt-lookup proposer is
                # built for
                stream = repetitive_stream(args.stream, args.prompt_len,
                                           args.gen_len, cfg.vocab_size)
            else:
                stream = synthetic_stream(args.stream, args.prompt_len,
                                          args.gen_len, cfg.vocab_size)
            rec = run_stream(engine, sched, stream,
                             park_idle=args.park_idle or 0)
            _print_stream(cfg, args, rec, dev)
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
