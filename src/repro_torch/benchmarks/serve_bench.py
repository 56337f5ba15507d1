"""Serving benchmark: static vs continuous vs paged-two-tier vs
prefix-shared tokens/s AND pool footprint, on the card.

The counterpart of ``benchmarks/serve_bench.py``: the same head-to-heads,
flags, gates and record keys, driven through the port's engine
(``repro_torch.serve``). It runs on the card unless ``--device cpu`` is
given (without a card it raises), at the ``REDUCED`` smoke widths unless
``--full`` asks for the published ones, under ``--target`` or else the
launcher's serving target (``h100`` on the card, the registry default on
the CPU). Weights are random, from a seeded ``torch.Generator``; every
``run_*`` function also takes a ``params`` tree (the tests hand in the
reference's weights through ``repro_torch.models.bridge``).

Drives the same synthetic mixed short/long request stream through the same
Engine in up to four modes:

  * **static** — requests are grouped into fixed batches of ``n_slots``; a
    batch admits once and decodes until its SLOWEST request drains.
  * **continuous** — one scheduler over the whole stream over the dense
    slot slab: every slot reserves a ``max_len``-deep KV slab.
  * **paged** (``--paged``) — the paged two-tier pool inside the SAME
    layer-0 byte budget the dense pool used: admission by pages, spill to
    the layer-1 tier under pressure; concurrent slots per byte.
  * **paged+share** (``--prefix-share``) — the shared-system-prompt stream
    through the paged pool twice in the SAME layer-0 bytes, sharing off vs
    on: tok/s, TTFT, physical vs mapped pages, and the outputs gate.

``--speculate`` runs the speculative-decoding head-to-head (the repetitive
stream, speculation off vs on in the same layer-0 bytes; gated metric:
decode tokens per forward), ``--chunked-prefill`` the admission-stall
head-to-head (baseline, one-shot and chunked admission of one
``--long-prompt-len`` prompt; gated metric: the token-weighted inter-token
p99), ``--disaggregate`` the prefill/decode role split (decode-role tok/s
at the inter-token p99, both runs phase-timed) and ``--kv-quant`` the
tier-codec head-to-head (concurrent residents per layer-0 byte; with
``--park-idle N`` the layer-2 host tier inside both runs). ``--mesh N``
with N > 1 raises ``NotImplementedError``: the mesh-sharded head-to-head
needs ``distributed/`` and ``launch/mesh.py``, which are not ported yet
(ROADMAP A13).

Latency on the host's wall clock, beside the reference's step clocks:

  * **inter-token**, token-weighted: each token emitted at a drain
    boundary contributes one sample of that boundary's wall divided by
    the tokens a stream received there — the decode chunk's length
    (``sync_interval``), as the reference's ``_stream_metrics`` divides;
    under speculation, whose verify forward emits a varying count, the
    boundary's tokens over the requests that received one;
  * **TTFT**: the host clock from the stream's submission to the drain
    that delivered a request's first token (``Request.first_wall``), over
    every request that received one; in static mode the stream is
    submitted at once, so later batches wait for earlier ones.

Outputs gates. The reference holds four pairs of runs bit-exact: sharing
off vs on, one-shot vs chunked prefill, speculation off vs on, combined vs
disaggregated. On the CPU all four stay exact here. On the card cuBLAS
picks GEMM algorithms by the row count, so the shared, chunked and
speculative runs are held by the teacher-forced rule
(``repro_torch.serve.checks``): every token of the second run, and of the
first where they part, within 0.05 of the best logit of one full-sequence
forward. Each gate's record carries its rule, the requests that parted and
the worst gap. Disaggregated == combined stays exact on the card.

Every record carries pool bytes and pages next to throughput. Emits
``serve_bench.json`` (and one artifact per head-to-head) under the port's
``src/repro_torch/benchmarks/artifacts/``; ``--emit-bench`` also writes
the flat metric file there as ``torch_BENCH_10.json`` (the reference's
schema, so ``tools/diff_bench.py`` diffs it), never at the repo root.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench
        [--device cpu] [--full] [--target NAME] [--paged] [--page-tokens N]
        [--layer0-bytes B] [--layer1-bytes B] [--require-spill]
        [--prefix-share] [--system-len N] [--require-share-win]
        [--chunked-prefill] [--long-prompt-len N] [--chunk-prefill-tokens N]
        [--sync-interval N] [--require-flat-p99] [--flat-p99-tol F]
        [--repeats N] [--speculate] [--speculate-tokens K]
        [--require-speculate-win] [--mesh SPEC] [--mesh-axes NAMES]
        [--require-scaling] [--disaggregate] [--require-disagg-win]
        [--disagg-win-min F] [--kv-quant CODEC] [--park-idle N]
        [--require-residency-win] [--emit-bench] [...]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.benchmarks.common import (ARTIFACT_ROOT, add_target_arg,
                                           fmt_table, save_artifact)
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.target import get_target, use_target
from repro_torch.launch.serve import mesh_size, serving_target
from repro_torch.models.api import build_model, resolve_device
from repro_torch.serve.checks import LOGIT_TOL, teacher_forced_gap
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import (DECODING, PREFILLING, Scheduler,
                                         derive_n_slots, derive_page_geometry,
                                         derive_prefill_chunk,
                                         derive_speculate_tokens,
                                         kv_bytes_per_token, percentile,
                                         repetitive_stream,
                                         shared_prefix_stream,
                                         synthetic_stream)

BENCH_ID = 10
#: the port's flat metric file, in its artifacts directory
BENCH_FILE = f"torch_BENCH_{BENCH_ID}.json"


def _emit_bench_json(meta: Dict, metrics: Dict) -> str:
    """Write the flat metric file ``torch_BENCH_<id>.json`` under the
    port's artifacts. Values are plain numbers only, keyed
    ``<run>.<metric>``, as the reference's ``BENCH_<id>.json``."""
    clean = {k: v for k, v in metrics.items()
             if isinstance(v, (int, float)) and not isinstance(v, bool)}
    payload = {"bench_id": BENCH_ID, "schema": 1, "meta": meta,
               "metrics": clean}
    os.makedirs(ARTIFACT_ROOT, exist_ok=True)
    path = os.path.join(ARTIFACT_ROOT, BENCH_FILE)
    with open(path, "w") as f:
        f.write(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


@contextlib.contextmanager
def _bench(target_name, arch: str, device, full: bool, params):
    """The card unless ``device`` says otherwise; ``target_name``, else the
    launcher's serving target; the REDUCED config unless ``full``; weights
    from a seeded generator unless ``params`` are given. Yields (device,
    target, config, model, params)."""
    dev = resolve_device(device)
    name = target_name or serving_target(dev)
    with use_target(name) if name else contextlib.nullcontext():
        cfg = get_config(arch) if full else get_reduced(arch)
        model = build_model(cfg, device=dev)
        if params is None:
            params = model.init(torch.Generator(device=dev).manual_seed(0))
        yield dev, get_target(), cfg, model, params


def _serve(engine: Engine, sch: Scheduler, **kw):
    """One ``engine.serve`` on the host's wall clock, the device drained
    before the clock stops. Returns (report, seconds)."""
    t0 = time.perf_counter()
    rep = engine.serve(scheduler=sch, **kw)
    if engine.core.device.type == "cuda":
        torch.cuda.synchronize(engine.core.device)
    return rep, time.perf_counter() - t0


def _gap_samples(stats: Sequence[Dict], steps: Optional[int],
                 walls_key: str = "boundary_wall_s") -> List[float]:
    """The token-weighted inter-token samples of one or more serve runs
    (see the module doc): ``steps`` tokens a stream a boundary, or, when
    None, the boundary's tokens over the requests that received one."""
    samples: List[float] = []
    for st in stats:
        for w, t, n in zip(st[walls_key], st["boundary_tokens"],
                           st["boundary_streams"]):
            if t:
                samples.extend([w / (steps or t / n)] * t)
    return samples


def _ttft_s(requests, t0: float) -> List[float]:
    """Wall-clock TTFT of every request that received a first token: its
    drain's host clock (``Request.first_wall``) minus ``t0``."""
    return [r.first_wall - t0 for r in requests if r.first_wall >= 0]


def _percentiles_ms(name: str, xs: Sequence[float]) -> Dict:
    """``{name}_p50_ms`` / ``_p95_ms`` / ``_p99_ms`` of ``xs`` (seconds)."""
    return {f"{name}_p{q}_ms": percentile(xs, q) * 1e3 for q in (50, 95, 99)}


def _outputs_gate(first: Dict, second: Dict, *, exact: bool, cfg=None,
                  params=None, prompts=None) -> Dict:
    """Hold two runs' outputs (rid -> tokens) to each other: ``exact``, or
    the teacher-forced rule (module doc) over every request of ``second``
    and, where the runs part, of ``first``. Returns the gate's record:
    its rule, the requests that parted, the worst gap and whether it
    passed."""
    parted = sorted(rid for rid in set(first) | set(second)
                    if first.get(rid) != second.get(rid))
    if exact:
        return {"rule": "exact", "parted": len(parted), "worst_gap": 0.0,
                "passed": not parted}
    worst = 0.0
    for rid, toks in second.items():
        runs = [toks] + ([first[rid]] if rid in parted and rid in first
                         else [])
        for t in runs:
            if t:
                worst = max(worst, teacher_forced_gap(cfg, params,
                                                      prompts[rid], t))
    return {"rule": f"teacher-forced, gap <= {LOGIT_TOL}",
            "parted": len(parted), "worst_gap": worst,
            "passed": worst <= LOGIT_TOL}


def _check_gate(what: str, gate: Dict) -> None:
    """``SystemExit`` naming ``what`` unless ``gate`` passed."""
    if not gate["passed"]:
        raise SystemExit(
            f"{what} ({gate['parted']} requests part; rule: {gate['rule']}"
            f", worst gap {gate['worst_gap']:.4f})")


def _run_mode(engine, stream: List[Dict], n_slots: int, mode: str,
              geom=None) -> Dict:
    paged = mode in ("paged", "paged+share")

    def make_sched():
        return Scheduler(n_slots=n_slots, pages=geom if paged else None,
                         prefix_share=(mode == "paged+share"))

    t0 = time.perf_counter()
    reports = []
    if mode == "static":                    # one batch at a time
        for i in range(0, len(stream), n_slots):
            sch = make_sched()
            for spec in stream[i:i + n_slots]:
                sch.submit(spec["prompt"], spec["max_new_tokens"])
            reports.append(_serve(engine, sch)[0])
    else:                                   # continuous / paged [+share]
        sch = make_sched()
        for spec in stream:
            sch.submit(spec["prompt"], spec["max_new_tokens"])
        reports.append(_serve(engine, sch)[0])
    dt = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens) for rep in reports for r in rep.requests)
    ttft = [t for rep in reports for t in rep.stats["ttft_steps"]]
    ttft_emit = [t for rep in reports
                 for t in rep.stats["ttft_emit_steps"]]
    last = reports[-1].stats
    rec = {
        "mode": mode,
        "wall_s": dt,
        "n_tokens": n_tokens,
        "tok_per_s": n_tokens / dt if dt else 0.0,
        "decode_steps": sum(rep.stats["decode_steps"] for rep in reports),
        "host_syncs": sum(rep.stats["host_syncs"] for rep in reports),
        "boundaries": sum(len(rep.stats["boundary_wall_s"])
                          for rep in reports),
        "max_slot_reuse": max(rep.stats["max_slot_reuse"]
                              for rep in reports),
        "completed": sum(rep.stats["drained"] for rep in reports),
        "n_slots": n_slots,
        "preemptions": sum(rep.stats["preemptions"] for rep in reports),
        "spilled_pages": sum(rep.stats["spilled_pages"] for rep in reports),
        "restores": sum(rep.stats["restores"] for rep in reports),
        # step clocks restart with each static batch's serve(): None there
        "ttft_steps_p50": (None if mode == "static"
                           else percentile(ttft, 50)),
        "ttft_steps_p95": (None if mode == "static"
                           else percentile(ttft, 95)),
        "ttft_emit_p50": (None if mode == "static"
                          else percentile(ttft_emit, 50)),
        "ttft_emit_p95": (None if mode == "static"
                          else percentile(ttft_emit, 95)),
        **_percentiles_ms("intertoken", _gap_samples(
            [rep.stats for rep in reports], engine.ecfg.sync_interval)),
        **_percentiles_ms("ttft_wall", _ttft_s(
            [r for rep in reports for r in rep.requests], t0)),
        # rid -> tokens and prompts, for the outputs gate (single-report
        # modes only: static restarts rids per batch)
        "outputs": ({r.rid: list(r.tokens) for r in reports[0].requests}
                    if len(reports) == 1 else {}),
        "prompts": {r.rid: r.prompt for r in reports[0].requests},
    }
    if paged:
        rec.update({
            "pool_bytes": last["pool_bytes"],
            "spill_bytes": last["spill_bytes"],
            "page_tokens": last["page_tokens"],
            "n_pages": last["n_pages"],
            "pages_high_water": max(rep.stats["pages_high_water"]
                                    for rep in reports),
            "spill_high_water": max(rep.stats["spill_high_water"]
                                    for rep in reports),
            "mapped_high_water": max(rep.stats["mapped_high_water"]
                                     for rep in reports),
        })
    if mode == "paged+share":
        rec.update({k: last[k] for k in (
            "prefix_hits", "prefix_misses", "shared_prefix_tokens",
            "cow_copies")})
        rec["residency_ratio"] = (rec["mapped_high_water"]
                                  / max(rec["pages_high_water"], 1))
    return rec


def run(target_name=None, arch: str = "qwen2.5-3b", n_requests: int = 32,
        prompt_len: int = 16, gen_len: int = 12, n_slots: int = None,
        seed: int = 0, paged: bool = False, page_tokens: int = 8,
        layer0_bytes: Optional[int] = None,
        layer1_bytes: Optional[int] = None, max_slots: int = 32,
        require_spill: bool = False, prefix_share: bool = False,
        system_len: Optional[int] = None,
        require_share_win: bool = False,
        sync_interval: Optional[int] = None,
        emit_bench: bool = False, *, device=None, full: bool = False,
        params: Any = None, warmup: bool = True) -> str:
    paged = paged or prefix_share
    with _bench(target_name, arch, device, full, params) as (
            dev, target, cfg, model, params):
        if prefix_share:
            # shared-system-prompt workload: one common prefix (3 full
            # pages by default) + unique tails up to one page
            system_len = system_len or 3 * page_tokens
            tail_len = page_tokens
            prompt_len = system_len + tail_len
            stream = shared_prefix_stream(n_requests, system_len, tail_len,
                                          gen_len, cfg.vocab_size, seed)
        else:
            stream = synthetic_stream(n_requests, prompt_len, gen_len,
                                      cfg.vocab_size, seed)
        max_len = prompt_len + gen_len
        n_slots = n_slots or derive_n_slots(cfg, max_len, max_slots=8)
        engine = Engine(model, params,
                        EngineConfig(max_len=max_len,
                                     sync_interval=sync_interval or 4))
        del params
        # the dense pool's layer-0 footprint is the shared byte budget:
        # the paged pool must beat it on concurrency INSIDE the same bytes
        dense_bytes = n_slots * kv_bytes_per_token(cfg) * max_len
        modes = [("static", n_slots, None), ("continuous", n_slots, None)]
        geom = None
        if paged:
            geom = derive_page_geometry(
                cfg, max_len, page_tokens=page_tokens, max_slots=max_slots,
                layer0_bytes=(layer0_bytes if layer0_bytes is not None
                              else dense_bytes),
                layer1_bytes=layer1_bytes)
            paged_slots = derive_n_slots(cfg, max_len, pages=geom,
                                         max_slots=max_slots)
            modes.append(("paged", paged_slots, geom))
            if prefix_share:
                # sharing on vs off, SAME geometry and layer-0 bytes
                modes.append(("paged+share", paged_slots, geom))
        if warmup:      # first calls of every shape (and the kernel builds)
            for mode, slots, g in modes[1:]:
                _run_mode(engine, stream, slots, mode, g)
        recs = [_run_mode(engine, stream, slots, mode, g)
                for mode, slots, g in modes]

        by_mode = {r["mode"]: r for r in recs}
        outputs = {r["mode"]: r.pop("outputs") for r in recs}  # not saved
        prompts = {r["mode"]: r.pop("prompts") for r in recs}
        share_gate = None
        if prefix_share:
            share_gate = _outputs_gate(
                outputs["paged"], outputs["paged+share"],
                exact=dev.type != "cuda", cfg=cfg, params=engine.params,
                prompts=prompts["paged+share"])
    stat, cont = by_mode["static"], by_mode["continuous"]
    for r in recs:
        r["pool_bytes"] = r.get("pool_bytes", dense_bytes)
    speedup = (cont["tok_per_s"] / stat["tok_per_s"]
               if stat["tok_per_s"] else 0.0)
    artifact = {
        "arch": cfg.name, "target": target.name, "device": str(dev),
        "n_requests": n_requests,
        "prompt_len": prompt_len, "gen_len": gen_len, "n_slots": n_slots,
        "dense_pool_bytes": dense_bytes,
        "static": stat, "continuous": cont, "speedup_tok_per_s": speedup,
    }
    lines = []
    if paged:
        pg = by_mode["paged"]
        slots_ratio = pg["n_slots"] / max(cont["n_slots"], 1)
        artifact.update({
            "paged": pg,
            "slots_ratio_paged_vs_dense": slots_ratio,
            "layer0_bytes": pg["pool_bytes"],
            "layer1_bytes": pg["spill_bytes"],
        })
        lines.append(
            f"paged vs dense concurrency: {pg['n_slots']} vs "
            f"{cont['n_slots']} slots in {pg['pool_bytes']} layer-0 bytes "
            f"({slots_ratio:.2f}x), spill tier: {pg['preemptions']} "
            f"preemptions / {pg['spilled_pages']} pages")
        if require_spill and pg["preemptions"] < 1:
            raise SystemExit(
                "serve_bench --require-spill: the layer-1 spill tier was "
                "never exercised — shrink --layer0-bytes")
    if prefix_share:
        pg, sh = by_mode["paged"], by_mode["paged+share"]
        _check_gate("serve_bench --prefix-share: sharing-on outputs differ "
                    "from sharing-off — prefix sharing must be bit-exact",
                    share_gate)
        artifact.update({
            "prefix_share": sh, "system_len": system_len,
            "residency_ratio": sh["residency_ratio"],
            "share_outputs_bit_identical": share_gate["parted"] == 0,
            "share_gate": share_gate,
        })
        lines.append(
            f"prefix sharing (system prompt {system_len} tok, same "
            f"{sh['pool_bytes']} layer-0 bytes): residency "
            f"{sh['mapped_high_water']} mapped vs {sh['pages_high_water']} "
            f"physical pages ({sh['residency_ratio']:.2f}x), ttft p50/p95 "
            f"{sh['ttft_steps_p50']:.0f}/{sh['ttft_steps_p95']:.0f} vs "
            f"{pg['ttft_steps_p50']:.0f}/{pg['ttft_steps_p95']:.0f} steps "
            f"sharing-off, wall ttft p95 {sh['ttft_wall_p95_ms']:.1f} vs "
            f"{pg['ttft_wall_p95_ms']:.1f} ms, {sh['prefix_hits']} hits "
            f"({sh['shared_prefix_tokens']} prompt tokens from cache, "
            f"{sh['cow_copies']} COW), outputs gate: {share_gate['rule']}, "
            f"{share_gate['parted']} parted, worst gap "
            f"{share_gate['worst_gap']:.4f}")
        if require_share_win and (
                sh["residency_ratio"] < 1.5
                or sh["ttft_steps_p95"] > pg["ttft_steps_p95"]):
            raise SystemExit(
                "serve_bench --require-share-win: expected >=1.5x mapped/"
                "physical residency and no-worse TTFT p95 with sharing on; "
                f"got {sh['residency_ratio']:.2f}x, p95 "
                f"{sh['ttft_steps_p95']:.0f} vs {pg['ttft_steps_p95']:.0f}")
    save_artifact("serve_bench.json", artifact)
    if emit_bench:
        metrics = {"speedup_tok_per_s": speedup}
        for r in recs:
            metrics.update({f"{r['mode']}.{k}": v for k, v in r.items()})
        path = _emit_bench_json(
            {"mode": "serve", "arch": cfg.name, "target": target.name,
             "device": str(dev), "n_requests": n_requests}, metrics)
        lines.append(f"bench metrics -> {path}")
    rows = [[r["mode"], f"{r['tok_per_s']:.1f}", r["n_tokens"], r["n_slots"],
             r["pool_bytes"], r.get("pages_high_water", "-"),
             ("-" if r["ttft_steps_p50"] is None else
              f"{r['ttft_steps_p50']:.0f}/{r['ttft_steps_p95']:.0f}"),
             f"{r['ttft_wall_p50_ms']:.1f}/{r['ttft_wall_p95_ms']:.1f}",
             f"{r['intertoken_p50_ms']:.2f}/{r['intertoken_p99_ms']:.2f}",
             r["preemptions"], r["max_slot_reuse"],
             f"{r['wall_s']*1e3:.0f} ms"] for r in recs]
    table = fmt_table(
        ["mode", "tok/s", "tokens", "slots", "pool bytes", "pages hw",
         "ttft p50/95", "ttft ms 50/95", "it ms 50/99", "preempt",
         "max reuse", "wall"],
        rows, title=f"Serve bench — {cfg.name}, {n_requests} requests "
                    f"({target.name}, {dev})")
    return "\n".join([table,
                      f"continuous/static speedup: {speedup:.2f}x"] + lines)


def _stream_metrics(rep, sync_interval: int) -> Dict:
    """Flatten one ServeReport into the latency/counter record the
    chunked-prefill head-to-head compares across runs.

    The inter-token distribution is token-weighted: every token emitted at
    a drain boundary contributes one sample of that boundary's
    ``wall / sync_interval``, so a slow boundary counts once per consumer
    that observed the gap. Boundaries that emit nothing (all decode slots
    drained, only prefill chunks ran) add no samples.
    """
    st = rep.stats
    return {
        "n_tokens": sum(len(r.tokens) for r in rep.requests),
        **_percentiles_ms("intertoken", _gap_samples([st], sync_interval)),
        "ttft_steps_p50": percentile(st["ttft_steps"], 50),
        "ttft_steps_p95": percentile(st["ttft_steps"], 95),
        "ttft_emit_p50": percentile(st["ttft_emit_steps"], 50),
        "ttft_emit_p95": percentile(st["ttft_emit_steps"], 95),
        "e2e_steps_p50": percentile(st["e2e_steps"], 50),
        "e2e_steps_p95": percentile(st["e2e_steps"], 95),
        "boundaries": len(st["boundary_wall_s"]),
        "completed": st["drained"],
        "decode_steps": st["decode_steps"],
        "host_syncs": st["host_syncs"],
        "preemptions": st["preemptions"],
        "spilled_pages": st["spilled_pages"],
        "restores": st["restores"],
        "prefill_chunks": st["prefill_chunks"],
        "max_boundary_prefill_tokens": st["max_boundary_prefill_tokens"],
        "pages_high_water": st.get("pages_high_water", 0),
        "mapped_high_water": st.get("mapped_high_water", 0),
        "prefix_hits": st.get("prefix_hits", 0),
        "cow_copies": st.get("cow_copies", 0),
    }


def run_chunked(target_name=None, arch: str = "qwen2.5-3b",
                n_requests: int = 32, prompt_len: int = 16,
                gen_len: int = 12, n_slots: Optional[int] = None,
                seed: int = 0, page_tokens: int = 8,
                layer0_bytes: Optional[int] = None,
                layer1_bytes: Optional[int] = None, max_slots: int = 32,
                prefix_share: bool = False,
                system_len: Optional[int] = None,
                long_prompt_len: int = 4096, long_gen_len: int = 4,
                chunk_prefill_tokens: int = 0, sync_interval: int = 8,
                flat_p99_tol: float = 0.10, require_flat_p99: bool = False,
                require_spill: bool = False, repeats: int = 3,
                emit_bench: bool = False, *, device=None, full: bool = False,
                params: Any = None, warmup: bool = True) -> str:
    """The chunked-prefill admission-stall head-to-head (see module doc)."""
    with _bench(target_name, arch, device, full, params) as (
            dev, target, cfg, model, params):
        if prefix_share:
            system_len = system_len or 3 * page_tokens
            prompt_len = system_len + page_tokens
            shorts = shared_prefix_stream(n_requests, system_len,
                                          page_tokens, gen_len,
                                          cfg.vocab_size, seed)
        else:
            shorts = synthetic_stream(n_requests, prompt_len, gen_len,
                                      cfg.vocab_size, seed)
        rng = np.random.RandomState(seed + 1)
        long_prompt = rng.randint(2, cfg.vocab_size,
                                  size=long_prompt_len).astype(np.int32)
        chunk = chunk_prefill_tokens or derive_prefill_chunk(cfg)
        max_len = long_prompt_len + max(gen_len, long_gen_len)
        n_slots = n_slots or 8
        if layer0_bytes is None:
            # fully resident by default: the head-to-head isolates the
            # admission stall. --layer0-bytes shrinks the pool to compose
            # chunking with spill/preemption.
            resident = (n_slots * (prompt_len + gen_len + page_tokens)
                        + long_prompt_len + long_gen_len + page_tokens)
            layer0_bytes = kv_bytes_per_token(cfg) * resident
        geom = derive_page_geometry(cfg, max_len, page_tokens=page_tokens,
                                    max_slots=max_slots,
                                    layer0_bytes=layer0_bytes,
                                    layer1_bytes=layer1_bytes)
        engine = Engine(model, params,
                        EngineConfig(max_len=max_len,
                                     sync_interval=sync_interval))
        del params

        def serve(with_long, chunk_setting):
            sch = Scheduler(n_slots=n_slots, pages=geom,
                            prefix_share=prefix_share,
                            chunk_prefill_tokens=chunk_setting)
            stream = list(shorts)
            if with_long:
                # lands mid-stream: the pool decodes at full concurrency
                # when the long prompt admits
                stream.insert(min(n_slots, len(stream)),
                              {"prompt": long_prompt,
                               "max_new_tokens": long_gen_len})
            for spec in stream:
                sch.submit(spec["prompt"], spec["max_new_tokens"])
            t0 = time.perf_counter()
            return (t0,) + _serve(engine, sch)

        runs = [("baseline", False, chunk),   # no long prompt
                ("unchunked", True, None),    # one-shot admission: stall
                ("chunked", True, chunk)]     # chunked admission
        if warmup:
            for _, with_long, c in runs:
                serve(with_long, c)
        recs, outputs, prompts = [], {}, {}
        for name, with_long, c in runs:
            # wall-clock p99 on a shared host is noisy: measure `repeats`
            # passes and keep the median-p99 one
            passes = []
            for _ in range(max(1, repeats)):
                t0, rep, dt = serve(with_long, c)
                m = {"run": name, "wall_s": dt,
                     **_stream_metrics(rep, sync_interval),
                     **_percentiles_ms("ttft_wall",
                                       _ttft_s(rep.requests, t0))}
                m["tok_per_s"] = m["n_tokens"] / dt if dt else 0.0
                passes.append((m, rep))
            passes.sort(key=lambda p: p[0]["intertoken_p99_ms"])
            rec, rep = passes[len(passes) // 2]
            recs.append(rec)
            outputs[name] = {r.rid: list(r.tokens) for r in rep.requests}
            prompts[name] = {r.rid: r.prompt for r in rep.requests}
        # phase breakdown runs separately: phase_timing blocks on device
        # completion per phase, which would skew the latency numbers above
        phases = {}
        engine.ecfg.phase_timing = True
        try:
            for name, with_long, c in (("unchunked", True, None),
                                       ("chunked", True, chunk)):
                phases[name] = dict(serve(with_long, c)[1].stats.get(
                    "phase_s", {}))
        finally:
            engine.ecfg.phase_timing = False
        gate = _outputs_gate(
            outputs["unchunked"], outputs["chunked"],
            exact=dev.type != "cuda", cfg=cfg, params=engine.params,
            prompts=prompts["chunked"])

    by = {r["run"]: r for r in recs}
    _check_gate("serve_bench --chunked-prefill: chunked outputs differ from "
                "one-shot prefill — chunked prefill must be bit-exact", gate)
    base_p99 = by["baseline"]["intertoken_p99_ms"] or 1e-9
    ratio_chunked = by["chunked"]["intertoken_p99_ms"] / base_p99
    ratio_unchunked = by["unchunked"]["intertoken_p99_ms"] / base_p99
    artifact = {
        "arch": cfg.name, "target": target.name, "device": str(dev),
        "n_requests": n_requests,
        "long_prompt_len": long_prompt_len,
        "chunk_prefill_tokens": chunk, "sync_interval": sync_interval,
        "n_slots": n_slots, "layer0_bytes": layer0_bytes,
        "prefix_share": prefix_share,
        "p99_ratio_chunked": ratio_chunked,
        "p99_ratio_unchunked": ratio_unchunked,
        "flat_p99_tol": flat_p99_tol,
        "outputs_bit_identical": gate["parted"] == 0,
        "chunk_gate": gate,
        "phase_s": phases,
        "runs": {r["run"]: r for r in recs},
    }
    save_artifact("serve_chunked_bench.json", artifact)
    rows = [[r["run"], f"{r['tok_per_s']:.1f}", r["n_tokens"],
             f"{r['intertoken_p50_ms']:.1f}",
             f"{r['intertoken_p99_ms']:.1f}",
             f"{r['ttft_emit_p50']:.0f}/{r['ttft_emit_p95']:.0f}",
             f"{r['ttft_wall_p50_ms']:.0f}/{r['ttft_wall_p95_ms']:.0f}",
             f"{r['e2e_steps_p95']:.0f}", r["preemptions"],
             r["prefill_chunks"], f"{r['wall_s']*1e3:.0f} ms"]
            for r in recs]
    table = fmt_table(
        ["run", "tok/s", "tokens", "it p50 ms", "it p99 ms",
         "ttft emit 50/95", "ttft ms 50/95", "e2e p95", "preempt", "chunks",
         "wall"],
        rows, title=f"Chunked prefill head-to-head — {cfg.name}, "
                    f"{n_requests}+1 requests, {long_prompt_len}-token "
                    f"admission, chunk={chunk} ({target.name}, {dev})")
    phase_keys = ("prefill", "insert", "generate", "drain")
    phase_rows = [[name] + [f"{phases[name].get(k, 0.0)*1e3:.0f}"
                            for k in phase_keys]
                  for name in phases]
    phase_table = fmt_table(
        ["run"] + [f"{k} ms" for k in phase_keys], phase_rows,
        title="Phase breakdown (separate phase-timed pass)")
    lines = [
        table, phase_table,
        f"p99 inter-token vs baseline: chunked x{ratio_chunked:.2f}, "
        f"one-shot x{ratio_unchunked:.2f} (tol {flat_p99_tol:.0%}); "
        f"outputs gate: {gate['rule']}, {gate['parted']} parted, worst gap "
        f"{gate['worst_gap']:.4f}"]
    if require_spill and by["chunked"]["preemptions"] < 1:
        raise SystemExit(
            "serve_bench --require-spill: the chunked run never preempted "
            "— shrink --layer0-bytes")
    if emit_bench:
        metrics = {"p99_ratio_chunked": ratio_chunked,
                   "p99_ratio_unchunked": ratio_unchunked}
        for r in recs:
            metrics.update({f"{r['run']}.{k}": v for k, v in r.items()})
        for name, ph in phases.items():
            metrics.update({f"{name}.phase_{k}_s": v
                            for k, v in ph.items()})
        path = _emit_bench_json(
            {"mode": "chunked-prefill", "arch": cfg.name,
             "target": target.name, "device": str(dev),
             "n_requests": n_requests,
             "long_prompt_len": long_prompt_len,
             "chunk_prefill_tokens": chunk,
             "sync_interval": sync_interval}, metrics)
        lines.append(f"bench metrics -> {path}")
    if require_flat_p99:
        if ratio_chunked > 1 + flat_p99_tol:
            raise SystemExit(
                "serve_bench --require-flat-p99: chunked admission moved "
                f"p99 inter-token x{ratio_chunked:.2f} vs baseline "
                f"(tolerance {flat_p99_tol:.0%}) — the chunk budget is not "
                "hiding under decode; shrink --chunk-prefill-tokens or "
                "raise --sync-interval")
        if ratio_unchunked <= 1 + flat_p99_tol:
            raise SystemExit(
                "serve_bench --require-flat-p99: the one-shot admission "
                f"stall never materialized (x{ratio_unchunked:.2f}) — the "
                "head-to-head is not measuring anything; lengthen "
                "--long-prompt-len")
    return "\n".join(lines)


def run_speculate(target_name=None, arch: str = "qwen2.5-3b",
                  n_requests: int = 24, prompt_len: int = 48,
                  gen_len: int = 32, n_slots: int = None, seed: int = 0,
                  page_tokens: int = 8,
                  layer0_bytes: Optional[int] = None,
                  layer1_bytes: Optional[int] = None, max_slots: int = 32,
                  speculate_tokens: int = 0,
                  sync_interval: Optional[int] = None,
                  require_speculate_win: bool = False,
                  emit_bench: bool = False, *, device=None,
                  full: bool = False, params: Any = None,
                  warmup: bool = True) -> str:
    """Speculative-decoding head-to-head: the repetitive stream through
    the paged pool in the SAME layer-0 byte budget, speculation off vs on.

    The gated metric is decode **tokens per forward** (modeled: each
    decode forward sweeps the pool's resident KV); wall tok/s and the
    inter-token distribution are reported beside it, not gated.
    """
    with _bench(target_name, arch, device, full, params) as (
            dev, target, cfg, model, params):
        k = speculate_tokens or derive_speculate_tokens(cfg) or 4
        stream = repetitive_stream(n_requests, prompt_len, gen_len,
                                   cfg.vocab_size, seed)
        max_len = prompt_len + gen_len
        n_slots = n_slots or derive_n_slots(cfg, max_len, max_slots=8)
        dense_bytes = n_slots * kv_bytes_per_token(cfg) * max_len
        geom = derive_page_geometry(
            cfg, max_len, page_tokens=page_tokens, max_slots=max_slots,
            layer0_bytes=(layer0_bytes if layer0_bytes is not None
                          else dense_bytes),
            layer1_bytes=layer1_bytes)
        slots = derive_n_slots(cfg, max_len, pages=geom,
                               max_slots=max_slots)
        engine = Engine(model, params,
                        EngineConfig(max_len=max_len,
                                     sync_interval=sync_interval or 4,
                                     speculate_tokens=k))
        del params

        def one(spec_k: int) -> Dict:
            engine.ecfg.speculate_tokens = spec_k
            sch = Scheduler(n_slots=slots, pages=geom)
            for spec in stream:
                sch.submit(spec["prompt"], spec["max_new_tokens"])
            t0 = time.perf_counter()
            rep, dt = _serve(engine, sch)
            st = rep.stats
            n_tokens = sum(len(r.tokens) for r in rep.requests)
            rec = {
                "mode": "speculate" if spec_k else "baseline",
                "speculate_tokens": spec_k,
                "wall_s": dt,
                "n_tokens": n_tokens,
                "tok_per_s": n_tokens / dt if dt else 0.0,
                "decode_steps": st["decode_steps"],
                "host_syncs": st["host_syncs"],
                "boundaries": len(st["boundary_wall_s"]),
                "completed": st["drained"],
                "n_slots": slots,
                "pool_bytes": st["pool_bytes"],
                "preemptions": st["preemptions"],
                "spilled_pages": st["spilled_pages"],
                # the gated metric: emitted tokens per full-pool KV sweep
                "tok_per_forward": (n_tokens / st["decode_steps"]
                                    if st["decode_steps"] else 0.0),
                "ttft_steps_p50": percentile(st["ttft_steps"], 50),
                "ttft_steps_p95": percentile(st["ttft_steps"], 95),
                "ttft_emit_p50": percentile(st["ttft_emit_steps"], 50),
                "ttft_emit_p95": percentile(st["ttft_emit_steps"], 95),
                **_percentiles_ms("intertoken", _gap_samples(
                    [st], None if spec_k else engine.ecfg.sync_interval)),
                **_percentiles_ms("ttft_wall", _ttft_s(rep.requests, t0)),
                "outputs": {r.rid: list(r.tokens) for r in rep.requests},
                "prompts": {r.rid: r.prompt for r in rep.requests},
            }
            if spec_k:
                rec.update({key: st[key] for key in (
                    "spec_proposed", "spec_accepted", "spec_rejected",
                    "spec_acceptance_rate")})
            return rec

        if warmup:
            for s in (0, k):
                one(s)
        off, on = one(0), one(k)
        outputs = (off.pop("outputs"), on.pop("outputs"))
        off.pop("prompts")
        prompts = on.pop("prompts")
        gate = _outputs_gate(*outputs, exact=dev.type != "cuda", cfg=cfg,
                             params=engine.params, prompts=prompts)

    ratio = (on["tok_per_forward"] / off["tok_per_forward"]
             if off["tok_per_forward"] else 0.0)
    artifact = {
        "arch": cfg.name, "target": target.name, "device": str(dev),
        "n_requests": n_requests,
        "prompt_len": prompt_len, "gen_len": gen_len,
        "speculate_tokens": k, "layer0_bytes": off["pool_bytes"],
        "baseline": off, "speculate": on,
        "tok_per_forward_ratio": ratio,
        "speculate_outputs_bit_identical": gate["parted"] == 0,
        "speculate_gate": gate,
    }
    save_artifact("serve_speculate.json", artifact)
    lines = [
        f"speculative decoding (k={k}, {on['pool_bytes']} layer-0 bytes, "
        f"acceptance {on['spec_acceptance_rate']:.2f}: "
        f"{on['spec_accepted']}/{on['spec_proposed']} drafts): "
        f"{on['tok_per_forward']:.2f} vs {off['tok_per_forward']:.2f} "
        f"decode tokens/forward ({ratio:.2f}x), wall "
        f"{on['tok_per_s']:.1f} vs {off['tok_per_s']:.1f} tok/s, outputs "
        f"gate: {gate['rule']}, {gate['parted']} parted, worst gap "
        f"{gate['worst_gap']:.4f}"]
    if emit_bench:
        metrics = {"tok_per_forward_ratio": ratio,
                   "acceptance_rate": on["spec_acceptance_rate"]}
        for r in (off, on):
            metrics.update({f"{r['mode']}.{key}": v
                            for key, v in r.items()})
        path = _emit_bench_json(
            {"mode": "speculate", "arch": cfg.name, "target": target.name,
             "device": str(dev), "n_requests": n_requests,
             "speculate_tokens": k}, metrics)
        lines.append(f"bench metrics -> {path}")
    _check_gate("serve_bench --speculate: speculative outputs differ from "
                "the non-speculative run — greedy speculation must be "
                "bit-exact", gate)
    if require_speculate_win and ratio < 1.5:
        raise SystemExit(
            "serve_bench --require-speculate-win: expected >=1.5x decode "
            f"tokens-per-forward with speculation on; got {ratio:.2f}x "
            f"(acceptance {on['spec_acceptance_rate']:.2f}) — lengthen the "
            "stream's repetition or raise --speculate-tokens")
    rows = [[r["mode"], f"{r['tok_per_forward']:.2f}",
             f"{r['tok_per_s']:.1f}", r["n_tokens"], r["decode_steps"],
             r["host_syncs"],
             f"{r['ttft_steps_p50']:.0f}/{r['ttft_steps_p95']:.0f}",
             f"{r['ttft_wall_p50_ms']:.1f}/{r['ttft_wall_p95_ms']:.1f}",
             f"{r['intertoken_p50_ms']:.2f}/{r['intertoken_p99_ms']:.2f}",
             f"{r.get('spec_acceptance_rate', 0.0):.2f}",
             f"{r['wall_s']*1e3:.0f} ms"] for r in (off, on)]
    table = fmt_table(
        ["mode", "tok/fwd", "tok/s", "tokens", "forwards", "syncs",
         "ttft p50/95", "ttft ms 50/95", "it ms 50/99", "accept", "wall"],
        rows, title=f"Speculative decode bench — {cfg.name}, "
                    f"{n_requests} requests, k={k} ({target.name}, {dev})")
    return "\n".join([table] + lines)


def run_disagg(target_name=None, arch: str = "qwen2.5-3b",
               n_requests: int = 24, prompt_len: int = 16,
               gen_len: int = 16, n_slots: Optional[int] = None,
               seed: int = 0, page_tokens: int = 8,
               layer0_bytes: Optional[int] = None,
               layer1_bytes: Optional[int] = None, max_slots: int = 32,
               long_prompt_len: int = 512, n_long: int = 3,
               long_gen_len: int = 8, chunk_prefill_tokens: int = 0,
               sync_interval: int = 8, disagg_win_min: float = 1.15,
               flat_p99_tol: float = 0.10,
               require_disagg_win: bool = False,
               emit_bench: bool = False, *, device=None, full: bool = False,
               params: Any = None, warmup: bool = True) -> str:
    """Disaggregated-roles head-to-head (see module doc): mixed
    long-prompt + decode traffic through the SAME paged pool geometry,
    combined engine vs prefill/decode role split.

    Both runs are phase-timed (every phase blocks on its device work), so
    the decode clock is measured, not simulated: combined, the full
    boundary wall is the inter-token gap every decode consumer observes;
    disaggregated, the decode consumer's clock spans only the decode
    dispatch + the decode role's drain fetch (``boundary_decode_wall_s``).
    """
    with _bench(target_name, arch, device, full, params) as (
            dev, target, cfg, model, params):
        shorts = synthetic_stream(n_requests, prompt_len, gen_len,
                                  cfg.vocab_size, seed)
        rng = np.random.RandomState(seed + 1)
        longs = [{"prompt": rng.randint(2, cfg.vocab_size,
                                        size=long_prompt_len
                                        ).astype(np.int32),
                  "max_new_tokens": long_gen_len}
                 for _ in range(max(1, n_long))]
        # interleave: every batch of short requests is followed by a long
        # prompt, so prompt chunks keep landing while the pool decodes
        stream = []
        per = max(1, len(shorts) // (len(longs) + 1))
        li = 0
        for i, spec in enumerate(shorts):
            stream.append(spec)
            if (i + 1) % per == 0 and li < len(longs):
                stream.append(longs[li])
                li += 1
        stream.extend(longs[li:])
        chunk = chunk_prefill_tokens or derive_prefill_chunk(cfg)
        max_len = long_prompt_len + max(gen_len, long_gen_len)
        n_slots = n_slots or 8
        if layer0_bytes is None:
            resident = (n_slots * (prompt_len + gen_len + page_tokens)
                        + n_long * (long_prompt_len + long_gen_len
                                    + page_tokens))
            layer0_bytes = kv_bytes_per_token(cfg) * resident
        geom = derive_page_geometry(cfg, max_len, page_tokens=page_tokens,
                                    max_slots=max_slots,
                                    layer0_bytes=layer0_bytes,
                                    layer1_bytes=layer1_bytes)

        def one(disagg: bool) -> Dict:
            # a fresh engine per mode keeps phase/role accounting separate;
            # phase_timing on BOTH sides so each phase blocks identically
            engine = Engine(model, params,
                            EngineConfig(max_len=max_len,
                                         sync_interval=sync_interval,
                                         phase_timing=True,
                                         disaggregate=disagg))

            def serve_once():
                sch = Scheduler(n_slots=n_slots, pages=geom,
                                chunk_prefill_tokens=chunk,
                                disaggregate=disagg)
                for spec in stream:
                    sch.submit(spec["prompt"], spec["max_new_tokens"])
                t0 = time.perf_counter()
                return (t0,) + _serve(engine, sch)

            if warmup:
                serve_once()
            t0, rep, dt = serve_once()
            st = rep.stats
            # the decode consumer's clock: full boundary combined, the
            # decode role's own span disaggregated
            walls_key = ("boundary_decode_wall_s" if disagg
                         else "boundary_wall_s")
            decode_wall = sum(st[walls_key])
            n_tokens = sum(len(r.tokens) for r in rep.requests)
            decode_tokens = st.get(
                "decode_tokens",
                n_tokens - sum(1 for r in rep.requests if r.tokens))
            rec = {
                "mode": "disaggregated" if disagg else "combined",
                "wall_s": dt,
                "n_tokens": n_tokens,
                "decode_tokens": decode_tokens,
                "decode_wall_s": decode_wall,
                # the gated metric: decode tokens over the decode clock
                "decode_tok_per_s": (decode_tokens / decode_wall
                                     if decode_wall else 0.0),
                **_percentiles_ms("intertoken", _gap_samples(
                    [st], sync_interval, walls_key)),
                **_percentiles_ms("ttft_wall", _ttft_s(rep.requests, t0)),
                "tok_per_s": n_tokens / dt if dt else 0.0,
                "boundaries": len(st["boundary_wall_s"]),
                "decode_steps": st["decode_steps"],
                "host_syncs": st["host_syncs"],
                "completed": st["drained"],
                "n_slots": n_slots,
                "pool_bytes": st["pool_bytes"],
                "pages_high_water": st["pages_high_water"],
                "preemptions": st["preemptions"],
                "spilled_pages": st["spilled_pages"],
                "restores": st["restores"],
                "prefill_chunks": st["prefill_chunks"],
                "handovers": st["handovers"],
                "handover_pages": st["handover_pages"],
                "ttft_steps_p50": percentile(st["ttft_steps"], 50),
                "ttft_steps_p95": percentile(st["ttft_steps"], 95),
                "ttft_emit_p50": percentile(st["ttft_emit_steps"], 50),
                "ttft_emit_p95": percentile(st["ttft_emit_steps"], 95),
                "phase_s": dict(st.get("phase_s", {})),
                "outputs": {r.rid: list(r.tokens) for r in rep.requests},
            }
            if disagg:
                rec["host_syncs_by_role"] = dict(st["host_syncs_by_role"])
                rec["role_s"] = dict(st.get("role_s", {}))
                for role, n in rec["host_syncs_by_role"].items():
                    if n > rec["boundaries"]:
                        raise SystemExit(
                            f"serve_bench --disaggregate: {role} role made "
                            f"{n} host syncs over {rec['boundaries']} "
                            "boundaries — at most one per role per boundary")
            return rec

        comb = one(False)
        dis = one(True)
        del params

    # the role split moves no GEMM's rows: exact on the card too
    gate = _outputs_gate(comb.pop("outputs"), dis.pop("outputs"),
                         exact=True)
    _check_gate("serve_bench --disaggregate: disaggregated outputs differ "
                "from the combined engine — the role split must be "
                "bit-exact", gate)
    ratio = (dis["decode_tok_per_s"] / comb["decode_tok_per_s"]
             if comb["decode_tok_per_s"] else 0.0)
    p99_ratio = (dis["intertoken_p99_ms"]
                 / max(comb["intertoken_p99_ms"], 1e-9))
    artifact = {
        "arch": cfg.name, "target": target.name, "device": str(dev),
        "n_requests": len(stream), "long_prompt_len": long_prompt_len,
        "n_long": n_long, "chunk_prefill_tokens": chunk,
        "sync_interval": sync_interval, "layer0_bytes": layer0_bytes,
        "decode_tok_per_s_ratio": ratio, "p99_ratio": p99_ratio,
        "disagg_win_min": disagg_win_min, "flat_p99_tol": flat_p99_tol,
        "outputs_bit_identical": True, "disagg_gate": gate,
        "combined": comb, "disaggregated": dis,
    }
    save_artifact("serve_disagg_bench.json", artifact)
    lines = [
        f"disaggregated roles ({dis['handovers']} handovers, "
        f"{dis['handover_pages']} pages moved zero-copy, same "
        f"{dis['pool_bytes']} layer-0 bytes): decode "
        f"{dis['decode_tok_per_s']:.1f} vs {comb['decode_tok_per_s']:.1f} "
        f"tok/s (x{ratio:.2f}), inter-token p99 "
        f"{dis['intertoken_p99_ms']:.2f} vs "
        f"{comb['intertoken_p99_ms']:.2f} ms (x{p99_ratio:.2f}, tol "
        f"{flat_p99_tol:.0%}), role syncs "
        f"{dis['host_syncs_by_role']}, outputs bit-identical"]
    if emit_bench:
        metrics = {"decode_tok_per_s_ratio": ratio,
                   "p99_ratio": p99_ratio}
        for r in (comb, dis):
            metrics.update({f"{r['mode']}.{k}": v for k, v in r.items()})
            metrics.update({f"{r['mode']}.phase_{k}_s": v
                            for k, v in r["phase_s"].items()})
        path = _emit_bench_json(
            {"mode": "disaggregate", "arch": cfg.name,
             "target": target.name, "device": str(dev),
             "n_requests": len(stream),
             "long_prompt_len": long_prompt_len,
             "chunk_prefill_tokens": chunk,
             "sync_interval": sync_interval}, metrics)
        lines.append(f"bench metrics -> {path}")
    if require_disagg_win:
        if ratio < disagg_win_min:
            raise SystemExit(
                "serve_bench --require-disagg-win: expected >="
                f"{disagg_win_min:.2f}x decode tok/s from the role split; "
                f"got x{ratio:.2f} — the stream's prompt work is too thin "
                "to matter (lengthen --long-prompt-len or add --n-long)")
        if p99_ratio > 1 + flat_p99_tol:
            raise SystemExit(
                "serve_bench --require-disagg-win: disaggregated p99 "
                f"inter-token moved x{p99_ratio:.2f} vs combined "
                f"(tolerance {flat_p99_tol:.0%}) — the decode role is not "
                "isolated from prompt work")
    phase_keys = ("prefill", "insert", "generate", "drain", "handover")
    rows = [[r["mode"], f"{r['decode_tok_per_s']:.1f}",
             f"{r['intertoken_p50_ms']:.2f}/{r['intertoken_p99_ms']:.2f}",
             f"{r['ttft_wall_p50_ms']:.0f}/{r['ttft_wall_p95_ms']:.0f}",
             r["n_tokens"], r["decode_tokens"], r["handovers"],
             r["prefill_chunks"], r["preemptions"],
             f"{r['host_syncs']}/{r['boundaries']}",
             f"{r['wall_s']*1e3:.0f} ms"] for r in (comb, dis)]
    table = fmt_table(
        ["mode", "dec tok/s", "it p50/p99 ms", "ttft ms 50/95", "tokens",
         "dec toks", "handover", "chunks", "preempt", "syncs/bnd", "wall"],
        rows, title=f"Disaggregated serve bench — {cfg.name}, "
                    f"{len(stream)} requests ({n_long} x "
                    f"{long_prompt_len}-token prompts), chunk={chunk} "
                    f"({target.name}, {dev})")
    phase_rows = [[r["mode"]] + [f"{r['phase_s'].get(k, 0.0)*1e3:.0f}"
                                 for k in phase_keys]
                  for r in (comb, dis)]
    phase_table = fmt_table(
        ["mode"] + [f"{k} ms" for k in phase_keys], phase_rows,
        title="Phase breakdown (both runs phase-timed)")
    return "\n".join([table, phase_table] + lines)


def run_quant(target_name=None, arch: str = "qwen2.5-3b",
              n_requests: int = 32, prompt_len: int = 16,
              gen_len: int = 12, seed: int = 0, *, page_tokens: int = 8,
              layer0_bytes: Optional[int] = None,
              layer1_bytes: Optional[int] = None, max_slots: int = 32,
              kv_quant: str = "int8", park_idle: int = 0,
              sync_interval: Optional[int] = None,
              residency_win_min: float = 1.8,
              require_residency_win: bool = False,
              emit_bench: bool = False, device=None, full: bool = False,
              params: Any = None, warmup: bool = True) -> str:
    """Tier-codec head-to-head: fp16 vs quantized pages, SAME layer-0
    bytes. The quantized page is smaller, so the same budget holds more
    pages and the pool keeps more sessions concurrently resident — the
    capacity win, gated as residents-per-byte. Greedy first-token
    agreement against the fp16 run bounds the quantization cost. With
    ``park_idle`` each run serves ``park_idle`` decode steps, parks every
    decoding resident, resumes and serves to the end: its host syncs,
    boundaries and inter-token samples are those of both serve() calls."""
    with _bench(target_name, arch, device, full, params) as (
            dev, target, cfg, model, params):
        stream = synthetic_stream(n_requests, prompt_len, gen_len,
                                  cfg.vocab_size, seed)
        max_len = prompt_len + gen_len
        engine = Engine(model, params,
                        EngineConfig(max_len=max_len,
                                     sync_interval=sync_interval or 4))
        del params
        # default budget: four full-depth fp16 residents — tight enough
        # that fp16 concurrency is page-capped, so the codec's smaller
        # page shows up as MORE residents, not just slack
        l0 = (layer0_bytes if layer0_bytes is not None
              else 4 * kv_bytes_per_token(cfg) * max_len)

        def one(qq: str) -> Dict:
            geom = derive_page_geometry(
                cfg, max_len, page_tokens=page_tokens, max_slots=max_slots,
                layer0_bytes=l0, layer1_bytes=layer1_bytes, kv_quant=qq)
            slots = derive_n_slots(cfg, max_len, pages=geom,
                                   max_slots=max_slots)

            def serve_once():
                sch = Scheduler(n_slots=slots, pages=geom)
                reqs = [sch.submit(s["prompt"], s["max_new_tokens"])
                        for s in stream]
                rid_map = {r.rid: r.rid for r in reqs}
                runs = []
                t0 = time.perf_counter()
                if park_idle:
                    runs.append(engine.serve(scheduler=sch,
                                             max_steps=park_idle).stats)
                    blobs = []
                    for slot in sorted(list(sch.active)):
                        req = sch.active[slot]
                        if req.status == DECODING:
                            blobs.append(
                                (req.rid,
                                 engine.park_request(sch, req.rid)))
                        elif req.status == PREFILLING:
                            sch.requeue(slot)
                    for old_rid, blob in blobs:
                        rid_map[old_rid] = \
                            engine.resume_parked(sch, blob).rid
                rep, _ = _serve(engine, sch)
                runs.append(rep.stats)
                return (reqs, rid_map, rep, runs, t0,
                        time.perf_counter() - t0)

            if warmup:
                serve_once()
            reqs, rid_map, rep, runs, t0, dt = serve_once()
            st = rep.stats
            n_tokens = sum(len(r.tokens) for r in rep.requests)
            return {
                "mode": f"kv-quant={qq}",
                "codec": qq,
                "wall_s": dt,
                "n_tokens": n_tokens,
                "tok_per_s": n_tokens / dt if dt else 0.0,
                "completed": st["drained"],
                "n_slots": slots,
                "n_pages": st["n_pages"],
                "pool_bytes": st["pool_bytes"],
                "page_bytes": geom.page_bytes,
                "resident_high_water": st["resident_high_water"],
                "residents_per_mb":
                    st["resident_high_water"] * 2**20 / max(l0, 1),
                "pages_high_water": st["pages_high_water"],
                "preemptions": st["preemptions"],
                "spilled_pages": st["spilled_pages"],
                "restores": st["restores"],
                "parks": st["parks"],
                "park_resumes": st["park_resumes"],
                "decode_steps": sum(s["decode_steps"] for s in runs),
                "host_syncs": sum(s["host_syncs"] for s in runs),
                "boundaries": sum(len(s["boundary_wall_s"]) for s in runs),
                "ttft_steps_p50": percentile(st["ttft_steps"], 50),
                "ttft_steps_p95": percentile(st["ttft_steps"], 95),
                "ttft_emit_p50": percentile(st["ttft_emit_steps"], 50),
                "ttft_emit_p95": percentile(st["ttft_emit_steps"], 95),
                **_percentiles_ms("intertoken", _gap_samples(
                    runs, engine.ecfg.sync_interval)),
                # over the submitted requests: a parked session's first
                # token is its original request's
                **_percentiles_ms("ttft_wall", _ttft_s(reqs, t0)),
                "outputs": [rep.outputs[rid_map[r.rid]] for r in reqs],
            }

        base = one("fp16")
        quant = one(kv_quant)

    for rec in (base, quant):
        if rec["completed"] != n_requests:
            raise SystemExit(
                f"serve_bench --kv-quant: {rec['mode']} drained "
                f"{rec['completed']}/{n_requests} requests")
    outs_base = base.pop("outputs")
    outs_quant = quant.pop("outputs")
    if any(not o for o in outs_base) or any(not o for o in outs_quant):
        raise SystemExit(
            "serve_bench --kv-quant: a drained request emitted no tokens")
    agreement = sum(a[0] == b[0]
                    for a, b in zip(outs_base, outs_quant)) / n_requests
    ratio = (quant["resident_high_water"]
             / max(base["resident_high_water"], 1))
    pages_ratio = (quant["n_pages"] - 1) / max(base["n_pages"] - 1, 1)
    artifact = {
        "arch": cfg.name, "target": target.name, "device": str(dev),
        "n_requests": n_requests,
        "prompt_len": prompt_len, "gen_len": gen_len,
        "kv_quant": kv_quant, "layer0_bytes": l0, "park_idle": park_idle,
        "residency_ratio": ratio, "pages_ratio": pages_ratio,
        "first_token_agreement": agreement,
        "base": base, "quant": quant,
    }
    save_artifact("serve_quant_bench.json", artifact)
    lines = [
        f"tier codecs ({kv_quant} vs fp16, same {l0} layer-0 bytes): "
        f"residency {quant['resident_high_water']} vs "
        f"{base['resident_high_water']} concurrent residents "
        f"({ratio:.2f}x), {quant['n_pages'] - 1} vs {base['n_pages'] - 1} "
        f"data pages ({pages_ratio:.2f}x), greedy first-token agreement "
        f"{agreement:.2f}"]
    if park_idle:
        lines.append(
            f"host parking: {quant['parks']} parked at step {park_idle}, "
            f"{quant['park_resumes']} resumed, stream completed")
    if emit_bench:
        metrics = {"residency_ratio": ratio, "pages_ratio": pages_ratio,
                   "first_token_agreement": agreement}
        for key, rec in (("base", base), ("quant", quant)):
            metrics.update({f"{key}.{k}": v for k, v in rec.items()})
        path = _emit_bench_json(
            {"mode": "kv-quant", "arch": cfg.name, "target": target.name,
             "device": str(dev), "n_requests": n_requests,
             "kv_quant": kv_quant, "layer0_bytes": l0,
             "park_idle": park_idle}, metrics)
        lines.append(f"bench metrics -> {path}")
    if require_residency_win and (ratio < residency_win_min
                                  or agreement < 0.75):
        raise SystemExit(
            "serve_bench --require-residency-win: expected >="
            f"{residency_win_min}x concurrent residents at >=0.75 "
            f"first-token agreement; got x{ratio:.2f} at {agreement:.2f} "
            "— either the budget is slack (fp16 was not page-capped) or "
            "the codec drifted")
    rows = [[r["mode"], r["n_slots"], r["resident_high_water"],
             r["n_pages"] - 1, r["page_bytes"], r["pool_bytes"],
             r["preemptions"], r["parks"],
             f"{r['ttft_emit_p50']:.0f}/{r['ttft_emit_p95']:.0f}",
             f"{r['ttft_wall_p50_ms']:.1f}/{r['ttft_wall_p95_ms']:.1f}",
             f"{r['intertoken_p50_ms']:.2f}/{r['intertoken_p99_ms']:.2f}",
             f"{r['tok_per_s']:.1f}"] for r in (base, quant)]
    table = fmt_table(
        ["mode", "slots", "res hw", "pages", "page B", "pool B",
         "preempt", "parks", "ttft 50/95", "ttft ms 50/95", "it ms 50/99",
         "tok/s"],
        rows, title=f"Tier-codec serve bench — {cfg.name}, "
                    f"{n_requests} requests, {l0} layer-0 bytes "
                    f"({target.name}, {dev})")
    return "\n".join([table] + lines)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: the "
                         "REDUCED smoke config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="also run the paged two-tier pool inside the dense "
                         "pool's layer-0 byte budget")
    ap.add_argument("--page-tokens", type=int, default=8,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--layer0-bytes", type=int, default=None,
                    help="layer-0 (hot tier) budget; default: the dense "
                         "pool's footprint")
    ap.add_argument("--layer1-bytes", type=int, default=None,
                    help="layer-1 (spill tier) budget; default: derived "
                         "from the target's TieredPartition")
    ap.add_argument("--max-slots", type=int, default=32,
                    help="cap on paged-mode concurrent slots")
    ap.add_argument("--require-spill", action="store_true",
                    help="fail unless the layer-1 spill tier was exercised")
    ap.add_argument("--prefix-share", action="store_true",
                    help="replay a shared-system-prompt stream through the "
                         "paged pool with prefix sharing off vs on (same "
                         "layer-0 bytes; outputs gated)")
    ap.add_argument("--system-len", type=int, default=None,
                    help="shared system-prompt length for --prefix-share "
                         "(default: 3 full pages)")
    ap.add_argument("--require-share-win", action="store_true",
                    help="fail unless sharing shows >=1.5x mapped/physical "
                         "residency and no-worse TTFT p95")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="run the chunked-prefill admission-stall "
                         "head-to-head instead of the mode comparison: "
                         "baseline stream vs one-shot vs chunked admission "
                         "of one --long-prompt-len prompt")
    ap.add_argument("--long-prompt-len", type=int, default=4096,
                    help="length of the admission-stall prompt "
                         "(--chunked-prefill)")
    ap.add_argument("--chunk-prefill-tokens", type=int, default=0,
                    metavar="N",
                    help="per-boundary prefill-token budget for the "
                         "chunked run (0: derive from the target's "
                         "CapacityPartition)")
    ap.add_argument("--sync-interval", type=int, default=None,
                    help="decode steps per drain boundary (default: 4, or "
                         "32 in --chunked-prefill mode, 8 in "
                         "--disaggregate mode)")
    ap.add_argument("--require-flat-p99", action="store_true",
                    help="fail unless chunked p99 inter-token latency "
                         "stays within --flat-p99-tol of baseline while "
                         "the one-shot admission degrades past it")
    ap.add_argument("--flat-p99-tol", type=float, default=0.10,
                    help="relative p99 tolerance for --require-flat-p99")
    ap.add_argument("--repeats", type=int, default=3,
                    help="measured passes per run in --chunked-prefill "
                         "mode; the median-p99 pass is reported")
    ap.add_argument("--speculate", action="store_true",
                    help="run the speculative-decoding head-to-head "
                         "instead of the mode comparison: the repetitive "
                         "stream through the paged pool, speculation off "
                         "vs on in the same layer-0 bytes")
    ap.add_argument("--speculate-tokens", type=int, default=0, metavar="K",
                    help="draft tokens per slot per boundary for "
                         "--speculate (0: derive from the target's "
                         "CapacityPartition)")
    ap.add_argument("--require-speculate-win", action="store_true",
                    help="fail unless speculation shows >=1.5x decode "
                         "tokens-per-forward with gated outputs")
    ap.add_argument("--mesh", default="1",
                    help="device mesh sizes, 'DxM' or one int; any size "
                         "> 1 raises NotImplementedError: the mesh-sharded "
                         "head-to-head is not ported yet (ROADMAP A13); 1 "
                         "is the single-device path")
    ap.add_argument("--mesh-axes", default="data,model",
                    help="comma-separated axis names for --mesh")
    ap.add_argument("--require-scaling", action="store_true",
                    help="the mesh head-to-head's scaling gate (not "
                         "ported yet: raises, ROADMAP A13)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="run the prefill/decode role-split head-to-head "
                         "instead of the mode comparison: mixed long-"
                         "prompt + decode traffic through the same paged "
                         "pool, combined engine vs disaggregated roles")
    ap.add_argument("--n-long", type=int, default=3,
                    help="long prompts interleaved into the --disaggregate "
                         "stream")
    ap.add_argument("--require-disagg-win", action="store_true",
                    help="fail unless the role split shows >= "
                         "--disagg-win-min x decode tok/s at inter-token "
                         "p99 within --flat-p99-tol of combined, with "
                         "bit-identical outputs")
    ap.add_argument("--disagg-win-min", type=float, default=1.15,
                    help="decode tok/s ratio --require-disagg-win gates on")
    ap.add_argument("--kv-quant", choices=("fp16", "fp8", "int8"),
                    default=None,
                    help="run the tier-codec head-to-head instead of the "
                         "mode comparison: the same stream in the same "
                         "layer-0 bytes, fp16 pages vs this codec")
    ap.add_argument("--park-idle", type=int, default=0, metavar="N",
                    help="inside the --kv-quant runs: after N decode "
                         "steps park every decoding resident to the "
                         "layer-2 host tier, resume, and finish")
    ap.add_argument("--require-residency-win", action="store_true",
                    help="fail unless the quantized run holds >=1.8x the "
                         "fp16 run's concurrent residents in the same "
                         "layer-0 bytes at >=0.75 greedy first-token "
                         "agreement")
    ap.add_argument("--emit-bench", action="store_true",
                    help="write the flat metric file %s under the port's "
                         "benchmark artifacts (never at the repo root)"
                    % BENCH_FILE)
    add_target_arg(ap)
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        mesh_n = mesh_size(args.mesh)
    except ValueError:
        ap.error(f"--mesh {args.mesh!r}: expected one int or 'DxM' sizes")
    if mesh_n != 1 or args.require_scaling:
        raise NotImplementedError(
            f"serve_bench --mesh {args.mesh}: the mesh-sharded head-to-head "
            f"(run_mesh) needs the port of distributed/ and launch/mesh.py, "
            f"which is not done yet (ROADMAP A13); --mesh 1 is the "
            f"single-device path")
    common = dict(device=args.device, full=args.full)
    if args.disaggregate or args.require_disagg_win:
        print(run_disagg(
            args.target, args.arch, args.requests, args.prompt_len,
            args.gen_len, args.slots, args.seed,
            page_tokens=args.page_tokens, layer0_bytes=args.layer0_bytes,
            layer1_bytes=args.layer1_bytes, max_slots=args.max_slots,
            long_prompt_len=args.long_prompt_len, n_long=args.n_long,
            chunk_prefill_tokens=args.chunk_prefill_tokens,
            sync_interval=args.sync_interval or 8,
            disagg_win_min=args.disagg_win_min,
            flat_p99_tol=args.flat_p99_tol,
            require_disagg_win=args.require_disagg_win,
            emit_bench=args.emit_bench, **common))
        return 0
    if args.kv_quant or args.require_residency_win:
        print(run_quant(
            args.target, args.arch, args.requests, args.prompt_len,
            args.gen_len, args.seed, page_tokens=args.page_tokens,
            layer0_bytes=args.layer0_bytes,
            layer1_bytes=args.layer1_bytes, max_slots=args.max_slots,
            kv_quant=args.kv_quant or "int8", park_idle=args.park_idle,
            sync_interval=args.sync_interval,
            require_residency_win=args.require_residency_win,
            emit_bench=args.emit_bench, **common))
        return 0
    if args.speculate:
        print(run_speculate(
            args.target, args.arch, args.requests,
            args.prompt_len, args.gen_len,
            args.slots, args.seed, page_tokens=args.page_tokens,
            layer0_bytes=args.layer0_bytes,
            layer1_bytes=args.layer1_bytes, max_slots=args.max_slots,
            speculate_tokens=args.speculate_tokens,
            sync_interval=args.sync_interval,
            require_speculate_win=args.require_speculate_win,
            emit_bench=args.emit_bench, **common))
        return 0
    if args.chunked_prefill:
        print(run_chunked(
            args.target, args.arch, args.requests, args.prompt_len,
            args.gen_len, args.slots or 16, args.seed,
            page_tokens=args.page_tokens, layer0_bytes=args.layer0_bytes,
            layer1_bytes=args.layer1_bytes, max_slots=args.max_slots,
            prefix_share=args.prefix_share, system_len=args.system_len,
            long_prompt_len=args.long_prompt_len,
            chunk_prefill_tokens=args.chunk_prefill_tokens,
            sync_interval=args.sync_interval or 32,
            flat_p99_tol=args.flat_p99_tol,
            require_flat_p99=args.require_flat_p99,
            require_spill=args.require_spill, repeats=args.repeats,
            emit_bench=args.emit_bench, **common))
        return 0
    print(run(args.target, args.arch, args.requests, args.prompt_len,
              args.gen_len, args.slots, args.seed, paged=args.paged,
              page_tokens=args.page_tokens, layer0_bytes=args.layer0_bytes,
              layer1_bytes=args.layer1_bytes, max_slots=args.max_slots,
              require_spill=args.require_spill,
              prefix_share=args.prefix_share, system_len=args.system_len,
              require_share_win=args.require_share_win,
              sync_interval=args.sync_interval,
              emit_bench=args.emit_bench, **common))
    return 0


if __name__ == "__main__":
    sys.exit(main())
