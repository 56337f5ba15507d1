"""Serving demo: the Engine's serving surfaces over the pooled KV cache.

The counterpart of ``examples/serve_demo.py``: one-shot batched decode
across four architecture families (dense GQA, MLA + MoE, pure SSM and the
encoder-decoder), continuous batching over the dense slot pool, the paged
two-tier pool (same stream, same layer-0 bytes, more concurrent slots,
preempt-and-spill to the stacked layer-1 tier) and ref-counted prefix
sharing over a shared-system-prompt stream, all on the smoke configs with
random weights from a fixed seed. On the card by default::

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]

On the card it serves under the ``h100`` target, as the launcher does.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.core.target import use_target
from repro_torch.launch.serve import serving_target
from repro_torch.models import build_model
from repro_torch.models.api import resolve_device
from repro_torch.models.frontends import fake_frontend
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import (Scheduler, derive_n_slots,
                                         derive_page_geometry,
                                         kv_bytes_per_token,
                                         shared_prefix_stream,
                                         synthetic_stream)

ONE_SHOT_ARCHS = ("yi-6b", "deepseek-v2-236b", "falcon-mamba-7b",
                  "seamless-m4t-medium")


def _engine(arch: str, device: torch.device, max_len: int, **ecfg):
    cfg = get_reduced(arch)
    model = build_model(cfg, device=device)
    params = model.init_serving(torch.Generator(device=device).manual_seed(0))
    return cfg, Engine(model, params, EngineConfig(max_len=max_len, **ecfg))


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def demo(arch: str, device: torch.device, prompt_len: int = 16,
         gen: int = 8) -> dict:
    """One-shot greedy decode of a batch of 2; an enc-dec model also gets
    ``prompt_len`` source frames from the frontend stub."""
    cfg = get_reduced(arch)
    cfg, engine = _engine(arch, device, prompt_len + gen + cfg.frontend_len)
    gen_t = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (2, prompt_len),
                                     generator=gen_t, device=device,
                                     dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = fake_frontend(cfg, 2, gen_t, prompt_len)
    t0 = time.perf_counter()
    out, state = engine.generate(batch, n_steps=gen)
    _wait(device)
    dt = time.perf_counter() - t0

    def nbytes(tree):
        if torch.is_tensor(tree):
            return tree.numel() * tree.element_size()
        return sum(nbytes(v) for v in tree.values())

    mib = nbytes(state) / 2**20      # the pooled-memory story per family
    print(f"{arch:24s} [{cfg.family:6s}] generated {out.shape[1]} tok/row "
          f"in {dt * 1e3:6.0f} ms | decode state {mib:7.2f} MiB | "
          f"tokens[0]={out[0].tolist()}", flush=True)
    return {"arch": arch, "tokens": out.cpu(), "state_mib": mib}


def demo_continuous(device: torch.device, arch: str = "qwen2.5-3b",
                    n_requests: int = 12, n_slots: int = 3) -> dict:
    """A request stream through the slot pool: admission at drain
    boundaries, per-slot cache_len vectors, slot reuse after EOS/budget."""
    cfg, engine = _engine(arch, device, 32, sync_interval=4)
    sched = Scheduler(n_slots=n_slots)
    for spec in synthetic_stream(n_requests, prompt_len=12, gen_len=8,
                                 vocab=cfg.vocab_size):
        sched.submit(spec["prompt"], spec["max_new_tokens"])
    t0 = time.perf_counter()
    report = engine.serve(scheduler=sched)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in report.requests)
    s = report.stats
    print(f"\ncontinuous batching [{arch}]: {s['drained']}/{n_requests} "
          f"requests, {n_tok} tokens in {dt * 1e3:.0f} ms "
          f"({n_tok / dt:.0f} tok/s)")
    print(f"  slots={s['n_slots']} allocations={s['slot_allocations']} "
          f"(max reuse {s['max_slot_reuse']}) | "
          f"{s['host_syncs']} host syncs / {s['decode_steps']} decode steps",
          flush=True)
    return s


def demo_paged(device: torch.device, arch: str = "qwen2.5-3b",
               n_requests: int = 12, dense_slots: int = 3) -> dict:
    """The paper's two-layer partition at the serving layer: inside the
    dense pool's layer-0 byte budget the paged pool carries more
    concurrent slots; under pressure the youngest resident spills to the
    stacked layer-1 tier and comes back exactly."""
    max_len = 32
    cfg, engine = _engine(arch, device, max_len, sync_interval=4)
    budget = dense_slots * kv_bytes_per_token(cfg) * max_len
    geom = derive_page_geometry(cfg, max_len, page_tokens=8, max_slots=16,
                                layer0_bytes=budget)
    sched = Scheduler(n_slots=derive_n_slots(cfg, max_len, pages=geom,
                                             max_slots=16), pages=geom)
    for spec in synthetic_stream(n_requests, prompt_len=12, gen_len=8,
                                 vocab=cfg.vocab_size, seed=1):
        sched.submit(spec["prompt"], spec["max_new_tokens"])
    t0 = time.perf_counter()
    report = engine.serve(scheduler=sched)
    dt = time.perf_counter() - t0
    s = report.stats
    n_tok = sum(len(r.tokens) for r in report.requests)
    print(f"\npaged two-tier pool       {arch}: {s['drained']}/{n_requests} "
          f"requests, {n_tok} tokens in {dt * 1e3:.0f} ms "
          f"({n_tok / dt:.0f} tok/s)")
    print(f"  {s['n_slots']} slots vs {dense_slots} dense in the same "
          f"{s['pool_bytes']} layer-0 bytes | pages hw "
          f"{s['pages_high_water']}/{s['n_pages']} | {s['preemptions']} "
          f"preemptions -> {s['spilled_pages']} pages spilled, "
          f"{s['restores']} restores", flush=True)
    return s


def demo_prefix_share(device: torch.device, arch: str = "qwen2.5-3b",
                      n_requests: int = 12) -> dict:
    """Ref-counted prefix sharing over the paged pool: every request
    carries the same system prompt; with sharing on, admissions map the
    cached prefix pages read-only and prefill only the unique tail."""
    max_len = 40
    cfg, engine = _engine(arch, device, max_len, sync_interval=4)
    geom = derive_page_geometry(
        cfg, max_len, page_tokens=8, max_slots=16,
        layer0_bytes=16 * kv_bytes_per_token(cfg) * 8)
    stream = shared_prefix_stream(n_requests, system_len=16, suffix_len=8,
                                  gen_len=8, vocab=cfg.vocab_size)
    outs, stats = {}, {}
    for share in (False, True):
        sched = Scheduler(n_slots=derive_n_slots(cfg, max_len, pages=geom,
                                                 max_slots=16),
                          pages=geom, prefix_share=share)
        for spec in stream:
            sched.submit(spec["prompt"], spec["max_new_tokens"])
        report = engine.serve(scheduler=sched)
        outs[share] = {r.rid: r.tokens for r in report.requests}
        stats[share] = report.stats
    s = stats[True]
    same = outs[True] == outs[False]
    print(f"\nprefix sharing            {arch}: {s['prefix_hits']} hits / "
          f"{s['prefix_misses']} misses, {s['shared_prefix_tokens']} prompt "
          f"tokens served from cache, {s['cow_copies']} COW copies")
    print(f"  residency {s['mapped_high_water']} mapped vs "
          f"{s['pages_high_water']} physical pages "
          f"({s['mapped_high_water'] / max(s['pages_high_water'], 1):.2f}x) "
          f"| outputs sharing on == off: {same}", flush=True)
    return {**s, "outputs_equal": same}


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    target = serving_target(dev)
    with use_target(target) if target else contextlib.nullcontext():
        print(f"family-spanning serving demo (reduced configs, {dev}):")
        one_shot = [demo(arch, dev) for arch in ONE_SHOT_ARCHS]
        print("\nnote the SSM row: its decode state is O(1) in sequence "
              "length.")
        return {"one_shot": one_shot, "continuous": demo_continuous(dev),
                "paged": demo_paged(dev), "prefix_share":
                demo_prefix_share(dev)}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
