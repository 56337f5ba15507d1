"""Sharded serving across cards (``python -m
repro_torch.benchmarks.mesh_probe``).

Serves ``--arch`` (default qwen2.5-3b) at its published widths
(``--device cpu``: the REDUCED smoke config), cut to ``--layers`` deep
where given, on a ``1xM`` mesh for each M of ``--meshes`` (default 2 and
4), one rank a GPU over NCCL (gloo on the CPU), the ranks spawned by
``launch.mesh.spawn``. qwen2.5-3b: at M = 2 the 2 KV heads divide the
model axis (the head path: each rank holds one KV head's pages); at M = 4
they do not (the pooled path: whole pools on every rank, each decode step
over a quarter of each slot's positions, merged by log-sum-exp).
qwen3-moe-30b-a3b (4 KV heads: the head path at 2 and 4) serves its MoE
layers expert-parallel, ``128 / M`` experts a rank: the whole 48-layer
model (61 GB served) fits no single card and needs M >= 2.
deepseek-v2-236b (the latent path) shards its MLA heads, ``128 / M`` a
rank, beside a latent pool whole on every rank, its routed experts
``160 / M`` a rank and its shared experts as a tensor-parallel SwiGLU; a
cut to ``--layers 7`` (the dense first layer and 6 MoE layers) fits four
cards, bounded by the whole f32 expert leaf each rank draws (30.2 GB at 6
MoE layers).

Each rank builds its shards of the weights (``Model.init_serving(gen,
mesh=)``, its peak recorded), rolls every request out one-shot
(``Engine.generate``) and then serves the same requests as one paged
stream (budgets priced for the mesh: ``model_shards``) under ``--target``,
else the launcher's serving target (``h100`` on the card). Rank 0
reports, for each M: how many requests' stream tokens are a prefix of
their one-shot rollout and where the others part (on the card cuBLAS
picks a GEMM's algorithm by its row count, and the one-shot runs one row
where the stream runs its slots, so a near-tie may part them; above two
ranks an expert-parallel MoE row also depends on its call's other rows:
the capacity cut drops by them, and the collective's order of summing
more than two partials follows the buffer's size), the worst teacher-forced
gap of the stream's tokens (``serve.checks``: below the best logit of one
full-sequence forward on the same shards) and the MoE hits the cap
dropped in those forwards (``moe.count_ep``, outside the stream),
the body each expert-parallel MoE call of the stream took
(``moe.count_ep``: weight-gather or partial-K), whether every rank
emits the same tokens, tok/s of the stream on the host's clock (the
device drained), host syncs against chunks, each rank's peak allocated
and reserved device memory (after building its weights, and over the
run), and the logits of one full-sequence forward over the first prompt
(its last ``LOGIT_ROWS`` positions) against the first mesh's, with the
card's name and power limit. It fails unless every rank emits the same
tokens with one host sync a chunk (and, on the CPU, every stream equals
its one-shot but an expert-parallel MoE's above two ranks). The JSON
record goes to
``--out`` (default ``mesh_probe.json`` under the port's benchmark
artifacts).

    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_probe
        [--arch NAME] [--layers N] [--meshes 2,4] [--device cpu]
        [--requests N] [--prompt-len N] [--gen-len N] [--out PATH]
        [--target NAME]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.benchmarks.common import ARTIFACT_ROOT, add_target_arg
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.target import use_target
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_gemm import grouped_gemm
from repro_torch.kernels.paged_attention import paged_flash_decode
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import serving_target
from repro_torch.models import layers, moe, transformer
from repro_torch.models.api import build_model, resolve_device
from repro_torch.serve.checks import LOGIT_TOL, teacher_forced_gap
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.scheduler import (Scheduler, derive_n_slots,
                                         derive_page_geometry, kv_shards,
                                         synthetic_stream)


#: prompt positions whose logits are compared across meshes
LOGIT_ROWS = 32


def _card() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _launches() -> Dict[str, int]:
    """Each kernel's launches so far in this process: flash by (D, Dv),
    paged decode and grouped_gemm (0 on the CPU, where the wrappers take
    their plain versions)."""
    out = {f"flash_d{d}_dv{dv}": n
           for (d, dv), n in flash_attention.launches_by_dims.items()}
    out.update(paged=paged_flash_decode.launches,
               grouped=grouped_gemm.launches)
    return out


def _wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(opts: Dict[str, Any], out: str) -> None:
    """One rank: its shards, the one-shot rollouts, the paged stream."""
    m = opts["mesh"]
    mesh = mesh_lib.make_mesh((1, m), ("data", "model"),
                              resolve_device(opts["device"]),
                              what=f"--mesh {m}")
    dev = mesh.device
    cfg = get_reduced(opts["arch"]) if dev.type == "cpu" else get_config(
        opts["arch"])
    if opts["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=opts["layers"])
    target = opts["target"] or serving_target(dev)
    with use_target(target) if target else contextlib.nullcontext():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg, device=dev)
        t0 = time.perf_counter()
        params = model.init_serving(
            torch.Generator(device=dev).manual_seed(0), mesh=mesh)
        _wait(dev)
        init_s = time.perf_counter() - t0
        init_peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                     if dev.type == "cuda" else None)
        max_len = opts["prompt_len"] + opts["gen_len"]
        engine = Engine(model, params, EngineConfig(max_len=max_len,
                                                    sync_interval=8,
                                                    mesh=mesh))
        del params
        stream = synthetic_stream(opts["requests"], opts["prompt_len"],
                                  opts["gen_len"], cfg.vocab_size)
        refs = []
        for spec in stream:
            toks, _ = engine.generate(
                {"tokens": torch.as_tensor(np.asarray(spec["prompt"]),
                                           dtype=torch.int32,
                                           device=dev)[None]},
                n_steps=spec["max_new_tokens"])
            refs.append(toks[0].tolist())
        shards = shd.axis_size(mesh, shd.MODEL_AXIS)
        geom = derive_page_geometry(cfg, max_len, page_tokens=16,
                                    max_slots=4, model_shards=shards)
        slots = derive_n_slots(cfg, max_len, max_slots=4, pages=geom,
                               model_shards=shards)
        sch = Scheduler(n_slots=slots, pages=geom)
        rids = [sch.submit(s["prompt"], s["max_new_tokens"]).rid
                for s in stream]
        _wait(dev)
        before = _launches()
        with moe.count_ep(drops=False) as count:
            t0 = time.perf_counter()
            rep = engine.serve(scheduler=sch)
            _wait(dev)
            wall = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in _launches().items()
                    if v - before[k]}
        bodies = dict(count.bodies)
        outs = [rep.outputs[r] for r in rids]
        with engine.core.scope():
            with moe.count_ep() as count:
                gaps = [teacher_forced_gap(cfg, engine.params, s["prompt"],
                                           o) for s, o in zip(stream, outs)]
            dropped = int(sum(d.item() for d in count.drops))
            # the same inputs on every mesh: one full-sequence forward over
            # the first prompt, its last LOGIT_ROWS positions' logits whole
            seq = torch.as_tensor(np.asarray(stream[0]["prompt"]),
                                  dtype=torch.int32, device=dev)[None]
            x, _, _ = transformer.forward(cfg, engine.params, seq)
            logits = tp.gather_logits(layers.unembed_logits(
                engine.params["tok"], x[0, -LOGIT_ROWS:]),
                cfg.padded_vocab)[:, :cfg.vocab_size].float().cpu()
    n_tokens = sum(len(o) for o in outs)
    prefixes = [bool(o) and o == r[:len(o)] for o, r in zip(outs, refs)]
    mine = {"rank": dist.get_rank(), "device": str(dev),
            "init_peak_allocated_gb": init_peak,
            "peak_allocated_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                  if dev.type == "cuda" else None),
            "peak_reserved_gb": (torch.cuda.max_memory_reserved(dev) / 1e9
                                 if dev.type == "cuda" else None),
            "prefix_of_one_shot": sum(prefixes),
            "first_parting": [next((i for i, (a, b) in enumerate(zip(o, r))
                                    if a != b), None)
                              for o, r in zip(outs, refs)],
            "teacher_forced_dropped": dropped,
            "stream_launches": launches,
            "outputs": outs}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    if dist.get_rank() != 0:
        return
    torch.save(logits, out + ".logits.pt")
    st = rep.stats
    rec = {"mesh": f"1x{m}", "arch": cfg.name, "layers": cfg.n_layers,
           "target": target,
           "path": ("latent" if cfg.use_mla else "pooled"
                    if cfg.n_kv_heads % m else "head"),
           "moe_bodies": bodies,
           # above 2 ranks an expert-parallel MoE row's output depends on
           # its call's other rows: the cut may drop its hits (M above the
           # capacity factor) and the collective's order of summing more
           # than two partials follows the buffer's size; a router near-tie
           # turns either into another expert
           "rows_matter": bool(cfg.n_experts) and m > 2,
           "teacher_forced_dropped": sum(r["teacher_forced_dropped"]
                                         for r in ranks),
           "kv_shards": kv_shards(cfg, m), "n_slots": slots,
           "n_pages": geom.n_pages, "pool_bytes": st["pool_bytes"],
           "requests": len(stream), "n_tokens": n_tokens,
           "wall_s": wall, "tok_per_s": n_tokens / wall,
           "init_serving_s": init_s,
           "host_syncs": st["host_syncs"], "chunks": st["chunks"],
           "decode_steps": st["decode_steps"],
           "preemptions": st["preemptions"],
           "prefix_of_one_shot": sum(prefixes),
           "first_parting": ranks[0]["first_parting"],
           "teacher_forced_worst_gap": max(gaps),
           "ranks_agree": all(r["outputs"] == outs for r in ranks),
           "ranks": [{k: v for k, v in r.items() if k != "outputs"}
                     for r in ranks]}
    with open(out, "w") as f:
        json.dump(rec, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the config cut to this many layers "
                         "(default: its own depth)")
    ap.add_argument("--meshes", default="2,4",
                    help="comma-separated model-axis sizes, one run each")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA cards; 'cpu' "
                         "runs the smoke config on gloo ranks)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(ARTIFACT_ROOT,
                                                  "mesh_probe.json"))
    add_target_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = _card() if dev.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    if dev.type == "cuda":
        build.build_all()       # once, before the ranks load the libraries
    runs = []
    for m in (int(x) for x in args.meshes.split(",")):
        opts = dict(arch=args.arch, layers=args.layers, mesh=m,
                    device=str(dev), target=args.target,
                    requests=args.requests, prompt_len=args.prompt_len,
                    gen_len=args.gen_len)
        with tempfile.TemporaryDirectory(prefix="repro_torch_probe_") as tmp:
            path = os.path.join(tmp, "rank0.json")
            t0 = time.perf_counter()
            mesh_lib.spawn(_rank, m, dev, args=(opts, path))
            with open(path) as f:
                rec = json.load(f)
            logits = torch.load(path + ".logits.pt")
        if not runs:
            first = logits
        rec["logits_vs_first_mesh"] = {
            "max_abs": float((logits - first).abs().max()),
            "argmax_agree": float((logits.argmax(-1) == first.argmax(-1))
                                  .float().mean())}
        rec["spawn_s"] = time.perf_counter() - t0
        runs.append(rec)
        peaks = ", ".join(f"rank {r['rank']} {r['peak_allocated_gb']} "
                          f"(weights built: {r['init_peak_allocated_gb']})"
                          for r in rec["ranks"])
        print(f"mesh {rec['mesh']} ({rec['arch']} x {rec['layers']}, "
              f"{rec['path']} path, kv pool sharded "
              f"{rec['kv_shards']}x; MoE bodies {rec['moe_bodies']}, "
              f"{rec['teacher_forced_dropped']} hits dropped in the "
              f"teacher-forced forwards): {rec['n_tokens']} tokens of "
              f"{rec['requests']} requests in {rec['wall_s']:.3f} s -> "
              f"{rec['tok_per_s']:.1f} tok/s; host syncs "
              f"{rec['host_syncs']} over {rec['chunks']} chunks; "
              f"{rec['prefix_of_one_shot']}/{rec['requests']} streams a "
              f"prefix of their one-shot (first parting "
              f"{rec['first_parting']}); teacher-forced worst gap "
              f"{rec['teacher_forced_worst_gap']:.4f} (<= {LOGIT_TOL}); "
              f"ranks agree: {rec['ranks_agree']}; the stream's launches on "
              f"rank 0: {rec['ranks'][0]['stream_launches']}; peak "
              f"allocated GB: "
              f"{peaks}; a {LOGIT_ROWS}-position forward's logits against "
              f"the first mesh's: max |d| "
              f"{rec['logits_vs_first_mesh']['max_abs']:.4f}, argmax agree "
              f"{rec['logits_vs_first_mesh']['argmax_agree']:.3f}",
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    # every rank the same tokens and one host sync a chunk; on the CPU's
    # GEMMs every stream its one-shot, but for an expert-parallel MoE above
    # two ranks ("rows_matter"). The teacher-forced gaps and the
    # cross-mesh logits are recorded, not gated: on the card a near-tie
    # parts within the rule's noise (0.0447 at one device, 29-5)
    exact = dev.type == "cpu"
    ok = all(r["ranks_agree"] and r["host_syncs"] == r["chunks"]
             and (r["prefix_of_one_shot"] == r["requests"] or not exact
                  or r["rows_matter"])
             for r in runs)
    print(json.dumps({"ok": ok, "card": card,
                      "runs": [{k: r[k] for k in (
                          "mesh", "arch", "layers", "path", "tok_per_s",
                          "prefix_of_one_shot", "teacher_forced_worst_gap",
                          "teacher_forced_dropped", "moe_bodies",
                          "ranks_agree", "logits_vs_first_mesh")}
                               for r in runs]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
