#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit and no result line):

  1. environment: torch/CUDA versions, the card (compute capability 9.0)
     and its power limit;
  2. build: every CUDA kernel of the port (one nvcc per source, all
     started together), from ``kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at edge cases, with median times of kernel,
     plain version, one library call where there is one, and the bound.
     Attention kernels in bf16, atol = rtol = 2e-2 (the kernels' online
     softmax and the plain f32 softmax agree to within 1-2 bf16 ulp of
     O(1) values); matmul3d at ``tests/test_kernels.py``'s tolerances
     (f32 2e-4, bf16 2e-2) at small and ragged shapes, and at M = 8192
     within ``mempool_matmul.REL_TOL`` of the plain version's largest
     value (bf16 1e-3, f32 1e-4);
  4. one-shot generate of qwen2.5-3b at full width (random weights);
  5. the paged continuous-batching stream at full width, then the same
     stream with layer 0 squeezed until it preempts, spills and restores;
     kernel launch counts must match admissions x layers and decode steps
     x layers, and every decode chunk runs with device->host syncs made
     errors (the engine's guard);
  6. the paper path: ``repro_torch.launch.mempool_matmul`` (the
     scratchpad-fraction sweep at M = 8192, bf16 and f32, each plan held
     to the plain version) and ``repro_torch.benchmarks.kernel_bench
     --target h100``, with the matmul3d launches counted around both;
  7. a few chunks of the stream under ``torch.profiler`` (CUDA activity
     only): device time by kernel and the device's idle share;
  8. the ``kernels`` summary line, the card line, and the result line.

Streamed tokens are checked against a teacher-forced full-sequence forward
of the same model: each greedy token must be within ``LOGIT_TOL`` of that
forward's best logit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

ATOL = RTOL = 2e-2
LOGIT_TOL = 0.05           # teacher-forced greedy check, f32 logits
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
N_TIMED = 25
MATMUL_M = 8192            # the paper sweep's size (see mempool_matmul)
PROFILE_STEPS = 32         # decode steps (4 chunks) traced in phase 7

STREAM = ["--arch", "qwen2.5-3b", "--full", "--stream", "8", "--paged",
          "--batch", "4", "--prompt-len", "512", "--gen-len", "64",
          "--sync-interval", "8"]
ONE_SHOT = ["--arch", "qwen2.5-3b", "--full", "--batch", "4",
            "--prompt-len", "256", "--gen-len", "32"]
MAX_LEN = 512 + 64         # STREAM's prompt + generation depth
SQUEEZED_PAGES = 50        # layer-0 pages that make STREAM preempt


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(n_bytes: float, flops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, tol: float = ATOL) -> float:
    import torch
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite kernel output")
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"{name}: max |d| {err:.3e} beyond atol = rtol = {tol}")
    log(f"  {name}: max |d| = {err:.3e}  ok")
    return err


# ------------------------------------------------------------------ phases


def phase_environment() -> str:
    import torch
    log(f"[1/8] environment: python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"  device 0: {name}, compute capability {cap}, "
        f"{torch.cuda.device_count()} visible")
    if cap != (9, 0):
        fail(f"the kernels are built for sm_90a; device has {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"  nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    log("[2/8] build: nvcc " + " ".join(build.NVCC_FLAGS))
    t0 = time.perf_counter()
    build.build_all()
    log(f"  built {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(cfg, geom, n_slots) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.kernels.paged_attention import (paged_flash_decode,
                                                     paged_flash_decode_plain)
    log(f"[3/8] kernels against their plain versions (attention: bf16, "
        f"atol = rtol = {ATOL})")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    depth, pt, p_max = geom.depth, geom.page_tokens, geom.max_pages_per_slot

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # ---- flash prefill: q (1, Hq, Sq, D) over the page-aligned depth
    flash_err = 0.0
    cases = [(1, hq, hkv, sq, dict()) for sq in (1, 37, 512)]
    cases += [(1, hq, hkv, 512, dict(window=64)),
              (1, hq, hkv, 37, dict(q_offset=16)),
              (1, hq, hq, 512, dict())]
    for b, h_q, h_kv, sq, kw in cases:
        q, k, v = rnd(b, h_q, sq, d), rnd(b, h_kv, depth, d), rnd(b, h_kv, depth, d)
        got = flash_attention(q, k, v, causal=True, **kw)
        want = flash_attention_plain(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        flash_err = max(flash_err, compare(
            f"flash Hq={h_q} Hkv={h_kv} Sq={sq} Skv={depth} {kw}", got, want))
    # timing at the main path's longest admission: Sq = 512, causal
    sq = 512
    q, k, v = rnd(1, hq, sq, d), rnd(1, hkv, depth, d), rnd(1, hkv, depth, d)
    f_ms = median_ms(lambda: flash_attention(q, k, v, causal=True), N_TIMED)
    f_plain = median_ms(
        lambda: flash_attention_plain(q, k, v, causal=True), N_TIMED)
    f_lib = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), N_TIMED)
    pairs = sum(min(i + 1, depth) for i in range(sq))       # causal, offset 0
    f_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    f_bound, f_by = bound_ms(f_bytes, 4.0 * d * hq * pairs)
    log(f"  flash Sq={sq} Skv={depth}: kernel {f_ms:.4f} ms, plain "
        f"{f_plain:.4f} ms, sdpa {f_lib:.4f} ms, bound {f_bound:.4f} ms "
        f"({f_by})")

    # ---- paged decode: B slots walking P pages of pt tokens
    def paged_case(b, p, lens, window=None, tag=""):
        n_pages = b * p + 1
        kp, vp = rnd(n_pages, hkv, pt, d), rnd(n_pages, hkv, pt, d)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        bt = perm[:b * p].reshape(b, p).to(torch.int32)
        # slots map only the pages their frontier reaches; the rest is null
        mapped = (torch.arange(p, device=dev)[None, :] * pt
                  <= torch.as_tensor(lens, device=dev)[:, None])
        bt = torch.where(mapped, bt, 0).contiguous()
        cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q = rnd(b, hq, 1, d)
        got = paged_flash_decode(q, kp, vp, bt, cl, window=window)
        want = paged_flash_decode_plain(q, kp, vp, bt, cl, window=window)
        torch.cuda.synchronize()
        err = compare(f"paged B={b} P={p} pt={pt} window={window} {tag}",
                      got, want)
        return err, (q, kp, vp, bt, cl)

    paged_err = 0.0
    edge = [0, pt, 40 * pt - 1, 1, 2 * pt - 1, 100, 333, 17]
    for window in (None, 64):
        e, _ = paged_case(8, 40, edge, window, "(0 / page boundary / last)")
        paged_err = max(paged_err, e)
    lens = [int(x) for x in torch.randint(256, depth - 1, (n_slots,),
                                          generator=gen, device=dev)]
    e, args = paged_case(n_slots, p_max, lens, None, "(main path)")
    paged_err = max(paged_err, e)
    q, kp, vp, bt, cl = args
    p_ms = median_ms(lambda: paged_flash_decode(q, kp, vp, bt, cl), N_TIMED)
    p_plain = median_ms(
        lambda: paged_flash_decode_plain(q, kp, vp, bt, cl), N_TIMED)
    visible = sum(n + 1 for n in lens)
    p_bytes = (2 * 2 * visible * hkv * d + 2 * 2 * q.numel()
               + 4 * bt.numel() + 4 * cl.numel())
    p_bound, p_by = bound_ms(p_bytes, 4.0 * d * hq * visible)
    log(f"  paged B={n_slots} P={p_max} lens={lens}: kernel {p_ms:.4f} ms, "
        f"plain {p_plain:.4f} ms, bound {p_bound:.4f} ms ({p_by})")
    return {
        "flash": dict(err=flash_err, ms=f_ms, plain_ms=f_plain,
                      library_ms=f_lib, bound_ms=f_bound, bound_by=f_by),
        "paged": dict(err=paged_err, ms=p_ms, plain_ms=p_plain,
                      library_ms=None, bound_ms=p_bound, bound_by=p_by),
        "matmul3d": phase_matmul_kernel(),
    }


def phase_matmul_kernel() -> dict:
    """matmul3d against its plain version: the reference's sweep shapes
    and ragged shapes through ``ops.matmul`` under the h100 target, then
    the default h100 plan at M = 8192 in bf16 (f32 out), which is timed
    and whose error the ``kernels`` row reports."""
    import torch
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.core import planner, tiling
    from repro_torch.core.target import get_target, use_target
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul3d import matmul3d, matmul3d_plain
    from repro_torch.launch.mempool_matmul import REL_TOL
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tols = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    err = 0.0
    with use_target("h100"):
        shapes = [(128, 128, 128), (256, 384, 512), (512, 128, 256),
                  (128, 512, 128), (200, 300, 100), (37, 45, 19),
                  (96, 32, 300)]
        for m, k, n in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
                plan = planner.matmul_kernel_plan(m, k, n,
                                                  in_bytes=a.element_size())
                got = ops.matmul(a, b, out_dtype=torch.float32)
                want = matmul3d_plain(a, b, out_dtype=torch.float32)
                torch.cuda.synchronize()
                err = max(err, compare(
                    f"matmul3d {m}x{k}x{n} {str(dtype)[6:]} plan "
                    f"{(plan.bm, plan.bk, plan.bn)}", got, want, tols[dtype]))
        a = torch.randn((200, 300), generator=gen, device=dev).bfloat16()
        b = torch.randn((300, 100), generator=gen, device=dev).bfloat16()
        got = ops.matmul(a, b, plan=tiling.MatmulPlan(128, 128, 128))
        err = max(err, compare("matmul3d 200x300x100 bf16 plan (128, 128, "
                               "128), bf16 out (pad and crop)", got,
                               matmul3d_plain(a, b), tols[torch.bfloat16]))
        m = MATMUL_M
        plan = planner.matmul_kernel_plan(m, m, m, in_bytes=2,
                                          target=get_target("h100"))
    a = torch.randn((m, m), generator=gen, device=dev).bfloat16()
    b = torch.randn((m, m), generator=gen, device=dev).bfloat16()
    got = matmul3d(a, b, plan=plan, out_dtype=torch.float32)
    want = matmul3d_plain(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    m_err = (got - want).abs().max().item()
    rel = m_err / want.abs().max().item()
    if not (torch.isfinite(got).all() and rel <= REL_TOL["bf16"]):
        fail(f"matmul3d M={m} bf16 plan {plan}: max|d| {m_err:.3e}, "
             f"relative {rel:.2e} beyond {REL_TOL['bf16']}")
    log(f"  matmul3d M={m} bf16 (f32 out) plan {(plan.bm, plan.bk, plan.bn)}"
        f": max |d| = {m_err:.3e}, relative {rel:.2e}  ok; worst max |d| "
        f"of the small and ragged cases {err:.3e}")
    del got, want
    ms = median_ms(
        lambda: matmul3d(a, b, plan=plan, out_dtype=torch.float32), N_TIMED)
    plain = median_ms(
        lambda: matmul3d_plain(a, b, out_dtype=torch.float32), N_TIMED)
    lib = median_ms(lambda: torch.mm(a, b, out_dtype=torch.float32), N_TIMED)
    bound, by = bound_ms(2 * 2 * m * m + 4 * m * m, 2.0 * m ** 3)
    log(f"  matmul3d M={m} bf16: kernel {ms:.4f} ms "
        f"({2 * m ** 3 / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
        f"torch.mm {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(err=m_err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by)


def teacher_forced_check(cfg, seed_params, prompt, tokens, label) -> float:
    """Greedy ``tokens`` after ``prompt`` must each be within LOGIT_TOL of
    the best logit of one full-sequence forward; returns the worst gap."""
    import torch
    from repro_torch.models import layers, transformer
    seq = torch.as_tensor(list(prompt) + list(tokens[:-1]), dtype=torch.int32,
                          device="cuda")[None]
    x, _ = transformer.prefill(cfg, seed_params, seq, seq.shape[1])
    logits = layers.unembed_logits(seed_params["tok"],
                                   x[0, len(prompt) - 1:])[:, :cfg.vocab_size]
    picked = logits.gather(1, torch.as_tensor(
        list(tokens), device="cuda")[:, None].long())[:, 0]
    gap = (logits.max(dim=1).values - picked).max().item()
    log(f"  {label}: {len(tokens)} tokens, worst gap to the teacher-forced "
        f"best logit {gap:.4f}")
    if not gap <= LOGIT_TOL:
        fail(f"{label}: a greedy token is {gap:.4f} below the teacher-forced "
             f"best logit (tolerance {LOGIT_TOL})")
    return gap


def reference_params(cfg):
    """The launcher's weights (seed 0), prepared for serving."""
    import torch
    from repro_torch.models.api import build_model
    model = build_model(cfg)
    return model.prepare(model.init(torch.Generator(device="cuda").manual_seed(0)))


def phase_one_shot(cfg) -> None:
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_flash_decode
    from repro_torch.launch import serve as cli
    log("[4/8] one-shot generate: " + " ".join(ONE_SHOT))
    flash_attention.launches = paged_flash_decode.launches = 0
    rec = cli.run(ONE_SHOT)
    fl, pl = flash_attention.launches, paged_flash_decode.launches
    toks = rec["tokens"].numpy()
    if toks.shape != (4, 32) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"one-shot tokens shape {toks.shape}, range "
             f"[{toks.min()}, {toks.max()}]")
    if fl != cfg.n_layers or pl != 0:
        fail(f"one-shot launches: flash {fl} (want {cfg.n_layers}), paged "
             f"{pl} (want 0)")
    log(f"  tok/s {rec['tok_per_s']:.1f}, host_syncs {rec['host_syncs']}, "
        f"flash launches {fl}")
    prompt = np.random.RandomState(1).randint(2, cfg.vocab_size,
                                              size=(4, 256))[0]
    teacher_forced_check(cfg, reference_params(cfg), prompt, toks[0],
                         "one-shot row 0")


def run_stream(cfg, argv, label) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_flash_decode
    from repro_torch.launch import serve as cli
    log(f"  {label}: " + " ".join(argv))
    flash_attention.launches = paged_flash_decode.launches = 0
    rec = cli.run(argv)
    rec["flash_launches"] = flash_attention.launches
    rec["paged_launches"] = paged_flash_decode.launches
    n = cfg.n_layers
    if rec["completed"] != rec["n_requests"]:
        fail(f"{label}: {rec['completed']}/{rec['n_requests']} completed")
    if rec["host_syncs"] != rec["chunks"]:
        fail(f"{label}: host_syncs {rec['host_syncs']} != chunks "
             f"{rec['chunks']}")
    if rec["flash_launches"] != rec["admissions"] * n:
        fail(f"{label}: flash launches {rec['flash_launches']} != "
             f"admissions {rec['admissions']} x {n}")
    if rec["paged_launches"] != rec["decode_steps_total"] * n:
        fail(f"{label}: paged launches {rec['paged_launches']} != decode "
             f"steps {rec['decode_steps_total']} x {n}")
    log(f"  {label}: ok — {rec['admissions']} admissions, "
        f"{rec['decode_steps_total']} decode steps, {rec['chunks']} chunks = "
        f"{rec['host_syncs']} host syncs; launches flash "
        f"{rec['flash_launches']}, paged {rec['paged_launches']}; "
        f"{rec['tok_per_s']:.1f} tok/s")
    return rec


def phase_stream(cfg) -> dict:
    from repro_torch.serve.scheduler import kv_bytes_per_token, synthetic_stream
    log("[5/8] paged stream (every decode chunk under "
        "set_sync_debug_mode('error'))")
    rec = run_stream(cfg, STREAM, "stream")
    layer0 = kv_bytes_per_token(cfg) * 16 * SQUEEZED_PAGES
    squeezed = run_stream(cfg, STREAM + ["--layer0-bytes", str(layer0)],
                          "squeezed")
    if not (squeezed["preemptions"] >= 1 and squeezed["spilled_pages"] >= 1
            and squeezed["restores"] >= 1):
        fail(f"squeezed stream did not preempt/spill/restore: "
             f"{squeezed['preemptions']}/{squeezed['spilled_pages']}/"
             f"{squeezed['restores']}")
    log(f"  squeezed: {squeezed['preemptions']} preemptions, "
        f"{squeezed['spilled_pages']} pages spilled, "
        f"{squeezed['restores']} restores")
    params = reference_params(cfg)
    stream = synthetic_stream(8, 512, 64, cfg.vocab_size)
    for rid in (0, 1):
        for name, r in (("stream", rec), ("squeezed", squeezed)):
            teacher_forced_check(cfg, params, stream[rid]["prompt"],
                                 r["outputs"][rid], f"{name} request {rid}")
    return rec


def phase_paper() -> dict:
    """The paper path on the card, through the entry points a user runs;
    the matmul3d launches are counted around both."""
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels.matmul3d import matmul3d
    from repro_torch.launch import mempool_matmul
    from repro_torch.launch.mempool_matmul import REL_TOL
    log("[6/8] the paper path: python -m repro_torch.launch.mempool_matmul; "
        "python -m repro_torch.benchmarks.kernel_bench --target h100")
    matmul3d.launches = 0
    rec = mempool_matmul.run([])
    kernel_bench.main(["--target", "h100"])
    launches = matmul3d.launches
    sweep = rec["sweep"]
    if len(sweep) != 8 or any(r["m"] != MATMUL_M for r in sweep):
        fail(f"mempool_matmul swept {[(r['dtype'], r['m']) for r in sweep]}")
    worst = {}
    for r in sweep:
        worst[r["dtype"]] = max(worst.get(r["dtype"], 0.0), r["rel_err"])
        if not r["rel_err"] <= REL_TOL[r["dtype"]]:
            fail(f"mempool_matmul {r['dtype']} plan {r['plan']}: relative "
                 f"error {r['rel_err']:.2e} beyond {REL_TOL[r['dtype']]}")
    if launches < len(sweep) + len(kernel_bench.MATMUL_SHAPES):
        fail(f"matmul3d launched {launches} times on the paper path")
    log(f"  paper path: ok — matmul3d launches {launches}; worst max|d| / "
        f"max|plain| at M = {MATMUL_M}: " + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items()))
    return {"launches": launches, "sweep": sweep}


def phase_profile(cfg, geom, n_slots) -> None:
    """Device time by kernel, and the device's idle share, over the first
    PROFILE_STEPS decode steps of one more run of the stream under
    ``torch.profiler`` with CUDA activity only (kernel launches made here
    are outside the counted main-path runs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.scheduler import Scheduler, synthetic_stream
    log(f"[7/8] where the time goes: torch.profiler (CUDA activity) over the "
        f"first {PROFILE_STEPS} decode steps of the same stream")
    model = build_model(cfg)
    engine = Engine(model, model.init(torch.Generator(device="cuda")
                                      .manual_seed(0)),
                    EngineConfig(max_len=MAX_LEN, sync_interval=8))
    sch = Scheduler(n_slots=n_slots, pages=geom)
    for spec in synthetic_stream(8, 512, 64, cfg.vocab_size):
        sch.submit(spec["prompt"], spec["max_new_tokens"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(scheduler=sch, max_steps=PROFILE_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = engine.last_stats
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("the profiler recorded no device time")
    log(f"  serve wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{stats['decode_steps']} decode steps in {stats['chunks']} chunks, "
        f"{stats['admissions']} admissions")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
            f"{e.key[:100]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.serve.scheduler import derive_n_slots, derive_page_geometry

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    cfg = get_config("qwen2.5-3b")
    geom = derive_page_geometry(cfg, MAX_LEN, page_tokens=16, max_slots=4)
    n_slots = derive_n_slots(cfg, MAX_LEN, max_slots=4, pages=geom)
    timing = phase_kernels(cfg, geom, n_slots)
    phase_one_shot(cfg)
    rec = phase_stream(cfg)
    paper = phase_paper()
    phase_profile(cfg, geom, n_slots)

    log(f"[8/8] summary ({time.perf_counter() - t_start:.0f} s)")
    rows = [("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:30", rec["flash_launches"],
             timing["flash"]),
            ("paged_flash_decode",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:154",
             rec["paged_launches"], timing["paged"]),
            ("matmul3d", "src/repro_torch/kernels/csrc/matmul3d.cu",
             "src/repro/kernels/matmul3d.py:32", paper["launches"],
             timing["matmul3d"])]
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": t["err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
               for name, source, replaces, launches, t in rows]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
