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
     value (bf16 1e-3, f32 1e-4); mamba_scan at falcon-mamba-7b's shapes
     under ``h100`` plans (prefill L = 512 and a ragged 300 from a zero
     state, decode B = 4 from a random state, the loss forward's L = 2048
     without state): bf16 y at atol = rtol = 2e-2, f32 y and the final
     state at 2e-4 (``test_mamba_scan_sweep``'s tolerance), several plans
     bit for bit equal, and a split scan equal to the full one;
  4. one-shot generate of qwen2.5-3b at full width (random weights);
  5. the paged continuous-batching stream at full width, then the same
     stream with layer 0 squeezed until it preempts, spills and restores;
     kernel launch counts must match admissions x layers and decode steps
     x layers, and every decode chunk runs with device->host syncs made
     errors (the engine's guard);
  6. falcon-mamba-7b at full width under ``--target h100``: one-shot
     generate, the paged stream, the squeezed stream (so the recurrent
     rows spill to their seats and come back, and every request emits the
     roomy stream's tokens), the greedy tokens against teacher-forced
     passes at the served batch, and ``Model.loss``'s forward on 1 x 2048
     tokens. Every forward call launches mamba_scan once per layer (64)
     and the plain scan never;
  7. the paper path: ``repro_torch.launch.mempool_matmul`` (the
     scratchpad-fraction sweep at M = 8192, bf16 and f32, each plan held
     to the plain version) and ``repro_torch.benchmarks.kernel_bench
     --target h100``, with the matmul3d launches counted around both;
  8. four chunks of the qwen2.5-3b stream and of the falcon-mamba-7b
     stream under ``torch.profiler`` (CUDA activity only): device time by
     kernel and the device's idle share;
  9. the ``kernels`` summary line, the card line, and the result line.

Greedy tokens are held within ``LOGIT_TOL`` of the best logit of a
teacher-forced pass of the same model. For qwen2.5-3b that pass is one
full-sequence forward (no caches). For falcon-mamba-7b it is the model's
own prefill and decode steps at the served batch, so that every GEMM sees
as many rows as it did in the served run; a stateless forward over the
whole sequence feeds the GEMMs other row counts, and through 64 bf16
layers that moves falcon's logits by more than ``LOGIT_TOL``. The
squeezed falcon stream must also emit the roomy stream's tokens bit for
bit: its recurrent rows only move between slots and f32 seats.
"""

from __future__ import annotations

import contextlib
import gc
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

N_TIMED_PLAIN_SCAN = 3    # the plain scan is one Python step per position
SCAN_TOL = 2e-4            # f32 y and final state (test_mamba_scan_sweep)

STREAM_ARGS = ["--stream", "8", "--paged", "--batch", "4", "--prompt-len",
               "512", "--gen-len", "64", "--sync-interval", "8"]
ONE_SHOT_ARGS = ["--batch", "4", "--prompt-len", "256", "--gen-len", "32"]
QWEN = ["--arch", "qwen2.5-3b", "--full"]
FALCON = ["--arch", "falcon-mamba-7b", "--full", "--target", "h100"]
STREAM, ONE_SHOT = QWEN + STREAM_ARGS, QWEN + ONE_SHOT_ARGS
MAX_LEN = 512 + 64         # STREAM's prompt + generation depth
SQUEEZED_PAGES = 50        # layer-0 pages that make qwen's STREAM preempt
# falcon-mamba-7b keeps no KV, so --layer0-bytes counts pages; its stream's
# prompts (drawn over its vocab) preempt at 45
FALCON_SQUEEZED_PAGES = 45
LOSS_LEN = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = BF16_FLOPS) -> tuple:
    """The least time for ``n_bytes`` of HBM traffic and ``n_ops``
    operations at ``ops_per_s``, and which of the two binds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layer_counts(cfg) -> tuple:
    """(attention layers, mamba layers) of ``cfg``'s stack."""
    kinds = [k for g in cfg.layer_groups() for _ in range(g.n_repeat)
             for k in g.pattern]
    ssm = sum(k.attn == "mamba" for k in kinds)
    return len(kinds) - ssm, ssm


def reset_counts() -> None:
    """Zero every kernel's launch count and the plain scan's call count."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
    from repro_torch.kernels.paged_attention import paged_flash_decode
    flash_attention.launches = paged_flash_decode.launches = 0
    mamba_scan.launches = mamba_scan_plain.calls = 0


def read_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
    from repro_torch.kernels.paged_attention import paged_flash_decode
    return {"flash": flash_attention.launches,
            "paged": paged_flash_decode.launches,
            "scan": mamba_scan.launches, "plain_scan": mamba_scan_plain.calls}


def check_counts(label: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{label}: launches {got}, want {want}")


def free_memory() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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
    log(f"[1/9] environment: python {sys.version.split()[0]}, torch "
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
    log("[2/9] build: nvcc " + " ".join(build.NVCC_FLAGS))
    t0 = time.perf_counter()
    build.build_all()
    log(f"  built {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(cfg, geom, n_slots, fcfg) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.kernels.paged_attention import (paged_flash_decode,
                                                     paged_flash_decode_plain)
    log(f"[3/9] kernels against their plain versions (attention: bf16, "
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
        "mamba_scan": phase_scan_kernel(fcfg),
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


def phase_scan_kernel(fcfg) -> dict:
    """mamba_scan against its plain version at falcon-mamba-7b's shapes,
    through ``ops.selective_scan`` under the h100 target's plans: x, B, C
    as the model gives them (bf16; f32 in the f32 cases), dt f32 in the
    model's [1e-3, 1e-1], A = -(1..Ds) per channel (S4D-real), D = 1. The
    prefill case (L = 512 from a zero state) is timed and its error is the
    ``kernels`` row's."""
    import math
    import torch
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.core.hw_profiles import H100_SXM
    from repro_torch.core.target import use_target
    from repro_torch.core.tiling import ScanChunkPlan
    from repro_torch.core import planner
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import mamba_scan_plain, scan_work
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    di, ds = fcfg.ssm_d_inner, fcfg.ssm_d_state
    lo, hi = math.log(1e-3), math.log(1e-1)

    def inputs(b, length, dtype):
        x = torch.randn((b, length, di), generator=gen, device=dev)
        u = torch.rand((b, length, di), generator=gen, device=dev)
        bc = torch.randn((2, b, length, ds), generator=gen, device=dev)
        a = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).expand(di, ds).contiguous()
        return (x.to(dtype), torch.exp(lo + u * (hi - lo)), a,
                bc[0].to(dtype), bc[1].to(dtype),
                torch.ones((di,), device=dev))

    def state(b, random):
        if not random:
            return torch.zeros((b, di, ds), device=dev)
        return torch.randn((b, di, ds), generator=gen, device=dev)

    def scan(args, h0, **kw):
        return ops.selective_scan(*args, h0=h0, return_state=h0 is not None,
                                  **kw)

    cases = [("prefill", 1, 512, torch.bfloat16, False),
             ("prefill ragged", 1, 300, torch.bfloat16, False),
             ("decode", 4, 1, torch.bfloat16, True),
             ("forward", 1, LOSS_LEN, torch.bfloat16, None),
             ("prefill f32", 1, 512, torch.float32, True)]
    log(f"  mamba_scan: Di = {di}, Ds = {ds}; y bf16 atol = rtol = {ATOL}, "
        f"f32 y and final state {SCAN_TOL}")
    timed = {}
    errs = {}
    with use_target("h100"):
        for label, b, length, dtype, random in cases:
            args = inputs(b, length, dtype)
            h0 = None if random is None else state(b, random)
            plan = planner.scan_kernel_plan(length, di, ds)
            got = scan(args, h0)
            want = mamba_scan_plain(*args, h0=h0,
                                    return_state=h0 is not None)
            torch.cuda.synchronize()
            if h0 is None:
                got, want = (got,), (want,)
            tol = SCAN_TOL if dtype == torch.float32 else ATOL
            errs[label] = compare(
                f"mamba_scan {label} B={b} L={length} {str(dtype)[6:]} "
                f"chunk {plan.chunk} y", got[0], want[0], tol)
            if h0 is not None:
                compare(f"mamba_scan {label} final state", got[1], want[1],
                        SCAN_TOL)
            timed[label] = (args, h0)
        args, _ = timed["prefill"]
        outs = [ops.selective_scan(*args, plan=ScanChunkPlan(ch))
                for ch in (1, 8, 64, 512)]
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            fail("mamba_scan: chunks 1, 8, 64 and 512 give different y")
        log("  mamba_scan chunks 1, 8, 64, 512 at L = 512: y bit for bit "
            "equal  ok")
        args, h0 = timed["prefill f32"]
        cut = 200
        head = [t[:, :cut] if t.dim() == 3 else t for t in args]
        tail = [t[:, cut:] if t.dim() == 3 else t for t in args]
        y1, h1 = scan(head, h0)
        y2, h2 = scan(tail, h1)
        yf, hf = scan(args, h0)
        torch.cuda.synchronize()
        compare("mamba_scan split at 200 of 512 vs full: y",
                torch.cat([y1, y2], dim=1), yf, SCAN_TOL)
        compare("mamba_scan split at 200 of 512 vs full: final state", h2,
                hf, SCAN_TOL)
        rows = {}
        for label in ("prefill", "decode", "forward"):
            args, h0 = timed[label]
            ms = median_ms(lambda: scan(args, h0), N_TIMED)
            plain = median_ms(lambda: mamba_scan_plain(
                *args, h0=h0, return_state=h0 is not None),
                N_TIMED_PLAIN_SCAN)
            n_bytes, exps = scan_work(*args, h0=h0,
                                      return_state=h0 is not None)
            bound, by = bound_ms(n_bytes, exps, H100_SXM.special_ops)
            rows[label] = dict(err=errs[label], ms=ms, plain_ms=plain,
                               library_ms=None, bound_ms=bound, bound_by=by)
            log(f"  mamba_scan {label} B={args[0].shape[0]} "
                f"L={args[0].shape[1]}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes} B, "
                f"{exps} exp), no library call")
    return rows["prefill"]


def teacher_forced_check(cfg, seed_params, prompt, tokens, label) -> float:
    """Greedy ``tokens`` after ``prompt`` must each be within LOGIT_TOL of
    the best logit of one full-sequence forward (no caches); returns the
    worst gap."""
    import torch
    from repro_torch.models import layers, transformer
    seq = torch.as_tensor(list(prompt) + list(tokens[:-1]), dtype=torch.int32,
                          device="cuda")[None]
    start, vocab = len(prompt) - 1, cfg.vocab_size
    x, _ = transformer.forward(cfg, seed_params, seq)
    logits = layers.unembed_logits(seed_params["tok"],
                                   x[0, start:])[:, :vocab]
    picked = logits.gather(1, torch.as_tensor(
        list(tokens), device="cuda")[:, None].long())[:, 0]
    gap = (logits.max(dim=1).values - picked).max().item()
    log(f"  {label}: {len(tokens)} tokens, worst gap to the teacher-forced "
        f"best logit {gap:.4f}")
    if not gap <= LOGIT_TOL:
        fail(f"{label}: a greedy token is {gap:.4f} below the teacher-forced "
             f"best logit (tolerance {LOGIT_TOL})")
    return gap


def served_batch_check(model, params, prompts, tokens, rows, label) -> float:
    """Greedy ``tokens`` (b, T) after ``prompts`` (b, L) must each be
    within LOGIT_TOL of the best logit of a teacher-forced pass through
    ``model.prefill`` and ``model.decode_step`` at the served batch: the b
    prompts prefill together, as the server prefilled them, each row is
    repeated up to ``rows`` (the server's decode batch) and every step
    feeds the served tokens. A row is checked up to its first EOS (after
    it the server fills EOS). Returns the worst gap."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import EngineConfig
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                              device="cuda")
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device="cuda")
    (b, length), n, vocab = prompts.shape, tokens.shape[1], model.cfg.vocab_size
    k = rows // b

    def widen(tree):
        if isinstance(tree, dict):
            return {name: widen(leaf) for name, leaf in tree.items()}
        return tree.repeat_interleave(k, dim=1)

    logits, state = model.prefill(params, {"tokens": prompts}, length + n)
    logits, state = logits.repeat_interleave(k, dim=0), {
        "caches": widen(state["caches"])}
    steps = torch.repeat_interleave(tokens, k, dim=0).to(torch.int32)
    gaps = []
    for t in range(n):
        lg = logits[::k, -1, :vocab]
        gaps.append(lg.max(dim=1).values - lg.gather(1, tokens[:, t:t + 1])[:, 0])
        if t + 1 < n:
            logits, state = model.decode_step(
                params, steps[:, t:t + 1], state,
                torch.tensor(length + t, dtype=torch.int32, device="cuda"))
    is_eos = (tokens == EngineConfig.eos_token).int()
    after_eos = (is_eos.cumsum(1) - is_eos) > 0
    gap = torch.stack(gaps, 1).masked_fill(after_eos, 0).max().item()
    log(f"  {label}: {b} x {n} tokens, prefill batch {b}, decode batch "
        f"{rows}; worst gap to the teacher-forced best logit {gap:.4f}")
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


def one_shot_prompts(cfg):
    """The launcher's one-shot prompts (``ONE_SHOT_ARGS``), (4, 256)."""
    import numpy as np
    return np.random.RandomState(1).randint(2, cfg.vocab_size,
                                            size=(4, 256))


def one_shot(cfg, argv, label) -> dict:
    """One-shot generate through the CLI; the prefill launches flash once
    per attention layer, and the prefill and every decode step launch
    mamba_scan once per mamba layer."""
    from repro_torch.launch import serve as cli
    n_attn, n_ssm = layer_counts(cfg)
    reset_counts()
    rec = cli.run(argv)
    counts = read_counts()
    toks = rec["tokens"].numpy()
    if toks.shape != (4, 32) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{label}: tokens shape {toks.shape}, range "
             f"[{toks.min()}, {toks.max()}]")
    check_counts(label, counts, {
        "flash": n_attn, "paged": 0, "plain_scan": 0,
        "scan": n_ssm * (1 + rec["decode_steps"])})
    log(f"  {label}: tok/s {rec['tok_per_s']:.1f}, host_syncs "
        f"{rec['host_syncs']}, {rec['decode_steps']} decode steps; launches "
        f"{counts}")
    return rec


def phase_one_shot(cfg) -> None:
    log("[4/9] one-shot generate: " + " ".join(ONE_SHOT))
    rec = one_shot(cfg, ONE_SHOT, "one-shot")
    teacher_forced_check(cfg, reference_params(cfg), one_shot_prompts(cfg)[0],
                         rec["tokens"].numpy()[0], "one-shot row 0")


def run_stream(cfg, argv, label) -> dict:
    """The paged stream through the CLI; each admission launches flash per
    attention layer, each decode step the paged kernel per attention
    layer, and both launch mamba_scan per mamba layer."""
    from repro_torch.launch import serve as cli
    log(f"  {label}: " + " ".join(argv))
    n_attn, n_ssm = layer_counts(cfg)
    reset_counts()
    rec = cli.run(argv)
    rec["launches"] = counts = read_counts()
    if rec["completed"] != rec["n_requests"]:
        fail(f"{label}: {rec['completed']}/{rec['n_requests']} completed")
    if rec["host_syncs"] != rec["chunks"]:
        fail(f"{label}: host_syncs {rec['host_syncs']} != chunks "
             f"{rec['chunks']}")
    adm, steps = rec["admissions"], rec["decode_steps_total"]
    check_counts(label, counts, {
        "flash": adm * n_attn, "paged": steps * n_attn,
        "scan": (adm + steps) * n_ssm, "plain_scan": 0})
    log(f"  {label}: ok — {adm} admissions, {steps} decode steps, "
        f"{rec['chunks']} chunks = {rec['host_syncs']} host syncs; launches "
        f"{counts}; {rec['tok_per_s']:.1f} tok/s")
    return rec


def check_squeezed(label, rec) -> None:
    if not (rec["preemptions"] >= 1 and rec["spilled_pages"] >= 1
            and rec["restores"] >= 1):
        fail(f"{label} did not preempt/spill/restore: "
             f"{rec['preemptions']}/{rec['spilled_pages']}/"
             f"{rec['restores']}")
    log(f"  {label}: {rec['preemptions']} preemptions, "
        f"{rec['spilled_pages']} pages spilled, {rec['restores']} restores")


def phase_stream(cfg) -> dict:
    from repro_torch.serve.scheduler import kv_bytes_per_token, synthetic_stream
    log("[5/9] paged stream (every decode chunk under "
        "set_sync_debug_mode('error'))")
    rec = run_stream(cfg, STREAM, "stream")
    layer0 = kv_bytes_per_token(cfg) * 16 * SQUEEZED_PAGES
    squeezed = run_stream(cfg, STREAM + ["--layer0-bytes", str(layer0)],
                          "squeezed")
    check_squeezed("squeezed stream", squeezed)
    params = reference_params(cfg)
    stream = synthetic_stream(8, 512, 64, cfg.vocab_size)
    for rid in (0, 1):
        for name, r in (("stream", rec), ("squeezed", squeezed)):
            teacher_forced_check(cfg, params, stream[rid]["prompt"],
                                 r["outputs"][rid], f"{name} request {rid}")
    return rec


def phase_falcon(fcfg) -> dict:
    """falcon-mamba-7b at full width on the h100 target: one-shot, stream,
    squeezed stream, teacher-forced checks and the loss forward, with
    mamba_scan launched once per layer in every forward call."""
    import numpy as np
    import torch
    from repro_torch.core.target import use_target
    from repro_torch.models.api import build_model
    from repro_torch.serve.scheduler import synthetic_stream
    log("[6/9] falcon-mamba-7b at full width: " + " ".join(FALCON)
        + " (every decode chunk under set_sync_debug_mode('error'))")
    n_ssm = layer_counts(fcfg)[1]
    first = one_shot(fcfg, FALCON + ONE_SHOT_ARGS, "one-shot")
    free_memory()
    rec = run_stream(fcfg, FALCON + STREAM_ARGS, "stream")
    free_memory()
    squeezed = run_stream(fcfg, FALCON + STREAM_ARGS + [
        "--layer0-bytes", str(FALCON_SQUEEZED_PAGES)], "squeezed")
    check_squeezed("squeezed stream", squeezed)
    differ = [rid for rid, toks in rec["outputs"].items()
              if squeezed["outputs"].get(rid) != toks]
    if differ or len(squeezed["outputs"]) != len(rec["outputs"]):
        fail(f"squeezed stream: requests {differ} emit other tokens than "
             f"the roomy stream")
    log(f"  squeezed stream: all {len(rec['outputs'])} requests emit the "
        f"roomy stream's tokens bit for bit")
    free_memory()
    with use_target("h100"):
        model = build_model(fcfg)
        params = model.prepare(model.init(
            torch.Generator(device="cuda").manual_seed(0)))
        stream = synthetic_stream(8, 512, 64, fcfg.vocab_size)
        rows = 4                                    # STREAM_ARGS' --batch
        checks = [(one_shot_prompts(fcfg), first["tokens"].numpy(),
                   "one-shot")]
        checks += [([stream[rid]["prompt"]], [rec["outputs"][rid]],
                    f"stream request {rid}") for rid in (0, 1)]
        reset_counts()
        gap = max(served_batch_check(model, params, p, t, rows, label)
                  for p, t, label in checks)
        check_counts("teacher-forced passes", read_counts(), {
            "flash": 0, "paged": 0, "plain_scan": 0,
            "scan": sum(len(t[0]) for _, t, _ in checks) * n_ssm})
        rng = np.random.RandomState(3)
        toks = rng.randint(2, fcfg.vocab_size, size=(1, LOSS_LEN + 1))
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
                 "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
        model.loss(params, batch)                       # warm
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        total, aux = model.loss(params, batch)
        torch.cuda.synchronize()
        loss_ms = (time.perf_counter() - t0) * 1e3
        check_counts("loss forward", read_counts(), {
            "flash": 0, "paged": 0, "scan": n_ssm, "plain_scan": 0})
        loss = float(total)
        if not (np.isfinite(loss) and int(aux["tokens"]) == LOSS_LEN):
            fail(f"loss forward: loss {loss}, tokens {aux['tokens']}")
        log(f"  Model.loss forward on 1 x {LOSS_LEN} tokens: loss "
            f"{loss:.4f} (ln of the vocab {np.log(fcfg.vocab_size):.4f}), "
            f"{loss_ms:.1f} ms host clock after one warm-up, mamba_scan "
            f"launches {n_ssm}")
    del model, params
    free_memory()
    return {"launches": rec["launches"]["scan"], "gap": gap,
            "loss": loss, "loss_ms": loss_ms}


def phase_paper() -> dict:
    """The paper path on the card, through the entry points a user runs;
    the matmul3d launches are counted around both."""
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels.matmul3d import matmul3d
    from repro_torch.launch import mempool_matmul
    from repro_torch.launch.mempool_matmul import REL_TOL
    log("[7/9] the paper path: python -m repro_torch.launch.mempool_matmul; "
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


def phase_profile(cfg, target=None) -> None:
    """Device time by kernel, and the device's idle share, over the first
    PROFILE_STEPS decode steps of one more run of ``cfg``'s stream under
    ``torch.profiler`` with CUDA activity only (kernel launches made here
    are outside the counted main-path runs). ``target`` is the launcher's
    ``--target`` (None: the default)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.target import use_target
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.scheduler import (Scheduler, derive_n_slots,
                                             derive_page_geometry,
                                             synthetic_stream)
    log(f"  {cfg.name}: the first {PROFILE_STEPS} decode steps of its stream")
    scope = use_target(target) if target else contextlib.nullcontext()
    with scope:
        geom = derive_page_geometry(cfg, MAX_LEN, page_tokens=16,
                                    max_slots=4)
        n_slots = derive_n_slots(cfg, MAX_LEN, max_slots=4, pages=geom)
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
    del engine, model
    free_memory()
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
    cfg, fcfg = get_config("qwen2.5-3b"), get_config("falcon-mamba-7b")
    geom = derive_page_geometry(cfg, MAX_LEN, page_tokens=16, max_slots=4)
    n_slots = derive_n_slots(cfg, MAX_LEN, max_slots=4, pages=geom)
    timing = phase_kernels(cfg, geom, n_slots, fcfg)
    free_memory()
    phase_one_shot(cfg)
    rec = phase_stream(cfg)
    free_memory()
    falcon = phase_falcon(fcfg)
    paper = phase_paper()
    log("[8/9] where the time goes: torch.profiler (CUDA activity)")
    phase_profile(cfg)
    phase_profile(fcfg, target="h100")

    log(f"[9/9] summary ({time.perf_counter() - t_start:.0f} s)")
    rows = [("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:30",
             rec["launches"]["flash"], timing["flash"]),
            ("paged_flash_decode",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:154",
             rec["launches"]["paged"], timing["paged"]),
            ("matmul3d", "src/repro_torch/kernels/csrc/matmul3d.cu",
             "src/repro/kernels/matmul3d.py:32", paper["launches"],
             timing["matmul3d"]),
            ("mamba_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
             "src/repro/kernels/mamba_scan.py:29", falcon["launches"],
             timing["mamba_scan"])]
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
