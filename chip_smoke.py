#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit and no result line):

  1. environment: torch/CUDA versions, the card (compute capability 9.0)
     and its power limit;
  2. build: every CUDA kernel of the port (one nvcc per source, all
     started together), from ``kernels/csrc``; then each library's SASS
     (``cuobjdump --dump-sass``): matmul3d and flash_attention must hold
     HGMMA (wgmma, the tensor cores) and UTMALDG (TMA loads); HMMA
     (``mma.sync``, paged decode's tensor cores) is counted beside them;
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at edge cases, with median times of kernel,
     plain version, one library call where there is one, and the bound.
     Attention kernels in bf16, atol = rtol = 2e-2 (the kernels' online
     softmax and the plain f32 softmax agree to within 1-2 bf16 ulp of
     O(1) values), flash also at the one-shot's admission (4 x 256), at
     an Sq no 64-row tile divides over a ragged Skv, on the strided
     ``transpose(1, 2)`` views models/attention.py passes, and at the
     resumed prefill's serving shapes (a 256-row prefix-share suffix at
     ``q_offset`` 256 and a 128-row chunk at 384, over the slot's 576
     positions; timed beside SDPA with the same mask); matmul3d at
     ``tests/test_kernels.py``'s tolerances (f32 2e-4, bf16 2e-2) at
     small and ragged shapes (bf16 with f32 and bf16 out), and at M = 8192
     within ``mempool_matmul.REL_TOL`` of the plain version's largest
     value (bf16 1e-3 at every h100 plan of the paper sweep, f32 1e-4 at
     the f32 default plan, timed beside ``torch.mm`` with TF32 off);
     paged decode also at split (4-page) boundaries, windows across and
     emptying splits, and the long case (4 slots x 4096 positions, timed
     in GB/s), one CUDA kernel a call, each slot alone and a 64-page
     null-padded table bit for bit equal to the batch of 4 over 36 pages;
     then every attention case is called REPEAT_ROUNDS more times, the
     cases interleaved, each call bit for bit equal to its first output;
     mamba_scan at falcon-mamba-7b's shapes
     under ``h100`` plans (prefill L = 512 and a ragged 300 from a zero
     state, decode B = 4 from a random state, the loss forward's L = 2048
     without state): bf16 y at atol = rtol = 2e-2, f32 y and the final
     state at 2e-4 (``test_mamba_scan_sweep``'s tolerance), several plans
     bit for bit equal, a split scan equal to the full one, and at decode
     the state written over h0 and each batch row alone bit for bit equal
     to the functional batched scan;
  4. one-shot generate of qwen2.5-3b at full width (random weights);
  5. qwen2.5-3b's continuous-batching streams at full width, through the
     launcher, which serves under the ``h100`` target on the card: the
     paged stream; the same with layer 0 squeezed until it preempts,
     spills and restores; the dense slot-slab stream; the prefix-shared
     stream (a common 256-token system prompt: at least one prefix hit and
     more mapped than physical pages); chunked prefill at 128 tokens a
     boundary on both pools; and, through ``Engine.serve``, the same
     page-aligned 512-token prompt twice with prefix sharing, whole and
     chunked, so the second admission copies its frontier page on write
     (the launcher's unique tails never do); speculative decoding with the
     draft budget derived under ``h100`` (k = 8) on both pools, over the
     launcher's repetitive stream; the chunked paged stream again with
     disaggregated prefill/decode roles, which must equal the combined
     chunked paged stream token for token, in its counters and in its
     launches, with one handover a request; the paged stream at
     ``--kv-quant int8`` and ``fp8`` (first tokens equal to the fp16
     stream's on at least 0.75 of requests; one decode step's largest
     logit change against an fp16 pool printed), int8 at the squeezed
     stream's layer-0 bytes (its pages and preemptions printed beside the
     fp16 squeezed stream's) and fp8 at half those bytes (it must preempt,
     so pages spill fp8 -> int8 and come back); ``--park-idle 16`` on the
     fp16 paged stream (every token equal to the uninterrupted stream's,
     parks == resumes > 0) and at int8 (every resumed page's codes and
     scales byte-equal to the parked ones). Each stream's time is printed.
     Kernel launch counts must
     match (admissions + prefill chunks) x layers for flash and decode
     steps x layers for paged decode (0 on the dense slab, whose decode is
     the masked oracle by the reference's dispatch, 0 in a
     speculative stream, whose multi-token verify forward takes gather +
     oracle by the same dispatch, and 0 on a quantized pool, which gathers
     and dequantizes as the reference does); every decode and verify chunk runs with
     device->host syncs made errors (the engine's guard); the host reads
     the device once a boundary (disaggregated: the decode role once a
     boundary, the prefill role only at boundaries that completed a
     prompt); and requests 0 and 1 of every stream, and every request of
     the prefix-shared and copy-on-write streams, are held to the
     teacher-forced rule;
  6. falcon-mamba-7b at full width: one-shot generate, the paged stream,
     the dense slot-slab stream, the squeezed paged stream (so the
     recurrent rows spill to their seats and come back, and every request
     emits the roomy stream's tokens), the greedy tokens against
     teacher-forced passes at the served batch, and ``Model.loss``'s
     forward on 1 x 2048 tokens. Every forward call launches mamba_scan
     once per layer (64) and the plain scan never;
  7. the paper path: ``repro_torch.launch.mempool_matmul`` (the
     scratchpad-fraction sweep at M = 8192, bf16 and f32, each plan held
     to the plain version) and ``repro_torch.benchmarks.kernel_bench
     --target h100``, with the matmul3d launches counted around both;
  8. four chunks of the qwen2.5-3b stream (fp16 and int8 pages) and of
     the falcon-mamba-7b stream under ``torch.profiler`` (CUDA activity
     only): device time by kernel, the device's idle share and the CUDA
     kernels launched;
  9. the ``kernels`` summary line (launches on the main path, the paged
     qwen stream, and by path for every stream), the card line, and the
     result line.

After every phase from 3 on, every counter buffer of paged decode's
in-launch merge (one per device and stream) must read all zeros: each
launch leaves its counters zero, so a non-zero entry means a launch that
did not complete.

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

import functools
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
F32_FLOPS = 67e12          # H100 SXM f32 peak outside the tensor cores
N_TIMED = 25
REPEAT_ROUNDS = 500        # phase 3's attention cases, each called again
MATMUL_M = 8192            # the paper sweep's size (see mempool_matmul)
PROFILE_STEPS = 32         # decode steps (4 chunks) traced in phase 7

N_TIMED_PLAIN_SCAN = 3    # the plain scan is one Python step per position
SCAN_TOL = 2e-4            # f32 y and final state (test_mamba_scan_sweep)

STREAM_ARGS = ["--stream", "8", "--paged", "--batch", "4", "--prompt-len",
               "512", "--gen-len", "64", "--sync-interval", "8"]
#: the same stream over the dense slot slab
DENSE_STREAM_ARGS = [a for a in STREAM_ARGS if a != "--paged"]
ONE_SHOT_ARGS = ["--batch", "4", "--prompt-len", "256", "--gen-len", "32"]
# no --target: on the card the launcher serves under h100
QWEN = ["--arch", "qwen2.5-3b", "--full"]
FALCON = ["--arch", "falcon-mamba-7b", "--full"]
STREAM, ONE_SHOT = QWEN + STREAM_ARGS, QWEN + ONE_SHOT_ARGS
SERVING_TARGET = "h100"    # the launcher's target on the card
MAX_LEN = 512 + 64         # STREAM's prompt + generation depth
SYSTEM_LEN = 256           # the prefix-shared stream's common prompt head
CHUNK_TOKENS = 128         # the chunked streams' prefill budget a boundary
SPEC_TOKENS = 8            # --speculate-tokens 0 derives this under h100
#: the quantized streams' first tokens must agree with the fp16 stream's on
#: this share of requests (the equivalence matrix's KVQ gate)
KVQ_FIRST_TOKEN_AGREEMENT = 0.75
#: (Sq, q_offset) of flash at the resumed prefill's serving shapes, over
#: the slot's whole depth: a prefix-share suffix and a prefill chunk
RESUMED_FLASH = {"suffix": (512 - SYSTEM_LEN, SYSTEM_LEN),
                 "chunk": (CHUNK_TOKENS, 3 * CHUNK_TOKENS)}
SQUEEZED_PAGES = 50        # layer-0 pages that make qwen's STREAM preempt
# falcon-mamba-7b keeps no KV, so --layer0-bytes counts pages; its stream's
# prompts (drawn over its vocab) preempt at 45
FALCON_SQUEEZED_PAGES = 45
LOSS_LEN = 2048
LONG_TOKENS = 4096         # the long-context paged case: 4 slots x 4096
#: libraries whose SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG)
TENSOR_CORE_KERNELS = ("matmul3d", "flash_attention")
#: the port's kernels by name, as the profiler lists them
PORT_KERNELS = ("flash_fwd_kernel", "paged_decode_kernel",
                "mamba_scan_kernel", "mamba_scan_step_kernel", "matmul3d_")


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


def device_profile(fn, kernel: str = "", n: int = N_TIMED) -> tuple:
    """Device time per call of ``fn`` in the kernels whose names hold
    ``kernel`` (every kernel it launches when empty), over ``n`` calls
    under torch.profiler (CUDA activity only): the device's work alone,
    without the host's call path that CUDA events around one call also
    count; and how many CUDA kernels of any name one call launches. A
    trace that holds no kernel at all (the profiler now and then returns
    an empty one) is taken again once; fails if the profiler saw no such
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if cuda:
            break
        log("  (the profiler returned an empty trace; tracing again)")
    hits = [e for e in cuda if kernel in e.key]
    if not hits:
        fail(f"the profiler saw no {kernel or 'CUDA'} kernel")
    return (sum(e.self_device_time_total for e in hits) / n / 1e3,
            sum(e.count for e in cuda) / n)


def device_ms(fn, kernel: str = "", n: int = N_TIMED) -> float:
    """:func:`device_profile`'s device time alone."""
    return device_profile(fn, kernel, n)[0]


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


def check_merge_counters(label: str) -> None:
    """Every counter buffer of paged decode's merge (one per device and
    stream) must read all zeros once the device is idle."""
    import torch
    from repro_torch.kernels.paged_attention import counter_buffers
    torch.cuda.synchronize()
    bufs = counter_buffers()
    nonzero = {f"{dev} stream {stream:#x}": int(torch.count_nonzero(buf))
               for (dev, stream), buf in bufs.items()}
    if any(nonzero.values()):
        fail(f"after {label}: paged merge counters not all zero: {nonzero}")
    log(f"  merge counters after {label}: {len(bufs)} buffer(s), "
        f"{sum(b.numel() for b in bufs.values())} entries, all zero  ok")


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


def phase_build() -> dict:
    """Build every kernel, log registers and spills, and read each
    library's SASS: the wgmma kernels must hold HGMMA (wgmma) and UTMALDG
    (TMA loads). Returns {library: its SASS counts of HGMMA, UTMALDG and
    HMMA (``mma.sync``, the tensor cores without wgmma)}."""
    from repro_torch.kernels import build
    log("[2/9] build: nvcc " + " ".join(build.NVCC_FLAGS))
    t0 = time.perf_counter()
    build.build_all()
    log(f"  built {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "Function properties" in line:
                log(f"  {name}: {line.split(' for ')[-1].strip()}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}:   {line.strip()}")
    sass_ops = {}
    for name in build.SOURCES:
        sass = build.sass(name)
        sass_ops[name] = {op: sass.count(op)
                          for op in ("HGMMA", "UTMALDG", "HMMA")}
        log(f"  {name} SASS (cuobjdump --dump-sass): {sass_ops[name]}")
    for name in TENSOR_CORE_KERNELS:
        if not (sass_ops[name]["HGMMA"] and sass_ops[name]["UTMALDG"]):
            fail(f"{name}: no HGMMA or no UTMALDG in its SASS; its bf16 "
                 f"path must run wgmma fed by TMA")
    return sass_ops


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

    def dense(b, h, seq):
        return rnd(b, h, seq, d)

    def model_view(b, h, seq):
        """(B, H, S, D) as models/attention.py passes it: the
        ``transpose(1, 2)`` view of a (B, S, H, D) tensor."""
        return rnd(b, seq, h, d).transpose(1, 2)

    # ---- flash prefill: q (B, Hq, Sq, D) over the page-aligned depth, the
    # one-shot's admission (4 x 256), an Sq no 64-row tile divides over a
    # ragged Skv, and the model's strided views
    flash_err = 0.0
    cases = [(1, hq, hkv, sq, depth, dict(), dense) for sq in (1, 37, 512)]
    cases += [(1, hq, hkv, 512, depth, dict(window=64), dense),
              (1, hq, hkv, 37, depth, dict(q_offset=16), dense),
              (1, hq, hq, 512, depth, dict(), dense),
              (4, hq, hkv, 256, 256, dict(), dense),
              (1, hq, hkv, 300, 333, dict(), dense),
              (4, hq, hkv, 256, 256, dict(), model_view),
              (2, hq, hkv, 300, 333, dict(window=100, q_offset=33),
               model_view)]
    # the resumed prefill's serving shapes: a suffix and a chunk over the
    # slot's whole depth, at their offsets
    cases += [(1, hq, hkv, sq, depth, dict(q_offset=off), model_view)
              for sq, off in RESUMED_FLASH.values()]
    repeats = []        # (label, call, first output): see repeat_calls
    for b, h_q, h_kv, sq, skv, kw, make in cases:
        q, k, v = make(b, h_q, sq), make(b, h_kv, skv), make(b, h_kv, skv)
        got = flash_attention(q, k, v, causal=True, **kw)
        want = flash_attention_plain(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        views = " (model views)" if make is model_view else ""
        label = (f"flash B={b} Hq={h_q} Hkv={h_kv} Sq={sq} Skv={skv} "
                 f"{kw}{views}")
        flash_err = max(flash_err, compare(label, got, want))
        repeats.append((label, functools.partial(
            flash_attention, q, k, v, causal=True, **kw), got))
    # timing at the main path's longest admission: Sq = 512, causal
    sq = 512
    q, k, v = rnd(1, hq, sq, d), rnd(1, hkv, depth, d), rnd(1, hkv, depth, d)
    f_ms = median_ms(lambda: flash_attention(q, k, v, causal=True), N_TIMED)
    f_dev = device_ms(lambda: flash_attention(q, k, v, causal=True),
                      "flash_fwd_kernel")
    f_plain = median_ms(
        lambda: flash_attention_plain(q, k, v, causal=True), N_TIMED)
    f_lib = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), N_TIMED)
    f_lib_dev = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = sum(min(i + 1, depth) for i in range(sq))       # causal, offset 0
    f_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    f_bound, f_by = bound_ms(f_bytes, 4.0 * d * hq * pairs)
    log(f"  flash Sq={sq} Skv={depth}: kernel {f_ms:.4f} ms (device "
        f"{f_dev:.4f} ms), plain "
        f"{f_plain:.4f} ms, sdpa {f_lib:.4f} ms (device {f_lib_dev:.4f} "
        f"ms), bound {f_bound:.4f} ms "
        f"({f_by})")
    resumed = {}
    for label, (sq, off) in RESUMED_FLASH.items():
        resumed[label] = time_resumed_flash(label, rnd, hq, hkv, d, sq,
                                            depth, off)

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
        label = f"paged B={b} P={p} pt={pt} window={window} {tag}"
        err = compare(label, got, want)
        repeats.append((label, functools.partial(
            paged_flash_decode, q, kp, vp, bt, cl, window=window), got))
        return err, (q, kp, vp, bt, cl)

    def paged_work(lens, q, bt, cl):
        """Bytes (visible K/V once, q, o, table, frontiers) and FLOPs of a
        call without a window."""
        visible = sum(n + 1 for n in lens)
        n_bytes = (2 * 2 * visible * hkv * d + 2 * 2 * q.numel()
                   + 4 * bt.numel() + 4 * cl.numel())
        return n_bytes, 4.0 * d * hq * visible

    # edge frontiers: 0, page and split (4 pages) boundaries and one short,
    # the last position, windows across a split boundary and emptying splits
    paged_err = 0.0
    edge = [0, pt, 40 * pt - 1, 1, 2 * pt - 1, 100, 333, 17]
    split = 4 * pt
    edges = [(edge, None), (edge, 64),
             ([split - 1, split, 2 * split - 1, 2 * split, 5 * split + 1,
               40 * pt - 2, 7, 9 * split], 2 * split + 3),
             ([400, 575, 200, 130, 64, 63, 600, 639], 20)]
    for lens_, window in edges:
        e, _ = paged_case(8, 40, lens_, window,
                          "(0 / page and split boundaries / last)")
        paged_err = max(paged_err, e)
    lens = [int(x) for x in torch.randint(256, depth - 1, (n_slots,),
                                          generator=gen, device=dev)]
    e, args = paged_case(n_slots, p_max, lens, None, "(main path)")
    paged_err = max(paged_err, e)
    q, kp, vp, bt, cl = args
    # bit for bit: each slot alone equals its row of the batch, and a
    # block table null-padded to 64 pages equals the 36-page one
    batch = paged_flash_decode(q, kp, vp, bt, cl)
    for i in range(n_slots):
        alone = paged_flash_decode(q[i:i + 1], kp, vp, bt[i:i + 1],
                                   cl[i:i + 1])
        if not torch.equal(alone, batch[i:i + 1]):
            fail(f"paged: slot {i} decoded alone differs from its row of "
                 f"the batch of {n_slots}")
    wide = torch.zeros((n_slots, 64), dtype=torch.int32, device=dev)
    wide[:, :p_max] = bt
    if not torch.equal(paged_flash_decode(q, kp, vp, wide, cl), batch):
        fail(f"paged: a 64-page block table differs from the {p_max}-page "
             f"one")
    log(f"  paged: each slot alone == its row of the batch of {n_slots}, "
        f"and P = 64 (null-padded) == P = {p_max}, bit for bit  ok")
    p_ms = median_ms(lambda: paged_flash_decode(q, kp, vp, bt, cl), N_TIMED)
    p_dev, p_kernels = device_profile(
        lambda: paged_flash_decode(q, kp, vp, bt, cl), "paged_decode_kernel")
    if p_kernels != 1:
        fail(f"paged: a call launched {p_kernels:g} CUDA kernels, want 1 "
             f"(the merge runs inside the launch)")
    p_plain = median_ms(
        lambda: paged_flash_decode_plain(q, kp, vp, bt, cl), N_TIMED)
    p_bytes, p_flops = paged_work(lens, q, bt, cl)
    p_bound, p_by = bound_ms(p_bytes, p_flops)
    log(f"  paged B={n_slots} P={p_max} lens={lens}: kernel {p_ms:.4f} ms "
        f"(device {p_dev:.4f} ms, {p_kernels:g} CUDA kernel(s) a call), "
        f"plain {p_plain:.4f} ms, bound {p_bound:.4f} ms ({p_by})")
    # the long case: 4 slots x 4096 positions, 256 pages each
    long_lens = [LONG_TOKENS - 1] * 4
    l_err, (q, kp, vp, bt, cl) = paged_case(4, LONG_TOKENS // pt, long_lens,
                                            None, "(long context)")
    paged_err = max(paged_err, l_err)
    l_dev = device_ms(lambda: paged_flash_decode(q, kp, vp, bt, cl),
                      "paged_decode_kernel")
    l_bytes, l_flops = paged_work(long_lens, q, bt, cl)
    l_bound, l_by = bound_ms(l_bytes, l_flops)
    l_gbps = l_bytes / l_dev / 1e6
    log(f"  paged long B=4 P={LONG_TOKENS // pt}: device {l_dev:.4f} ms, "
        f"{l_bytes / 1e6:.2f} MB at {l_gbps:.1f} GB/s "
        f"({l_gbps * 1e9 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s), bound "
        f"{l_bound:.4f} ms ({l_by})")
    repeat_calls(repeats)
    del q, kp, vp, bt, cl, batch, repeats
    return {
        "flash": dict(err=flash_err, ms=f_ms, device_ms=f_dev,
                      library_device_ms=f_lib_dev, plain_ms=f_plain,
                      library_ms=f_lib, bound_ms=f_bound, bound_by=f_by,
                      extra={f"{label}_{key}": row[key]
                             for label, row in resumed.items()
                             for key in row}),
        "paged": dict(err=paged_err, ms=p_ms, device_ms=p_dev,
                      plain_ms=p_plain,
                      library_ms=None, bound_ms=p_bound, bound_by=p_by,
                      extra=dict(cuda_kernels_per_call=p_kernels,
                                 long_device_ms=l_dev, long_bound_ms=l_bound,
                                 long_gb_per_s=l_gbps)),
        "matmul3d": phase_matmul_kernel(),
        "mamba_scan": phase_scan_kernel(fcfg),
    }


def repeat_calls(repeats) -> None:
    """Call every attention case of phase 3 again, REPEAT_ROUNDS rounds
    with the cases interleaved on one stream, and hold each call to the
    case's first output bit for bit (both kernels are deterministic: no
    atomics in any sum). The soak that narrows ROADMAP C1."""
    import torch
    t0 = time.perf_counter()
    bad = {}
    for _ in range(REPEAT_ROUNDS):
        for label, call, first in repeats:
            if not torch.equal(call(), first):
                bad[label] = bad.get(label, 0) + 1
    torch.cuda.synchronize()
    if bad:
        fail(f"repeated calls differ from the first: {bad}")
    log(f"  repeated calls: {REPEAT_ROUNDS} rounds x {len(repeats)} cases = "
        f"{REPEAT_ROUNDS * len(repeats)} calls, each equal to its case's "
        f"first output bit for bit, in {time.perf_counter() - t0:.1f} s  ok")


def time_resumed_flash(label, rnd, hq, hkv, d, sq, skv, q_offset) -> dict:
    """Flash at a resumed prefill's shape (Sq rows at ``q_offset`` over
    the whole Skv depth, causal) beside its plain version and SDPA with the
    same causal mask given as a boolean ``attn_mask``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = rnd(1, hq, sq, d), rnd(1, hkv, skv, d), rnd(1, hkv, skv, d)
    rows = q_offset + torch.arange(sq, device=q.device)
    mask = torch.arange(skv, device=q.device)[None, :] <= rows[:, None]

    def kernel():
        return flash_attention(q, k, v, causal=True, q_offset=q_offset)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    compare(f"flash {label}: SDPA with the mask vs the plain version",
            sdpa(), flash_attention_plain(q, k, v, causal=True,
                                          q_offset=q_offset))
    ms = median_ms(kernel, N_TIMED)
    dev_ms = device_ms(kernel, "flash_fwd_kernel")
    plain = median_ms(lambda: flash_attention_plain(
        q, k, v, causal=True, q_offset=q_offset), N_TIMED)
    lib = median_ms(sdpa, N_TIMED)
    pairs = sum(min(q_offset + i + 1, skv) for i in range(sq))
    bound, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                         4.0 * d * hq * pairs)
    log(f"  flash {label} Sq={sq} Skv={skv} q_offset={q_offset}: kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain:.4f} ms, sdpa "
        f"(mask) {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by)


def phase_matmul_kernel() -> dict:
    """matmul3d against its plain version: the reference's sweep shapes
    and ragged shapes through ``ops.matmul`` under the h100 target (bf16
    with f32 and bf16 out: the clamped plans round up to the tensor-core
    grain), then every h100 bf16 plan of the paper sweep at M = 8192 (f32
    out). The default h100 plan in bf16 is timed (its error is the
    ``kernels`` row's), and so is the f32 default plan beside ``torch.mm``
    in full f32 (TF32 off), which stays on the CUDA cores."""
    import torch
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.core import planner, tiling
    from repro_torch.core.target import get_target, use_target
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul3d import (kernel_blocks, matmul3d,
                                              matmul3d_plain)
    from repro_torch.launch.mempool_matmul import FRACTIONS, REL_TOL
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tols = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    err = 0.0
    with use_target("h100"):
        shapes = [(128, 128, 128), (256, 384, 512), (512, 128, 256),
                  (128, 512, 128), (200, 300, 100), (37, 45, 19),
                  (96, 32, 300)]
        for m, k, n in shapes:
            for dtype, out in ((torch.float32, torch.float32),
                               (torch.bfloat16, torch.float32),
                               (torch.bfloat16, torch.bfloat16)):
                a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
                plan = planner.matmul_kernel_plan(m, k, n,
                                                  in_bytes=a.element_size())
                blocks = kernel_blocks(plan, m, k, n, a.element_size())
                got = ops.matmul(a, b, out_dtype=out)
                want = matmul3d_plain(a, b, out_dtype=out)
                torch.cuda.synchronize()
                err = max(err, compare(
                    f"matmul3d {m}x{k}x{n} {str(dtype)[6:]} -> "
                    f"{str(out)[6:]} plan {(plan.bm, plan.bk, plan.bn)}, "
                    f"kernel blocks {blocks}", got, want, tols[dtype]))
        a = torch.randn((200, 300), generator=gen, device=dev).bfloat16()
        b = torch.randn((300, 100), generator=gen, device=dev).bfloat16()
        got = ops.matmul(a, b, plan=tiling.MatmulPlan(128, 128, 128))
        err = max(err, compare("matmul3d 200x300x100 bf16 plan (128, 128, "
                               "128), bf16 out (pad and crop)", got,
                               matmul3d_plain(a, b), tols[torch.bfloat16]))
    m = MATMUL_M
    h100 = get_target("h100")
    plan = planner.matmul_kernel_plan(m, m, m, in_bytes=2, target=h100)
    a = torch.randn((m, m), generator=gen, device=dev).bfloat16()
    b = torch.randn((m, m), generator=gen, device=dev).bfloat16()
    want = matmul3d_plain(a, b, out_dtype=torch.float32)
    peak = want.abs().max().item()
    m_err = None
    for frac in FRACTIONS:
        p = tiling.plan_matmul(m, m, m, in_bytes=2,
                               partition=h100.partition(fraction=frac))
        got = matmul3d(a, b, plan=p, out_dtype=torch.float32)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and e / peak <= REL_TOL["bf16"]):
            fail(f"matmul3d M={m} bf16 plan {p}: max|d| {e:.3e}, relative "
                 f"{e / peak:.2e} beyond {REL_TOL['bf16']}")
        log(f"  matmul3d M={m} bf16 (f32 out) fraction {frac} plan "
            f"{(p.bm, p.bk, p.bn)}: max |d| = {e:.3e}, relative "
            f"{e / peak:.2e}  ok")
        if p == plan:
            m_err = e
        del got
    if m_err is None:
        fail(f"the default h100 plan {plan} is none of the sweep's")
    log(f"  worst max |d| of the small and ragged cases {err:.3e}")
    del want
    ms = median_ms(
        lambda: matmul3d(a, b, plan=plan, out_dtype=torch.float32), N_TIMED)
    dev_ms = device_ms(
        lambda: matmul3d(a, b, plan=plan, out_dtype=torch.float32),
        "matmul3d_tc_kernel")
    plain = median_ms(
        lambda: matmul3d_plain(a, b, out_dtype=torch.float32), N_TIMED)
    lib = median_ms(lambda: torch.mm(a, b, out_dtype=torch.float32), N_TIMED)
    lib_dev = device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
    bound, by = bound_ms(2 * 2 * m * m + 4 * m * m, 2.0 * m ** 3)
    log(f"  matmul3d M={m} bf16 plan {(plan.bm, plan.bk, plan.bn)}: kernel "
        f"{ms:.4f} ms ({2 * m ** 3 / ms / 1e9:.2f} TFLOP/s; device "
        f"{dev_ms:.4f} ms), plain "
        f"{plain:.4f} ms, torch.mm {lib:.4f} ms (device {lib_dev:.4f} ms), "
        f"bound {bound:.4f} ms ({by})")
    # f32: the CUDA-core kernel at its default plan beside full-f32 torch.mm
    plan32 = planner.matmul_kernel_plan(m, m, m, in_bytes=4, target=h100)
    a, b = a.float(), b.float()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = matmul3d(a, b, plan=plan32)
        want = torch.mm(a, b)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if not rel <= REL_TOL["f32"]:
            fail(f"matmul3d M={m} f32 plan {plan32}: relative {rel:.2e} "
                 f"beyond {REL_TOL['f32']}")
        del got, want
        ms32 = median_ms(lambda: matmul3d(a, b, plan=plan32), N_TIMED)
        lib32 = median_ms(lambda: torch.mm(a, b), N_TIMED)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    bound32, by32 = bound_ms(3 * 4 * m * m, 2.0 * m ** 3, F32_FLOPS)
    log(f"  matmul3d M={m} f32 plan {(plan32.bm, plan32.bk, plan32.bn)}: "
        f"relative {rel:.2e}  ok; kernel {ms32:.4f} ms "
        f"({2 * m ** 3 / ms32 / 1e9:.2f} TFLOP/s, CUDA cores), torch.mm f32 "
        f"(TF32 off) {lib32:.4f} ms, bound {bound32:.4f} ms ({by32})")
    return dict(err=m_err, ms=ms, device_ms=dev_ms, plain_ms=plain,
                library_ms=lib, library_device_ms=lib_dev, bound_ms=bound,
                bound_by=by, f32_ms=ms32, f32_library_ms=lib32,
                f32_bound_ms=bound32)


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
        # bit for bit: the final state written over h0 equals the
        # functional one, and each batch row equals that row scanned alone
        args, h0 = timed["decode"]
        y_f, h_f = scan(args, h0)
        cache = h0.clone()
        y_i, h_i = ops.selective_scan(*args, h0=cache, return_state=True,
                                      state_in_place=True)
        if h_i is not cache or not (torch.equal(y_i, y_f)
                                    and torch.equal(cache, h_f)):
            fail("mamba_scan: the state written in place differs from the "
                 "functional state")
        for i in range(args[0].shape[0]):
            row = [t[i:i + 1] if t.dim() == 3 else t for t in args]
            y1, h1 = scan(row, h0[i:i + 1])
            if not (torch.equal(y1, y_f[i:i + 1])
                    and torch.equal(h1, h_f[i:i + 1])):
                fail(f"mamba_scan: batch row {i} alone differs from its "
                     f"row of the batch")
        log(f"  mamba_scan decode B={args[0].shape[0]}: state in place == "
            f"functional, each row alone == its row of the batch, bit for "
            f"bit  ok")
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
            dev = device_ms(lambda: scan(args, h0), "mamba_scan")
            plain = median_ms(lambda: mamba_scan_plain(
                *args, h0=h0, return_state=h0 is not None),
                N_TIMED_PLAIN_SCAN)
            n_bytes, exps = scan_work(*args, h0=h0,
                                      return_state=h0 is not None)
            bound, by = bound_ms(n_bytes, exps, H100_SXM.special_ops)
            rows[label] = dict(err=errs[label], ms=ms, device_ms=dev,
                               plain_ms=plain, library_ms=None,
                               bound_ms=bound, bound_by=by)
            log(f"  mamba_scan {label} B={args[0].shape[0]} "
                f"L={args[0].shape[1]}: kernel {ms:.4f} ms (device "
                f"{dev:.4f} ms), plain "
                f"{plain:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes} B, "
                f"{exps} exp), no library call")
    row = dict(rows["prefill"])
    row["extra"] = {f"{label}_{key}": rows[label][key]
                    for label in ("decode", "forward")
                    for key in ("device_ms", "bound_ms", "bound_by")}
    return row


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
    """A stream through the CLI, its launches counted around it: each
    whole-prompt or suffix admission and each prefill chunk launches flash
    once per attention layer; each decode step launches the paged kernel
    once per attention layer on an fp16 paged pool and no kernel on the
    dense slot slab or a quantized pool (the reference's dispatch: both
    decode through the masked oracle); admissions and decode steps launch
    mamba_scan once per mamba layer. Prints the stream's time."""
    from repro_torch.launch import serve as cli
    log(f"  {label}: " + " ".join(argv))
    t0 = time.perf_counter()
    reset_counts()
    rec = cli.run(argv)
    counts = read_counts()
    log(f"  {label}: {time.perf_counter() - t0:.1f} s, build and weights "
        f"included")
    return check_stream(cfg, rec, counts, label)


def check_stream(cfg, rec, counts, label) -> dict:
    """A stream's completions, host syncs and launches (see run_stream)."""
    n_attn, n_ssm = layer_counts(cfg)
    rec["launches"] = counts
    if rec["completed"] != rec["n_requests"]:
        fail(f"{label}: {rec['completed']}/{rec['n_requests']} completed")
    syncs = f"{rec['chunks']} chunks = {rec['host_syncs']} host syncs"
    if rec.get("disaggregate"):
        # one decode-role read a boundary, one prefill-role read at each
        # boundary that completed a prompt
        roles = rec["host_syncs_by_role"]
        if not (roles["decode"] == rec["chunks"]
                and 0 < roles["prefill"] <= rec["chunks"]
                and rec["host_syncs"] == roles["decode"] + roles["prefill"]):
            fail(f"{label}: host syncs {rec['host_syncs']} by role {roles} "
                 f"over {rec['chunks']} chunks")
        syncs = (f"{rec['chunks']} chunks = {roles['decode']} decode-role "
                 f"host syncs (+ {roles['prefill']} prefill-role)")
    elif rec["host_syncs"] != rec["chunks"]:
        fail(f"{label}: host_syncs {rec['host_syncs']} != chunks "
             f"{rec['chunks']}")
    adm, steps = rec["admissions"], rec["decode_steps_total"]
    chunks = rec["prefill_chunks"]
    # a speculative stream's verify forwards are multi-token and a quantized
    # pool's pages are not bf16: both gather + oracle, never the paged kernel
    paged_steps = (rec["paged"] and not rec.get("speculate_tokens")
                   and rec.get("layer0_codec") == "fp16")
    check_counts(label, counts, {
        "flash": (adm + chunks) * n_attn,
        "paged": steps * n_attn if paged_steps else 0,
        "scan": (adm + steps) * n_ssm, "plain_scan": 0})
    log(f"  {label}: ok — {adm} admissions, {chunks} prefill chunks, "
        f"{steps} decode steps, {syncs}; launches {counts}; "
        f"{rec['tok_per_s']:.1f} tok/s; ttft to the first token p50/p95 "
        f"{rec['ttft_emit_steps_p50']:.0f}/{rec['ttft_emit_steps_p95']:.0f} "
        f"steps")
    return rec


def check_speculative(label, rec) -> None:
    """The derived draft budget, one verify forward a boundary, and
    acceptance counters that add up."""
    k, prop, acc = (rec.get("speculate_tokens"), rec["spec_proposed"],
                    rec["spec_accepted"])
    if not (k == SPEC_TOKENS and prop > 0 and 0 <= acc <= prop
            and rec["spec_rejected"] == prop - acc
            and rec["decode_steps_total"] == rec["chunks"]):
        fail(f"{label}: k {k} (want {SPEC_TOKENS}), {prop} proposed, {acc} "
             f"accepted, {rec['spec_rejected']} rejected, "
             f"{rec['decode_steps_total']} verify forwards over "
             f"{rec['chunks']} chunks")
    log(f"  {label}: k = {k} derived under {SERVING_TARGET}; {prop} drafts "
        f"proposed, {acc} accepted (rate {rec['spec_acceptance_rate']:.4f}); "
        f"{rec['n_tokens']} tokens in {rec['decode_steps_total']} verify "
        f"forwards; {rec['tok_per_s']:.1f} tok/s")


def check_disaggregated(rec, combined) -> None:
    """The disaggregated chunked stream against the combined one: the same
    tokens, counters and launches, bit for bit, and one handover a
    request."""
    keys = ("chunks", "decode_steps_total", "prefill_chunks", "admissions")
    differ = [k for k in keys if rec[k] != combined[k]]
    differ += [f"launches[{k}]" for k in ("flash", "paged")
               if rec["launches"][k] != combined["launches"][k]]
    differ += [f"request {rid}" for rid, toks in combined["outputs"].items()
               if rec["outputs"].get(rid) != toks]
    if differ or len(rec["outputs"]) != len(combined["outputs"]):
        fail(f"disaggregated chunked stream differs from the combined one "
             f"in {differ}")
    if rec["handovers"] != rec["n_requests"] or rec["handover_pages"] <= 0:
        fail(f"disaggregated chunked stream: {rec['handovers']} handovers "
             f"({rec['handover_pages']} pages) for {rec['n_requests']} "
             f"requests")
    log(f"  disagg chunked: == chunked paged in every token, {keys} and the "
        f"flash / paged launches, bit for bit; {rec['handovers']} handovers "
        f"({rec['handover_pages']} pages, 0 bytes copied), "
        f"{rec['decode_tokens']} decode-role tokens; "
        f"{rec['tok_per_s']:.1f} tok/s against {combined['tok_per_s']:.1f}")


def check_squeezed(label, rec) -> None:
    if not (rec["preemptions"] >= 1 and rec["spilled_pages"] >= 1
            and rec["restores"] >= 1):
        fail(f"{label} did not preempt/spill/restore: "
             f"{rec['preemptions']}/{rec['spilled_pages']}/"
             f"{rec['restores']}")
    log(f"  {label}: {rec['preemptions']} preemptions, "
        f"{rec['spilled_pages']} pages spilled, {rec['restores']} restores")


def phase_stream(cfg) -> dict:
    """qwen2.5-3b's streams: paged, squeezed, dense slot slab, prefix
    shared and chunked (paged and dense). Every stream's requests 0 and 1
    are held to the teacher-forced rule."""
    from repro_torch.serve.scheduler import (kv_bytes_per_token,
                                             repetitive_stream,
                                             shared_prefix_stream,
                                             synthetic_stream)
    log("[5/9] qwen2.5-3b streams (every decode and verify chunk under "
        "set_sync_debug_mode('error')); the prefix-shared stream's requests "
        "are all held to the teacher-forced rule")
    recs = {"stream": run_stream(cfg, STREAM, "stream")}
    layer0 = kv_bytes_per_token(cfg) * 16 * SQUEEZED_PAGES
    recs["squeezed"] = run_stream(
        cfg, STREAM + ["--layer0-bytes", str(layer0)], "squeezed")
    check_squeezed("squeezed stream", recs["squeezed"])
    free_memory()
    recs["dense"] = run_stream(cfg, QWEN + DENSE_STREAM_ARGS, "dense stream")
    log("  dense stream: decode over the slot slab is the masked oracle, as "
        "the reference dispatches it (no kernel walks a slab): 0 paged "
        "launches")
    free_memory()
    share = run_stream(cfg, STREAM + ["--prefix-share", "--system-len",
                                      str(SYSTEM_LEN)], "prefix-shared")
    if not (share["prefix_hits"] >= 1 and share["shared_prefix_tokens"] >= 1
            and share["mapped_high_water"] > share["pages_high_water"]):
        fail(f"prefix-shared stream: {share['prefix_hits']} hits, "
             f"{share['shared_prefix_tokens']} shared tokens, "
             f"{share['mapped_high_water']} mapped vs "
             f"{share['pages_high_water']} physical pages")
    log(f"  prefix-shared: {share['prefix_hits']} hits / "
        f"{share['prefix_misses']} misses, {share['shared_prefix_tokens']} "
        f"prompt tokens from shared pages, {share['cow_copies']} COW "
        f"copies, {share['mapped_high_water']} mapped vs "
        f"{share['pages_high_water']} physical pages")
    recs["prefix_share"] = share
    free_memory()
    chunk_args = ["--chunk-prefill-tokens", str(CHUNK_TOKENS)]
    for name, argv in (("chunked_paged", STREAM + chunk_args),
                       ("chunked_dense", QWEN + DENSE_STREAM_ARGS
                        + chunk_args)):
        rec = run_stream(cfg, argv, name.replace("_", " "))
        if not (rec["admissions"] == 0 and rec["prefill_chunks"] > 8
                and rec["max_boundary_prefill_tokens"] <= CHUNK_TOKENS):
            fail(f"{name}: {rec['admissions']} whole admissions, "
                 f"{rec['prefill_chunks']} chunks, max boundary prefill "
                 f"{rec['max_boundary_prefill_tokens']} tokens (budget "
                 f"{CHUNK_TOKENS})")
        recs[name] = rec
        free_memory()
    spec_args = ["--speculate-tokens", "0"]
    for name, argv in (("speculate_paged", STREAM + spec_args),
                       ("speculate_dense", QWEN + DENSE_STREAM_ARGS
                        + spec_args)):
        rec = run_stream(cfg, argv, name.replace("_", " "))
        check_speculative(name.replace("_", " "), rec)
        recs[name] = rec
        free_memory()
    rec = run_stream(cfg, STREAM + chunk_args + ["--disaggregate"],
                     "disagg chunked")
    check_disaggregated(rec, recs["chunked_paged"])
    recs["disagg_chunked"] = rec
    free_memory()
    params = reference_params(cfg)
    plain = synthetic_stream(8, 512, 64, cfg.vocab_size)
    shared = shared_prefix_stream(8, SYSTEM_LEN, 512 - SYSTEM_LEN, 64,
                                  cfg.vocab_size)
    # the launcher serves a speculating stream over its repetitive workload
    repetitive = repetitive_stream(8, 512, 64, cfg.vocab_size)
    for name, r in recs.items():
        stream = (shared if name == "prefix_share"
                  else repetitive if name.startswith("speculate") else plain)
        # every prefix-shared request: all but the first are suffix
        # admissions over shared pages
        for rid in range(len(stream) if name == "prefix_share" else 2):
            teacher_forced_check(cfg, params, stream[rid]["prompt"],
                                 r["outputs"][rid], f"{name} request {rid}")
    recs.update(cow_streams(cfg, params))
    free_memory()
    recs.update(quantized_streams(cfg, params, recs))
    recs.update(park_streams(cfg, params, recs))
    del params
    free_memory()
    return recs


def first_token_agreement(label, rec, fp16) -> float:
    """The share of requests whose first token is the fp16 paged
    stream's; fails under KVQ_FIRST_TOKEN_AGREEMENT."""
    agree = sum(rec["outputs"][rid][0] == toks[0]
                for rid, toks in fp16["outputs"].items()) / len(fp16["outputs"])
    if agree < KVQ_FIRST_TOKEN_AGREEMENT:
        fail(f"{label}: first tokens agree with the fp16 paged stream on "
             f"{agree:.3f} of requests (want >= {KVQ_FIRST_TOKEN_AGREEMENT})")
    return agree


def one_step_drift(cfg, params, prompt) -> dict:
    """max |logit - fp16 logit| of one decode step after admitting
    ``prompt`` into an int8 and an fp8 pool (printed, not gated: the
    pinned bounds hold the tiny models of the tests)."""
    import torch
    from repro_torch.core.target import use_target
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.scheduler import Scheduler, derive_page_geometry
    logits = {}
    with use_target(SERVING_TARGET):
        engine = Engine(build_model(cfg), params,
                        EngineConfig(max_len=MAX_LEN, sync_interval=8))
        for q in ("fp16", "int8", "fp8"):
            geom = derive_page_geometry(cfg, MAX_LEN, page_tokens=16,
                                        max_slots=1, kv_quant=q)
            sch = Scheduler(n_slots=1, pages=geom)
            sch.submit(prompt, 8)
            plan = sch.plan_boundary(chunk_tokens=1, max_len=MAX_LEN)
            pool, _ = engine.pools.init_paged_pool(sch)
            slot, req = plan.admits[0]
            pool, _ = engine.prefill_role.paged_admit(pool, slot, req, geom)
            out, _ = engine.model.decode_step(
                engine.params, pool.tok[:, None], pool.state, pool.cache_len,
                plans=engine.plans,
                block_tables=engine.core.tensor(sch.block_table()))
            logits[q] = out[slot, 0, :cfg.vocab_size].float()
            del pool
    del engine
    free_memory()
    return {q: (logits[q] - logits["fp16"]).abs().max().item()
            for q in ("int8", "fp8")}


def quantized_streams(cfg, params, recs) -> dict:
    """The paged stream at ``--kv-quant int8`` and ``fp8`` (flash as in the
    fp16 stream, the paged kernel never: a quantized pool decodes by gather
    + oracle, the reference's dispatch; first tokens agree with the fp16
    stream on at least KVQ_FIRST_TOKEN_AGREEMENT of requests), int8 at the
    squeezed stream's layer-0 bytes (about twice its pages) and fp8 at
    half those bytes (it preempts and spills through the fp8 -> int8 ->
    fp8 copies). The merge counters are checked after each."""
    from repro_torch.serve.scheduler import kv_bytes_per_token
    fp16, squeezed = recs["stream"], recs["squeezed"]
    layer0 = kv_bytes_per_token(cfg) * 16 * SQUEEZED_PAGES
    out = {}
    for name, codec, extra in (
            ("kv_int8", "int8", []), ("kv_fp8", "fp8", []),
            ("squeezed_int8", "int8", ["--layer0-bytes", str(layer0)]),
            ("squeezed_fp8", "fp8", ["--layer0-bytes", str(layer0 // 2)])):
        label = name.replace("_", " ")
        rec = run_stream(cfg, STREAM + ["--kv-quant", codec] + extra, label)
        if rec["layer0_codec"] != codec or rec["launches"]["paged"] != 0:
            fail(f"{label}: layer 0 {rec['layer0_codec']}, "
                 f"{rec['launches']['paged']} paged launches (want {codec}, "
                 f"0)")
        if not extra and rec["launches"]["flash"] != fp16["launches"]["flash"]:
            fail(f"{label}: {rec['launches']['flash']} flash launches, the "
                 f"fp16 stream {fp16['launches']['flash']}")
        agree = first_token_agreement(label, rec, fp16)
        log(f"  {label}: layer0={rec['layer0_codec']} "
            f"layer1={rec['layer1_codec']}, {rec['n_pages'] - 1} layer-0 "
            f"pages in {rec['pool_bytes']} B, {rec['preemptions']} "
            f"preemptions, {rec['spilled_pages']} pages spilled, first-token "
            f"agreement {agree:.3f}; {rec['tok_per_s']:.1f} tok/s (fp16 "
            f"{fp16['tok_per_s']:.1f})")
        out[name] = rec
        check_merge_counters(label)
        free_memory()
    sq8, sq_fp8 = out["squeezed_int8"], out["squeezed_fp8"]
    log(f"  squeezed at {layer0} B: fp16 {squeezed['n_pages'] - 1} pages, "
        f"{squeezed['preemptions']} preemptions; int8 {sq8['n_pages'] - 1} "
        f"pages, {sq8['preemptions']} preemptions")
    if sq_fp8["preemptions"] < 1 or sq_fp8["layer1_codec"] != "int8":
        fail(f"squeezed fp8 at {layer0 // 2} B: {sq_fp8['preemptions']} "
             f"preemptions, layer 1 {sq_fp8['layer1_codec']} (want >= 1, "
             f"int8)")
    drift = one_step_drift(cfg, params, synthetic_prompt(cfg))
    log(f"  one decode step off a quantized pool vs the fp16 pool: max "
        f"|d logit| int8 {drift['int8']:.4f}, fp8 {drift['fp8']:.4f} "
        f"(printed, not gated)")
    out["kv_int8"]["one_step_drift"] = drift["int8"]
    out["kv_fp8"]["one_step_drift"] = drift["fp8"]
    return out


def synthetic_prompt(cfg):
    from repro_torch.serve.scheduler import synthetic_stream
    return synthetic_stream(8, 512, 64, cfg.vocab_size)[0]["prompt"]


def park_streams(cfg, params, recs) -> dict:
    """``--park-idle 16`` on the fp16 paged stream (tokens == the
    uninterrupted stream's, bit for bit; parks == resumes > 0), and
    ``--park-idle 16 --kv-quant int8`` through the launcher's run_stream
    with an engine built here, so that each resumed session's pages can be
    read: codes and scales byte-equal to the parked ones."""
    import torch
    from repro_torch.core.target import use_target
    from repro_torch.kernels.paged_attention import as_bits
    from repro_torch.launch import serve as cli
    from repro_torch.models.api import build_model
    from repro_torch.serve import park as park_mod
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.scheduler import (Scheduler, derive_n_slots,
                                             derive_page_geometry,
                                             synthetic_stream)
    out = {}
    rec = run_stream(cfg, STREAM + ["--park-idle", "16"], "park")
    differ = [rid for rid, toks in recs["stream"]["outputs"].items()
              if rec["outputs"][rid] != toks]
    if differ or not rec["parks"] == rec["park_resumes"] > 0:
        fail(f"park stream: requests {differ} differ from the uninterrupted "
             f"paged stream; {rec['parks']} parks, {rec['park_resumes']} "
             f"resumes")
    log(f"  park: {rec['parks']} sessions parked at step 16 and resumed; "
        f"every token == the uninterrupted paged stream's; "
        f"{rec['tok_per_s']:.1f} tok/s")
    out["park"] = rec
    check_merge_counters("park")
    free_memory()

    label = "park int8"
    log(f"  {label}: run_stream(park_idle=16) over the paged stream at "
        f"--kv-quant int8")
    t0 = time.perf_counter()
    with use_target(SERVING_TARGET):
        engine = Engine(build_model(cfg), params,
                        EngineConfig(max_len=MAX_LEN, sync_interval=8))
        geom = derive_page_geometry(cfg, MAX_LEN, page_tokens=16,
                                    max_slots=4, kv_quant="int8")
        sch = Scheduler(n_slots=derive_n_slots(cfg, MAX_LEN, max_slots=4,
                                               pages=geom), pages=geom)
        staged, checked = {}, []
        resume_parked, exec_resume = engine.resume_parked, engine._exec_resume

        def on_resume_parked(s, blob):
            req = resume_parked(s, blob)
            staged[req.rid] = park_mod.unpack_parked(blob)[1]
            return req

        def on_exec_resume(pool, rs, g):
            pool = exec_resume(pool, rs, g)
            arrays, req = staged.pop(rs.req.rid), rs.req
            k = min(next(v.shape[1] for key, v in arrays.items()
                         if key.startswith("pages/")), len(req.pages))
            priv = torch.as_tensor(req.pages[req.n_shared:k],
                                   device="cuda").long()
            for key, parked in arrays.items():
                kind, gname, gkey, name = key.split("/")
                if kind != "pages":
                    continue
                arr = pool.state["caches"][gname][gkey][name]
                got = as_bits(arr)[:, priv]
                want = as_bits(parked[:, req.n_shared:k]).contiguous().to(
                    got.device)
                if not torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8)):
                    fail(f"{label}: request {req.rid}'s {key} restored "
                         f"unlike its parked bytes")
            checked.append((req.rid, len(arrays), k - req.n_shared))
            return pool

        engine.resume_parked, engine._exec_resume = (on_resume_parked,
                                                     on_exec_resume)
        stream = synthetic_stream(8, 512, 64, cfg.vocab_size)
        reset_counts()
        rec = cli.run_stream(engine, sch, stream, park_idle=16)
        rec = check_stream(cfg, rec, read_counts(), label)
    if not (checked and rec["parks"] == rec["park_resumes"] == len(checked)
            and rec["layer0_codec"] == "int8" and not staged):
        fail(f"{label}: {rec['parks']} parks, {rec['park_resumes']} resumes, "
             f"{len(checked)} resumes checked, layer 0 {rec['layer0_codec']}")
    log(f"  {label}: {len(checked)} sessions resumed, every page leaf "
        f"(codes and scales: {checked[0][1]} leaves, {sum(c[2] for c in checked)} "
        f"pages) byte-equal to its parked copy; first-token agreement "
        f"{first_token_agreement(label, rec, recs['stream']):.3f}; "
        f"{time.perf_counter() - t0:.1f} s")
    out["park_int8"] = rec
    del engine
    check_merge_counters(label)
    free_memory()
    return out


def cow_streams(cfg, params) -> dict:
    """The same page-aligned 512-token prompt twice over two paged slots,
    served whole and by CHUNK_TOKENS chunks: the second request shares all
    but the prompt's last page and prefills only its last token over a
    private copy of that page (the copy-on-write admission, which the
    launcher's streams never make: their tails are unique). Both requests
    are held to the teacher-forced rule."""
    import numpy as np
    from repro_torch.core.target import use_target
    from repro_torch.launch import serve as cli
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.scheduler import Scheduler, derive_page_geometry
    prompt = np.random.RandomState(3).randint(2, cfg.vocab_size, size=512)
    stream = [{"prompt": prompt.astype(np.int32), "max_new_tokens": 32}] * 2
    recs = {}
    with use_target(SERVING_TARGET):
        engine = Engine(build_model(cfg), params,
                        EngineConfig(max_len=MAX_LEN, sync_interval=8))
        pages = derive_page_geometry(cfg, MAX_LEN, page_tokens=16,
                                     max_slots=2)
        for name, chunk in (("cow", None), ("cow_chunked", CHUNK_TOKENS)):
            label = f"copy-on-write ({'whole' if chunk is None else chunk})"
            log(f"  {label}: Engine.serve, 2 slots, prefix sharing, the same "
                f"512-token prompt twice")
            sch = Scheduler(n_slots=2, pages=pages, prefix_share=True,
                            chunk_prefill_tokens=chunk)
            reset_counts()
            rec = cli.run_stream(engine, sch, stream)
            rec = check_stream(cfg, rec, read_counts(), label)
            if not (rec["cow_copies"] == 1 and rec["prefix_hits"] == 1
                    and rec["shared_prefix_tokens"] == 511):
                fail(f"{label}: {rec['cow_copies']} COW copies, "
                     f"{rec['prefix_hits']} hits, "
                     f"{rec['shared_prefix_tokens']} shared tokens (want 1, "
                     f"1, 511)")
            for rid in (0, 1):
                teacher_forced_check(cfg, params, prompt, rec["outputs"][rid],
                                     f"{label} request {rid}")
            recs[name] = rec
    del engine
    return recs


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
        + f" (the launcher's target on the card, {SERVING_TARGET}; every "
        "decode chunk under set_sync_debug_mode('error'))")
    n_ssm = layer_counts(fcfg)[1]
    first = one_shot(fcfg, FALCON + ONE_SHOT_ARGS, "one-shot")
    free_memory()
    rec = run_stream(fcfg, FALCON + STREAM_ARGS, "stream")
    free_memory()
    dense = run_stream(fcfg, FALCON + DENSE_STREAM_ARGS, "dense stream")
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
        checks += [([stream[rid]["prompt"]], [r["outputs"][rid]],
                    f"{name} request {rid}") for rid in (0, 1)
                   for name, r in (("stream", rec), ("dense stream", dense))]
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
            "loss": loss, "loss_ms": loss_ms, "stream": rec, "dense": dense}


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


def phase_profile(cfg, kv_quant=None) -> None:
    """Device time by kernel, the device's idle share and the CUDA kernels
    launched, over the first PROFILE_STEPS decode steps of one more run of
    ``cfg``'s paged stream (at the ``kv_quant`` tier codec when given)
    under ``torch.profiler`` with CUDA activity only (kernel launches made
    here are outside the counted main-path runs), under the launcher's
    target on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.target import use_target
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.scheduler import (Scheduler, derive_n_slots,
                                             derive_page_geometry,
                                             synthetic_stream)
    log(f"  {cfg.name}: the first {PROFILE_STEPS} decode steps of its stream"
        + (f" at --kv-quant {kv_quant}" if kv_quant else ""))
    with use_target(SERVING_TARGET):
        geom = derive_page_geometry(cfg, MAX_LEN, page_tokens=16,
                                    max_slots=4, kv_quant=kv_quant)
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
        f"{stats['admissions']} admissions; "
        f"{sum(e.count for e in kernels)} CUDA kernels launched")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the top 12, then the port's own kernels wherever they rank
    shown = ranked[:12] + [e for e in ranked[12:]
                           if any(n in e.key for n in PORT_KERNELS)]
    for e in shown:
        rank = ranked.index(e) + 1
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
            f"#{rank:<3d} {e.key[:100]}")


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
    from repro_torch.core.target import use_target
    from repro_torch.serve.scheduler import derive_n_slots, derive_page_geometry

    t_start = time.perf_counter()
    smi = phase_environment()
    sass_ops = phase_build()
    cfg, fcfg = get_config("qwen2.5-3b"), get_config("falcon-mamba-7b")
    with use_target(SERVING_TARGET):       # the streams' geometry
        geom = derive_page_geometry(cfg, MAX_LEN, page_tokens=16, max_slots=4)
        n_slots = derive_n_slots(cfg, MAX_LEN, max_slots=4, pages=geom)
    timing = phase_kernels(cfg, geom, n_slots, fcfg)
    check_merge_counters("phase 3")
    free_memory()
    phase_one_shot(cfg)
    check_merge_counters("phase 4")
    streams = phase_stream(cfg)
    check_merge_counters("phase 5")
    rec = streams["stream"]
    free_memory()
    falcon = phase_falcon(fcfg)
    check_merge_counters("phase 6")
    paper = phase_paper()
    check_merge_counters("phase 7")
    log("[8/9] where the time goes: torch.profiler (CUDA activity)")
    phase_profile(cfg)
    phase_profile(cfg, kv_quant="int8")
    phase_profile(fcfg)
    check_merge_counters("phase 8")

    log(f"[9/9] summary ({time.perf_counter() - t_start:.0f} s)")
    rows = [("flash_attention", "flash_attention",
             "src/repro/kernels/flash_attention.py:30",
             rec["launches"]["flash"], timing["flash"]),
            ("paged_flash_decode", "paged_attention",
             "src/repro/kernels/paged_attention.py:154",
             rec["launches"]["paged"], timing["paged"]),
            ("matmul3d", "matmul3d", "src/repro/kernels/matmul3d.py:32",
             paper["launches"], timing["matmul3d"]),
            ("mamba_scan", "mamba_scan", "src/repro/kernels/mamba_scan.py:29",
             falcon["launches"], timing["mamba_scan"])]
    kernels = []
    for name, lib, replaces, launches, t in rows:
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{lib}.cu",
               "replaces": replaces, "launches": launches,
               "max_abs_err": t["err"], "ms": t["ms"],
               "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "library_device_ms": t.get("library_device_ms"),
               "tensor_cores": bool(sass_ops[lib]["HGMMA"]
                                    or sass_ops[lib]["HMMA"]),
               "sass_ops": sass_ops[lib]}
        if name == "matmul3d":   # the f32 path (CUDA cores) beside torch.mm
            row.update(f32_ms=t["f32_ms"],
                       f32_library_ms=t["f32_library_ms"],
                       f32_bound_ms=t["f32_bound_ms"])
        row.update(t.get("extra", {}))
        kernels.append(row)
    # every stream's own counts, each read around that stream alone
    by_path = {f"qwen {name}": r["launches"] for name, r in streams.items()}
    by_path.update({f"falcon {name}": falcon[name]["launches"]
                    for name in ("stream", "dense")})
    for row, key in zip(kernels, ("flash", "paged", None, "scan")):
        if key:
            row["launches_by_path"] = {path: c[key]
                                       for path, c in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
