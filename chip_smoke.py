#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit and no result line):

  1. environment: torch/CUDA versions, the card (compute capability 9.0)
     and its power limit;
  2. build: every CUDA kernel of the port (one nvcc per source, all
     started together), from ``kernels/csrc``; then each library's SASS
     (``cuobjdump --dump-sass``): matmul3d, flash_attention and
     grouped_gemm must hold HGMMA (wgmma, the tensor cores) and UTMALDG
     (TMA loads), paged decode HMMA (``mma.sync``, its tensor cores);
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
     positions; timed beside SDPA with the same mask), at D = Dv = 128
     bit for bit equal to the kernel before its (D, Dv) template
     (FLASH_DIGESTS), and at multi-head latent attention's D = 192, Dv =
     128 with 128 heads (deepseek-v2's one-shot admission 4 x 256, timed
     beside SDPA, over its 288 positions, ragged at an offset, and on the
     model's own K and V views), at D = Dv = 64 for seamless-m4t-medium's
     three kinds of call (encoder 4 x 512 non-causal, decoder prefill 4 x
     256 causal, cross-attention 4 x 256 and 4 x 1 over 512 source
     positions; 16 heads, model views; each timed beside SDPA) and windowed
     at gemma3-27b's widths (1 x 32 heads over 16, 4096 positions, window
     1024, timed beside SDPA given the band mask, bound over the band);
     paged decode windowed at gemma3's widths (4 slots at frontiers
     2048-4095, window 1024); flash at jamba's admission (phase 15's
     inputs); flash at D = Dv = 32 and 16 at the training examples'
     shapes (FLASH_NARROW_CASES, timed beside SDPA); these new cases'
     outputs digested from
     numpy-seeded inputs and held to NEW_CASE_DIGESTS; matmul3d at
     ``tests/test_kernels.py``'s tolerances (f32 2e-4, bf16 2e-2) at
     small and ragged shapes (bf16 with f32 and bf16 out), and at M = 8192
     within ``mempool_matmul.REL_TOL`` of the plain version's largest
     value (bf16 1e-3 at every h100 plan of the paper sweep, f32 1e-4 at
     the f32 default plan, timed beside ``torch.mm`` with TF32 off);
     paged decode also at split (4-page) boundaries, windows across and
     emptying splits, and the long case (4 slots x 4096 positions, timed
     in GB/s), one CUDA kernel a call, each slot alone and a 64-page
     null-padded table bit for bit equal to the batch of 4 over 36 pages,
     and at serve_bench's 8-token pages (8 pages a split): its chunked
     head-to-head's shape (8 slots over 514 pages, timed) and split edges
     under a window;
     the pooled decode's range walk (the paged kernel given a start and
     writing its log-sum-exp) at rows 2, 2a and 2b's shapes, each slot's
     live positions split in 2 and in 4 (``RANGE_SPLITS``), each range
     against its plain version (output within ATOL, lse within 1e-3),
     the ranges merged and held against the whole walk and the plain
     version within ATOL, range 0 of 2 at row 2 timed beside its bytes
     bound, the merged outputs digested (``range_row2`` ...); qwen2.5-3b's
     per-rank shapes at a 1 x 2 mesh (flash at 4 x 256 and paged decode,
     8 query heads over 1 KV head), digested as ``qwen_1x2_*``;
     grouped_gemm at qwen3-moe-30b-a3b's expert-parallel rank shapes (rank
     0 of 1 x 2, 64 experts, and of 1 x 4, 32; T 1024 and 4, gate and
     down projections): ``cap`` rows of which only the rank's own hits
     lie inside the offsets, the computed rows within GEMM_REL_TOL of the
     plain version, timed beside ``F.grouped_mm`` and the bound of the
     computed rows, in the repeat set and digested as
     ``qwen3moe_1x{2,4}_*`` (f32 outputs), and the same at deepseek-v2's
     rank shapes (80 and 40 experts, K 5120 / N 1536; ``deepseek_1x{2,4}_*``);
     flash at (192, 128) over deepseek-v2's heads a rank of 1 x 2 and 1 x
     4 (64 and 32; its 4 x 256 admission on the model's views), each
     timed beside SDPA and its bound, in the repeat set and digested as
     ``deepseek_1x{2,4}_flash``;
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
     the masked oracle by the reference's dispatch; k + 1 a layer for each
     verify forward of a speculative paged stream, one launch per query
     column; 0 on a quantized pool, which gathers and dequantizes as the
     reference does); every decode and verify chunk runs with
     device->host syncs made errors (the engine's guard); the host reads
     the device once a boundary (disaggregated: the decode role once a
     boundary, the prefill role only at boundaries that completed a
     prompt); and requests 0 and 1 of every stream, and every request of
     the prefix-shared and copy-on-write streams, are held to the
     teacher-forced rule;
  6. ``repro_torch.benchmarks.serve_bench``'s head-to-heads on
     qwen2.5-3b at full width under the bench's h100 default, 16
     requests, each run once: static / continuous / paged / paged+share,
     the chunked-prefill stall (the reference's 4096-token prompt), the
     speculative, disaggregated and int8 + host-parking head-to-heads.
     For each run: tok/s, wall-clock inter-token p50/p95/p99 and TTFT,
     TTFT in steps and at emission, host syncs against boundaries,
     preemptions and spills; every request drains, at most one host sync
     a boundary (a role a boundary when disaggregated), and the outputs
     gates pass (disaggregated == combined exactly; sharing, chunking and
     speculation by the teacher-forced rule; a failed gate fails the
     script after phase 14, so that the later phases still report);
     launches counted around the phase, and the phase's seconds printed;
  7. falcon-mamba-7b at full width: one-shot generate, the paged stream,
     the dense slot-slab stream, the squeezed paged stream (so the
     recurrent rows spill to their seats and come back, and every request
     emits the roomy stream's tokens), the greedy tokens against
     teacher-forced passes at the served batch, and ``Model.loss``'s
     forward on 1 x 2048 tokens. Every forward call launches mamba_scan
     once per layer (64) and the plain scan never;
  8. qwen3-moe-30b-a3b at its published widths, 16 of 48 layers (cut when
     its f32 init had to fit the card), through the launcher given the
     cut config:
     the grouped MoE (bf16 experts) against the plain one (f32, every
     expert on every token) at one full-width layer, T = 1024 and T = 4,
     each grouped call under the sync guard (no count read to the host),
     within MOE_TOL and with the same aux loss; the grouped_gemm kernel
     alone at the layer's routes (gate and down projections, T = 1024 and
     T = 4) within GEMM_REL_TOL of its plain version, timed beside
     ``F.grouped_mm`` (bf16 out) and the hit experts' bytes, each by
     events a call, back to back and by CUDA-graph replay (the device's
     time alone), with the wrapper's host time a call; the one-shot
     (flash 16 a admission) and the paged stream (paged 16 a decode step,
     host syncs once a chunk, decode chunks under the sync guard); every
     greedy token of the one-shot and of the stream's 8 requests held to
     teacher-forced passes at the served batch and pool; a full-sequence
     forward on the step-by-step pass's routes held to that pass within
     FORCED_ROUTE_TOL, and two control faults in the decode steps alone
     (K and V projections traded; ``wo`` rounded through fp8) that must
     fail that gate; the expert-parallel MoE (``moe_block(impl="ep")``)
     on NCCL world 1 held bit for bit to the grouped one at one layer, T =
     4 and 1024 (partial-K by the reference's byte rule) and 8192
     (weight-gather), each call's body logged; each rank's share of the
     layer on 1 x 2 and 1 x 4 meshes in one process (T 1024 and 4): kept
     hits the reference's cut, NaN in the rows past the offsets never
     reaching a share, the shares' sum within EP_RANK_TOL of the grouped
     layer (at 1 x 4 on the tokens that lost no hit; drops logged); the
     phase's seconds;
  9. deepseek-v2-236b the same way at 3 of 60 layers (the dense first
     layer, then 2 MLA + MoE layers): flash at D = 192, Dv = 128 3 a
     admission, the paged kernel never (MLA decodes in latent space, as
     the reference does), the paged stream over the latent pool and again
     at ``--kv-quant int8`` (first tokens against the fp16 stream's); its
     K / V control trades the K and V parts of ``wkv_b``; the
     expert-parallel layer at world 1 and its ranks' shares as phase 8's
     (every call partial-K by the byte rule at deepseek's widths; the
     shared experts' column / row shards summed against the whole SwiGLU
     within SHARED_RANK_TOL), and each rank's share of one MLA layer on 1 x
     2 and 1 x 4 (``check_mla_ranks``: leaves cut as ``init_serving`` cuts
     them, ``n_heads / M`` heads over the whole latent; the ranks' f32
     ``wo`` partials summed against the whole layer's at the admission's
     prefill through flash and one absorbed decode step, within
     MLA_RANK_TOL);
 10. gemma3-27b at its published widths cut to two 5:1 periods (12 of 62
     layers, globals at 5 and 11): the one-shot (2 x 2048-token prompts x
     32) and the paged stream (4 requests, prompts 1207-1708, 4 slots,
     16-token pages), both past the 1024-token window (flash skips the
     blocks behind the band; paged decode masks at cache_len - window on
     the local layers), launches counted (flash 12 an admission, paged 12
     a decode step), every greedy token held to the teacher-forced rule;
     the phase's seconds;
 11. qwen2-vl-2b uncut one-shot through the launcher (M-RoPE, 256 stub
     patch embeddings before each of 4 x 256-token prompts, 32 tokens;
     flash (128, 128) 28 times) and seamless-m4t-medium uncut one-shot
     through ``Engine.generate`` (4 rows of 512 source frames, 256-token
     decoder prompts, 32 tokens; flash (64, 64) once per encoder layer,
     twice per decoder layer at the prefill and once per decoder layer a
     decode step for the one-row cross-attention), every row held to the
     teacher-forced rule with its own frontend or source frames;
 12. the paper path: ``repro_torch.launch.mempool_matmul`` (the
     scratchpad-fraction sweep at M = 8192, bf16 and f32, each plan held
     to the plain version) and ``repro_torch.benchmarks.kernel_bench
     --target h100``, with the matmul3d launches counted around both;
 13. four chunks of the qwen2.5-3b stream (fp16 and int8 pages) and of
     the falcon-mamba-7b stream under ``torch.profiler`` (CUDA activity
     only): device time by kernel, the device's idle share and the CUDA
     kernels launched;
 14. training: each kernel's autograd Function (the kernel forward, a
     backward from its plain version) against autograd through the plain
     version at the training paths' shapes, the output and every input
     gradient within GRAD_TOL of its largest value (flash (128, 128) at
     qwen2.5-3b's 8 x 128 tokens, 16 query over 2 KV heads, causal;
     grouped_gemm's gate and down products at one qwen3-moe-30b-a3b
     layer's 1024-token admission; mamba_scan at falcon-mamba-7b's widths
     over 8 x 128 tokens), each plain backward timed; qwen2.5-3b at full
     width trained TRAIN_STEPS steps through ``launch.train.run``
     (TRAIN_ARGS, remat on): flash 72 launches a step (36 in the forward,
     36 in the backward's recompute), its plain backward 36 times, no
     other kernel; every loss finite and the last below the first; step
     time, tokens/s and peak memory beside the reckoning of f32 params,
     grads and both moments and the bf16 compute copy; the crash drill at
     full width cut to DRILL_LAYERS layers with int8 moments (a checkpoint
     every 2 steps, an injected crash before step 3 exits 17, ``--resume``
     continues: the resumed losses and the final params and moments equal
     an uninterrupted run's bit for bit), its saves and restore timed;
     ``repro_torch.examples.quickstart`` (300 steps, flash at (32, 32):
     8 launches a step, 4 plain backwards; final loss under 0.8 x uniform;
     its tok/s); qwen3-moe-30b-a3b at its published widths cut to
     MOE_TRAIN_LAYERS layers, trained through ``launch.train.run``
     (MOE_TRAIN_ARGS: 5 steps of 8 x 128 tokens at lr 3e-4): every loss
     finite and the last below the first, step time, peak memory beside
     its reckoning (18 B a parameter), grouped_gemm's launches (3 a MoE
     layer in the forward and 3 in the recompute) and plain backwards (3 a
     layer) a step, flash's at (128, 128); ``repro_torch.examples.
     elastic_restart`` through the mesh path on NCCL world 1 (1x1 then
     1x1; flash at (16, 16)), its continuity check; the phase's seconds;
 15. jamba-1.5-large-398b at its published widths. First its four kernels
     alone, each held against its plain version and timed as phase 3
     times: flash at its one-shot admission (4 x 256, 64 query heads over
     8, causal, on the model's views; beside SDPA ``is_causal,
     enable_gqa``; the same inputs are in phase 3's repeat set and
     digested as ``jamba_flash``); paged decode with 8 KV heads at group
     8, 4 slots of 16-token pages at frontiers past split edges (each slot
     alone bit for bit its row of the batch, one CUDA kernel a call);
     mamba_scan at Di = 16384, Ds = 16 under h100 plans, the prefill 1 x
     512 from a zero state and decode B = 4 from a random state written in
     place (== the functional state bit for bit), y at ATOL and the final
     state at SCAN_TOL; grouped_gemm at 16 experts top-2 on a seeded
     router's routes at d = 8192, T = 1024 and T = 4, the gate (K 8192, N
     24576) and down (K 24576, N 8192) projections each alone and freed
     after, within GEMM_REL_TOL, beside ``F.grouped_mm`` (bf16 out) and
     the hit experts' bytes, by CUDA-graph replay too, with
     ``launch_config``'s pick printed. Then the serving copy
     (``Model.init_serving``, built leaf by leaf) against
     ``prepare(init(gen))`` bit for bit where both fit (qwen2.5-3b uncut,
     qwen3-moe-30b-a3b at 2 layers: bf16 experts). Then the model cut to
     its 5 shallowest layers (mamba + MLP, mamba + MoE, twice, then GQA +
     MLP; 24.05 B parameters, 48.1 GB served) through the launcher: its
     serving copy built alone, peak allocated and reserved against the
     reckoning (the copy + its largest leaf in f32, 73.9 GB); the one-shot
     (4 x 256 x 32), the paged stream, the dense stream and the paged
     stream squeezed to 50 layer-0 pages (it must preempt, and emit the
     roomy stream's tokens bit for bit), launches counted around each by
     the rules of phases 4-5 and 8 (flash once per GQA layer and
     admission, paged decode once per GQA layer and decode step,
     mamba_scan once per mamba layer and forward, grouped_gemm 3 times
     per MoE layer and forward; all four > 0 on the paged stream; host
     syncs == chunks); every greedy token of the one-shot and the paged
     stream, and requests 0 and 1 of the dense stream, held to
     teacher-forced passes at the served batch and pool; a full-sequence
     forward on the step-by-step pass's routes held to that pass, its
     logits within FORCED_ROUTE_TOL and each sublayer's output (every
     mixer and feed-forward block) within FORCED_SUBLAYER_TOL of its
     largest, and three control faults in the decode steps alone that
     must fail that gate (the GQA layer's K and V traded, its ``wo``
     through fp8; every mamba layer's ``out_proj`` through fp8); the
     phase's seconds;
 16. the mesh path: qwen2.5-3b at full width served through
     ``launch.serve.run`` with ``--mesh 1`` (NCCL world 1, a process group
     of its own; every collective of the tensor-parallel engine spans one
     rank): launches by phase 5's rules, host syncs == chunks, and every
     token, the scheduler counters and the launches equal phase 5's
     single-device paged stream; then deepseek-v2-236b x 3 the same way
     (MLA's head-sharded layer, the expert-parallel MoE and the shared
     experts' tensor-parallel SwiGLU over one rank) against phase 9's
     paged stream; the phase's seconds;
 17. the ``kernels`` summary line (launches on the main path, the paged
     qwen stream, and by path for every stream; flash at D = 192 a row of
     its own, launched by deepseek-v2's paged stream, its 64- and 32-head
     rank shapes and the MLA rank check among its extras (the rank shapes
     launch on a main path only across cards: ``mesh_probe``, PERF.md);
     grouped_gemm's extras hold both MoE models' rank shapes, layer
     checks and shares; flash at D = 64 a
     row launched by seamless-m4t-medium's one-shot; grouped_gemm a row
     launched by qwen3-moe's paged stream; the training launches a step,
     and each Function's check and plain backward time, on the flash,
     mamba_scan and grouped_gemm rows; four rows at jamba's widths from
     phase 15, whose ``launches`` are each kernel's on jamba's own paged
     stream; the range walk's row from phase 3, its launches the paged
     kernel's on phase 16's stream, its range walks there counted apart),
     the card line, and the result line.

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
layers that moves falcon's logits by more than ``LOGIT_TOL``. The MoE
models take the same passes, the stream's over a paged pool as it was
served: a full-sequence forward computes the same function through other
GEMM shapes (and, for MLA, through decompressed bf16 heads where decode
reads the f32 latent), and a router near-tie that it flips moves the
logits by up to 0.41 (deepseek-v2 at 3 layers, measured). Such a forward,
its routes forced to the step-by-step pass's, is held to that pass
within ``FORCED_ROUTE_TOL`` (jamba also sublayer by sublayer, within
``FORCED_SUBLAYER_TOL``: its one GQA layer adds too little to the logits
for a fault there to show in them): the one check of the MoE paths on
the card that does not replay the served code. The squeezed falcon and jamba
streams must also emit the roomy stream's tokens bit for bit: their
recurrent rows only move between slots and f32 seats.
"""

from __future__ import annotations

import contextlib
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
PROFILE_STEPS = 32         # decode steps (4 chunks) traced in phase 13
PROFILE_TRIES = 6          # traces taken before the profiler is given up
PROFILE_PAD_S = 0.5        # host idle at either end of a phase 13 trace
KERNEL_PAD_S = 0.05        # ... of a kernel's trace of N_TIMED calls
SENTINEL = "spin_kernel"   # torch.cuda._sleep's kernel, opening each trace
SENTINEL_LAUNCHES = 64     # at either end of a trace
SENTINEL_CYCLES = 1000

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
BENCH_PAGE_TOKENS = 8      # serve_bench's default --page-tokens
BENCH_REQUESTS = 16        # each serve_bench head-to-head's stream
#: serve_bench's park step for its int8 head-to-head: the first boundary
#: (4 steps), where no request is preempted, so the next serve() may run
BENCH_PARK_IDLE = 4
#: pages a slot in serve_bench's chunked head-to-head: its 4096-token
#: prompt + 12 generated over 8-token pages
BENCH_P_MAX = -(-(4096 + 12) // BENCH_PAGE_TOKENS)
#: flash at D = Dv = 128 on numpy-seeded inputs (``flash_digest_inputs``):
#: the first 16 hex digits of each output's sha256, as the kernel before
#: its (D, Dv) template (commit 1a1021e) printed them on an NVIDIA H100
#: 80GB HBM3.
#: The template must not move a bit.
FLASH_DIGESTS = {"admission": "2be6a11c2e88583d", "ragged": "df2f42699612d5ac",
                 "views": "1aa9d5a8e277dfce", "window": "2e440388610f8045",
                 "offset": "1eb79b3a10b47377", "mha": "329f070aa7763e0a",
                 "noncausal": "63d113eb070f630c"}
#: the windowed and (64, 64) attention cases (``new_attention_cases``: flash
#: at (64, 64), windowed flash and paged decode; flash at jamba's admission;
#: flash at (32, 32) and (16, 16), FLASH_NARROW_CASES; the range walks and
#: the 1 x 2 rank shapes, ``paged_range_cases`` / ``qwen_rank_cases``),
#: digested as the kernels printed them on an NVIDIA H100 80GB HBM3; a later
#: change must not move a bit
NEW_CASE_DIGESTS = {"d64_encoder": "aea592b592485ddb",
                    "d64_decoder": "9443e92d6e2995b8",
                    "d64_cross": "9ad63f4b0801c5c7",
                    "d64_cross_decode": "053aecdb506d646c",
                    "window": "4368ebeded649f77",
                    "paged_window": "90ef91573dbe1ad4",
                    "jamba_flash": "4e6d007a2931ac24",
                    "d32_quickstart": "32296beb00d49315",
                    "d16_elastic": "097455ccf3d972e2",
                    # the range walks merged at 2 ranges, and qwen2.5-3b's
                    # 1 x 2 rank shapes
                    "range_row2": "94eabc09fcd478f7",
                    "range_row2a": "fc4aff04a5773e71",
                    "range_row2b": "e6d58f55eb370b8b",
                    "qwen_1x2_flash": "a17d66b01fb24e22",
                    "qwen_1x2_paged": "e42f5c5abcc7ed41",
                    # grouped_gemm at qwen3-moe's expert-parallel rank
                    # shapes (f32 outputs, the rows inside the offsets)
                    "qwen3moe_1x2_prefill_gate": "ac3f528747cf50d8",
                    "qwen3moe_1x2_prefill_down": "299082f9f706ef5d",
                    "qwen3moe_1x2_decode_gate": "7203743bc1352ae6",
                    "qwen3moe_1x2_decode_down": "76dadf1b21c6555c",
                    "qwen3moe_1x4_prefill_gate": "6f25f1ea97627a92",
                    "qwen3moe_1x4_prefill_down": "89e535b49678efb6",
                    "qwen3moe_1x4_decode_gate": "1a87df59ff57a153",
                    "qwen3moe_1x4_decode_down": "c337f87e47bec2c9",
                    # deepseek-v2's rank shapes: flash (192, 128) over 64 /
                    # 32 heads and grouped_gemm over 80 / 40 experts
                    "deepseek_1x2_flash": "f9c9abc5f541449c",
                    "deepseek_1x4_flash": "fee44a44a2e11d97",
                    "deepseek_1x2_prefill_gate": "5fc22115cb340554",
                    "deepseek_1x2_prefill_down": "84e9f816dd393bea",
                    "deepseek_1x2_decode_gate": "c3c553821652479c",
                    "deepseek_1x2_decode_down": "04369b062c538df1",
                    "deepseek_1x4_prefill_gate": "ea4deb59877b5bac",
                    "deepseek_1x4_prefill_down": "5865752fb0366e82",
                    "deepseek_1x4_decode_gate": "4d64e33c7fcda866",
                    "deepseek_1x4_decode_down": "33a8f9717f123a9f"}
#: the pooled decode's range splits held in phase 3
RANGE_SPLITS = (2, 4)
#: the model axes whose rank shapes phase 3 runs grouped_gemm (and MLA's
#: flash) at
EP_RANK_MESHES = (2, 4)
#: grouped_gemm at the expert-parallel rank shapes of phase 3: arch ->
#: (digest prefix, numpy seed, experts drawn: None draws every expert of
#: rank 0, a number draws that many and tiles them to the rank's count,
#: so that deepseek-v2's 80 x 5120 x 1536 experts are not drawn on the
#: host one by one)
EP_RANK_GEMM = {"qwen3-moe-30b-a3b": ("qwen3moe", 393, None),
                "deepseek-v2-236b": ("deepseek", 397, 8)}
#: (B, Hq, Hkv, Sq, Skv, kwargs, transposed views) of each digest case
FLASH_DIGEST_CASES = {
    "admission": (4, 16, 2, 256, 256, {}, False),
    "ragged": (1, 16, 2, 300, 333, {}, False),
    "views": (2, 16, 2, 200, 256, {}, True),
    "window": (1, 16, 2, 512, 576, {"window": 64}, False),
    "offset": (1, 16, 2, 37, 576, {"q_offset": 16}, False),
    "mha": (1, 16, 16, 512, 576, {}, False),
    "noncausal": (1, 8, 2, 100, 130, {"causal": False}, False),
}
#: the MoE family at published widths, depth cut when the f32 init had to
#: fit the card (PERF.md section 4; the serving copy is now built leaf by
#: leaf): (arch, layers kept of the published)
QWEN_MOE = ("qwen3-moe-30b-a3b", 16)
DEEPSEEK = ("deepseek-v2-236b", 3)
#: deepseek-v2's one-shot admission (B, S): flash at (192, 128) and the MLA
#: rank check's prefill
MLA_ADMISSION = (4, 256)
#: the grouped MoE (bf16 experts, f32 expert products) against the plain
#: one (f32 experts) at one full-width layer: bf16 operand rounding. Read
#: on an NVIDIA H100 80GB HBM3 (PERF.md section 6): qwen3-moe 7.8e-3 / 3.9e-3
#: (T 1024 / 4), deepseek-v2 1.56e-2 at both, whose shared expert's bf16
#: SwiGLU output rounds on both sides
MOE_TOL = 2e-2
#: one full-width MoE layer's token counts: a one-shot admission's prefill
#: (4 x 256) and a decode step over the 4 slots
MOE_TOKENS = {"prefill": 1024, "decode": 4}
#: the expert-parallel layer's token counts at world 1; the body each call
#: must take is the reference's byte rule's (``moe.ep_body``): at qwen3-moe's
#: widths partial-K below ~5560 tokens (T 4, 1024) and weight-gather above
#: (8192), at deepseek-v2's partial-K below ~21800 (all three)
EP_LAYER_TOKENS = (4, 1024, 8192)
#: the sum of the ranks' f32 shares of one full-width expert-parallel layer
#: against the grouped layer's f32 output, relative to its largest value:
#: the same hits through the same weights, the k hits of a token summed in
#: another f32 order. Read on an NVIDIA H100 80GB HBM3: 1.1e-7 to 1.7e-7
#: at T 1024 and 4; a hit lost or counted twice moves its token by about
#: its gate (1 / top_k) of its output
EP_RANK_TOL = 1e-5
#: each rank's f32 partial of deepseek-v2's shared experts (its column
#: shards of ``w_gate`` / ``w_up``, row shard of ``w_down``, through
#: ``layers.mlp(..., d_ff=)``) summed over the ranks against the whole
#: SwiGLU's f32 product, relative to its largest value: the same bf16
#: column products (cuBLAS may round a column of the sliced GEMM otherwise)
#: and the row partials summed in another f32 order. Read on an NVIDIA H100
#: 80GB HBM3, 700.00 W: 2.2e-6 to 3.3e-6 at 1 x 2 / 1 x 4, T 1024 / 4
#: (PERF.md, PR 32; the CPU reads 1.2e-7 / 1.7e-7); a rank's share lost or
#: counted twice moves the sum by about its own size
SHARED_RANK_TOL = 2e-5
#: the MLA rank check (``check_mla_ranks``): the sum of the ranks' f32 ``wo``
#: partials of one full-width deepseek-v2 layer against the whole layer's
#: f32 ``wo`` product, relative to its largest value, at the prefill (flash
#: over the rank's heads) and one absorbed decode step: the same heads
#: through column-sliced bf16 GEMMs and the row partials summed in another
#: f32 order. Read on an NVIDIA H100 80GB HBM3, 700.00 W: prefill 1.2e-5 /
#: 1.4e-5, decode 7.1e-5 at 1 x 2 / 1 x 4 (PERF.md, PR 32); a head lost,
#: counted twice or paired with another rank's rows moves the sum by O(1)
MLA_RANK_TOL = 5e-4
#: a MoE model's step-by-step pass against a full-sequence forward on the
#: same routes (forced_routes), max |d logit| over the generated
#: positions, by arch: about 2.3x the sound runs' readings (up to 0.041
#: and 0.110: GEMM shapes, and for MLA bf16 heads against the f32 latent)
#: and at most half the weaker control's (0.206 and 0.988: ``wo`` through
#: fp8 in the decode steps). NVIDIA H100 80GB HBM3, PERF.md section 6.
#: jamba x 5: 1.27x its sound readings (0.1316 / 0.1419 / 0.1569: four
#: bf16 mamba layers through other GEMM shapes; logits twice qwen3's
#: scale at d 8192); ``swap_kv`` reads 0.2442, ``fp8_out_proj`` 1.9863,
#: but ``fp8_wo`` 0.1401, under the sound readings: with random weights
#: its one GQA layer's output is small beside the residual stream, so it
#: is gated by sublayer too (FORCED_SUBLAYER_TOL)
FORCED_ROUTE_TOL = {"qwen3-moe-30b-a3b": 0.1, "deepseek-v2-236b": 0.25,
                    "jamba-1.5-large-398b": 0.2}
#: jamba x 5, the same comparison by sublayer (sublayer_gaps): each mixer's
#: and feed-forward block's largest |d| over the generated positions as a
#: share of its largest output there. Sound readings up to 0.0219 (the
#: GQA layer's 0.0151-0.0184), the controls' at their faulted sublayer
#: 0.2203 (swap_kv), 0.0474 (fp8_wo), 0.0774-0.2934 (fp8_out_proj): the
#: gate sits near their geometric mean, 1.46x the sound readings and 0.68x
#: fp8_wo's (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, PR 27)
FORCED_SUBLAYER_TOL = 0.032
#: gemma3-27b at its published widths cut to two 5:1 periods (globals at 5
#: and 11): 12 of 62 layers (PERF.md section 4); its prompts run past the
#: 1024-token window, so flash skips the blocks behind the band and paged
#: decode masks at cache_len - window on the local layers
GEMMA = ("gemma3-27b", 12)
GEMMA_ONE_SHOT_ARGS = ["--batch", "2", "--prompt-len", "2048", "--gen-len",
                       "32"]
#: 4 requests, prompts 1207-1708 tokens (synthetic_stream's draw at 2048),
#: budgets 18-31, 4 slots, 16-token pages
GEMMA_STREAM_ARGS = ["--stream", "4", "--paged", "--batch", "4",
                     "--prompt-len", "2048", "--gen-len", "32",
                     "--sync-interval", "8"]
#: the windowed flash case (gemma3's widths: 32 heads over 16, window 1024)
#: over 4096 positions, and windowed paged decode at frontiers 2048-4095
WINDOW, WINDOW_SEQ = 1024, 4096
PAGED_WINDOW_LENS = [2048, 2730, 3413, 4095]
#: qwen2-vl-2b uncut, one-shot: 4 rows of 256 stub patch embeddings + 256
#: text tokens, 32 generated
QWEN_VL = ["--arch", "qwen2-vl-2b", "--full", "--batch", "4",
           "--prompt-len", "256", "--gen-len", "32"]
#: seamless-m4t-medium uncut, one-shot: 4 rows of 512 source frames and a
#: 256-token decoder prompt, 32 generated
SEAMLESS = ("seamless-m4t-medium", 512, 256)
#: flash at (64, 64), seamless' three kinds of call at its widths (16 heads
#: over 16): (B, Sq, Skv, causal)
FLASH_D64_CASES = {"encoder": (4, 512, 512, False),
                   "decoder": (4, 256, 256, True),
                   "cross": (4, 256, 512, False),
                   "cross_decode": (4, 1, 512, False)}
#: flash at (32, 32) and (16, 16), the training examples' causal
#: self-attention at their own shapes on the model's views: (B, Hq, Hkv, S,
#: D) of repro_torch.examples.quickstart (8 x 256 tokens, 8 heads over 4)
#: and elastic_restart (8 x 64, 4 over 2)
FLASH_NARROW_CASES = {"d32_quickstart": (8, 8, 4, 256, 32),
                      "d16_elastic": (8, 4, 2, 64, 16)}
#: the grouped_gemm kernel against its plain version (the same exact f32
#: products summed in another order): max |d| over the output's largest
GEMM_REL_TOL = 1e-4
#: phase 15: jamba-1.5-large-398b's four kernels alone at its published
#: widths on numpy-seeded inputs (the model follows, below): flash at its
#: one-shot admission (B, S: 64 query heads over 8,
#: causal); paged decode over 4 slots of 16-token pages at frontiers past
#: split (4-page) edges; mamba_scan's prefill (B, L) from a zero state and
#: decode from a random one written in place; grouped_gemm at a prefill's
#: and a decode step's tokens (16 experts, top-2)
JAMBA = "jamba-1.5-large-398b"
JAMBA_ADMISSION = (4, 256)
JAMBA_PAGED_LENS = [64, 129, 1025, 4095]
JAMBA_PAGE_TOKENS = 16
JAMBA_SCAN = {"prefill": (1, 512, False), "decode": (4, 1, True)}
JAMBA_GEMM_TOKENS = {"prefill": 1024, "decode": 4}
#: phase 15's model: jamba at its published widths cut to its 5 shallowest
#: layers, the shallowest cut with attention (``blocks`` x 2: mamba + MLP,
#: mamba + MoE; ``tail``: GQA + MLP): 24.05 B parameters, 96.2 GB in f32,
#: 48.1 GB as served
JAMBA_LAYERS = 5
#: the serving copy's reckoning from jamba's shapes: the bf16 copy plus one
#: f32 expert leaf (2 x 16 x 8192 x 24576), 48.1 + 25.8 GB; the phase also
#: computes it from the copy it builds
JAMBA_RECKONING_GB = 73.9
#: layer-0 pages that make jamba's STREAM preempt (a CPU rehearsal of the
#: scheduler at jamba's vocab: 2 preemptions, 53 pages spilled; at 45 it
#: does not preempt)
JAMBA_SQUEEZED_PAGES = 50
#: the serving copy against prepare(init(gen)) on the card, where both fit:
#: (arch, layers kept; None: all)
SERVING_COPY_CHECKS = (("qwen2.5-3b", None), ("qwen3-moe-30b-a3b", 2))
#: phase 14: qwen2.5-3b --full trained through the launcher (remat on)
TRAIN_STEPS = 10
#: at the launcher's default peak lr of 3e-3 (sized for the smoke configs)
#: this run's loss fell for 6 steps and then rose past its first value
#: (12.415 -> 12.154 -> 12.550 on an NVIDIA H100 80GB HBM3); a 3B
#: model trains at a tenth of that
TRAIN_ARGS = ["--arch", "qwen2.5-3b", "--full", "--steps", str(TRAIN_STEPS),
              "--global-batch", "8", "--seq-len", "128", "--lr", "3e-4",
              "--log-every", "1"]
#: the crash drill: qwen2.5-3b at full width cut to DRILL_LAYERS layers,
#: int8 moments, a checkpoint every 2 steps, a crash before step 3; at 2
#: layers (465.6 M params) its two saves and restore took 70 s (a save of
#: 2.81 GB in 30 s, on an NVIDIA H100 80GB HBM3's host) and pushed the
#: phase past 120 s
DRILL_LAYERS = 1
DRILL_ARGS = ["--steps", "4", "--global-batch", "8", "--seq-len", "128",
              "--quantized-moments", "--ckpt-every", "2", "--log-every", "1"]
#: phase 14: qwen3-moe-30b-a3b at its published widths trained on the card
#: (launch.train.run, remat on), cut to its first MOE_TRAIN_LAYERS layers:
#: an untied 2 x 311.2 M embedding plus ~623 M a layer, 3.11 B parameters,
#: ~56 GB at 18 B a parameter (f32 params, grads, m, v and the bf16 copy)
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 5
MOE_TRAIN_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--full", "--steps",
                  str(MOE_TRAIN_STEPS), "--global-batch", "8", "--seq-len",
                  "128", "--lr", "3e-4", "--log-every", "1"]
#: repro_torch.examples.quickstart's steps (its default): flash at (32, 32)
QUICKSTART_STEPS = 300
#: the kernels' autograd Functions against autograd through their plain
#: versions: output and each input gradient within this share of its
#: largest value (bf16 operands)
GRAD_TOL = 2e-2
#: qwen3-moe-30b-a3b's routed hits at a 1024-token admission (top 8 of 128)
GRAD_MOE = (1024 * 8, 2048, 768, 128)
#: libraries whose SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG)
TENSOR_CORE_KERNELS = ("matmul3d", "flash_attention", "grouped_gemm")
#: libraries whose SASS must hold mma.sync (HMMA)
MMA_SYNC_KERNELS = ("paged_attention",)
#: the port's kernels by name, as the profiler lists them
PORT_KERNELS = ("flash_fwd_kernel", "paged_decode_kernel",
                "mamba_scan_kernel", "mamba_scan_step_kernel", "matmul3d_",
                "grouped_gemm_kernel")


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


@contextlib.contextmanager
def cuda_trace(pad_s: float):
    """torch.profiler over CUDA activity only, with ``pad_s`` of host idle
    inside its window at either end. The profiler keeps a kernel only if
    its device times, mapped to the host's clock, fall inside the window;
    on the H100 that mapping parts from the window by up to ~20 ms over a
    trace of seconds (the profiler's own "Out-of-range" count: up to 659
    records a trace, the last launches first), so unpadded traces lost
    the kernels at their ends. Past a few thousand traced kernels in the
    process a trace may also drop its first kernel record whatever the
    padding (an NVIDIA H100 80GB HBM3, torch 2.11: one of 25 in every
    retake), and a long trace its first few records (falcon-mamba's
    stream: both of two opening spin kernels and the first admission's
    first scan kernel, in every retake on one machine), so each trace
    opens and closes with SENTINEL_LAUNCHES spin kernels
    (``torch.cuda._sleep``), which :func:`traced_kernels` leaves out and
    :func:`sentinels_traced` counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def sentinels():
        for _ in range(SENTINEL_LAUNCHES):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        sentinels()
        yield prof
        torch.cuda.synchronize()
        sentinels()
        time.sleep(pad_s)


def traced_kernels(prof) -> list:
    """The CUDA kernels of a :func:`cuda_trace`, its sentinels left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and SENTINEL not in e.key]


def sentinels_traced(prof) -> str:
    """How many of a :func:`cuda_trace`'s spin kernels it kept, of how
    many launched: which end of a trace that lost records lost them."""
    from torch.autograd import DeviceType
    kept = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and SENTINEL in e.key)
    first = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda e: e.time_range.start)[:3]
    return (f"{kept} of {2 * SENTINEL_LAUNCHES} sentinels, first kept "
            f"{[e.name[:40] for e in first]}")


def device_profile(fn, kernel: str = "", n: int = N_TIMED) -> tuple:
    """Device time per call of ``fn`` in the kernels whose names hold
    ``kernel`` (every kernel it launches when empty), over ``n`` calls
    under torch.profiler (CUDA activity only): the device's work alone,
    without the host's call path that CUDA events around one call also
    count; and how many CUDA kernels of any name one call launches.

    The trace is padded (:func:`cuda_trace`). Every call of ``fn``
    launches the same kernels, so a whole trace holds each kernel a
    multiple of ``n`` times; any other trace is taken again, up to
    PROFILE_TRIES traces. Fails if none was whole or none held such a
    kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with cuda_trace(KERNEL_PAD_S) as prof:
            for _ in range(n):
                fn()
        cuda = traced_kernels(prof)
        if cuda and all(e.count % n == 0 for e in cuda):
            break
        log(f"  (the profiler lost kernel records: {n} calls, "
            f"{sum(e.count for e in cuda)} kernels traced "
            f"({', '.join(f'{e.key[:40]} {e.count}' for e in cuda)}), "
            f"{sentinels_traced(prof)}; tracing again)")
    else:
        fail(f"the profiler returned no whole trace of {n} calls in "
             f"{PROFILE_TRIES} tries")
    hits = [e for e in cuda if kernel in e.key]
    if not hits:
        fail(f"the profiler saw no {kernel or 'CUDA'} kernel")
    return (sum(e.self_device_time_total for e in hits) / n / 1e3,
            sum(e.count for e in cuda) / n)


def device_ms(fn, kernel: str = "", n: int = N_TIMED) -> float:
    """:func:`device_profile`'s device time alone."""
    return device_profile(fn, kernel, n)[0]


def layer_counts(cfg) -> tuple:
    """(attention layers, mamba layers, GQA layers) of ``cfg``'s stack.
    Every attention layer's prefill launches flash (a GQA layer at D =
    128, an MLA layer at D = 192); only a GQA layer's decode walks pages with the paged kernel (MLA decodes in latent
    space: einsums, as the reference does)."""
    kinds = [k for g in cfg.layer_groups() for _ in range(g.n_repeat)
             for k in g.pattern]
    ssm = sum(k.attn == "mamba" for k in kinds)
    return len(kinds) - ssm, ssm, sum(k.attn == "gqa" for k in kinds)


def moe_layers(cfg) -> int:
    """MoE layers of ``cfg``'s stack: each forward launches grouped_gemm 3
    times in each (gate, up and down projections)."""
    return sum(k.mlp == "moe" for g in cfg.layer_groups()
               for _ in range(g.n_repeat) for k in g.pattern)


def reset_counts() -> None:
    """Zero every kernel's launch count and the plain scan's call count."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
    from repro_torch.kernels.paged_attention import paged_flash_decode
    flash_attention.launches = paged_flash_decode.launches = 0
    paged_flash_decode.range_launches = 0
    flash_attention.launches_by_dims.update(
        dict.fromkeys(flash_attention.launches_by_dims, 0))
    mamba_scan.launches = mamba_scan_plain.calls = grouped_gemm.launches = 0


def read_counts() -> dict:
    """Each kernel's launches; flash by instance: ``flash`` at D = Dv =
    128, ``flash_d192`` at D = 192, Dv = 128, ``flash_d64``, ``flash_d32``
    and ``flash_d16`` at D = Dv = 64, 32 and 16; ``paged_range`` the paged
    launches that walked a position range (the pooled decode)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
    from repro_torch.kernels.paged_attention import paged_flash_decode
    by_dims = flash_attention.launches_by_dims
    return {"flash": by_dims[128, 128], "flash_d192": by_dims[192, 128],
            "flash_d64": by_dims[64, 64], "flash_d32": by_dims[32, 32],
            "flash_d16": by_dims[16, 16],
            "paged": paged_flash_decode.launches,
            "paged_range": paged_flash_decode.range_launches,
            "scan": mamba_scan.launches, "plain_scan": mamba_scan_plain.calls,
            "grouped": grouped_gemm.launches}


def check_counts(label: str, got: dict, want: dict) -> None:
    """``got`` must equal ``want``; a kernel ``want`` does not name must
    not have launched."""
    want = {**dict.fromkeys(got, 0), **want}
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
    log(f"[1/17] environment: python {sys.version.split()[0]}, torch "
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
    log("[2/17] build: nvcc " + " ".join(build.NVCC_FLAGS))
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
    for name in MMA_SYNC_KERNELS:
        if not sass_ops[name]["HMMA"]:
            fail(f"{name}: no HMMA in its SASS; its products must run on "
                 f"the tensor cores (mma.sync)")
    return sass_ops


def phase_kernels(cfg, geom, n_slots, fcfg) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.kernels.paged_attention import (paged_flash_decode,
                                                     paged_flash_decode_plain)
    log(f"[3/17] kernels against their plain versions (attention: bf16, "
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
    check_flash_digests()
    flash_mla = flash_mla_cases(rnd, repeats)
    new_cases = new_attention_cases(repeats)

    # ---- paged decode: B slots walking P pages of pt tokens
    def paged_case(b, p, lens, window=None, tag="", page_tokens=pt):
        n_pages = b * p + 1
        kp = rnd(n_pages, hkv, page_tokens, d)
        vp = rnd(n_pages, hkv, page_tokens, d)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        bt = perm[:b * p].reshape(b, p).to(torch.int32)
        # slots map only the pages their frontier reaches; the rest is null
        mapped = (torch.arange(p, device=dev)[None, :] * page_tokens
                  <= torch.as_tensor(lens, device=dev)[:, None])
        bt = torch.where(mapped, bt, 0).contiguous()
        cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q = rnd(b, hq, 1, d)
        got = paged_flash_decode(q, kp, vp, bt, cl, window=window)
        want = paged_flash_decode_plain(q, kp, vp, bt, cl, window=window)
        torch.cuda.synchronize()
        label = f"paged B={b} P={p} pt={page_tokens} window={window} {tag}"
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
    # 8-token pages, serve_bench's default: a 64-position split walks 8
    # pages. Its chunked head-to-head's shape (8 slots over 514 pages: one
    # 4099-token frontier among short ones) and edges at split boundaries
    # under a window
    e, (q, kp, vp, bt, cl) = paged_case(
        8, BENCH_P_MAX, [4099, 27, 20, 63, 64, 0, 1, 2050], None,
        "(serve_bench chunked shape)", page_tokens=BENCH_PAGE_TOKENS)
    paged_err = max(paged_err, e)
    e8, _ = paged_case(8, 40, [63, 64, 127, 128, 319, 7, 100, 200], 70,
                       "(8-token pages, split edges)",
                       page_tokens=BENCH_PAGE_TOKENS)
    paged_err = max(paged_err, e8)
    lens8 = [int(x) for x in cl.tolist()]
    p8_ms = median_ms(lambda: paged_flash_decode(q, kp, vp, bt, cl), N_TIMED)
    p8_dev = device_ms(lambda: paged_flash_decode(q, kp, vp, bt, cl),
                       "paged_decode_kernel")
    p8_plain = median_ms(
        lambda: paged_flash_decode_plain(q, kp, vp, bt, cl), N_TIMED)
    p8_bound, p8_by = bound_ms(*paged_work(lens8, q, bt, cl))
    log(f"  paged B=8 P={BENCH_P_MAX} pt={BENCH_PAGE_TOKENS} lens={lens8}: "
        f"kernel {p8_ms:.4f} ms (device {p8_dev:.4f} ms), plain "
        f"{p8_plain:.4f} ms, bound {p8_bound:.4f} ms ({p8_by})")
    ranges = paged_range_cases(repeats, n_slots, depth)
    rank_cases = qwen_rank_cases(repeats, depth)
    gemms = [ep_rank_gemm_cases(repeats, arch) for arch in EP_RANK_GEMM]
    ep_gemm = {"err": max(g["err"] for g in gemms),
               "cases": {k: v for g in gemms for k, v in g["cases"].items()},
               "digests": {k: v for g in gemms
                           for k, v in g["digests"].items()}}
    mla_rank = mla_rank_flash_cases(repeats)
    flash_mla["extra"] = {f"rank_{mesh}_{key}": value for mesh, row
                          in mla_rank["cases"].items()
                          for key, value in row.items()}
    flash_mla["extra"]["rank_max_abs_err"] = mla_rank["err"]
    flash_mla["digests"] = mla_rank["digests"]
    new_digests = {**ranges["digests"], **rank_cases["digests"],
                   **ep_gemm["digests"], **mla_rank["digests"]}
    differ = {case: got for case, got in new_digests.items()
              if case in NEW_CASE_DIGESTS and NEW_CASE_DIGESTS[case] != got}
    if differ:
        fail(f"outputs moved from their recorded digests: {differ}")
    log(f"  digests of the range, 1x2 rank, expert-parallel rank and MLA "
        f"rank cases: {new_digests} "
        f"(recorded: {sorted(set(NEW_CASE_DIGESTS) & set(new_digests))})")
    repeat_calls(repeats)
    del q, kp, vp, bt, cl, batch, repeats
    return {
        "flash": dict(err=flash_err, ms=f_ms, device_ms=f_dev,
                      library_device_ms=f_lib_dev, plain_ms=f_plain,
                      library_ms=f_lib, bound_ms=f_bound, bound_by=f_by,
                      extra={f"{label}_{key}": row[key]
                             for label, row in (
                                 *resumed.items(),
                                 ("window", new_cases["flash_window"]))
                             for key in row}),
        "flash_mla": flash_mla,
        "flash_d64": dict(err=new_cases["flash_d64_err"],
                          **new_cases["flash_d64"]["encoder"],
                          extra={f"{kind}_{key}": row[key]
                                 for kind, row in
                                 new_cases["flash_d64"].items()
                                 for key in row},
                          digests=new_cases["digests"]),
        "flash_d32": new_cases["flash_d32"],
        "flash_d16": new_cases["flash_d16"],
        "paged": dict(err=paged_err, ms=p_ms, device_ms=p_dev,
                      plain_ms=p_plain,
                      library_ms=None, bound_ms=p_bound, bound_by=p_by,
                      extra=dict(cuda_kernels_per_call=p_kernels,
                                 long_device_ms=l_dev, long_bound_ms=l_bound,
                                 long_gb_per_s=l_gbps, pt8_ms=p8_ms,
                                 pt8_device_ms=p8_dev, pt8_plain_ms=p8_plain,
                                 pt8_bound_ms=p8_bound,
                                 pt8_bound_by=p8_by,
                                 **{f"window_{key}": value for key, value
                                    in new_cases["paged_window"].items()})),
        "paged_range": dict(err=ranges["err"], **ranges["timing"],
                            digests=ranges["digests"],
                            extra={"rank_1x2_err": rank_cases["err"],
                                   "rank_1x2_digests":
                                       rank_cases["digests"]}),
        "grouped_rank": ep_gemm,
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
    def same(a, b):
        if isinstance(b, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    for _ in range(REPEAT_ROUNDS):
        for label, call, first in repeats:
            if not same(call(), first):
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


def flash_digest_inputs(case: str, seed: int):
    """q, k, v and kwargs of one FLASH_DIGEST_CASES case, from a numpy
    seed (bf16 on the card)."""
    import numpy as np
    import torch
    b, hq, hkv, sq, skv, kw, views = FLASH_DIGEST_CASES[case]
    rng = np.random.RandomState(seed)

    def t(bb, h, seq):
        shape = (bb, seq, h, 128) if views else (bb, h, seq, 128)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16).cuda()
        return x.transpose(1, 2) if views else x

    return t(b, hq, sq), t(b, hkv, skv), t(b, hkv, skv), kw


def check_flash_digests() -> None:
    """Flash at D = Dv = 128 equals, bit for bit, what the kernel printed
    before its (D, Dv) template: FLASH_DIGESTS."""
    import hashlib
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    got = {}
    for i, case in enumerate(FLASH_DIGEST_CASES):
        q, k, v, kw = flash_digest_inputs(case, 100 + i)
        out = flash_attention(q, k, v, **kw)
        got[case] = hashlib.sha256(
            out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
    differ = [case for case in got if got[case] != FLASH_DIGESTS[case]]
    if differ:
        fail(f"flash (128, 128): cases {differ} differ from the kernel "
             f"before the template: {got}")
    log(f"  flash (128, 128): {len(got)} cases bit for bit equal to the "
        f"kernel before its (D, Dv) template (sha256 digests)  ok")


def flash_mla_cases(rnd, repeats) -> dict:
    """Flash at multi-head latent attention's prefill widths (D = nope +
    rope = 192, Dv = 128, 128 heads, deepseek-v2): the one-shot admission
    (4 x 256 over 256, timed beside the plain version and SDPA, which takes
    Dv != D), over the one-shot's 288 positions, a ragged tile at an offset
    and the model's own views (K the concatenation of the decompressed
    nope heads and the shared rope head, V a strided view of the
    decompressed heads). Each case joins the repeat set."""
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cfg = get_config(DEEPSEEK[0])
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vdim, d = cfg.v_head_dim, nope + rope
    scale = d ** -0.5

    def dense(b, sq, skv):
        return rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, vdim)

    def model_views(b, sq, skv):
        kv = rnd(b, skv, h, nope + vdim)
        k_rope = rnd(b, skv, rope)
        k = torch.cat([kv[..., :nope].transpose(1, 2),
                       k_rope[:, None].expand(b, h, skv, rope)], dim=-1)
        return rnd(b, h, sq, d), k, kv[..., nope:].transpose(1, 2)

    err = 0.0
    for b, sq, skv, kw, make in ((4, 256, 256, {}, dense),
                                 (4, 256, 288, {}, model_views),
                                 (1, 37, 300, {"q_offset": 40}, dense),
                                 (2, 300, 333, {"q_offset": 33},
                                  model_views)):
        q, k, v = make(b, sq, skv)
        got = flash_attention(q, k, v, causal=True, scale=scale, **kw)
        want = flash_attention_plain(q, k, v, causal=True, scale=scale, **kw)
        torch.cuda.synchronize()
        label = (f"flash D={d} Dv={vdim} B={b} H={h} Sq={sq} Skv={skv} {kw}"
                 + (" (model views)" if make is model_views else ""))
        err = max(err, compare(label, got, want))
        repeats.append((label, functools.partial(
            flash_attention, q, k, v, causal=True, scale=scale, **kw), got))
    q, k, v = dense(4, 256, 256)

    def kernel():
        return flash_attention(q, k, v, causal=True, scale=scale)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)

    compare("flash D=192: SDPA (Dv != D) vs the plain version", sdpa(),
            flash_attention_plain(q, k, v, causal=True, scale=scale))
    ms = median_ms(kernel, N_TIMED)
    dev_ms = device_ms(kernel, "flash_fwd_kernel")
    plain = median_ms(lambda: flash_attention_plain(q, k, v, causal=True,
                                                    scale=scale), N_TIMED)
    lib = median_ms(sdpa, N_TIMED)
    lib_dev = device_ms(sdpa)
    pairs = 4 * sum(min(i + 1, 256) for i in range(256))
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + 4 * h * 256 * vdim)
    bound, by = bound_ms(n_bytes, 2.0 * (d + vdim) * h * pairs)
    log(f"  flash D={d} Dv={vdim} 4 x 256 over 256, {h} heads: kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain:.4f} ms, sdpa "
        f"{lib:.4f} ms (device {lib_dev:.4f} ms), bound {bound:.4f} ms "
        f"({by}, {n_bytes / 1e6:.1f} MB)")
    return dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
                library_ms=lib, library_device_ms=lib_dev, bound_ms=bound,
                bound_by=by)


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a bf16 or f32 tensor's
    bits."""
    import hashlib
    import torch
    bits = t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def seeded(seed: int):
    """A bf16 tensor maker on the card from a numpy seed (the same bits on
    any torch build, so outputs can be held to recorded digests)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)

    def make(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16).cuda()
    return make


def time_case(label, kernel, plain, library, name, n_bytes, n_ops,
              back_to_back: bool = False) -> dict:
    """A kernel's median time (CUDA events: the host path included) and
    device time (profiler, kernels named ``name``; or with
    ``back_to_back`` N_TIMED calls queued back to back between two events,
    where the profiler drops kernel records of long traces, as phase 8's
    grouped GEMMs lost them in every retake on an NVIDIA H100 80GB HBM3)
    beside its plain version, one library call (or None) and the bound of
    ``n_bytes`` and ``n_ops``."""
    from repro_torch.benchmarks.common import back_to_back_ms, median_ms

    def on_device(fn, kernel_name=""):
        return back_to_back_ms(fn, N_TIMED) if back_to_back else device_ms(
            fn, kernel_name)

    ms = median_ms(kernel, N_TIMED)
    dev = on_device(kernel, name)
    plain_ms = median_ms(plain, N_TIMED)
    lib = median_ms(library, N_TIMED) if library else None
    lib_dev = on_device(library) if library else None
    bound, by = bound_ms(n_bytes, n_ops)
    how = "back to back" if back_to_back else "device"
    lib_txt = (f", library {lib:.4f} ms ({how} {lib_dev:.4f} ms)"
               if library else "")
    log(f"  {label}: kernel {ms:.4f} ms ({how} {dev:.4f} ms), plain "
        f"{plain_ms:.4f} ms{lib_txt}, bound {bound:.4f} ms ({by})")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
                device_ms_by=how)


def new_attention_cases(repeats) -> dict:
    """The attention cases of gemma3's window and seamless' head_dim, each
    held against its plain version, timed beside its bound (and SDPA where
    one call computes the same function), added to the repeat set and
    digested (numpy-seeded inputs; NEW_CASE_DIGESTS holds them bit for bit):
    flash at (64, 64) for seamless-m4t-medium's three kinds of call (the
    encoder's non-causal self-attention, the decoder's causal prefill,
    cross-attention with Sq != Skv down to one query row, on the model's
    ``transpose(1, 2)`` views, 16 heads over 16); flash (128, 128) at
    gemma3's widths over 4096 positions with its 1024 window (SDPA given
    the band as a mask; the bound counts the band only); paged decode at
    frontiers 2048-4095 with the same window (16 KV heads, group 2,
    16-token pages)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_flash_decode,
                                                     paged_flash_decode_plain)
    out, digests = {"flash_d64": {}}, {}
    err_d64 = 0.0
    for i, (kind, (b, sq, skv, causal)) in enumerate(FLASH_D64_CASES.items()):
        make = seeded(300 + i)
        q, k, v = (make(b, n, 16, 64).transpose(1, 2)
                   for n in (sq, skv, skv))
        label = (f"flash D=64 {kind} B={b} H=16 Sq={sq} Skv={skv} "
                 f"causal={causal} (model views)")
        got = flash_attention(q, k, v, causal=causal)
        err_d64 = max(err_d64, compare(label, got, flash_attention_plain(
            q, k, v, causal=causal)))
        call = functools.partial(flash_attention, q, k, v, causal=causal)
        repeats.append((label, call, got))
        digests[f"d64_{kind}"] = digest(got)
        pairs = b * 16 * sum(min(r + 1, skv) if causal else skv
                             for r in range(sq))
        out["flash_d64"][kind] = time_case(
            f"flash D=64 {kind}", call,
            functools.partial(flash_attention_plain, q, k, v, causal=causal),
            functools.partial(F.scaled_dot_product_attention, q, k, v,
                              is_causal=causal),
            "flash_fwd_kernel",
            2 * (2 * q.numel() + k.numel() + v.numel()), 4.0 * 64 * pairs)
    out["flash_d64_err"] = err_d64

    make = seeded(310)
    hq, hkv, d, n = 32, 16, 128, WINDOW_SEQ
    q, k, v = make(1, hq, n, d), make(1, hkv, n, d), make(1, hkv, n, d)
    rows = torch.arange(n, device="cuda")
    band = ((rows[None, :] <= rows[:, None])
            & (rows[None, :] > rows[:, None] - WINDOW))
    label = f"flash window={WINDOW} B=1 Hq={hq} Hkv={hkv} S={n}"
    got = flash_attention(q, k, v, causal=True, window=WINDOW)
    plain = functools.partial(flash_attention_plain, q, k, v, causal=True,
                              window=WINDOW)
    err_w = compare(label, got, plain())
    sdpa = functools.partial(F.scaled_dot_product_attention, q, k, v,
                             attn_mask=band, enable_gqa=True)
    compare("flash window: SDPA with the band mask vs the plain version",
            sdpa(), plain())
    call = functools.partial(flash_attention, q, k, v, causal=True,
                             window=WINDOW)
    repeats.append((label, call, got))
    digests["window"] = digest(got)
    pairs = hq * sum(min(r + 1, WINDOW) for r in range(n))
    out["flash_window"] = dict(err=err_w, **time_case(
        f"flash window={WINDOW} S={n}", call, plain, sdpa,
        "flash_fwd_kernel", 2 * (2 * q.numel() + k.numel() + v.numel()),
        4.0 * d * pairs))
    del q, k, v, band

    make = seeded(320)
    pt, p_max, b = 16, WINDOW_SEQ // 16, len(PAGED_WINDOW_LENS)
    kp, vp = (make(b * p_max + 1, hkv, pt, d) for _ in range(2))
    perm = torch.from_numpy(np.random.RandomState(321).permutation(
        b * p_max) + 1).cuda()
    lens = torch.tensor(PAGED_WINDOW_LENS, dtype=torch.int32, device="cuda")
    mapped = torch.arange(p_max, device="cuda")[None, :] * pt <= lens[:, None]
    bt = torch.where(mapped, perm.reshape(b, p_max), 0).to(
        torch.int32).contiguous()
    qd = make(b, hq, 1, d)
    label = (f"paged window={WINDOW} B={b} Hq={hq} Hkv={hkv} pt={pt} "
             f"lens={PAGED_WINDOW_LENS}")
    got = paged_flash_decode(qd, kp, vp, bt, lens, window=WINDOW)
    plain = functools.partial(paged_flash_decode_plain, qd, kp, vp, bt, lens,
                              window=WINDOW)
    err_p = compare(label, got, plain())
    call = functools.partial(paged_flash_decode, qd, kp, vp, bt, lens,
                             window=WINDOW)
    repeats.append((label, call, got))
    digests["paged_window"] = digest(got)
    visible = sum(min(WINDOW, n + 1) for n in PAGED_WINDOW_LENS)
    out["paged_window"] = dict(err=err_p, **time_case(
        f"paged window={WINDOW} frontiers {PAGED_WINDOW_LENS}", call, plain,
        None, "paged_decode_kernel",
        2 * 2 * visible * hkv * d + 2 * 2 * qd.numel() + 4 * bt.numel()
        + 4 * b, 4.0 * d * hq * visible))
    for i, (case, (b, hq, hkv, n, d)) in enumerate(
            FLASH_NARROW_CASES.items()):
        make = seeded(340 + i)
        q, k, v = (make(b, n, h, d).transpose(1, 2) for h in (hq, hkv, hkv))
        label = (f"flash D={d} {case} B={b} Hq={hq} Hkv={hkv} S={n} causal "
                 f"(model views)")
        got = flash_attention(q, k, v, causal=True)
        plain = functools.partial(flash_attention_plain, q, k, v, causal=True)
        err = compare(label, got, plain())
        call = functools.partial(flash_attention, q, k, v, causal=True)
        repeats.append((label, call, got))
        digests[case] = digest(got)
        pairs = b * hq * sum(r + 1 for r in range(n))
        out[f"flash_d{d}"] = dict(err=err, **time_case(
            f"flash D={d} {case}", call, plain,
            functools.partial(F.scaled_dot_product_attention, q, k, v,
                              is_causal=True, enable_gqa=True),
            "flash_fwd_kernel", 2 * (2 * q.numel() + k.numel() + v.numel()),
            4.0 * d * pairs))
        del q, k, v
    q, k, v = jamba_flash_inputs()
    label = jamba_flash_label(q, k)
    got = flash_attention(q, k, v, causal=True)
    compare(label, got, flash_attention_plain(q, k, v, causal=True))
    repeats.append((label, functools.partial(flash_attention, q, k, v,
                                             causal=True), got))
    digests["jamba_flash"] = digest(got)
    del q, k, v
    differ = {case: got for case, got in digests.items()
              if case in NEW_CASE_DIGESTS and NEW_CASE_DIGESTS[case] != got}
    if differ:
        fail(f"outputs moved from their recorded digests: {differ}")
    log(f"  digests of the windowed, (64, 64), (32, 32) and (16, 16) "
        f"cases: {digests} "
        f"(recorded: {sorted(NEW_CASE_DIGESTS)})")
    out["digests"] = digests
    return out


def paged_range_cases(repeats, n_slots, depth) -> dict:
    """The paged kernel over position ranges with its log-sum-exp, the
    pooled decode's kernel (numpy-seeded inputs, digested): at row 2's
    shape (the main path's slots over 16-token pages, 16 query heads over
    2), row 2a's (8-token pages, serve_bench's chunked shape) and row 2b's
    (gemma3's widths under its 1024 window). Each slot's live positions
    are split into 2 and 4 ranges (``decode_range``), each range walked by
    the kernel (``span=``: a start and a frontier, the window folded into
    the start) and by its plain version, the ranges merged by their
    log-sum-exps (``merge_ranges``) and held against the whole walk and
    the plain version within ATOL; each range's lse within 1e-3 of the
    plain one's (relative); an empty range zero and -inf. Range 0 of 2 at
    row 2 is timed beside its bytes bound; the merged outputs at 2 ranges
    and range 0's call join the repeat set."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import (
        decode_range, merge_ranges, paged_decode_attention,
        paged_flash_decode, paged_flash_decode_plain)
    rng = np.random.RandomState(360)
    rows = {"row2": (16, 16, 2, [int(x) for x in rng.randint(
                256, depth - 1, n_slots)], -(-depth // 16), None),
            "row2a": (BENCH_PAGE_TOKENS, 16, 2,
                      [4099, 27, 20, 63, 64, 0, 1, 2050], BENCH_P_MAX, None),
            "row2b": (16, 32, 16, PAGED_WINDOW_LENS, WINDOW_SEQ // 16,
                      WINDOW)}
    out, digests, err = {}, {}, 0.0
    for i, (row, (pt, hq, hkv, lens, p_max, window)) in enumerate(
            rows.items()):
        make = seeded(370 + i)
        b, d = len(lens), 128
        kp, vp = (make(b * p_max + 1, hkv, pt, d) for _ in range(2))
        perm = torch.from_numpy(np.random.RandomState(380 + i).permutation(
            b * p_max) + 1).cuda()
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        mapped = (torch.arange(p_max, device="cuda")[None, :] * pt
                  <= cl[:, None])
        bt = torch.where(mapped, perm.reshape(b, p_max), 0).to(
            torch.int32).contiguous()
        q = make(b, hq, 1, d)
        whole = paged_flash_decode(q, kp, vp, bt, cl, window=window)
        plain = paged_flash_decode_plain(q, kp, vp, bt, cl, window=window)
        for n in RANGE_SPLITS:
            outs, lses = [], []
            for r in range(n):
                span = decode_range(cl, 1, n, r, batch=b, window=window)
                o, lse = paged_decode_attention(q, kp, vp, bt, cl,
                                                window=window, span=span)
                po, plse = paged_decode_attention(q, kp, vp, bt, cl,
                                                  window=window, span=span,
                                                  impl="ref")
                label = f"paged range {r}/{n} {row} B={b} pt={pt}"
                err = max(err, compare(label, o, po))
                live = torch.isfinite(plse)
                if not torch.equal(live, torch.isfinite(lse)) or not bool(
                        ((lse - plse).abs()[live] <= 1e-3 * plse.abs()[live]
                         .clamp(min=1)).all()) or bool(
                        (o[~live[..., 0]] != 0).any()):
                    fail(f"{label}: lse or empty ranges differ from the "
                         f"plain version")
                outs.append(o)
                lses.append(lse)
                if n == 2 and r == 0:
                    repeats.append((label, functools.partial(
                        paged_decode_attention, q, kp, vp, bt, cl,
                        window=window, span=span), (o, lse)))
            merged = merge_ranges(outs, lses)
            label = f"paged {n} ranges merged {row}"
            err = max(err, compare(f"{label} vs the whole walk", merged,
                                   whole))
            err = max(err, compare(f"{label} vs the plain version", merged,
                                   plain))
            if n == 2:
                digests[f"range_{row}"] = digest(merged)
        if row == "row2":
            start, end = decode_range(cl, 1, 2, 0, batch=b)
            front = (torch.minimum(end, cl + 1) - 1).contiguous()
            call = functools.partial(paged_flash_decode, q, kp, vp, bt, front,
                                     start=start, return_lse=True)
            visible = int(torch.clamp(front + 1 - start, min=0).sum())
            out["timing"] = time_case(
                f"paged range 0/2 {row} ({visible} of {sum(lens) + b} "
                f"positions) with its lse", call,
                functools.partial(paged_flash_decode_plain, q, kp, vp, bt,
                                  front, start=start, return_lse=True),
                None, "paged_decode_kernel",
                2 * 2 * visible * hkv * d + 2 * 2 * q.numel()
                + 4 * b * hq + 4 * (bt.numel() + 2 * b),
                4.0 * d * hq * visible)
        del q, kp, vp, bt
    out["err"], out["digests"] = err, digests
    return out


def qwen_rank_cases(repeats, depth) -> dict:
    """qwen2.5-3b's per-rank shapes at a 1x2 mesh (the head path: 8 query
    heads over 1 KV head a rank): flash at the one-shot's 4 x 256
    admission on the model's views and paged decode over the main path's
    16-token pages, each held against its plain version, added to the
    repeat set and digested (numpy-seeded inputs)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_flash_decode,
                                                     paged_flash_decode_plain)
    make, digests = seeded(390), {}
    q, k, v = (make(4, 256, h, 128).transpose(1, 2) for h in (8, 1, 1))
    got = flash_attention(q, k, v, causal=True)
    err = compare("flash 1x2 rank: B=4 Hq=8 Hkv=1 S=256 causal (model views)",
                  got, flash_attention_plain(q, k, v, causal=True))
    repeats.append(("flash 1x2 rank", functools.partial(
        flash_attention, q, k, v, causal=True), got))
    digests["qwen_1x2_flash"] = digest(got)
    pt, p_max = 16, -(-depth // 16)
    lens = [int(x) for x in np.random.RandomState(391).randint(
        256, depth - 1, 4)]
    kp, vp = (make(4 * p_max + 1, 1, pt, 128) for _ in range(2))
    bt = torch.from_numpy(np.random.RandomState(392).permutation(
        4 * p_max) + 1).reshape(4, p_max).to(torch.int32).cuda()
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qd = make(4, 8, 1, 128)
    got = paged_flash_decode(qd, kp, vp, bt, cl)
    err = max(err, compare(f"paged 1x2 rank: B=4 Hq=8 Hkv=1 lens={lens}",
                           got, paged_flash_decode_plain(qd, kp, vp, bt,
                                                         cl)))
    repeats.append(("paged 1x2 rank", functools.partial(
        paged_flash_decode, qd, kp, vp, bt, cl), got))
    digests["qwen_1x2_paged"] = digest(got)
    return {"err": err, "digests": digests}


def ep_rank_routes(t: int, e: int, k: int, m: int, cf: float, seed: int):
    """Rank 0 of a ``1xm`` expert-parallel MoE over ``t`` tokens of ``e``
    experts, top-``k``: numpy-seeded routes (``k`` distinct experts a
    token), cut as the reference cuts them (its local experts first by a
    stable sort, then ``cap`` rows). Returns (cap, the offsets of its ``e /
    m`` experts, the rows they hold): the rows past the last offset are
    other ranks' hits, which the kernel must leave alone."""
    import math
    import numpy as np
    rng = np.random.RandomState(seed)
    idx = np.argsort(rng.rand(t, e), axis=1)[:, :k].reshape(-1)
    e_loc = e // m
    loc_e = np.where(idx < e_loc, idx, e_loc)
    cap = min(t * k, int(math.ceil(cf * t * k / m)))
    sel_e = loc_e[np.argsort(loc_e, kind="stable")][:cap]
    offs = np.searchsorted(sel_e, np.arange(e_loc), side="right")
    return cap, offs.astype(np.int32), int(offs[-1])


def ep_rank_gemm_cases(repeats, arch: str) -> dict:
    """``grouped_gemm`` at ``arch``'s expert-parallel rank shapes on a 1 x 2
    and a 1 x 4 mesh (rank 0: half and a quarter of the experts;
    qwen3-moe-30b-a3b 64 / 32 at K 2048, N 768; deepseek-v2-236b 80 / 40
    at K 5120, N 1536), a one-shot admission (T 1024) and a decode step (T
    4) through the gate and down projections: ``cap`` rows of which only
    the rank's own hits lie inside the offsets (``ep_rank_routes``). The
    computed rows are held to the plain version within GEMM_REL_TOL, added
    to the repeat set and digested (numpy-seeded inputs, EP_RANK_GEMM:
    ``<prefix>_1x{2,4}_*``); timed by events a call, back to back and by
    CUDA-graph replay (the device's time alone) beside ``F.grouped_mm``
    (bf16 out) and the bound of the hit experts' weights, the computed
    rows and their f32 output (the kernel reads and writes none of the
    rows past the last offset)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.common import graph_ms
    from repro_torch.benchmarks.grouped_gemm_ab import case_work
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_gemm import (grouped_gemm,
                                                  grouped_gemm_plain,
                                                  launch_config)
    cfg = get_config(arch)
    prefix, seed, drawn = EP_RANK_GEMM[arch]
    rng = np.random.default_rng(seed)

    def make(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(torch.bfloat16).cuda()

    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def experts(k, n):
        w = make(drawn or e // 2, k, n) * k ** -0.5
        return w.repeat(e // 2 // w.shape[0], 1, 1) if drawn else w

    # rank 0's experts: 0..e/2-1 on 1 x 2, the first half of those on 1 x 4
    weights = {"gate": experts(d, f), "down": experts(f, d)}
    out, digests, err = {}, {}, 0.0
    for m in EP_RANK_MESHES:
        for label, t in MOE_TOKENS.items():
            cap, offs_np, rows = ep_rank_routes(t, e, cfg.top_k, m,
                                                cfg.capacity_factor,
                                                seed + 1 + m + t)
            offs = torch.from_numpy(offs_np).cuda()
            for proj, w in weights.items():
                w = w[:e // m]
                xs = make(cap, w.shape[1])
                got = grouped_gemm(xs, w, offs)[:rows]
                want = grouped_gemm_plain(xs, w, offs)[:rows]
                rel = ((got - want).abs().max() / want.abs().max()).item()
                conf = launch_config(cap, w.shape[1], w.shape[2], w.shape[0])
                name = (f"grouped_gemm {prefix} 1x{m} rank 0 {label} {proj} "
                        f"({rows} of {cap} rows its own, {w.shape[0]} "
                        f"experts, K={w.shape[1]}, N={w.shape[2]}; "
                        f"{conf.bm} x {conf.bn} tiles)")
                if not (bool(torch.isfinite(got).all())
                        and rel <= GEMM_REL_TOL):
                    fail(f"{name}: {rel:.2e} of the largest value "
                         f"(tolerance {GEMM_REL_TOL})")
                log(f"  {name}: {rel:.2e} of the largest  ok")
                err = max(err, rel)
                key = f"{prefix}_1x{m}_{label}_{proj}"
                kernel = functools.partial(grouped_gemm, xs, w, offs)
                repeats.append((key, lambda kernel=kernel, rows=rows:
                                kernel()[:rows], got))
                digests[key] = digest(got)
                timing = time_case(
                    name, kernel,
                    functools.partial(grouped_gemm_plain, xs, w, offs),
                    functools.partial(F.grouped_mm, xs, w, offs=offs),
                    "grouped_gemm_kernel", *case_work(xs[:rows], w, offs),
                    back_to_back=True)
                timing.update(graph_ms=graph_ms(kernel, N_TIMED), rows=rows,
                              cap=cap, rel_err=rel)
                out[key] = timing
    del weights
    return {"err": err, "cases": out, "digests": digests}


def mla_rank_flash_cases(repeats) -> dict:
    """Flash at (192, 128) over deepseek-v2-236b's heads a rank of a 1 x 2
    (64) and a 1 x 4 mesh (32): its one-shot admission (4 x 256, causal)
    on the model's views (q and K the concatenations ``mla_attention``
    makes, V a strided view of the decompressed heads), numpy-seeded; held
    to the plain version, timed beside SDPA and the bound, added to the
    repeat set and digested (``deepseek_1x{2,4}_flash``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cfg = get_config(DEEPSEEK[0])
    nope, rope, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    d, scale = nope + rope, (nope + rope) ** -0.5
    b, n = MLA_ADMISSION
    out, digests, err = {}, {}, 0.0
    for m in EP_RANK_MESHES:
        h = cfg.n_heads // m
        make = seeded(400 + m)
        q = make(b, h, n, d)
        kv, k_rope = make(b, n, h, nope + vdim), make(b, n, rope)
        k = torch.cat([kv[..., :nope].transpose(1, 2),
                       k_rope[:, None].expand(b, h, n, rope)], dim=-1)
        v = kv[..., nope:].transpose(1, 2)
        kernel = functools.partial(flash_attention, q, k, v, causal=True,
                                   scale=scale)
        plain = functools.partial(flash_attention_plain, q, k, v,
                                  causal=True, scale=scale)
        got = kernel()
        label = (f"flash D={d} Dv={vdim} 1x{m} rank: B={b} H={h} S={n} "
                 f"causal (model views)")
        err = max(err, compare(label, got, plain()))
        repeats.append((label, kernel, got))
        digests[f"deepseek_1x{m}_flash"] = digest(got)
        pairs = b * sum(min(i + 1, n) for i in range(n))
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + b * h * n * vdim)
        out[f"1x{m}"] = time_case(
            label, kernel, plain,
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   scale=scale),
            "flash_fwd_kernel", n_bytes, 2.0 * (d + vdim) * h * pairs)
    return {"err": err, "cases": out, "digests": digests}


def jamba_flash_inputs():
    """q, k, v of jamba's one-shot admission at its widths (JAMBA_ADMISSION,
    64 query heads over 8 at D = 128), numpy-seeded, on the model's
    ``transpose(1, 2)`` views."""
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA)
    b, n = JAMBA_ADMISSION
    make = seeded(330)
    return tuple(make(b, n, h, cfg.head_dim).transpose(1, 2)
                 for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))


def jamba_flash_label(q, k) -> str:
    b, hq, n, _ = q.shape
    return (f"flash jamba B={b} Hq={hq} Hkv={k.shape[1]} S={n} causal "
            f"(model views)")


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


def scan_inputs(gen, di, ds, b, length, dtype) -> tuple:
    """x, dt, A, B, C, D of a selective scan on the card, drawn from
    ``gen`` as the model gives them: x, B, C in ``dtype``, dt f32 in the
    model's [1e-3, 1e-1], A = -(1..Ds) per channel (S4D-real), D = 1."""
    import math
    import torch
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    x = torch.randn((b, length, di), generator=gen, device=dev)
    u = torch.rand((b, length, di), generator=gen, device=dev)
    bc = torch.randn((2, b, length, ds), generator=gen, device=dev)
    a = -torch.arange(1, ds + 1, dtype=torch.float32,
                      device=dev).expand(di, ds).contiguous()
    return (x.to(dtype), torch.exp(lo + u * (hi - lo)), a, bc[0].to(dtype),
            bc[1].to(dtype), torch.ones((di,), device=dev))


def scan_state(gen, di, ds, b, random):
    """A zero initial state, or a random one drawn from ``gen``."""
    import torch
    if not random:
        return torch.zeros((b, di, ds), device=gen.device)
    return torch.randn((b, di, ds), generator=gen, device=gen.device)


def scan(args, h0, **kw):
    """``ops.selective_scan`` from ``h0``, returning the state with one."""
    from repro_torch.kernels import ops
    return ops.selective_scan(*args, h0=h0, return_state=h0 is not None,
                              **kw)


def phase_scan_kernel(fcfg) -> dict:
    """mamba_scan against its plain version at falcon-mamba-7b's shapes,
    through ``ops.selective_scan`` under the h100 target's plans, on
    :func:`scan_inputs` (bf16; f32 in the f32 cases). The prefill case (L
    = 512 from a zero state) is timed and its error is the ``kernels``
    row's."""
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
    inputs = functools.partial(scan_inputs, gen, di, ds)
    state = functools.partial(scan_state, gen, di, ds)

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


def teacher_forced_check(cfg, seed_params, prompt, tokens, label,
                         **inputs) -> float:
    """``repro_torch.serve.checks.teacher_forced_check`` (greedy ``tokens``
    after ``prompt`` each within LOGIT_TOL of the best logit of one
    full-sequence forward, no caches; ``inputs``: a frontend model's
    ``frontend_embeds`` or an enc-dec model's ``src_embeds`` for the
    row), logged; returns the worst gap."""
    from repro_torch.serve import checks
    gap = checks.teacher_forced_check(cfg, seed_params, prompt, tokens, label,
                                      LOGIT_TOL, **inputs)
    log(f"  {label}: {len(tokens)} tokens, worst gap to the teacher-forced "
        f"best logit {gap:.4f}")
    return gap


def served_batch_check(model, params, prompts, tokens, rows, label, *,
                       depth=None, page_tokens=0) -> float:
    """Greedy ``tokens`` (b, T) after ``prompts`` (b, L) must each be
    within LOGIT_TOL of the best logit of a teacher-forced pass through
    ``model.prefill`` and ``model.decode_step`` at the served batch: the b
    prompts prefill together at ``depth`` (default L + T), as the server
    prefilled them, each row is repeated up to ``rows`` (the server's
    decode batch) and every step feeds the served tokens. With
    ``page_tokens`` the steps decode over a paged pool, as a served stream
    does: each of the ``rows`` slots holds its prompt's row cut into its
    own pages at the pool's page-aligned ``depth``, with per-slot
    frontiers. A row is checked up to its first EOS (after it the server
    fills EOS). Returns the worst gap."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import EngineConfig
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                              device="cuda")
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device="cuda")
    (b, length), n, vocab = prompts.shape, tokens.shape[1], model.cfg.vocab_size
    k = rows // b
    depth = depth or length + n

    def take(tree, i):
        if isinstance(tree, dict):
            return {name: take(leaf, i) for name, leaf in tree.items()}
        return tree[:, i:i + 1]

    def widen(tree):
        if isinstance(tree, dict):
            return {name: widen(leaf) for name, leaf in tree.items()}
        return tree.repeat_interleave(k, dim=1)

    logits, state = model.prefill(params, {"tokens": prompts}, depth)
    logits = logits.repeat_interleave(k, dim=0)
    tables = None
    if page_tokens:
        p_max = depth // page_tokens
        tables = (torch.arange(rows * p_max, dtype=torch.int32,
                               device="cuda") + 1).reshape(rows, p_max)
        pool = {"caches": transformer.init_paged_caches(
            model.cfg, rows, rows * p_max + 1, page_tokens, "cuda")}
        for slot in range(rows):
            model.slot_update_paged(pool, {"caches": take(
                state["caches"], slot // k)}, slot, tables[slot], page_tokens)
        state = pool
    else:
        state = {"caches": widen(state["caches"])}
    steps = torch.repeat_interleave(tokens, k, dim=0).to(torch.int32)
    gaps = []
    for t in range(n):
        lg = logits[::k, -1, :vocab]
        gaps.append(lg.max(dim=1).values - lg.gather(1, tokens[:, t:t + 1])[:, 0])
        if t + 1 < n:
            cache_len = (torch.full((rows,), length + t, dtype=torch.int32,
                                    device="cuda") if page_tokens
                         else torch.tensor(length + t, dtype=torch.int32,
                                           device="cuda"))
            logits, state = model.decode_step(
                params, steps[:, t:t + 1], state, cache_len,
                block_tables=tables)
    is_eos = (tokens == EngineConfig.eos_token).int()
    after_eos = (is_eos.cumsum(1) - is_eos) > 0
    gap = torch.stack(gaps, 1).masked_fill(after_eos, 0).max().item()
    pool_kind = (f"paged ({page_tokens}-token pages)" if page_tokens
                 else "dense")
    log(f"  {label}: {b} x {n} tokens, prefill batch {b} at depth {depth}, "
        f"decode batch {rows} over the {pool_kind} pool; worst gap to the "
        f"teacher-forced best logit {gap:.4f}")
    if not gap <= LOGIT_TOL:
        fail(f"{label}: a greedy token is {gap:.4f} below the teacher-forced "
             f"best logit (tolerance {LOGIT_TOL})")
    return gap


def reference_params(cfg):
    """The launcher's weights (seed 0): the serving copy, built leaf by
    leaf."""
    import torch
    from repro_torch.models.api import build_model
    return build_model(cfg).init_serving(
        torch.Generator(device="cuda").manual_seed(0))


def one_shot_prompts(cfg, rows=4, length=256):
    """The launcher's one-shot prompts (``ONE_SHOT_ARGS``: (4, 256))."""
    import numpy as np
    return np.random.RandomState(1).randint(2, cfg.vocab_size,
                                            size=(rows, length))


def _arg(argv, flag) -> int:
    return int(argv[argv.index(flag) + 1])


def one_shot(cfg, argv, label) -> dict:
    """One-shot generate through the CLI; the prefill launches flash once
    per attention layer, the prefill and every decode step launch
    mamba_scan once per mamba layer and grouped_gemm 3 times per MoE
    layer."""
    from repro_torch.launch import serve as cli
    n_attn, n_ssm, n_gqa = layer_counts(cfg)
    reset_counts()
    rec = cli.run(argv, cfg=cfg)
    counts = read_counts()
    toks = rec["tokens"].numpy()
    if (toks.shape != (_arg(argv, "--batch"), _arg(argv, "--gen-len"))
            or toks.min() < 0 or toks.max() >= cfg.vocab_size):
        fail(f"{label}: tokens shape {toks.shape}, range "
             f"[{toks.min()}, {toks.max()}]")
    forwards = 1 + rec["decode_steps"]
    check_counts(label, counts, {
        "flash": n_gqa, "flash_d192": n_attn - n_gqa, "paged": 0,
        "plain_scan": 0, "scan": n_ssm * forwards,
        "grouped": 3 * moe_layers(cfg) * forwards})
    rec["launches"] = counts
    log(f"  {label}: tok/s {rec['tok_per_s']:.1f}, host_syncs "
        f"{rec['host_syncs']}, {rec['decode_steps']} decode steps; launches "
        f"{counts}")
    return rec


def phase_one_shot(cfg) -> None:
    log("[4/17] one-shot generate: " + " ".join(ONE_SHOT))
    rec = one_shot(cfg, ONE_SHOT, "one-shot")
    teacher_forced_check(cfg, reference_params(cfg), one_shot_prompts(cfg)[0],
                         rec["tokens"].numpy()[0], "one-shot row 0")


def run_stream(cfg, argv, label) -> dict:
    """A stream through the CLI, its launches counted around it: each
    whole-prompt or suffix admission and each prefill chunk launches flash
    once per attention layer; each forward (admission, chunk, decode step
    or verify) launches grouped_gemm 3 times per MoE layer; each decode
    step launches the paged kernel
    once per attention layer on an fp16 paged pool (a verify forward k + 1
    times: once per query column) and no kernel on the
    dense slot slab or a quantized pool (the reference's dispatch: both
    decode through the masked oracle); admissions and decode steps launch
    mamba_scan once per mamba layer. Prints the stream's time."""
    from repro_torch.launch import serve as cli
    log(f"  {label}: " + " ".join(argv))
    t0 = time.perf_counter()
    reset_counts()
    rec = cli.run(argv, cfg=cfg)
    counts = read_counts()
    log(f"  {label}: {time.perf_counter() - t0:.1f} s, build and weights "
        f"included")
    return check_stream(cfg, rec, counts, label)


def check_stream(cfg, rec, counts, label) -> dict:
    """A stream's completions, host syncs and launches (see run_stream)."""
    n_attn, n_ssm, n_gqa = layer_counts(cfg)
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
    # a speculative stream's verify forward walks pages once per query
    # column (k + 1 a layer); a quantized pool's pages are not bf16: gather
    # + oracle, never the paged kernel
    columns = 1 + (rec.get("speculate_tokens") or 0)
    paged_steps = rec["paged"] and rec.get("layer0_codec") == "fp16"
    check_counts(label, counts, {
        "flash": (adm + chunks) * n_gqa,
        "flash_d192": (adm + chunks) * (n_attn - n_gqa),
        "paged": steps * columns * n_gqa if paged_steps else 0,
        "scan": (adm + steps) * n_ssm, "plain_scan": 0,
        "grouped": 3 * moe_layers(cfg) * (adm + chunks + steps)})
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
    differ += [f"launches[{k}]" for k in combined["launches"]
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
    log("[5/17] qwen2.5-3b streams (every decode and verify chunk under "
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


def _bench_row(label: str, r: dict) -> None:
    """One head-to-head run's wall-clock and step-clock latency, syncs and
    pool counters; fails unless its host syncs are at most one a
    boundary (one a role a boundary when disaggregated)."""
    by_role = r.get("host_syncs_by_role")
    syncs_ok = (all(n <= r["boundaries"] for n in by_role.values())
                if by_role else r["host_syncs"] <= r["boundaries"])
    if not syncs_ok:
        fail(f"serve_bench {label}: host syncs {by_role or r['host_syncs']} "
             f"over {r['boundaries']} boundaries")
    steps = ("-" if r.get("ttft_steps_p50") is None else
             f"{r['ttft_steps_p50']:.0f}/{r['ttft_steps_p95']:.0f}")
    emit = ("-" if r.get("ttft_emit_p50") is None else
            f"{r['ttft_emit_p50']:.0f}/{r['ttft_emit_p95']:.0f}")
    log(f"  {label}: {r['tok_per_s']:.1f} tok/s; inter-token p50/p95/p99 "
        f"{r['intertoken_p50_ms']:.2f}/{r['intertoken_p95_ms']:.2f}/"
        f"{r['intertoken_p99_ms']:.2f} ms; TTFT wall p50/p95/p99 "
        f"{r['ttft_wall_p50_ms']:.1f}/{r['ttft_wall_p95_ms']:.1f}/"
        f"{r['ttft_wall_p99_ms']:.1f} ms, steps {steps}, at emission {emit}; "
        f"host syncs {by_role or r['host_syncs']} over {r['boundaries']} "
        f"boundaries; {r.get('preemptions', 0)} preemptions, "
        f"{r.get('spilled_pages', 0)} pages spilled")


def phase_serve_bench(cfg) -> dict:
    """``repro_torch.benchmarks.serve_bench``'s five head-to-heads on
    qwen2.5-3b at full width, under the bench's default target on the card
    (h100), BENCH_REQUESTS requests, each run once (no warm-up pass,
    repeats 1): sharing off vs on, the chunked-prefill stall with the
    reference's 4096-token prompt, speculation off vs on, combined vs
    disaggregated roles, fp16 vs int8 pages with host parking. Every
    request drains; host syncs at most one a boundary (a role a boundary
    when disaggregated); the outputs gates pass (exact for the roles, the
    teacher-forced rule for sharing, chunking and speculation); launches
    counted around the phase."""
    from repro_torch.benchmarks import serve_bench as sb
    from repro_torch.benchmarks.common import ARTIFACT_ROOT
    log(f"[6/17] serve_bench head-to-heads: qwen2.5-3b --full, "
        f"{BENCH_REQUESTS} requests, each run once")
    t0 = time.perf_counter()
    common = dict(arch="qwen2.5-3b", n_requests=BENCH_REQUESTS, full=True,
                  warmup=False)
    runs = [
        ("share", "serve_bench.json",
         ("static", "continuous", "paged", "prefix_share"),
         lambda: sb.run(paged=True, prefix_share=True, **common)),
        ("chunked", "serve_chunked_bench.json", None,
         lambda: sb.run_chunked(repeats=1, **common)),
        ("speculate", "serve_speculate.json", ("baseline", "speculate"),
         lambda: sb.run_speculate(**common)),
        ("disagg", "serve_disagg_bench.json", ("combined", "disaggregated"),
         lambda: sb.run_disagg(**common)),
        ("quant", "serve_quant_bench.json", ("base", "quant"),
         lambda: sb.run_quant(kv_quant="int8", park_idle=BENCH_PARK_IDLE,
                              **common)),
    ]
    reset_counts()
    gates, failed = {}, []
    for name, artifact, keys, fn in runs:
        t = time.perf_counter()
        path = os.path.join(ARTIFACT_ROOT, artifact)
        if os.path.exists(path):
            os.remove(path)
        try:
            for line in fn().splitlines():
                log(f"    {line}")
        except SystemExit as e:
            # a failed outputs gate; the speculative head-to-head saves its
            # artifact first, the others raise before they save one
            failed.append(f"{name}: {e}")
            log(f"  {name}: FAILED: {e}")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            art = json.load(f)
        recs = art["runs"] if keys is None else {k: art[k] for k in keys}
        for label, r in recs.items():
            # the chunked runs but the baseline add the long prompt
            n = art["n_requests"] + (name == "chunked"
                                     and label != "baseline")
            if r["completed"] != n:
                fail(f"serve_bench {name} {label}: {r['completed']}/{n} "
                     f"requests drained")
            _bench_row(f"{name} {label}", r)
        gate = (art.get("share_gate") or art.get("chunk_gate")
                or art.get("speculate_gate") or art.get("disagg_gate"))
        if gate:
            gates[name] = gate
            log(f"  {name} gate: {gate['rule']}; {gate['parted']} requests "
                f"parted, worst gap {gate['worst_gap']:.4f}"
                + ("" if gate["passed"] else "  FAILED"))
        log(f"  {name}: {time.perf_counter() - t:.1f} s")
        check_merge_counters(f"serve_bench {name}")
        free_memory()
    counts = read_counts()
    if not (counts["flash"] > 0 and counts["paged"] > 0
            and counts["plain_scan"] == 0):
        fail(f"serve_bench: launches {counts}")
    log(f"  serve_bench: launches {counts}; the phase took "
        f"{time.perf_counter() - t0:.1f} s"
        + (f"; FAILED gates (fatal after phase 14): {failed}" if failed
           else ""))
    return {"launches": counts, "gates": gates, "failed": failed,
            "seconds": time.perf_counter() - t0}


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
    log("[7/17] falcon-mamba-7b at full width: " + " ".join(FALCON)
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
        params = model.init_serving(
            torch.Generator(device="cuda").manual_seed(0))
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


def check_grouped_moe(cfg) -> dict:
    """The grouped MoE (the card's, bf16 experts) against the plain one
    (f32 experts, every expert on every token) at one full-width layer,
    random weights: T = 1024 (a one-shot admission's prefill) and T = 4 (a
    decode step over the 4 slots). The grouped call runs under
    ``set_sync_debug_mode("error")`` (it reads nothing to the host) and
    must agree within MOE_TOL, with the same aux loss. For an
    expert-parallel decoder (qwen3-moe) the expert-parallel layer at world
    1 then (``check_ep_layer``), and each rank's share of it on 1 x 2 and
    1 x 4 meshes (``check_ep_ranks``), and for MLA each rank's share of
    one attention layer (``check_mla_ranks``). Returns {label: (max |d|,
    grouped ms, plain ms)}, the grouped_gemm cases, ``ep_world1``,
    ``ep_ranks`` and ``mla_ranks``."""
    import torch
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = {k: (v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()})
         for k, v in moe.init_moe(cfg, gen).items()}
    served = {k: (v.to(torch.bfloat16) if k.startswith("we_") else v)
              for k, v in p.items()}
    out = {}
    for label, t in MOE_TOKENS.items():
        x = torch.randn((1, t, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)

        def grouped():
            return moe.moe_block(served, x, cfg=cfg, impl="grouped")

        def plain():
            return moe.moe_block(p, x, cfg=cfg, impl="dense")

        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, aux = grouped()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        want, aux_want = plain()
        err = compare(f"grouped MoE {label} T={t} (no host read) vs the "
                      f"plain version", got, want, MOE_TOL)
        if not torch.allclose(aux, aux_want, rtol=1e-5):
            fail(f"grouped MoE {label}: aux {aux.item()} against the plain "
                 f"version's {aux_want.item()}")
        out[label] = (err, median_ms(grouped, 5), median_ms(plain, 3))
        log(f"  grouped MoE {label} T={t}: {out[label][1]:.3f} ms, plain "
            f"{out[label][2]:.3f} ms (host clock, events)")
        out.update(grouped_gemm_cases(cfg, served, x, label))
    if tp.ep_moe_decoder(cfg):
        out["ep_world1"] = check_ep_layer(cfg, served, gen)
        out["ep_ranks"] = check_ep_ranks(cfg, served, gen)
    del p, served
    free_memory()
    if cfg.use_mla:
        out["mla_ranks"] = check_mla_ranks(cfg, gen)
    return out


def check_ep_layer(cfg, served, gen) -> dict:
    """The expert-parallel MoE (``moe_block(impl="ep")``) on NCCL world 1
    (a ``1x1`` serving mesh in a one-rank process group of its own: every
    hit local, ``cap = t k``, the sum over ``model`` one rank's) held bit
    for bit to the grouped one at one full-width layer, output and aux
    (shared experts included, deepseek-v2's through ``layers.mlp``'s
    row-parallel sum over one rank), at EP_LAYER_TOKENS, each call taking
    the body the reference's byte rule picks (``moe.ep_body``; logged and
    checked), under ``set_sync_debug_mode("error")``. Returns {T:
    body}."""
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    dev = torch.device("cuda")
    out = {}
    with mesh_lib.ranks(1, dev):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), dev)
        for t in EP_LAYER_TOKENS:
            want_body = moe.ep_body(cfg, 1, t, 1)
            x = torch.randn((1, t, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            with tp.use_mesh(mesh), moe.count_ep(drops=False) as count:
                torch.cuda.synchronize()
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got, aux = moe.moe_block(served, x, cfg=cfg, impl="ep")
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
            want, aux_want = moe.moe_block(served, x, cfg=cfg,
                                           impl="grouped")
            body = dict(count.bodies)
            if body != {want_body: 1}:
                fail(f"expert-parallel MoE T={t}: took {body}, the "
                     f"reference's rule picks {want_body}")
            if not (torch.equal(got, want) and torch.equal(aux, aux_want)):
                fail(f"expert-parallel MoE T={t} on NCCL world 1: max |d| "
                     f"{(got.float() - want.float()).abs().max().item():.3e} "
                     f"from the grouped MoE (must be bit for bit)")
            log(f"  expert-parallel MoE T={t} on NCCL world 1 ({want_body} "
                f"body): output and aux bit for bit the grouped MoE's  ok")
            out[t] = want_body
    return out


def check_ep_ranks(cfg, served, gen) -> dict:
    """Every rank's share of the expert-parallel MoE (``moe._ep_partial``,
    f32, before the sum over ``model``) on 1 x 2 and 1 x 4 meshes, on one
    card in one process, at one full-width layer and T in MOE_TOKENS: its
    experts a slice of ``served``, every token routed, its own hits first,
    cut at ``cap``, the rows past the last offset (other ranks' hits)
    dropped by ``torch.where``. Each rank's kept hits equal a numpy copy
    of the reference's stable sort and cut. The shares, recomputed with
    those rows filled with NaN, are finite and the same bits. Their sum
    over the ranks is held to the grouped layer's f32 output within
    EP_RANK_TOL of its largest value: at 1 x 2 on every token (nothing is
    dropped), at 1 x 4 on the tokens that lost no hit (the dropped hits and
    their tokens logged). Returns {"1xM T": record}."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    e, k = cfg.n_experts, cfg.top_k
    grouped = moe._grouped

    def poisoned(xs, w, offs):
        out = grouped(xs, w, offs)
        tail = torch.arange(out.shape[0], device=out.device)[:, None]
        return out.masked_fill(tail >= offs[-1], float("nan"))

    out = {}
    for t in MOE_TOKENS.values():
        xt = torch.randn((t, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
        want, _ = moe._ep_partial(served, xt, cfg, 0, 1)
        scale = want.abs().max().item()
        for m in EP_RANK_MESHES:
            e_loc = e // m
            total = torch.zeros_like(want)
            lost = np.zeros(t, bool)
            dropped = garbage = 0
            for r in range(m):
                p = {n: (v[r * e_loc:(r + 1) * e_loc] if n.startswith("we_")
                         else v) for n, v in served.items()}
                y, _ = moe._ep_partial(p, xt, cfg, r, m)
                moe._grouped = poisoned
                try:
                    y_nan, _ = moe._ep_partial(p, xt, cfg, r, m)
                finally:
                    moe._grouped = grouped
                if not (bool(torch.isfinite(y_nan).all())
                        and torch.equal(y_nan, y)):
                    fail(f"expert-parallel MoE 1x{m} rank {r} T={t}: NaN in "
                         f"the rows past the last offset reached the share")
                route = moe.ep_route(p["router"], xt, cfg, r, m)
                sel = route.sel.cpu().numpy()
                sel_e = route.sel_e.cpu().numpy()
                flat = route.idx.reshape(-1).cpu().numpy()
                local = (flat >= r * e_loc) & (flat < (r + 1) * e_loc)
                loc_e = np.where(local, flat - r * e_loc, e_loc)
                cap = min(t * k, int(np.ceil(cfg.capacity_factor * t * k
                                             / m)))
                want_sel = np.argsort(loc_e, kind="stable")[:cap]
                kept = sel[sel_e < e_loc]
                if not np.array_equal(kept, want_sel[loc_e[want_sel]
                                                     < e_loc]):
                    fail(f"expert-parallel MoE 1x{m} rank {r} T={t}: the "
                         f"kept hits differ from the reference's cut")
                drop = local.copy()
                drop[kept] = False
                lost |= drop.reshape(t, k).any(1)
                dropped += int(drop.sum())
                garbage += int((sel_e >= e_loc).sum())
                total += y
            keep = torch.from_numpy(~lost).cuda()
            err = ((total - want).abs().amax(1)[keep].max().item()
                   if bool(keep.any()) else 0.0) / scale
            label = f"1x{m} T={t}"
            if m == 2 and dropped:
                fail(f"expert-parallel MoE {label}: {dropped} hits dropped "
                     f"at a capacity factor of {cfg.capacity_factor}")
            if not err <= EP_RANK_TOL:
                fail(f"expert-parallel MoE {label}: the ranks' shares sum "
                     f"{err:.3e} of the largest from the grouped layer "
                     f"(tolerance {EP_RANK_TOL})")
            log(f"  expert-parallel MoE {label}: {m} ranks' shares (kept "
                f"hits the reference's; {garbage} rows past the offsets, "
                f"NaN-filled, never reach a share) sum to the grouped layer "
                f"within {err:.2e} of its largest on {int(keep.sum())} of "
                f"{t} tokens; {dropped} hits dropped on {int(lost.sum())} "
                f"tokens  ok")
            out[label] = dict(rel_err=err, dropped=dropped,
                              tokens_with_drops=int(lost.sum()),
                              rows_past_offsets=garbage)
            if "shared" in served:
                out[label]["shared_rel_err"] = check_shared_ranks(
                    cfg, served["shared"], xt, m, label)
    return out


class RankView:
    """Rank ``r`` of a ``1 x m`` serving mesh on one card: the axis sizes
    and the coordinate that ``sharding`` and ``tensor_parallel`` read
    (no process group behind it: see :func:`as_rank`)."""

    def __init__(self, m: int, r: int):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": m}
        self.r = r

    def coordinate(self, name: str) -> int:
        return self.r if name == "model" else 0


@contextlib.contextmanager
def as_rank(m: int, r: int, gathered=()):
    """Compute as rank ``r`` of a ``1 x m`` serving mesh on one card: under
    ``tensor_parallel.use_mesh(RankView(m, r))`` every product that would
    be summed over ``model`` (``tp.all_sum``) passes its f32 partial on
    unsummed and appends it to the yielded list, and the n-th
    ``tp.all_gather`` returns ``gathered[n]``, what every rank's pieces
    make whole (the rank's own piece checked against it). At ``m`` = 1 the
    list holds the whole f32 products."""
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    partials, wholes = [], iter(gathered)
    saved = tp.all_sum, tp.all_gather

    def keep(x):
        partials.append(x.float().clone())
        return x

    def gather(x, dim):
        whole, n = next(wholes, None), x.shape[dim]
        if whole is None or not torch.equal(whole.narrow(dim, r * n, n), x):
            fail(f"rank {r} of 1x{m}: its piece of a gather is not the "
                 f"whole's")
        return whole

    tp.all_sum, tp.all_gather = keep, gather
    try:
        with tp.use_mesh(RankView(m, r)):
            yield partials
    finally:
        tp.all_sum, tp.all_gather = saved


def rank_leaves(tree, m: int, r: int):
    """Rank ``r`` of ``1 x m``'s shards of a layer's f32 leaves, cut as
    ``Model.init_serving`` cuts them (``spec_for_param`` by leaf name, then
    the cast of a matrix to bf16)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    leaf, view = api._serving_leaf(grouped_moe=True), RankView(m, r)
    return {name: (rank_leaves(x, m, r) if isinstance(x, dict) else leaf(
        name, shd.local_shard(x, shd.spec_for_param(
            name, tuple(x.shape), view), view))) for name, x in tree.items()}


def check_shared_ranks(cfg, shared, xt, m: int, label: str) -> float:
    """The shared experts' tensor-parallel SwiGLU (``layers.mlp(...,
    d_ff=)``) on each rank of ``1 x m`` (:func:`as_rank`): the ranks' f32
    ``w_down`` partials summed against the whole SwiGLU's f32 product
    within SHARED_RANK_TOL of its largest value."""
    from repro_torch.models import layers
    f = cfg.moe_d_ff * cfg.n_shared_experts
    with as_rank(1, 0) as whole:
        layers.mlp(rank_leaves(shared, 1, 0), xt, d_ff=f)
    total = 0.0
    for r in range(m):
        with as_rank(m, r) as part:
            layers.mlp(rank_leaves(shared, m, r), xt, d_ff=f)
        total = total + part[0]
    err = ((total - whole[0]).abs().max() / whole[0].abs().max()).item()
    if not err <= SHARED_RANK_TOL:
        fail(f"shared experts {label}: the ranks' partials sum {err:.3e} of "
             f"the largest from the whole SwiGLU (tolerance "
             f"{SHARED_RANK_TOL})")
    log(f"  shared experts {label}: {m} ranks' column / row shards sum to "
        f"the whole SwiGLU within {err:.2e} of its largest  ok")
    return err


def check_mla_ranks(cfg, gen) -> dict:
    """Each rank's share of one full-width MLA layer on 1 x 2 and 1 x 4
    meshes, on one card (:func:`as_rank`): its leaves cut as
    ``Model.init_serving`` cuts them (``wq_a`` / ``wq_b`` / ``wkv_b``
    column shards, ``wkv_a`` whole, ``wo`` a row shard; ``n_heads / M``
    heads), ``wq_a``'s columns gathered whole before the q norm, the
    latent whole in each rank's own slab. The admission's prefill
    (MLA_ADMISSION, flash over the rank's heads) and one absorbed decode
    step after it: the ranks' f32 ``wo`` partials summed against the whole
    layer's f32 ``wo`` product within MLA_RANK_TOL of its largest value;
    every rank's latent slab the whole layer's bit for bit. Returns
    {"1xM": {"prefill": rel, "decode": rel}}."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention, layers
    p = {k: (v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()})
         for k, v in attention.init_mla(cfg, gen).items()}
    b, n = MLA_ADMISSION
    kind = next(k for g in cfg.layer_groups() for k in g.pattern
                if k.attn == "mla")
    x = torch.randn((b, n, cfg.d_model), generator=gen,
                    device=gen.device).to(torch.bfloat16)
    x1 = torch.randn((b, 1, cfg.d_model), generator=gen,
                     device=gen.device).to(torch.bfloat16)
    pos = torch.arange(n, device=gen.device)[None].expand(b, n)

    def layer(m, r, gathered=()):
        """Rank r's prefill and decode partials, and its latent slab."""
        leaves = rank_leaves(p, m, r)
        cache = attention.init_mla_cache(cfg, b, n + 32, gen.device)
        with as_rank(m, r, gathered) as parts:
            if attention.mla_heads(leaves, cfg) != cfg.n_heads // m:
                fail(f"MLA 1x{m} rank {r}: its leaves hold "
                     f"{attention.mla_heads(leaves, cfg)} heads")
            attention.mla_attention(leaves, x, cfg=cfg, kind=kind,
                                    positions=pos, cache=cache, cache_len=0)
            attention.mla_attention(
                leaves, x1, cfg=cfg, kind=kind, positions=pos[:, :1] + n,
                cache=cache, cache_len=torch.tensor(n, device=gen.device))
        return parts, cache

    whole, whole_cache = layer(1, 0)
    out = {}
    for m in EP_RANK_MESHES:
        q_a = torch.cat([layers.linear(x, rank_leaves(p, m, r)["wq_a"])
                         for r in range(m)], dim=-1)
        q_a1 = torch.cat([layers.linear(x1, rank_leaves(p, m, r)["wq_a"])
                          for r in range(m)], dim=-1)
        totals = [0.0, 0.0]
        launches = flash_attention.launches_by_dims[192, 128]
        for r in range(m):
            # the prefill's gather of wq_a's columns, then the decode step's
            parts, cache = layer(m, r, (q_a, q_a1))
            for i in range(2):
                totals[i] = totals[i] + parts[i]
            for name in ("ckv", "krope"):
                if not torch.equal(cache[name], whole_cache[name]):
                    fail(f"MLA 1x{m} rank {r}: its latent {name} is not the "
                         f"whole layer's")
        rec = {}
        for i, step in enumerate(("prefill", "decode")):
            rel = ((totals[i] - whole[i]).abs().max()
                   / whole[i].abs().max()).item()
            if not rel <= MLA_RANK_TOL:
                fail(f"MLA 1x{m} {step}: the ranks' wo partials sum {rel:.3e} "
                     f"of the largest from the whole layer (tolerance "
                     f"{MLA_RANK_TOL})")
            rec[step] = rel
        rec["flash_launches"] = (flash_attention.launches_by_dims[192, 128]
                                 - launches)
        log(f"  MLA 1x{m} ({cfg.n_heads // m} heads a rank, the latent "
            f"whole): the ranks' wo partials sum to the whole layer within "
            f"{rec['prefill']:.2e} (prefill, flash over the rank's heads, "
            f"{rec['flash_launches']} launches) / {rec['decode']:.2e} "
            f"(absorbed decode) of its largest; every rank's latent slab "
            f"the whole layer's bit for bit  ok")
        out[f"1x{m}"] = rec
    return out


def grouped_gemm_cases(cfg, p, x, label) -> dict:
    """The grouped_gemm kernel alone at one MoE layer's shapes: the hits of
    ``x``'s own routes sorted by expert, through the gate projection (K =
    d_model, N = moe_d_ff) and the down projection (K = moe_d_ff, N =
    d_model), against its plain version within GEMM_REL_TOL, timed beside
    ``F.grouped_mm`` (bf16 out, the yardstick) and the bound of the hit
    experts' weights, the rows and the f32 output: by events a call, 25
    calls back to back between two events (``device_ms``), and the
    device's time alone, 25 calls in one CUDA graph replayed between two
    events (``graph_ms``, ``library_graph_ms``); and the wrapper's host
    time a call (``host_ms``: ``grouped_gemm_ab.N_HOST`` calls with no
    synchronisation). The cases, their work and the host count are
    ``benchmarks/grouped_gemm_ab.py``'s."""
    from repro_torch.benchmarks.grouped_gemm_ab import routed_inputs
    return {f"gemm_{label}_{proj}": gemm_case(f"{label} {proj}", *args)
            for proj, args in routed_inputs(cfg, p, x).items()}


def gemm_case(label, xs, w, offs) -> dict:
    """One grouped_gemm call held and timed as :func:`grouped_gemm_cases`
    says; the pick of ``launch_config`` printed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.common import graph_ms, host_ms
    from repro_torch.benchmarks.grouped_gemm_ab import (N_HOST, case_work,
                                                        experts_hit)
    from repro_torch.kernels.grouped_gemm import (grouped_gemm,
                                                  grouped_gemm_plain,
                                                  launch_config)
    cap, k, n = xs.shape[0], w.shape[1], w.shape[2]
    hit = experts_hit(offs)
    got = grouped_gemm(xs, w, offs)
    want = grouped_gemm_plain(xs, w, offs)
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    conf = launch_config(cap, k, n, w.shape[0])
    name = (f"grouped_gemm {label} ({cap} hits of {hit} experts, K={k}, "
            f"N={n}; {conf.regime}, {conf.bm} x {conf.bn} tiles, grid "
            f"{conf.grid})")
    finite = bool(torch.isfinite(got).all())
    del got, want
    if not (finite and rel <= GEMM_REL_TOL):
        fail(f"{name}: max |d| {err:.3e}, {rel:.2e} of the largest value "
             f"(tolerance {GEMM_REL_TOL})")
    log(f"  {name}: max |d| {err:.3e} ({rel:.2e} of the largest)  ok")
    kernel = functools.partial(grouped_gemm, xs, w, offs)
    library = functools.partial(F.grouped_mm, xs, w, offs=offs)
    timing = time_case(
        name, kernel, functools.partial(grouped_gemm_plain, xs, w, offs),
        library, "grouped_gemm_kernel", *case_work(xs, w, offs),
        back_to_back=True)
    timing.update(graph_ms=graph_ms(kernel, N_TIMED),
                  library_graph_ms=graph_ms(library, N_TIMED),
                  host_ms=host_ms(kernel, N_HOST))
    log(f"    device alone (CUDA graph, {N_TIMED} calls): kernel "
        f"{timing['graph_ms']:.4f} ms, F.grouped_mm "
        f"{timing['library_graph_ms']:.4f} ms; the wrapper's host time "
        f"{timing['host_ms']:.4f} ms a call")
    return dict(err=err, rel_err=rel, hits=cap, experts_hit=hit,
                regime=conf.regime, tiles=[conf.bm, conf.bn], **timing)


def swap_kv(params, cfg):
    """``params`` with every attention layer's K and V projections traded
    (GQA: ``wk`` and ``wv``; MLA: the K (nope) and V parts of each head's
    ``wkv_b`` columns, one width in deepseek-v2): a control fault for
    forced_routes, given to the decode steps only."""
    import torch
    out = {}
    for name, leaf in params.items():
        if not isinstance(leaf, dict):
            out[name] = leaf
        elif name != "attn":
            out[name] = swap_kv(leaf, cfg)
        elif "wkv_b" in leaf:
            w, nope = leaf["wkv_b"], cfg.qk_nope_head_dim
            heads = w.reshape(*w.shape[:-1], cfg.n_heads, -1)
            out[name] = {**leaf, "wkv_b": torch.cat(
                [heads[..., nope:], heads[..., :nope]], -1).reshape(w.shape)}
        else:
            out[name] = {**leaf, "wk": leaf["wv"], "wv": leaf["wk"]}
    return out


def fp8_wo(params, cfg=None, proj="wo"):
    """``params`` with every attention output projection ``wo`` (or every
    leaf named ``proj``) rounded through fp8-e4m3: a subtler control fault
    for forced_routes, given to the decode steps only."""
    import torch
    return {name: (fp8_wo(leaf, cfg, proj) if isinstance(leaf, dict)
                   else leaf.to(torch.float8_e4m3fn).to(leaf.dtype)
                   if name == proj else leaf)
            for name, leaf in params.items()}


def fp8_out_proj(params, cfg=None):
    """``params`` with every mamba layer's output projection ``out_proj``
    rounded through fp8-e4m3: a control fault confined to the mamba
    layers, for forced_routes, given to the decode steps only."""
    return fp8_wo(params, cfg, "out_proj")


def forced_routes(model, params, prompt, tokens, decode_params=None) -> tuple:
    """A full-sequence forward (no caches) against the step-by-step pass
    (prefill, then one decode step a token, batch 1; the steps given
    ``decode_params`` when set) over the same tokens, with the forward's
    routes forced to the steps': each MoE layer takes, at each position,
    the experts the step-by-step pass chose there, gated by its own router
    probabilities. The two then compute one function through other GEMM
    shapes (and, for MLA, decompressed bf16 heads where decode reads the
    f32 latent), and differ only by rounding. Returns (max |d logit| over
    the generated positions, the positions of the whole sequence where
    the forward's own router would have chosen other experts in some MoE
    layer, the largest k-th to (k+1)-th router probability margin among
    them)."""
    import torch
    from repro_torch.models import layers, moe, transformer
    cfg, k = model.cfg, model.cfg.top_k
    route = moe._route
    seen = []

    def recording(w, xt, top_k):
        out = route(w, xt, top_k)
        seen.append(out[1])
        return out

    seq = torch.as_tensor(list(prompt) + list(tokens[:-1]), dtype=torch.int32,
                          device="cuda")[None]
    n, start = len(tokens), len(prompt) - 1
    moe._route = recording
    try:
        logits, state = model.prefill(params, {"tokens": seq[:, :start + 1]},
                                      start + n)
        steps = [logits[0, -1]]
        per_layer = [[i] for i in seen]
        for t in range(n - 1):
            seen.clear()
            logits, state = model.decode_step(
                decode_params or params, seq[:, start + 1 + t:start + 2 + t],
                state,
                torch.tensor(start + 1 + t, dtype=torch.int32, device="cuda"))
            steps.append(logits[0, -1])
            for layer, i in enumerate(seen):
                per_layer[layer].append(i)
        chosen = iter([torch.cat(i) for i in per_layer])
        parted = torch.zeros(seq.shape[1], dtype=torch.bool, device="cuda")
        margin = torch.zeros((), device="cuda")

        def forcing(w, xt, top_k):
            nonlocal parted, margin
            _, own, probs = route(w, xt, top_k)
            idx = next(chosen)
            differ = (own.sort(1).values != idx.sort(1).values).any(1)
            top = probs.topk(top_k + 1, dim=1).values
            gap = torch.where(differ, top[:, top_k - 1] - top[:, top_k], 0.0)
            parted, margin = parted | differ, torch.maximum(margin, gap.max())
            gates = probs.gather(1, idx)
            return gates / torch.clamp(gates.sum(-1, keepdim=True),
                                       min=1e-9), idx, probs

        moe._route = forcing
        x, _, _ = transformer.forward(cfg, params, seq)
    finally:
        moe._route = route
    whole = layers.unembed_logits(params["tok"], x[0, start:])
    vocab = cfg.vocab_size
    d = (torch.stack(steps)[:, :vocab] - whole[:, :vocab]).abs().max()
    return float(d), int(parted.sum()), float(margin)


@contextlib.contextmanager
def sublayer_outputs():
    """Record, in call order, the output (f32) of every mixer (attention,
    mamba) and feed-forward block (MLP, MoE) the model calls while the
    block runs: [(kind, output (B, S, d))]."""
    from repro_torch.models import attention, layers, moe, ssm
    rec = []

    def recording(kind, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec.append((kind, (out[0] if isinstance(out, tuple)
                               else out).float()))
            return out
        return call

    saved = (dict(attention.APPLY), ssm.mamba_block, layers.mlp,
             moe.moe_block)
    for kind, fn in saved[0].items():
        attention.APPLY[kind] = recording(kind, fn)
    ssm.mamba_block = recording("mamba", saved[1])
    layers.mlp = recording("mlp", saved[2])
    moe.moe_block = recording("moe", saved[3])
    try:
        yield rec
    finally:
        attention.APPLY.update(saved[0])
        ssm.mamba_block, layers.mlp, moe.moe_block = saved[1:]


def sublayer_gaps(rec, n_sub, n, start) -> dict:
    """From :func:`sublayer_outputs`' record of one :func:`forced_routes`
    call (``n_sub`` sublayers a forward; the step-by-step pass's prefill
    and n - 1 decode steps, then the full-sequence forward): each
    sublayer's largest |d| over the n generated positions, as a share of
    its largest output there. {"<layer> <kind>": share}."""
    import torch
    if len(rec) != n_sub * (n + 1):
        fail(f"sublayer record: {len(rec)} calls, want {n_sub} x {n + 1}")
    out, layer = {}, -1
    for i in range(n_sub):
        kind = rec[i][0]
        layer += kind not in ("mlp", "moe")     # a mixer opens a layer
        steps = torch.cat([rec[t * n_sub + i][1][0, -1:] for t in range(n)])
        whole = rec[n * n_sub + i][1][0, start:start + n]
        out[f"{layer} {kind}"] = float(
            (steps - whole).abs().max() / steps.abs().max())
    return out


def phase_moe(arch: str, n_layers: int, phase: int) -> dict:
    """One MoE model at its published widths, ``n_layers`` deep, through
    the launcher (``cli.run(argv, cfg=...)``) under its h100 default: the
    grouped MoE against the plain one at one layer, the one-shot and the
    paged stream (deepseek-v2 also at ``--kv-quant int8``), launches
    counted around each (flash once per attention layer and admission;
    the paged kernel once per GQA layer and decode step, never for MLA,
    whose decode runs in latent space), host syncs once a chunk, and every
    greedy token of the one-shot and of the stream held to teacher-forced
    passes at the served batch and pool, a full-sequence forward on the
    same routes held to the step-by-step pass, and the controls that must
    fail that gate. Prints the phase's seconds."""
    import dataclasses
    from repro_torch.configs import get_config
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.serve.scheduler import synthetic_stream
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    groups = ", ".join(f"{g.name} x {g.n_repeat}" for g in cfg.layer_groups())
    argv = ["--arch", arch, "--full"]
    log(f"[{phase}/17] {arch} at its published widths, {n_layers} of "
        f"{full.n_layers} layers ({groups}): " + " ".join(argv))
    moe_check = check_grouped_moe(cfg)
    torch.cuda.reset_peak_memory_stats()
    recs = {"one_shot": one_shot(cfg, argv + ONE_SHOT_ARGS, "one-shot")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  one-shot: peak device memory {peak:.1f} GB (its serving copy, "
        f"built leaf by leaf, and the one-shot)")
    free_memory()
    recs["stream"] = run_stream(cfg, argv + STREAM_ARGS, "stream")
    free_memory()
    if cfg.use_mla:
        rec = run_stream(cfg, argv + STREAM_ARGS + ["--kv-quant", "int8"],
                         "kv int8")
        agree = first_token_agreement("kv int8", rec, recs["stream"])
        log(f"  kv int8: {rec['n_pages'] - 1} latent pages in "
            f"{rec['pool_bytes']} B (fp16: {recs['stream']['n_pages'] - 1} "
            f"in {recs['stream']['pool_bytes']} B), first-token agreement "
            f"{agree:.3f}; {rec['tok_per_s']:.1f} tok/s (fp16 "
            f"{recs['stream']['tok_per_s']:.1f})")
        recs["kv_int8"] = rec
        check_merge_counters("kv int8")
        free_memory()
    # the teacher-forced passes run the served batch and pool (as falcon's
    # do): a full-sequence forward computes the same function through other
    # GEMM shapes and, for MLA, decompressed bf16 heads instead of the f32
    # latent, and a router near-tie it flips moves the logits by more than
    # LOGIT_TOL. With its routes forced to the step-by-step pass's it is
    # held to that pass within FORCED_ROUTE_TOL
    model = build_model(cfg)
    params = reference_params(cfg)
    stream = synthetic_stream(8, 512, 64, cfg.vocab_size)
    served_batch_check(model, params, one_shot_prompts(cfg),
                       recs["one_shot"]["tokens"].numpy(), 4, "one-shot")
    for rid in range(len(stream)):
        served_batch_check(model, params, [stream[rid]["prompt"]],
                           [recs["stream"]["outputs"][rid]], 4,
                           f"stream request {rid}", depth=MAX_LEN,
                           page_tokens=16)
    worst, tol = 0.0, FORCED_ROUTE_TOL[arch]
    for label, prompt, toks in (
            ("one-shot row 0", one_shot_prompts(cfg)[0],
             recs["one_shot"]["tokens"].numpy()[0]),
            ("stream request 0", stream[0]["prompt"],
             recs["stream"]["outputs"][0]),
            ("stream request 1", stream[1]["prompt"],
             recs["stream"]["outputs"][1])):
        d, parts, margin = forced_routes(model, params, prompt, toks)
        log(f"  {label}: a full-sequence forward on the step-by-step pass's "
            f"routes (its own would part at {parts} positions, largest "
            f"margin {margin:.2e}): max |d logit| {d:.4f} (gated at "
            f"{tol})")
        if not d <= tol:
            fail(f"{arch} {label}: a full-sequence forward on the same "
                 f"routes parts from the step-by-step pass by {d:.4f}")
        worst = max(worst, d)
    # the controls: a fault in the decode steps alone must fail the gate
    controls = {}
    for fault, what in ((swap_kv, "K and V projections traded"),
                        (fp8_wo, "wo rounded through fp8-e4m3")):
        d, parts, _ = forced_routes(
            model, params, stream[0]["prompt"], recs["stream"]["outputs"][0],
            decode_params=fault(params, cfg))
        controls[fault.__name__] = d
        log(f"  control (stream request 0, the decode steps' {what}): max "
            f"|d logit| {d:.4f} ({parts} positions' own routes part)")
        if d <= tol:
            fail(f"{arch}: the forced-route gate passes its control ({what})")
    del params, model
    free_memory()
    seconds = time.perf_counter() - t0
    log(f"  {arch}: the phase took {seconds:.1f} s")
    return {"recs": recs, "moe": moe_check, "forced_route_gap": worst,
            "forced_route_controls": controls, "peak_gb": peak,
            "seconds": seconds}


def phase_gemma(phase: int) -> dict:
    """gemma3-27b at its published widths, cut to GEMMA's two 5:1 periods,
    through the launcher under its h100 default: the one-shot (2 x 2048)
    and the paged stream (prompts 1207-1708), both past the 1024-token
    window, launches counted around each (flash 12 an admission, paged 12
    a decode step), host syncs once a chunk, every greedy token of both
    held to the teacher-forced rule. Prints the phase's seconds."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.scheduler import synthetic_stream
    t0 = time.perf_counter()
    arch, n_layers = GEMMA
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    kinds = [k for g in cfg.layer_groups() for _ in range(g.n_repeat)
             for k in g.pattern]
    globals_ = [i for i, k in enumerate(kinds) if k.window is None]
    argv = ["--arch", arch, "--full"]
    log(f"[{phase}/17] {arch} at its published widths, {n_layers} of "
        f"{full.n_layers} layers (window {full.window}, global layers "
        f"{globals_}): " + " ".join(argv))
    if globals_ != [5, 11] or len(kinds) != n_layers:
        fail(f"{arch} cut: global layers {globals_} of {len(kinds)}")
    torch.cuda.reset_peak_memory_stats()
    recs = {"one_shot": one_shot(cfg, argv + GEMMA_ONE_SHOT_ARGS,
                                 "one-shot")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  one-shot: peak device memory {peak:.1f} GB")
    free_memory()
    recs["stream"] = run_stream(cfg, argv + GEMMA_STREAM_ARGS, "stream")
    free_memory()
    stream = synthetic_stream(4, 2048, 32, cfg.vocab_size)
    lens = [len(r["prompt"]) for r in stream]
    if min(lens) <= full.window:
        fail(f"{arch} stream prompts {lens} do not pass the window")
    params = reference_params(cfg)
    prompts = one_shot_prompts(cfg, 2, 2048)
    for r in range(2):
        teacher_forced_check(cfg, params, prompts[r],
                             recs["one_shot"]["tokens"].numpy()[r],
                             f"one-shot row {r}")
    for rid in range(len(stream)):
        teacher_forced_check(cfg, params, stream[rid]["prompt"],
                             recs["stream"]["outputs"][rid],
                             f"stream request {rid} ({lens[rid]}-token "
                             f"prompt)")
    del params
    free_memory()
    seconds = time.perf_counter() - t0
    log(f"  {arch}: the phase took {seconds:.1f} s")
    return {"recs": recs, "peak_gb": peak, "prompt_lens": lens,
            "seconds": seconds}


def phase_families(phase: int) -> dict:
    """qwen2-vl-2b uncut through the launcher (QWEN_VL: M-RoPE, 256 stub
    patch embeddings before each 256-token prompt; flash (128, 128) 28
    times) and seamless-m4t-medium uncut through ``Engine.generate``
    (SEAMLESS: 512 source frames, 256-token decoder prompts): flash (64,
    64) once per encoder layer, twice per decoder layer at the prefill
    (causal self-attention, cross-attention) and once per decoder layer
    at each decode step (cross-attention, one query row; the decoder's
    self-attention over its dense cache takes the masked oracle, the
    reference's dispatch). Every row's greedy tokens held to the
    teacher-forced rule with the same frontend or source frames. Prints
    the phase's seconds and the launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.target import use_target
    from repro_torch.models.api import build_model
    from repro_torch.models.frontends import fake_frontend
    from repro_torch.serve.engine import Engine, EngineConfig
    t0 = time.perf_counter()
    log(f"[{phase}/17] the other attention families uncut, one-shot: "
        + " ".join(QWEN_VL) + f"; {SEAMLESS[0]} --full through "
        f"Engine.generate ({SEAMLESS[1]} source frames, {SEAMLESS[2]}-token "
        f"prompts)")
    out = {}
    cfg = get_config("qwen2-vl-2b")
    rec = one_shot(cfg, QWEN_VL, "qwen2-vl-2b one-shot")
    params = reference_params(cfg)
    front = fake_frontend(cfg, 4, torch.Generator(device="cuda")
                          .manual_seed(1))
    prompts = one_shot_prompts(cfg)
    for r in range(4):
        teacher_forced_check(cfg, params, prompts[r], rec["tokens"].numpy()[r],
                             f"qwen2-vl-2b one-shot row {r}",
                             frontend_embeds=front[r:r + 1])
    out["qwen2-vl-2b one_shot"] = rec
    del params, front
    free_memory()

    name, n_src, n_prompt = SEAMLESS
    cfg = get_config(name)
    gen_len = 32
    with use_target(SERVING_TARGET):
        model = build_model(cfg)
        engine = Engine(model, model.init_serving(
            torch.Generator(device="cuda").manual_seed(0)),
                        EngineConfig(max_len=n_prompt + gen_len))
        prompts = np.random.RandomState(1).randint(2, cfg.vocab_size,
                                                   size=(4, n_prompt))
        src = fake_frontend(cfg, 4, torch.Generator(device="cuda")
                            .manual_seed(1), n_src)
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int32,
                                           device="cuda"),
                 "src_embeds": src}
        reset_counts()
        t1 = time.perf_counter()
        toks, _ = engine.generate(batch, gen_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = read_counts()
    toks = toks.cpu().numpy()
    steps = engine.last_stats["decode_steps"]
    if toks.shape != (4, gen_len) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"{name} one-shot: tokens shape {toks.shape}")
    check_counts(f"{name} one-shot", counts, {
        "flash_d64": cfg.n_encoder_layers + cfg.n_layers * (2 + steps)})
    for r in range(4):
        teacher_forced_check(cfg, engine.params, prompts[r], toks[r],
                             f"{name} one-shot row {r}",
                             src_embeds=src[r:r + 1])
    tok_s = toks.size / wall
    log(f"  {name} one-shot: {tok_s:.1f} tok/s, host_syncs "
        f"{engine.last_stats['host_syncs']}, {steps} decode steps; launches "
        f"{counts}")
    out[f"{name} one_shot"] = {"tokens": toks, "tok_per_s": tok_s,
                               "launches": counts, "decode_steps": steps}
    del engine, model, src
    free_memory()
    seconds = time.perf_counter() - t0
    log(f"  the phase took {seconds:.1f} s")
    out["seconds"] = seconds
    return out


def phase_paper() -> dict:
    """The paper path on the card, through the entry points a user runs;
    the matmul3d launches are counted around both."""
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels.matmul3d import matmul3d
    from repro_torch.launch import mempool_matmul
    from repro_torch.launch.mempool_matmul import REL_TOL
    log("[12/17] the paper path: python -m repro_torch.launch.mempool_matmul; "
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
        engine = Engine(model, model.init_serving(
            torch.Generator(device="cuda").manual_seed(0)),
                        EngineConfig(max_len=MAX_LEN, sync_interval=8))
        # a trace that lost kernel records (see device_profile) traces the
        # port's kernels fewer times than their wrappers launched them
        for _ in range(PROFILE_TRIES):
            sch = Scheduler(n_slots=n_slots, pages=geom)
            for spec in synthetic_stream(8, 512, 64, cfg.vocab_size):
                sch.submit(spec["prompt"], spec["max_new_tokens"])
            before = read_counts()
            with cuda_trace(PROFILE_PAD_S) as prof:
                t0 = time.perf_counter()
                engine.serve(scheduler=sch, max_steps=PROFILE_STEPS)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            after = read_counts()
            by_wrapper = {k: after[k] - before[k]
                          for k in ("flash", "flash_d192", "paged", "scan")}
            launched = sum(by_wrapper.values())
            kernels = traced_kernels(prof)
            ours = {e.key[:48]: e.count for e in kernels
                    if any(n in e.key for n in PORT_KERNELS)}
            traced = sum(ours.values())
            if kernels and traced == launched:
                break
            log(f"  (the profiler lost kernel records: the port's kernels "
                f"launched {launched} times ({by_wrapper}), traced {traced} "
                f"({ours}), {sentinels_traced(prof)}; tracing again)")
        else:
            fail(f"the profiler returned no whole trace in {PROFILE_TRIES} "
                 f"tries")
    stats = engine.last_stats
    del engine, model
    free_memory()
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
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


def _rel_errs(got, want) -> list:
    """max |got - want| / max |want| of each pair (f32)."""
    return [(a.float() - b.float()).abs().max().item()
            / max(b.float().abs().max().item(), 1e-30)
            for a, b in zip(got, want)]


def grad_check(label, names, kernel_fn, plain_fn, inputs, grad_out) -> float:
    """``kernel_fn`` (a kernel inside its autograd Function) against
    autograd through ``plain_fn`` on the same leaves: the output and each
    input's gradient within GRAD_TOL of its largest value. Returns the
    worst share."""
    import torch
    out = kernel_fn(*inputs)
    got = [out, *torch.autograd.grad(out, inputs, grad_out)]
    ref = plain_fn(*inputs)
    want = [ref, *torch.autograd.grad(ref, inputs, grad_out)]
    errs = _rel_errs(got, want)
    log(f"  {label}: max |d| / max |plain| " + ", ".join(
        f"{n} {e:.2e}" for n, e in zip(["out"] + names, errs)))
    if not all(e <= GRAD_TOL for e in errs):
        fail(f"{label}: gradients beyond {GRAD_TOL} of their largest value")
    return max(errs)


def train_grad_checks() -> dict:
    """Each kernel's autograd Function (kernel forward, plain backward) at
    the training paths' shapes against autograd through its plain version;
    the plain backward's time a call (the work a backward kernel, ROADMAP
    B6, would take over)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.core.target import use_target
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, flash_attention_plain_vjp)
    from repro_torch.kernels.grouped_gemm import grouped_gemm_plain_vjp
    from repro_torch.kernels.mamba_scan import mamba_scan_plain_vjp
    make = seeded(41)

    def leaf(*shape, scale=1.0):
        return (make(*shape) * scale).requires_grad_()

    out = {}
    # flash (128, 128) at qwen2.5-3b's training shape, causal
    q, k, v = leaf(8, 16, 128, 128), leaf(8, 2, 128, 128), leaf(8, 2, 128,
                                                                 128)
    g = make(8, 16, 128, 128)
    err = grad_check("flash (128, 128), 8 x 16 over 2 heads x 128, causal",
                     ["dq", "dk", "dv"],
                     lambda *t: ops.attention(*t, causal=True),
                     lambda *t: flash_attention_plain(*t, causal=True),
                     (q, k, v), g)
    ms = median_ms(lambda: flash_attention_plain_vjp(q, k, v, g,
                                                     causal=True), N_TIMED)
    out["flash"] = {"grad_err": err, "backward_plain_ms": ms}
    log(f"  flash's plain backward: {ms:.4f} ms a call (events)")
    # grouped_gemm at one qwen3-moe layer's 1024-token admission
    m, d, f, e = GRAD_MOE
    rng = np.random.RandomState(42)
    hits = np.sort(rng.randint(0, e, size=m))
    offs = torch.as_tensor(np.searchsorted(hits, np.arange(e), "right"),
                           dtype=torch.int32, device="cuda")
    bounds = [0] + offs.tolist()

    def per_expert(xs, w):
        return torch.cat([xs[lo:hi].float() @ w[i].float()
                          for i, (lo, hi) in enumerate(zip(bounds,
                                                           bounds[1:]))])
    worst = 0.0
    for name, kk, nn in (("gate", d, f), ("down", f, d)):
        xs, w = leaf(m, kk), leaf(e, kk, nn, scale=kk ** -0.5)
        g = torch.from_numpy(rng.randn(m, nn).astype(np.float32)).cuda()
        worst = max(worst, grad_check(
            f"grouped_gemm {name} ({m} hits, K {kk}, N {nn}, {e} experts)",
            ["dxs", "dw"], lambda a, b: ops.grouped_matmul(a, b, offs),
            per_expert, (xs, w), g))
    ms = median_ms(lambda: grouped_gemm_plain_vjp(xs, w, offs, g), 5)
    out["grouped"] = {"grad_err": worst, "backward_plain_ms": ms}
    log(f"  grouped_gemm's plain backward (down): {ms:.4f} ms a call")
    # mamba_scan at falcon-mamba-7b's widths, L 128, the training batch
    x, b_, c_ = leaf(8, 128, 8192), leaf(8, 128, 16), leaf(8, 128, 16)
    dt = F.softplus(make(8, 128, 8192).float() - 3).requires_grad_()
    a = (-torch.arange(1, 17, device="cuda", dtype=torch.float32)
         .expand(8192, 16).contiguous()).requires_grad_()
    dd = torch.ones(8192, device="cuda", requires_grad=True)
    g = make(8, 128, 8192)
    with use_target(SERVING_TARGET):
        err = grad_check("mamba_scan 8 x 128 x 8192 x 16",
                         ["dx", "ddt", "dA", "dB", "dC", "dD"],
                         lambda *t: ops.selective_scan(*t),
                         lambda *t: ref.selective_scan_ref(*t),
                         (x, dt, a, b_, c_, dd), g)
    ms = median_ms(lambda: mamba_scan_plain_vjp(x, dt, a, b_, c_, dd, g), 3)
    out["scan"] = {"grad_err": err, "backward_plain_ms": ms}
    log(f"  mamba_scan's plain backward: {ms:.4f} ms a call")
    return out


def _bits(tree) -> list:
    """Every leaf of a params / optimizer tree as raw bytes, in order."""
    import torch
    from repro_torch.train.checkpoint import _flatten
    return [(key, t.detach().reshape(-1).view(torch.uint8))
            for key, t in _flatten(tree)]


def same_bits(a, b) -> bool:
    import torch
    bits_a, bits_b = _bits(a), _bits(b)
    return ([k for k, _ in bits_a] == [k for k, _ in bits_b]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(bits_a,
                                                                  bits_b)))


def crash_drill() -> dict:
    """The launcher's crash drill at full width cut to DRILL_LAYERS
    layers, int8 moments: an uninterrupted run; a run with checkpoints
    every 2 steps that crashes before step 3 (exit 17); ``--resume``. The
    resumed steps' losses and the final params and moments must equal the
    uninterrupted run's bit for bit. The checkpoint manager's records give
    each save's and the restore's seconds and bytes."""
    import dataclasses
    import struct
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=DRILL_LAYERS)
    log(f"  crash drill: qwen2.5-3b at full width, {DRILL_LAYERS} layers, "
        + " ".join(DRILL_ARGS))
    t0 = time.perf_counter()
    whole = train_cli.run(DRILL_ARGS, cfg=cfg)
    whole_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ["--ckpt-dir", os.path.join(tmp, "drill")]
        t0 = time.perf_counter()
        crashed = train_cli.run(DRILL_ARGS + ckpt + ["--fail-at", "3"],
                                cfg=cfg)
        crashed_s = time.perf_counter() - t0
        if crashed["exit"] != 17:
            fail(f"crash drill: --fail-at 3 exited {crashed['exit']}, not 17")
        t0 = time.perf_counter()
        resumed = train_cli.run(DRILL_ARGS + ckpt + ["--resume"], cfg=cfg)
        resumed_s = time.perf_counter() - t0
        bits = lambda x: struct.pack("<d", x)              # noqa: E731
        if resumed["start_step"] != 2 or any(
                bits(resumed["losses"][s]) != bits(whole["losses"][s])
                for s in (2, 3)):
            fail(f"crash drill: resumed at {resumed['start_step']} with "
                 f"losses {resumed['losses']}, uninterrupted "
                 f"{whole['losses']}")
        if not same_bits({"p": resumed["params"], "o": resumed["opt"]},
                         {"p": whole["params"], "o": whole["opt"]}):
            fail("crash drill: the resumed run's params or moments part "
                 "from the uninterrupted run's")
    ckpts = crashed["checkpoints"] + resumed["checkpoints"]
    if [(r["op"], r["step"]) for r in ckpts] != [("save", 2), ("restore", 2),
                                                  ("save", 4)]:
        fail(f"crash drill: checkpoints {ckpts}")
    save, restore = ckpts[0], ckpts[1]
    n_params = sum(t.numel() for t in tree_leaves(resumed["params"]))
    log(f"  crash drill ok: exit 17 at step 3, resumed from step 2, losses "
        f"{[resumed['losses'][s] for s in (2, 3)]} and params and int8 "
        f"moments bit for bit the uninterrupted run's; runs {whole_s:.1f} / "
        f"{crashed_s:.1f} / {resumed_s:.1f} s; {n_params / 1e6:.1f} M "
        f"params; a checkpoint {save['raw_bytes'] / 1e9:.3f} GB raw, "
        f"{save['disk_bytes'] / 1e9:.3f} GB on disk (zlib), saved in "
        f"{save['seconds']:.2f} s (its call to its rename) and "
        f"{ckpts[2]['seconds']:.2f} s, restored in {restore['seconds']:.2f} "
        f"s")
    del whole, crashed, resumed
    free_memory()
    return {"save_s": save["seconds"], "restore_s": restore["seconds"],
            "raw_bytes": save["raw_bytes"], "disk_bytes": save["disk_bytes"],
            "params": n_params, "run_s": [whole_s, crashed_s, resumed_s]}


def phase_train(phase: int) -> dict:
    """Training on the card: the kernels' autograd Functions at the
    training paths' shapes; qwen2.5-3b at full width through
    ``launch.train.run`` (TRAIN_ARGS, remat on: each attention layer
    launches flash in the forward and again in the backward's recompute,
    72 a step, and its plain backward once; no other kernel), its losses
    finite and the last below the first, its step time, tokens/s and
    peak memory beside the reckoning of f32 params, grads and moments
    plus the bf16 compute copy; the crash drill. Prints the phase's
    seconds."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain_vjp
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import tree_leaves
    t_phase = time.perf_counter()
    log(f"[{phase}/17] training: the kernels' autograd Functions; "
        f"python -m repro_torch.launch.train " + " ".join(TRAIN_ARGS)
        + "; the crash drill")
    checks = train_grad_checks()
    free_memory()
    reset_counts()
    flash_attention_plain_vjp.calls = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = train_cli.run(TRAIN_ARGS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts, vjp = read_counts(), flash_attention_plain_vjp.calls
    n_params = sum(p.numel() for p in tree_leaves(rec["params"]))
    reckoning = n_params * (4 + 4 + 4 + 4 + 2)
    check_counts("qwen training", counts, {"flash": 72 * TRAIN_STEPS})
    if vjp != 36 * TRAIN_STEPS:
        fail(f"qwen training: flash's plain backward ran {vjp} times, want "
             f"{36 * TRAIN_STEPS}")
    losses = [rec["losses"][s] for s in range(TRAIN_STEPS)]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"qwen training: losses {losses}")
    step_s = float(np.median(rec["step_s"][1:]))
    tokens = 8 * 128
    log(f"  qwen2.5-3b --full trained {TRAIN_STEPS} steps: losses "
        f"{[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms "
        f"(median of steps 1-{TRAIN_STEPS - 1}, host clock; step 0 "
        f"{rec['step_s'][0] * 1e3:.1f} ms), {tokens / step_s:.0f} tok/s; "
        f"flash {counts['flash'] // TRAIN_STEPS} launches a step, its plain "
        f"backward {vjp // TRAIN_STEPS}; {n_params / 1e9:.3f} B params, "
        f"peak {peak / 1e9:.2f} GB against the {reckoning / 1e9:.2f} GB of "
        f"f32 params, grads, m and v and the bf16 copy")
    del rec
    free_memory()
    drill = crash_drill()
    examples = train_examples()
    moe = train_moe()
    seconds = time.perf_counter() - t_phase
    log(f"  training: the phase took {seconds:.1f} s")
    return {"checks": checks, "launches": counts, "losses": losses,
            "step_ms": step_s * 1e3, "tok_per_s": tokens / step_s,
            "peak_gb": peak / 1e9, "reckoning_gb": reckoning / 1e9,
            "plain_backward_calls": vjp, "drill": drill, "seconds": seconds,
            "examples": examples, "moe": moe}


def train_examples() -> dict:
    """The training examples on the card, each run as its ``main()``
    runs it: quickstart's QUICKSTART_STEPS steps (flash at (32, 32), 8
    launches a step: 4 layers, forward and recompute; its loss rule);
    elastic_restart through the mesh path on NCCL world 1 (flash at (16,
    16), 4 launches a step over its 60 steps; its continuity check).
    Launches counted around each."""
    import torch.distributed as dist
    from repro_torch.examples import elastic_restart, quickstart
    from repro_torch.kernels.flash_attention import flash_attention_plain_vjp
    t0 = time.perf_counter()
    reset_counts()
    flash_attention_plain_vjp.calls = 0
    qs = quickstart.run(["--steps", str(QUICKSTART_STEPS)])
    counts, vjp = read_counts(), flash_attention_plain_vjp.calls
    check_counts("quickstart", counts, {"flash_d32": 8 * QUICKSTART_STEPS})
    if vjp != 4 * QUICKSTART_STEPS:
        fail(f"quickstart: flash's plain backward ran {vjp} times, want "
             f"{4 * QUICKSTART_STEPS}")
    if qs["exit"] != 0:
        fail(f"quickstart: final loss {qs['final']:.4f} not under 0.8 x "
             f"uniform {qs['uniform']:.4f}")
    qs_s = time.perf_counter() - t0
    log(f"  quickstart ok: {QUICKSTART_STEPS} steps, loss "
        f"{qs['losses'][0]:.4f} -> {qs['final']:.4f} (< 0.8 x "
        f"{qs['uniform']:.4f}), {qs['tok_per_s']:.0f} tok/s (host clock, "
        f"the whole run), checkpoints {qs['checkpoints']}; flash (32, 32) "
        f"{counts['flash_d32'] // QUICKSTART_STEPS} launches a step; "
        f"{qs_s:.1f} s")
    t0 = time.perf_counter()
    reset_counts()
    el = elastic_restart.run([])
    el_counts = read_counts()
    steps = len(el["phase1"]) + len(el["phase2"])
    check_counts("elastic_restart", el_counts, {"flash_d16": 4 * steps})
    if not el["ok"] or dist.is_initialized():
        fail(f"elastic_restart: continuity check failed ({el}) or its "
             f"process group was left behind")
    el_s = time.perf_counter() - t0
    log(f"  elastic_restart ok (NCCL, world 1, mesh {el['mesh_a']} then "
        f"{el['mesh_b']}): phase 1 {el['phase1'][0]:.3f} -> "
        f"{el['phase1'][-1]:.3f}, restored at step {el['restored_step']}, "
        f"phase 2 {el['phase2'][0]:.3f} -> {el['phase2'][-1]:.3f}; flash "
        f"(16, 16) {el_counts['flash_d16']} launches; {el_s:.1f} s")
    free_memory()
    return {"quickstart": {"launches": counts, "losses_first_last": [
                qs["losses"][0], qs["final"]], "uniform": qs["uniform"],
                "tok_per_s": qs["tok_per_s"], "seconds": qs_s,
                "plain_backward_calls": vjp},
            "elastic": {"launches": el_counts, "phase1": el["phase1"],
                        "phase2": el["phase2"], "seconds": el_s}}


def train_moe() -> dict:
    """qwen3-moe-30b-a3b at its published widths cut to MOE_TRAIN_LAYERS
    layers trained through ``launch.train.run`` (MOE_TRAIN_ARGS, remat
    on): losses finite and the last below the first; grouped_gemm 6
    launches a MoE layer a step (gate, up and down; forward and the
    backward's recompute) and its plain backward 3; flash (128, 128) 2 a
    layer; step time and the peak beside the reckoning of 18 B a
    parameter."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain_vjp
    from repro_torch.kernels.grouped_gemm import grouped_gemm_plain_vjp
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config(QWEN_MOE[0]),
                              n_layers=MOE_TRAIN_LAYERS)
    n_moe = moe_layers(cfg)
    log(f"  {QWEN_MOE[0]} at {MOE_TRAIN_LAYERS} layers: python -m "
        f"repro_torch.launch.train " + " ".join(MOE_TRAIN_ARGS))
    t0 = time.perf_counter()
    free_memory()
    reset_counts()
    flash_attention_plain_vjp.calls = grouped_gemm_plain_vjp.calls = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = train_cli.run(MOE_TRAIN_ARGS, cfg=cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved()
    counts = read_counts()
    g_vjp, f_vjp = grouped_gemm_plain_vjp.calls, flash_attention_plain_vjp.calls
    n_params = sum(p.numel() for p in tree_leaves(rec["params"]))
    reckoning = n_params * (4 + 4 + 4 + 4 + 2)
    steps = MOE_TRAIN_STEPS
    check_counts(f"{QWEN_MOE[0]} training", counts,
                 {"flash": 2 * MOE_TRAIN_LAYERS * steps,
                  "grouped": 6 * n_moe * steps})
    if g_vjp != 3 * n_moe * steps or f_vjp != MOE_TRAIN_LAYERS * steps:
        fail(f"{QWEN_MOE[0]} training: plain backwards grouped_gemm {g_vjp}"
             f", flash {f_vjp}; want {3 * n_moe * steps} and "
             f"{MOE_TRAIN_LAYERS * steps}")
    losses = [rec["losses"][s] for s in range(steps)]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"{QWEN_MOE[0]} training: losses {losses}")
    step_s = float(np.median(rec["step_s"][1:]))
    seconds = time.perf_counter() - t0
    log(f"  {QWEN_MOE[0]} x {MOE_TRAIN_LAYERS} trained {steps} steps: "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} "
        f"ms (median of steps 1-{steps - 1}, host clock; step 0 "
        f"{rec['step_s'][0] * 1e3:.1f} ms), {8 * 128 / step_s:.0f} tok/s; "
        f"grouped_gemm {counts['grouped'] // steps} launches a step, its "
        f"plain backward {g_vjp // steps}; flash {counts['flash'] // steps}"
        f"; {n_params / 1e9:.3f} B params, peak {peak / 1e9:.2f} GB "
        f"allocated ({reserved / 1e9:.2f} GB reserved) against the "
        f"{reckoning / 1e9:.2f} GB of f32 params, grads, m and v and the "
        f"bf16 copy; {seconds:.1f} s")
    del rec
    free_memory()
    return {"launches": counts, "losses": losses, "step_ms": step_s * 1e3,
            "peak_gb": peak / 1e9, "reserved_gb": reserved / 1e9,
            "reckoning_gb": reckoning / 1e9, "params": n_params,
            "grouped_plain_backward_calls": g_vjp,
            "flash_plain_backward_calls": f_vjp, "seconds": seconds}


def jamba_flash_case() -> dict:
    """Flash at jamba's admission: held, timed beside SDPA ``is_causal,
    enable_gqa`` (phase 3 repeats and digests the same call)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = jamba_flash_inputs()
    label = jamba_flash_label(q, k)
    call = functools.partial(flash_attention, q, k, v, causal=True)
    plain = functools.partial(flash_attention_plain, q, k, v, causal=True)
    err = compare(label, call(), plain())
    sdpa = functools.partial(F.scaled_dot_product_attention, q, k, v,
                             is_causal=True, enable_gqa=True)
    compare("flash jamba: SDPA vs the plain version", sdpa(), plain())
    b, hq, n, d = q.shape
    pairs = b * hq * sum(min(r + 1, n) for r in range(n))
    return dict(err=err, **time_case(
        label, call, plain, sdpa, "flash_fwd_kernel",
        2 * (2 * q.numel() + k.numel() + v.numel()), 4.0 * d * pairs))


def jamba_paged_case() -> dict:
    """Paged decode at jamba's widths (8 KV heads, group 8): 4 slots over
    JAMBA_PAGE_TOKENS-token pages at JAMBA_PAGED_LENS, held, each slot
    alone bit for bit its row of the batch, one CUDA kernel a call,
    timed; no library call walks a block table."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (paged_flash_decode,
                                                     paged_flash_decode_plain)
    cfg = get_config(JAMBA)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pt, lens = JAMBA_PAGE_TOKENS, JAMBA_PAGED_LENS
    b, p_max = len(lens), -(-(max(lens) + 1) // pt)
    make = seeded(340)
    kp, vp = (make(b * p_max + 1, hkv, pt, d) for _ in range(2))
    perm = torch.from_numpy(np.random.RandomState(341).permutation(
        b * p_max) + 1).cuda()
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mapped = torch.arange(p_max, device="cuda")[None, :] * pt <= cl[:, None]
    bt = torch.where(mapped, perm.reshape(b, p_max), 0).to(
        torch.int32).contiguous()
    q = make(b, hq, 1, d)
    label = (f"paged jamba B={b} Hq={hq} Hkv={hkv} pt={pt} P={p_max} "
             f"lens={lens}")
    call = functools.partial(paged_flash_decode, q, kp, vp, bt, cl)
    plain = functools.partial(paged_flash_decode_plain, q, kp, vp, bt, cl)
    got = call()
    err = compare(label, got, plain())
    for i in range(b):
        if not torch.equal(paged_flash_decode(q[i:i + 1], kp, vp,
                                              bt[i:i + 1], cl[i:i + 1]),
                           got[i:i + 1]):
            fail(f"{label}: slot {i} alone differs from its row of the batch")
    n_kernels = device_profile(call, "paged_decode_kernel")[1]
    if n_kernels != 1:
        fail(f"{label}: a call launched {n_kernels:g} CUDA kernels, want 1")
    log(f"  {label}: each slot alone == its row of the batch, bit for bit; "
        f"one CUDA kernel a call  ok")
    visible = sum(n + 1 for n in lens)
    return dict(err=err, **time_case(
        label, call, plain, None, "paged_decode_kernel",
        2 * 2 * visible * hkv * d + 2 * 2 * q.numel() + 4 * bt.numel()
        + 4 * b, 4.0 * d * hq * visible))


def jamba_scan_cases() -> dict:
    """mamba_scan at jamba's widths (Di 16384, Ds 16) under h100 plans:
    the prefill from a zero state and decode from a random state written
    in place (== the functional state bit for bit), y at ATOL and the
    final state at SCAN_TOL of the plain scan; each timed, the plain scan
    N_TIMED_PLAIN_SCAN times. Returns {label: row}."""
    import torch
    from repro_torch.benchmarks.common import median_ms
    from repro_torch.configs import get_config
    from repro_torch.core.hw_profiles import H100_SXM
    from repro_torch.core.target import use_target
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba_scan import mamba_scan_plain, scan_work
    cfg = get_config(JAMBA)
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {}
    with use_target("h100"):
        for label, (b, length, random) in JAMBA_SCAN.items():
            args = scan_inputs(gen, di, ds, b, length, torch.bfloat16)
            h0 = scan_state(gen, di, ds, b, random)
            y, h = scan(args, h0)
            want_y, want_h = mamba_scan_plain(*args, h0=h0,
                                              return_state=True)
            name = f"mamba_scan jamba {label} B={b} L={length} Di={di}"
            err = compare(f"{name} y", y, want_y)
            compare(f"{name} final state", h, want_h, SCAN_TOL)
            if random:
                cache = h0.clone()
                y_i, _ = ops.selective_scan(*args, h0=cache,
                                            return_state=True,
                                            state_in_place=True)
                if not (torch.equal(y_i, y) and torch.equal(cache, h)):
                    fail(f"{name}: the state written in place differs "
                         f"from the functional state")
                log(f"  {name}: state in place == functional, bit for "
                    f"bit  ok")
            ms = median_ms(lambda: scan(args, h0), N_TIMED)
            dev = device_ms(lambda: scan(args, h0), "mamba_scan")
            plain = median_ms(lambda: mamba_scan_plain(
                *args, h0=h0, return_state=True), N_TIMED_PLAIN_SCAN)
            n_bytes, exps = scan_work(*args, h0=h0, return_state=True)
            bound, by = bound_ms(n_bytes, exps, H100_SXM.special_ops)
            log(f"  {name}: kernel {ms:.4f} ms (device {dev:.4f} ms), "
                f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}: "
                f"{n_bytes} B, {exps} exp), no library call")
            rows[label] = dict(err=err, ms=ms, device_ms=dev, plain_ms=plain,
                               library_ms=None, bound_ms=bound, bound_by=by)
    return rows


def expert_weights(gen, e, k, n):
    """(e, k, n) bf16 expert weights drawn from ``gen``, one expert at a
    time (an f32 draw of all of them would take 12.9 GB at jamba's)."""
    import torch
    w = torch.empty((e, k, n), dtype=torch.bfloat16, device="cuda")
    for i in range(e):
        w[i] = torch.randn((k, n), generator=gen, device="cuda").mul_(
            k ** -0.5)
    return w


def jamba_gemm_cases() -> dict:
    """grouped_gemm at jamba's widths: 16 experts top-2, routes of a seeded
    router at d 8192 for JAMBA_GEMM_TOKENS; the gate projection (K 8192,
    N 24576) and then the down projection (K 24576, N 8192), each made,
    held and timed alone and freed after (:func:`gemm_case`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(JAMBA)
    d, f, e, top = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(16)
    router = torch.randn((d, e), generator=gen, device="cuda") * d ** -0.5
    routes = {}
    for label, t in JAMBA_GEMM_TOKENS.items():
        x = torch.randn((t, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        _, idx, _ = moe._route(router, x, top)
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        routes[label] = (x[order // top].contiguous(),
                         moe._offsets(flat[order], e))
    out = {}
    for proj, (k, n) in (("gate", (d, f)), ("down", (f, d))):
        w = expert_weights(gen, e, k, n)
        for label, (xs, offs) in routes.items():
            if proj == "down":      # the down projection's rows: f wide
                xs = torch.randn((xs.shape[0], f), generator=gen,
                                 device="cuda").to(torch.bfloat16)
            out[f"{label}_{proj}"] = gemm_case(f"jamba {label} {proj}", xs,
                                               w, offs)
            free_memory()
        del w
        free_memory()
    return out


def check_serving_copy(arch: str, n_layers) -> dict:
    """``Model.init_serving(gen)`` against ``prepare(init(gen))`` on the
    card, bit for bit and dtype for dtype: ``arch`` at its published
    widths, ``n_layers`` deep (None: uncut)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.train.checkpoint import _flatten
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    got = model.init_serving(gen())
    want = model.prepare(model.init(gen()))
    dtypes = [(k, t.dtype) for k, t in _flatten(got)]
    if not (dtypes == [(k, t.dtype) for k, t in _flatten(want)]
            and same_bits(got, want)):
        fail(f"{arch} x {cfg.n_layers}: the serving copy built leaf by leaf "
             f"differs from prepare(init(gen))")
    n_bf16 = sum(d == torch.bfloat16 for _, d in dtypes)
    experts = {str(d) for k, d in dtypes
               if k.rsplit("/", 1)[-1].startswith("we_")}
    gb = sum(t.nbytes for _, t in _flatten(got)) / 1e9
    log(f"  serving copy of {arch} x {cfg.n_layers}: {len(dtypes)} leaves "
        f"({n_bf16} bf16; experts {sorted(experts) or 'none'}), {gb:.2f} GB, "
        f"== prepare(init(gen)) bit for bit  ok")
    del got, want
    free_memory()
    return {"leaves": len(dtypes), "gb": gb}


def jamba_serving_copy(cfg) -> dict:
    """Build jamba's serving copy alone on a drained card and read its
    peak, allocated and reserved, against the reckoning: the copy's bytes
    plus its largest leaf in f32 (the one f32 leaf alive at a time). The
    f32 tree is never whole, so the peak must stay within the reckoning."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.train.checkpoint import _flatten
    free_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_serving(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved()
    leaves = [t for _, t in _flatten(params)]
    served = sum(t.nbytes for t in leaves)
    f32_tree = sum(4 * t.numel() for t in leaves)
    largest = max(4 * t.numel() for t in leaves
                  if t.dtype == torch.bfloat16)
    card = torch.cuda.get_device_properties(0).total_memory
    reckoning = served + largest
    log(f"  serving copy of {cfg.name} x {cfg.n_layers}: {served / 1e9:.2f} "
        f"GB served ({f32_tree / 1e9:.2f} GB as an f32 tree, never made), "
        f"built in {seconds:.2f} s; peak allocated {peak / 1e9:.2f} GB, peak "
        f"reserved {reserved / 1e9:.2f} GB, against the reckoning "
        f"{reckoning / 1e9:.2f} GB (the copy + its largest leaf in f32, "
        f"{largest / 1e9:.2f} GB; reckoned beforehand {JAMBA_RECKONING_GB} "
        f"GB) and the card's {card / 1e9:.2f} GB")
    # 64 MiB: the mamba init's dt temporaries and the allocator's rounding
    if peak > reckoning + 2 ** 26 or reserved > card:
        fail(f"{cfg.name}: the serving copy peaked at {peak / 1e9:.2f} GB "
             f"allocated, {reserved / 1e9:.2f} GB reserved, over its "
             f"reckoning {reckoning / 1e9:.2f} GB")
    del params, leaves
    free_memory()
    return {"served_gb": served / 1e9, "f32_tree_gb": f32_tree / 1e9,
            "reckoning_gb": reckoning / 1e9, "peak_gb": peak / 1e9,
            "reserved_gb": reserved / 1e9, "build_s": seconds}


def jamba_checks(cfg, recs) -> dict:
    """jamba's served tokens against the teacher-forced rule at the served
    batch and pool (every request of the one-shot and the paged stream,
    requests 0 and 1 of the dense stream), and a full-sequence forward on
    the step-by-step pass's routes held to that pass (its logits within
    FORCED_ROUTE_TOL, each sublayer's output within FORCED_SUBLAYER_TOL of
    its largest), with three control faults in the decode steps that must
    fail it: the GQA layer's K and V traded, its ``wo`` through fp8, every
    mamba layer's ``out_proj`` through fp8. Every reading is logged before
    a gate fails."""
    from repro_torch.models.api import build_model
    from repro_torch.serve.scheduler import synthetic_stream
    model = build_model(cfg)
    params = reference_params(cfg)
    stream = synthetic_stream(8, 512, 64, cfg.vocab_size)
    prompts, roomy = one_shot_prompts(cfg), recs["stream"]["outputs"]
    gaps = [served_batch_check(model, params, prompts,
                               recs["one_shot"]["tokens"].numpy(), 4,
                               "one-shot")]
    for rid in range(len(stream)):
        gaps.append(served_batch_check(
            model, params, [stream[rid]["prompt"]], [roomy[rid]], 4,
            f"stream request {rid}", depth=MAX_LEN, page_tokens=16))
    for rid in (0, 1):
        gaps.append(served_batch_check(
            model, params, [stream[rid]["prompt"]],
            [recs["dense"]["outputs"][rid]], 4,
            f"dense stream request {rid}", depth=MAX_LEN))
    tol, sub_tol = FORCED_ROUTE_TOL[JAMBA], FORCED_SUBLAYER_TOL
    n_sub = sum(2 if k.mlp != "none" else 1 for g in cfg.layer_groups()
                for _ in range(g.n_repeat) for k in g.pattern)
    readings = {}

    def gate(label, prompt, toks, fault=None):
        with sublayer_outputs() as rec:
            d, parts, margin = forced_routes(
                model, params, prompt, toks,
                decode_params=fault(params, cfg) if fault else None)
        sub = sublayer_gaps(rec, n_sub, len(toks), len(prompt) - 1)
        worst = max(sub, key=sub.get)
        readings[label] = (d, sub[worst])
        log(f"  {label}: max |d logit| {d:.4f} (gated at {tol}); worst "
            f"sublayer {worst} {sub[worst]:.4f} of its largest output "
            f"(gated at {sub_tol}; " + ", ".join(
                f"{k} {v:.4f}" for k, v in sub.items()) + f"); the "
            f"forward's own routes would part at {parts} positions, "
            f"largest margin {margin:.2e}")

    log("  a full-sequence forward on the step-by-step pass's routes "
        "against that pass: the logits, and each sublayer's output")
    for label, prompt, toks in (
            ("one-shot row 0", prompts[0],
             recs["one_shot"]["tokens"].numpy()[0]),
            ("stream request 0", stream[0]["prompt"], roomy[0]),
            ("stream request 1", stream[1]["prompt"], roomy[1])):
        gate(label, prompt, toks)
    for fault, what in ((swap_kv, "the GQA layer's K and V projections "
                                  "traded"),
                        (fp8_wo, "the GQA layer's wo rounded through "
                                 "fp8-e4m3"),
                        (fp8_out_proj, "the mamba layers' out_proj rounded "
                                       "through fp8-e4m3")):
        gate(f"control {fault.__name__} (stream request 0; in the decode "
             f"steps, {what})", stream[0]["prompt"], roomy[0], fault)
    sound = {k: v for k, v in readings.items() if not k.startswith("control")}
    for label, (d, sub) in readings.items():
        passes = d <= tol and sub <= sub_tol
        if passes != (label in sound):
            fail(f"{JAMBA} {label}: the forced-route gate "
                 f"{'passes' if passes else 'fails'} it (logits {d:.4f}, "
                 f"sublayer {sub:.4f})")
    del params, model
    free_memory()
    return {"teacher_forced_gap": max(gaps),
            "forced_route_gap": max(d for d, _ in sound.values()),
            "forced_sublayer_gap": max(sub for _, sub in sound.values()),
            "forced_route_controls": {k: v for k, v in readings.items()
                                      if k not in sound}}


def jamba_served() -> dict:
    """jamba at its published widths cut to JAMBA_LAYERS layers, served
    through the launcher (``cli.run(argv, cfg=<cut>)``) under its h100
    default: its serving copy's peak; the one-shot, the paged stream, the
    dense stream and the squeezed paged stream, launches counted around
    each; the squeezed stream's tokens == the roomy one's bit for bit;
    every greedy token of the one-shot and the paged stream (and requests
    0 and 1 of the dense stream) held to teacher-forced passes at the
    served batch and pool; a full-sequence forward on the step-by-step
    pass's routes held to it, and three control faults in the decode
    steps that must fail that gate (:func:`jamba_checks`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.target import use_target
    from repro_torch.serve.scheduler import kv_bytes_per_token
    full = get_config(JAMBA)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    groups = ", ".join(
        f"{g.name} x {g.n_repeat} ("
        + ", ".join(f"{k.attn} + {k.mlp}" for k in g.pattern) + ")"
        for g in cfg.layer_groups())
    argv = ["--arch", JAMBA, "--full"]
    log(f"  {JAMBA} served at its published widths, {JAMBA_LAYERS} of "
        f"{full.n_layers} layers ({groups}): " + " ".join(argv))
    out = {"copy": jamba_serving_copy(cfg)}
    torch.cuda.reset_peak_memory_stats()
    recs = {"one_shot": one_shot(cfg, argv + ONE_SHOT_ARGS, "one-shot")}
    out["one_shot_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  one-shot: peak device memory {out['one_shot_peak_gb']:.2f} GB "
        f"(the serving copy and the one-shot)")
    free_memory()
    recs["stream"] = run_stream(cfg, argv + STREAM_ARGS, "stream")
    if not all(recs["stream"]["launches"][k] > 0
               for k in ("flash", "paged", "scan", "grouped")):
        fail(f"{JAMBA} paged stream: a kernel of its path did not launch: "
             f"{recs['stream']['launches']}")
    free_memory()
    recs["dense"] = run_stream(cfg, argv + DENSE_STREAM_ARGS, "dense stream")
    free_memory()
    layer0 = kv_bytes_per_token(cfg) * 16 * JAMBA_SQUEEZED_PAGES
    recs["squeezed"] = run_stream(cfg, argv + STREAM_ARGS + [
        "--layer0-bytes", str(layer0)], "squeezed")
    check_squeezed("squeezed stream", recs["squeezed"])
    roomy, squeezed = recs["stream"]["outputs"], recs["squeezed"]["outputs"]
    differ = [rid for rid, toks in roomy.items()
              if squeezed.get(rid) != toks]
    if differ or len(squeezed) != len(roomy):
        fail(f"{JAMBA} squeezed stream: requests {differ} emit other tokens "
             f"than the roomy stream")
    log(f"  squeezed stream: all {len(roomy)} requests emit the roomy "
        f"stream's tokens bit for bit")
    free_memory()
    with use_target(SERVING_TARGET):       # mamba_scan plans on the card
        out.update(jamba_checks(cfg, recs))
    out["recs"] = recs
    return out


def phase_jamba(phase: int) -> dict:
    """jamba-1.5-large-398b at its published widths: its four kernels
    alone (flash, paged decode, mamba_scan and grouped_gemm, each held
    against its plain version and timed beside its bound and its library
    call where there is one); the serving copy against prepare(init(gen))
    bit for bit where both fit (SERVING_COPY_CHECKS); then the model cut to
    JAMBA_LAYERS layers served through the launcher (:func:`jamba_served`).
    Prints the phase's seconds."""
    t0 = time.perf_counter()
    log(f"[{phase}/17] {JAMBA} at its published widths: its kernels, then "
        f"the model at {JAMBA_LAYERS} layers served")
    out = {"flash": jamba_flash_case(), "paged": jamba_paged_case()}
    free_memory()
    out["scan"] = jamba_scan_cases()
    free_memory()
    out["gemm"] = jamba_gemm_cases()
    free_memory()
    out["serving_copy"] = {arch: check_serving_copy(arch, n)
                           for arch, n in SERVING_COPY_CHECKS}
    out["served"] = jamba_served()
    out["seconds"] = time.perf_counter() - t0
    log(f"  {JAMBA}: the phase took {out['seconds']:.1f} s")
    return out


#: the counters of the world-1 mesh stream that must equal the single-device
#: paged stream's
MESH_COUNTERS = ("n_requests", "completed", "n_tokens", "host_syncs",
                 "chunks", "admissions", "decode_steps_total", "n_slots",
                 "preemptions", "spilled_pages", "restores", "n_pages",
                 "pages_high_water", "pool_bytes", "ttft_steps_p50",
                 "ttft_steps_p95", "e2e_steps_p50", "e2e_steps_p95")


def phase_mesh(phase: int, cfg, single: dict, deepseek: dict) -> dict:
    """The mesh path on one card, through ``launch.serve.run(... +
    ["--mesh", "1"])`` on NCCL world 1 (a process group of its own, every
    collective over one rank): qwen2.5-3b at full width (the row-parallel
    sums, the vocabulary-parallel embedding and greedy merge, the int8
    scale max), then deepseek-v2-236b cut to DEEPSEEK's depth (MLA's
    head-sharded layer over the whole latent, the expert-parallel MoE and
    the shared experts' tensor-parallel SwiGLU, each over one rank). Each
    stream's launches by phase 5's rules, host syncs == chunks, and its
    tokens, scheduler counters and launches bit for bit those of the
    single-device paged stream of phase 5 (``single``) and phase 9
    (``deepseek``) on the same requests; the pooled decode's range walks
    never run at world 1. Prints the phase's seconds."""
    import dataclasses
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    log(f"[{phase}/17] the mesh path: qwen2.5-3b and {DEEPSEEK[0]} x "
        f"{DEEPSEEK[1]} served through --mesh 1 (NCCL world 1)")
    ds_cfg = dataclasses.replace(get_config(DEEPSEEK[0]),
                                 n_layers=DEEPSEEK[1])
    out = {name: mesh_stream(f"{name} mesh 1 stream", c, argv, want)
           for name, c, argv, want in (
               ("qwen", cfg, STREAM, single),
               ("deepseek", ds_cfg, ["--arch", DEEPSEEK[0], "--full"]
                + STREAM_ARGS, deepseek))}
    seconds = time.perf_counter() - t0
    log(f"  the phase took {seconds:.1f} s")
    return {"rec": out["qwen"], "deepseek": out["deepseek"],
            "launches": out["qwen"]["launches"], "seconds": seconds}


def mesh_stream(label, cfg, argv, want) -> dict:
    """``argv``'s paged stream served through ``--mesh 1`` on NCCL world 1,
    held to the single-device stream ``want`` in every token, the
    MESH_COUNTERS and the launches."""
    t0 = time.perf_counter()
    rec = run_stream(cfg, argv + ["--mesh", "1"], label)
    if rec.get("mesh") != {"data": 1, "model": 1, "kv_shards": 1}:
        fail(f"{label}: mesh record {rec.get('mesh')}")
    if rec["outputs"] != want["outputs"]:
        parted = [r for r in rec["outputs"]
                  if rec["outputs"][r] != want["outputs"].get(r)]
        fail(f"{label}: requests {parted} differ from the single-device "
             f"paged stream")
    differ = {k: (rec[k], want[k]) for k in MESH_COUNTERS
              if rec[k] != want[k]}
    if differ or rec["launches"] != want["launches"]:
        fail(f"{label}: counters {differ} or launches {rec['launches']} vs "
             f"{want['launches']} differ from the single-device paged "
             f"stream")
    log(f"  {label}: every token, {len(MESH_COUNTERS)} counters and the "
        f"launches equal the single-device paged stream's  ok; "
        f"{rec['tok_per_s']:.1f} tok/s against {want['tok_per_s']:.1f}; "
        f"{time.perf_counter() - t0:.1f} s")
    free_memory()
    return rec


def jamba_rows(jamba) -> list:
    """The kernels line's rows at jamba's widths: (name, library, replaces,
    launches on jamba's paged stream, timing)."""
    scan_row = dict(jamba["scan"]["prefill"], extra={
        f"decode_{key}": value for key, value
        in jamba["scan"]["decode"].items()})
    gemm = jamba["gemm"]
    gemm_row = dict(gemm["prefill_gate"], extra={
        f"{label}_{key}": value for label, case in gemm.items()
        for key, value in case.items()})
    counts = jamba["served"]["recs"]["stream"]["launches"]
    return [("flash_attention_jamba", "flash_attention",
             "src/repro/kernels/flash_attention.py:30", counts["flash"],
             jamba["flash"]),
            ("paged_flash_decode_jamba", "paged_attention",
             "src/repro/kernels/paged_attention.py:154", counts["paged"],
             jamba["paged"]),
            ("mamba_scan_jamba", "mamba_scan",
             "src/repro/kernels/mamba_scan.py:29", counts["scan"], scan_row),
            ("grouped_gemm_jamba", "grouped_gemm",
             "src/repro/models/moe.py:145", counts["grouped"], gemm_row)]


def grouped_gemm_row(moe_runs, rank) -> dict:
    """The kernels line's grouped_gemm timing: qwen3-moe's 1024-token
    admission through the gate projection, every other case beside it,
    phase 3's expert-parallel rank shapes (``rank``) with their digests,
    the bodies the expert-parallel layer took at world 1, each bit for bit
    the grouped layer, and its ranks' shares on 1 x 2 and 1 x 4, for
    qwen3-moe and deepseek-v2 (its shared experts' shares too)."""
    cases = {f"{arch} {key[5:]}": case for arch, run in moe_runs.items()
             for key, case in run["moe"].items() if key.startswith("gemm_")}
    cases.update(rank["cases"])
    main = cases[f"{QWEN_MOE[0]} prefill_gate"]
    extra = {f"{label}_{key}": value for label, case in cases.items()
             for key, value in case.items()}
    extra.update(rank_max_rel_err=rank["err"], rank_digests=rank["digests"],
                 ep_world1_bit_equal_grouped={
                     arch: {str(t): body for t, body in
                            run["moe"]["ep_world1"].items()}
                     for arch, run in moe_runs.items()},
                 ep_rank_shares={arch: run["moe"]["ep_ranks"]
                                 for arch, run in moe_runs.items()})
    return dict(main, extra=extra)


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
    bench = phase_serve_bench(cfg)
    check_merge_counters("phase 6")
    free_memory()
    falcon = phase_falcon(fcfg)
    check_merge_counters("phase 7")
    free_memory()
    moe_runs = {}
    for phase, (arch, n_layers) in ((8, QWEN_MOE), (9, DEEPSEEK)):
        moe_runs[arch] = phase_moe(arch, n_layers, phase)
        check_merge_counters(f"phase {phase}")
        free_memory()
    gemma = phase_gemma(10)
    check_merge_counters("phase 10")
    free_memory()
    families = phase_families(11)
    check_merge_counters("phase 11")
    free_memory()
    paper = phase_paper()
    check_merge_counters("phase 12")
    log("[13/17] where the time goes: torch.profiler (CUDA activity)")
    phase_profile(cfg)
    phase_profile(cfg, kv_quant="int8")
    phase_profile(fcfg)
    check_merge_counters("phase 13")
    free_memory()
    train = phase_train(14)
    check_merge_counters("phase 14")
    free_memory()
    jamba = phase_jamba(15)
    check_merge_counters("phase 15")
    free_memory()
    mesh = phase_mesh(16, cfg, rec,
                      moe_runs[DEEPSEEK[0]]["recs"]["stream"])
    check_merge_counters("phase 16")
    if bench["failed"]:
        fail(f"serve_bench outputs gates: {bench['failed']}")

    log(f"[17/17] summary ({time.perf_counter() - t_start:.0f} s)")
    rows = [("flash_attention", "flash_attention",
             "src/repro/kernels/flash_attention.py:30",
             rec["launches"]["flash"], timing["flash"]),
            ("paged_flash_decode", "paged_attention",
             "src/repro/kernels/paged_attention.py:154",
             rec["launches"]["paged"], timing["paged"]),
            ("matmul3d", "matmul3d", "src/repro/kernels/matmul3d.py:32",
             paper["launches"], timing["matmul3d"]),
            ("mamba_scan", "mamba_scan", "src/repro/kernels/mamba_scan.py:29",
             falcon["launches"], timing["mamba_scan"]),
            # the same kernel at MLA's widths: deepseek-v2's paged stream
            ("flash_attention_d192_dv128", "flash_attention",
             "src/repro/kernels/flash_attention.py:30",
             moe_runs[DEEPSEEK[0]]["recs"]["stream"]["launches"]["flash_d192"],
             timing["flash_mla"]),
            # at seamless-m4t-medium's head_dim: its one-shot
            ("flash_attention_d64_dv64", "flash_attention",
             "src/repro/kernels/flash_attention.py:30",
             families[f"{SEAMLESS[0]} one_shot"]["launches"]["flash_d64"],
             timing["flash_d64"]),
            # the training examples' head dims: quickstart's run, and
            # elastic_restart's on NCCL world 1
            ("flash_attention_d32_dv32", "flash_attention",
             "src/repro/kernels/flash_attention.py:30",
             train["examples"]["quickstart"]["launches"]["flash_d32"],
             timing["flash_d32"]),
            ("flash_attention_d16_dv16", "flash_attention",
             "src/repro/kernels/flash_attention.py:30",
             train["examples"]["elastic"]["launches"]["flash_d16"],
             timing["flash_d16"]),
            # the reference's ragged_dot (XLA, no Pallas kernel): qwen3-moe's
            # paged stream; timed at its 1024-token admission's gate GEMM
            ("grouped_gemm", "grouped_gemm", "src/repro/models/moe.py:145",
             moe_runs[QWEN_MOE[0]]["recs"]["stream"]["launches"]["grouped"],
             grouped_gemm_row(moe_runs, timing["grouped_rank"]))]
    # jamba's widths: each kernel's launches on jamba's own paged stream
    jamba_path = f"the {JAMBA} x {JAMBA_LAYERS} paged stream"
    launches_path = {
        "flash_attention_d32_dv32": f"repro_torch.examples.quickstart, "
                                    f"{QUICKSTART_STEPS} steps",
        "flash_attention_d16_dv16": "repro_torch.examples.elastic_restart "
                                    "on NCCL world 1, 60 steps"}
    for row in jamba_rows(jamba):
        rows.append(row)
        launches_path[row[0]] = jamba_path
    # MLA's rank check at one full-width layer (phase 9) beside the d192
    # row's rank shapes (phase 3)
    kernels_d192 = timing["flash_mla"]
    kernels_d192["extra"]["mla_rank_check"] = moe_runs[DEEPSEEK[0]]["moe"][
        "mla_ranks"]
    # the pooled decode's range walk: the paged kernel with a start and an
    # lse; its launches are the kernel's on the world-1 mesh stream (whose
    # range walks are 0: the pooled decode runs at a model axis above 1)
    rows.append(("paged_flash_decode_range_lse", "paged_attention",
                 "src/repro/kernels/paged_attention.py:154",
                 mesh["launches"]["paged"], timing["paged_range"]))
    launches_path["paged_flash_decode_range_lse"] = (
        "the qwen2.5-3b --mesh 1 paged stream (NCCL world 1); range walks "
        f"{mesh['launches']['paged_range']}")
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
        if "digests" in t:
            row["digests"] = t["digests"]
        grad = train["checks"].get({"flash_attention": "flash",
                                    "mamba_scan": "scan",
                                    "grouped_gemm": "grouped"}.get(name))
        if grad:    # the autograd Function's check and its plain backward
            row.update(grad_check_max_rel_err=grad["grad_err"],
                       backward_plain_ms=grad["backward_plain_ms"])
        if name == "flash_attention":
            row["train_launches_per_step"] = (train["launches"]["flash"]
                                              // TRAIN_STEPS)
        if name == "grouped_gemm":    # qwen3-moe trained on the card
            row["train_launches_per_step"] = (
                train["moe"]["launches"]["grouped"] // MOE_TRAIN_STEPS)
            row["train_plain_backward_per_step"] = (
                train["moe"]["grouped_plain_backward_calls"]
                // MOE_TRAIN_STEPS)
        if name in launches_path:
            row["launches_path"] = launches_path[name]
        kernels.append(row)
    # every stream's own counts, each read around that stream alone
    by_path = {f"qwen {name}": r["launches"] for name, r in streams.items()}
    by_path.update({f"falcon {name}": falcon[name]["launches"]
                    for name in ("stream", "dense")})
    by_path["qwen serve_bench"] = bench["launches"]
    by_path.update({f"{arch} {name}": r["launches"]
                    for arch, run in moe_runs.items()
                    for name, r in run["recs"].items()})
    by_path.update({f"{GEMMA[0]} {name}": r["launches"]
                    for name, r in gemma["recs"].items()})
    by_path.update({path: r["launches"] for path, r in families.items()
                    if path != "seconds"})
    by_path["qwen train"] = train["launches"]
    by_path["quickstart train"] = train["examples"]["quickstart"]["launches"]
    by_path["elastic_restart train"] = train["examples"]["elastic"][
        "launches"]
    by_path[f"{QWEN_MOE[0]} x {MOE_TRAIN_LAYERS} train"] = train["moe"][
        "launches"]
    by_path.update({f"{JAMBA} x {JAMBA_LAYERS} {name}": r["launches"]
                    for name, r in jamba["served"]["recs"].items()})
    by_path["qwen mesh 1"] = mesh["launches"]
    by_path[f"{DEEPSEEK[0]} mesh 1"] = mesh["deepseek"]["launches"]
    for row, key in zip(kernels, ("flash", "paged", None, "scan",
                                  "flash_d192", "flash_d64", "flash_d32",
                                  "flash_d16", "grouped",
                                  "flash", "paged", "scan", "grouped",
                                  "paged_range")):
        if key:
            row["launches_by_path"] = {path: c.get(key)
                                       for path, c in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
