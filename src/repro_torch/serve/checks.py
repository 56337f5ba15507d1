"""Greedy-token checks for streams whose GEMMs see other row counts.

On the card cuBLAS picks a GEMM's algorithm by its row count M, so a
prompt prefilled in chunks, a suffix over shared prefix pages or a
width-(k+1) verify forward may round its logits differently from the
whole-prompt, single-token run, and a near-tie greedy token may part
between two streams that are both right. Such streams are held by the
teacher-forced rule instead of token equality: each greedy token must be
within ``LOGIT_TOL`` of the best logit of ONE full-sequence forward of the
same model (no caches) over the prompt and the tokens before it.
``chip_smoke.py``, ``repro_torch.benchmarks.serve_bench`` and
``repro_torch.benchmarks.mesh_probe`` share this copy (under a serving
mesh the forward runs on the rank's shards, its logits gathered whole).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import encdec, layers, transformer
from repro_torch.models.config import ModelConfig

LOGIT_TOL = 0.05           # f32 logits


def teacher_forced_gap(cfg: ModelConfig, params: Any,
                       prompt: Sequence[int], tokens: Sequence[int], *,
                       frontend_embeds=None, src_embeds=None) -> float:
    """The largest amount by which a greedy token of ``tokens`` (emitted
    after ``prompt``) falls below the best logit of one full-sequence
    forward at its position. ``params`` are prepared serving params
    (``Model.prepare``, as ``Engine.params`` holds them); the forward runs
    on their device. A frontend model's forward takes the row's
    ``frontend_embeds`` (1, Sf, d) before the text; an enc-dec model's
    decoder reads the encoder's output of ``src_embeds`` (1, Ss, d)."""
    device = params["tok"]["embed"].device
    seq = torch.as_tensor(list(prompt) + list(tokens[:-1]), dtype=torch.int32,
                          device=device)[None]
    start, vocab = len(prompt) - 1, cfg.vocab_size
    if cfg.family == "encdec":
        x, _ = encdec.decode(cfg, params, seq,
                             encdec.encode(cfg, params, src_embeds))
    else:
        x, _, _ = transformer.forward(cfg, params, seq,
                                      frontend_embeds=frontend_embeds)
        start += x.shape[1] - seq.shape[1]      # past the frontend
    logits = tp.gather_logits(layers.unembed_logits(params["tok"],
                                                    x[0, start:]),
                              cfg.padded_vocab)[:, :vocab]
    picked = logits.gather(1, torch.as_tensor(
        [int(t) for t in tokens], device=device)[:, None].long())[:, 0]
    return (logits.max(dim=1).values - picked).max().item()


def teacher_forced_check(cfg: ModelConfig, params: Any,
                         prompt: Sequence[int], tokens: Sequence[int],
                         label: str, tol: float = LOGIT_TOL,
                         **inputs) -> float:
    """:func:`teacher_forced_gap` (``inputs``: its ``frontend_embeds`` or
    ``src_embeds``), raising ``SystemExit`` past ``tol``; returns the
    gap."""
    gap = teacher_forced_gap(cfg, params, prompt, tokens, **inputs)
    if not gap <= tol:
        raise SystemExit(
            f"{label}: a greedy token is {gap:.4f} below the teacher-forced "
            f"best logit (tolerance {tol})")
    return gap
