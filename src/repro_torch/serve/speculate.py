"""Self-drafting speculative decoding: proposer + acceptance folding.

The counterpart of ``src/repro/serve/speculate.py``. Per drain boundary the
host proposes up to k draft tokens per live slot from the slot's own
prompt + emitted history (prompt lookup, no second model), the engine
scores them all in ONE width-(k+1) verify forward
(:meth:`repro_torch.models.api.Model.verify_step`), and
:func:`fold_acceptance` turns per-slot greedy agreement into the pool's
done-masked updates. Logits column ``j`` of the verify forward is what the
``j``-th sequential decode step would produce, so every emitted token is
the argmax given its true prefix.

Host/device split: :func:`propose_ngram` is numpy and runs at drain
boundaries, where the host already owns a sync (a copy of the reference's:
its module imports JAX). :func:`fold_acceptance` is torch and runs on the
device inside the verify chunk, under the engine's ``device_only`` guard:
no host read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def propose_ngram(context: np.ndarray, k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> np.ndarray:
    """Prompt-lookup draft proposal: continue the most recent repeat.

    Finds the latest earlier occurrence of the context's trailing n-gram
    (longest ``max_ngram``..``min_ngram`` first) and proposes the up-to-k
    tokens that followed it; among the hits, the most recent one whose
    continuation supplies all k tokens wins (on a short-period cycle the
    latest hits sit so close to the end that their continuation is cut).
    No match proposes nothing, and the boundary degrades to an ordinary
    single-token step. Proposals are guesses: the verify forward decides.
    """
    ctx = np.asarray(context, np.int32)
    n = int(ctx.shape[0])
    if k <= 0 or n < min_ngram + 1:
        return np.zeros((0,), np.int32)
    for g in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        tail = ctx[n - g:]
        windows = np.lib.stride_tricks.sliding_window_view(ctx, g)
        # candidate starts strictly before the trailing occurrence, so a
        # continuation of at least one token exists
        hits = np.nonzero((windows[:n - g] == tail).all(axis=1))[0]
        if hits.size:
            full = hits[hits + g + k <= n]
            start = int(full[-1] if full.size else hits[-1]) + g
            return ctx[start:start + k].copy()
    return np.zeros((0,), np.int32)


@dataclasses.dataclass
class FoldResult:
    """On-device result of folding verify targets against drafts."""

    valid: torch.Tensor      # (S, k+1) bool — token j of this slot is emitted
    emitted: torch.Tensor    # (S,) int32 — tokens emitted = accepted + 1
    tok: torch.Tensor        # (S,) int32 — new last-emitted token per slot
    done: torch.Tensor       # (S,) bool — done mask after the fold
    n_gen: torch.Tensor      # (S,) int32
    cache_len: torch.Tensor  # (S,) int32 — rolled-back frontier


def fold_acceptance(targets: torch.Tensor, drafts: torch.Tensor,
                    draft_len: torch.Tensor, *, done: torch.Tensor,
                    n_gen: torch.Tensor, budget: torch.Tensor,
                    cache_len: torch.Tensor, max_len: int,
                    eos_token: int) -> FoldResult:
    """Fold greedy verify targets into the pool's done-masked updates.

    ``targets[:, j]`` is the argmax after feeding token ``j`` of the verify
    chunk (the slot's last token, then its drafts); ``drafts`` is ``(S, k)``
    with ``draft_len`` proposed entries per slot. A slot emits the longest
    prefix of drafts that matches the targets plus one correction token —
    exactly what as many sequential single-token steps would emit, stop
    rules included: nothing past the first rejection, nothing past an
    emitted EOS, an exhausted ``budget`` or a full ``max_len`` slot.
    ``cache_len`` advances by the emitted count, so the rejected suffix's
    K/V sits at or past the frontier, masked like any stale row.

    Device ops only (cumprod / cumsum / take_along_dim / where): no host
    read.
    """
    k = drafts.shape[1]
    dev = targets.device
    idx = torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :]
    match = ((targets[:, :k] == drafts)
             & (torch.arange(k, dtype=torch.int32, device=dev)[None, :]
                < draft_len[:, None]))
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    # stop[:, j]: emitting token j makes the slot done (the predicate the
    # single-token loop applies after its j-th step)
    stop = ((targets == eos_token)
            | (n_gen[:, None] + idx + 1 >= budget[:, None])
            | (cache_len[:, None] + idx + 1 >= max_len))
    stop_i = stop.to(torch.int32)
    stops_before = torch.cumsum(stop_i, dim=1) - stop_i
    valid = ((~done[:, None]) & (idx <= accepted[:, None])
             & (stops_before == 0))
    emitted = valid.sum(dim=1).to(torch.int32)
    last = torch.clamp(emitted - 1, min=0).long()[:, None]
    last_tok = torch.take_along_dim(targets, last, dim=1)[:, 0]
    tok = torch.where(emitted > 0, last_tok.to(torch.int32),
                      eos_token).to(torch.int32)
    stop_last = torch.take_along_dim(stop, last, dim=1)[:, 0]
    return FoldResult(valid=valid, emitted=emitted, tok=tok,
                      done=done | ((emitted > 0) & stop_last),
                      n_gen=n_gen + emitted, cache_len=cache_len + emitted)
