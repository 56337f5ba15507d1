"""GQA attention (+ sliding window, RoPE) with in-place KV caches.

The counterpart of the GQA branch of ``src/repro/models/attention.py``.
Two cache layouts share the math:

  * **dense slot slab** — ``(B, Hkv, max_len, D)``, one worst-case-deep
    slab per row. This is the oracle path.
  * **paged pool** — ``(n_pages, Hkv, page_tokens, D)``, a flat page pool
    addressed through per-slot block tables. Writes resolve ``cache_len ->
    (physical page, offset)`` through the block table; reads walk the table
    (:mod:`repro_torch.kernels.paged_attention`).

Unlike the reference's functional arrays, cache writes here update the
cache tensors IN PLACE (they are views into the stacked per-group arrays,
so a write lands in the pool the caller holds) and the same dict is
returned. Everything the caller needs for ordering is that a write happens
before the attention that reads it, which program order gives.

MLA (``deepseek-v2``), M-RoPE (``qwen2-vl``) and cross-attention are later
slices (ROADMAP A7).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import tiling
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (decode_attention_masked,
                                                 paged_decode_attention)
from repro_torch.models import layers
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.layers import linear, randn


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor, cache_len,
                 axis: int) -> torch.Tensor:
    """Write ``new`` into the cache at position ``cache_len``, in place.

    ``cache_len`` is a python int (prefill: a static slice) or, for a
    single-token ``new``, a 0-d tensor (one-shot decode: every row at one
    offset) or a per-row ``(B,)`` tensor (each slot at its own depth).
    Tensor offsets stay on the device: a masked select, never a host read.
    Multi-token appends at tensor offsets (the speculative verify chunk)
    come with ROADMAP A6.
    """
    new = new.to(cache_arr.dtype)
    s = new.shape[axis]
    if not torch.is_tensor(cache_len):
        idx = [slice(None)] * cache_arr.ndim
        idx[axis] = slice(cache_len, cache_len + s)
        cache_arr[tuple(idx)] = new
        return cache_arr
    if s != 1:
        raise NotImplementedError(
            "multi-token appends at device-side offsets (speculative "
            "verify) are not ported yet (ROADMAP A6)")
    shape = [1] * cache_arr.ndim
    shape[axis] = cache_arr.shape[axis]
    iota = torch.arange(cache_arr.shape[axis],
                        device=cache_arr.device).reshape(shape)
    if cache_len.ndim == 1:          # per-slot lengths over batch axis 0
        cache_len = cache_len.reshape((-1,) + (1,) * (cache_arr.ndim - 1))
    cache_arr.copy_(torch.where(iota == cache_len, new, cache_arr))
    return cache_arr


def _paged_cache_write(pages: torch.Tensor, new: torch.Tensor,
                       cache_len: torch.Tensor, block_tables: torch.Tensor,
                       axis: int) -> torch.Tensor:
    """Block-table-aware token append into the paged pool, in place.

    ``pages`` is ``(n_pages, *page_shape)`` with the token axis at ``axis``
    inside a page (GQA: 1); ``new`` is ``(B, ..., s, ...)``. Row token
    ``j`` resolves ``cache_len + j -> (physical page, offset)`` through the
    row's block table; rows whose frontier is at or past the mapped depth
    write to the null page 0. Pages written here are private to the row by
    scheduler invariant.
    """
    pt = pages.shape[1 + axis]
    p_max = block_tables.shape[1]
    s = new.shape[1 + axis]
    new = new.to(pages.dtype)
    cache_len = cache_len.long()
    for j in range(s):
        pos = cache_len + j
        logical = torch.clamp(pos // pt, max=p_max - 1)
        phys = torch.gather(block_tables.long(), 1, logical[:, None])[:, 0]
        phys = torch.where(pos < p_max * pt, phys, 0)
        off = pos % pt
        if axis == 0:
            pages[phys, off] = new[:, j]
        else:
            pages[phys, :, off] = new[:, :, j]
    return pages


# ---------------------------------------------------------------------- GQA

def init_gqa(cfg: ModelConfig, gen: torch.Generator, n: int = 1) -> Dict:
    """GQA weights, stacked ``n`` deep on a leading axis."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": randn(gen, (n, d, hq * hd), s),
        "wk": randn(gen, (n, d, hkv * hd), s),
        "wv": randn(gen, (n, d, hkv * hd), s),
        "wo": randn(gen, (n, hq * hd, d), 1.0 / math.sqrt(hq * hd)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((n, width), dtype=torch.float32,
                                  device=gen.device)
    return p


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=torch.bfloat16) -> Dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_gqa_pages(cfg: ModelConfig, n_pages: int, page_tokens: int, device,
                   dtype=torch.bfloat16) -> Dict:
    """Flat page pool replacing the per-slot slab (page 0 = null page)."""
    shape = (n_pages, cfg.n_kv_heads, page_tokens, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_attention(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
                  kind: LayerKind,
                  positions: torch.Tensor,
                  cache: Optional[Dict] = None,
                  cache_len=None,
                  causal: bool = True,
                  plan: Optional[tiling.AttentionPlan] = None,
                  block_tables: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). Returns (out, cache).

    Modes: prefill (cache given with an int ``cache_len``: the prompt's K/V
    land in the cache and attention runs over the whole cache depth through
    :func:`repro_torch.kernels.ops.attention`); dense decode (tensor
    ``cache_len``: the masked oracle over the slab); paged decode
    (``block_tables`` given: block-table write, page-walk attention).
    Without a cache (training-style forward) attention runs over ``x``.
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = linear(x, p["wq"], p.get("bq")).reshape(b, s, hq, hd).transpose(1, 2)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, s, hkv, hd).transpose(1, 2)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, s, hkv, hd).transpose(1, 2)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and block_tables is not None:
        if "k_scale" in cache:
            raise NotImplementedError(
                "quantized KV pools are not ported yet (ROADMAP A6)")
        _paged_cache_write(cache["k"], k, cache_len, block_tables, axis=1)
        _paged_cache_write(cache["v"], v, cache_len, block_tables, axis=1)
        out = paged_decode_attention(q, cache["k"], cache["v"], block_tables,
                                     cache_len, window=kind.window,
                                     causal=causal)
        out = out.transpose(1, 2).reshape(b, s, hq * hd)
        return linear(out, p["wo"]), cache

    q_offset = 0
    if cache is not None:
        k = _cache_write(cache["k"], k, cache_len, axis=2)
        v = _cache_write(cache["v"], v, cache_len, axis=2)
        q_offset = cache_len

    if torch.is_tensor(q_offset):
        # decode with a device-side offset: direct masked attention over
        # the cache
        out = decode_attention_masked(q, k, v, q_offset, window=kind.window,
                                      causal=causal)
    else:
        out = ops.attention(q, k, v, causal=causal, window=kind.window,
                            q_offset=q_offset, plan=plan)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return linear(out, p["wo"]), cache
