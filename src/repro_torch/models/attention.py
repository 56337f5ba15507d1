"""GQA attention (+ sliding window, RoPE) and multi-head latent attention
(MLA) with in-place KV caches.

The counterpart of ``src/repro/models/attention.py``'s GQA and MLA
branches. Two cache layouts share the math:

  * **dense slot slab** — ``(B, Hkv, max_len, D)``, one worst-case-deep
    slab per row. This is the oracle path.
  * **paged pool** — ``(n_pages, Hkv, page_tokens, D)``, a flat page pool
    addressed through per-slot block tables. Writes resolve ``cache_len ->
    (physical page, offset)`` through the block table; reads walk the table
    (:mod:`repro_torch.kernels.paged_attention`). A quantized pool stores
    int8 codes with one f32 scale per page (sibling ``k_scale`` /
    ``v_scale`` leaves) or fp8-e4m3 values, and its reads dequantize after
    the gather.

Unlike the reference's functional arrays, cache writes here update the
cache tensors IN PLACE (they are views into the stacked per-group arrays,
so a write lands in the pool the caller holds) and the same dict is
returned. Everything the caller needs for ordering is that a write happens
before the attention that reads it, which program order gives.

MLA caches only the compressed latent (``ckv``) and the one shared RoPE
key head (``krope``): ``(B, max_len, width)`` on the slab, ``(n_pages,
page_tokens, width)`` in the pool. GQA also takes M-RoPE position streams
(``qwen2-vl``) and precomputed cross-attention K/V (the enc-dec decoder).

Under a serving mesh (``distributed.tensor_parallel``) GQA is
tensor-parallel over ``model``, as the reference places it: where the KV
heads divide the axis a rank projects, caches and attends over its own
query and KV heads (column shards of ``wq`` / ``wk`` / ``wv``) and ``wo`` is
a row-parallel product; where they do not, the rank's q / k / v columns
are gathered whole, the caches are whole on every rank, prefill runs
replicated, and decode is pooled: each rank attends over its range of
every slot's positions (``paged_attention.decode_range``) and the ranks'
(output, log-sum-exp) pairs merge in rank order
(``paged_attention.merge_ranges``), the reference's flash-decoding across
chips. MLA shards its heads over ``model`` and keeps the latent whole,
as the reference's absorbed decode does where the heads divide the axis:
a rank projects, decompresses and attends over its ``n_heads / M`` heads
(column shards of ``wq_b`` / ``wkv_b``; ``wq_a``'s column shard gathered
whole for the q norm), every rank computes and caches the same latent
(``wkv_a`` whole), and ``wo`` is a row-parallel product.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import tiling
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (FP8, INT8_QMAX, as_bits,
                                                 decode_attention_lse,
                                                 decode_attention_masked,
                                                 decode_range,
                                                 gather_kv_pages,
                                                 merge_ranges,
                                                 paged_decode_attention)
from repro_torch.models import layers
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.layers import cast, linear, randn


def _cache_write(cache_arr: torch.Tensor, new: torch.Tensor, cache_len,
                 axis: int) -> torch.Tensor:
    """Write ``new`` into the cache at position ``cache_len``, in place.

    ``cache_len`` is a python int (prefill: a static slice), a 0-d tensor
    (one-shot decode: every row at one offset) or a per-row ``(B,)`` tensor
    (each slot at its own depth). Tensor offsets stay on the device: a
    masked select, never a host read. A multi-token ``new`` at tensor
    offsets (the speculative verify chunk, k+1 rows a slot) is the
    reference's masked gather-select: position ``cache_len + j`` takes row
    ``j``, and rows that would land past the cache depth fall outside the
    iota mask.
    """
    new = new.to(cache_arr.dtype)
    s = new.shape[axis]
    if not torch.is_tensor(cache_len):
        idx = [slice(None)] * cache_arr.ndim
        idx[axis] = slice(cache_len, cache_len + s)
        cache_arr[tuple(idx)] = new
        return cache_arr
    shape = [1] * cache_arr.ndim
    shape[axis] = cache_arr.shape[axis]
    iota = torch.arange(cache_arr.shape[axis],
                        device=cache_arr.device).reshape(shape)
    if cache_len.ndim == 1:          # per-slot lengths over batch axis 0
        cache_len = cache_len.reshape((-1,) + (1,) * (cache_arr.ndim - 1))
    if s == 1:
        cache_arr.copy_(torch.where(iota == cache_len, new, cache_arr))
        return cache_arr
    # multi-token append: gather row (position - cache_len) of ``new`` at
    # every position, keep it where the position is one of the s written
    rel = iota - cache_len
    idx = torch.clamp(rel, 0, s - 1).expand(
        *cache_arr.shape[:axis], cache_arr.shape[axis],
        *cache_arr.shape[axis + 1:])
    gathered = torch.gather(new.expand(*cache_arr.shape[:axis], s,
                                       *cache_arr.shape[axis + 1:]),
                            axis, idx.long())
    cache_arr.copy_(torch.where((rel >= 0) & (rel < s), gathered, cache_arr))
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
    scheduler invariant. An fp8 pool takes the cast as its encode and is
    written as bits.
    """
    pt = pages.shape[1 + axis]
    p_max = block_tables.shape[1]
    s = new.shape[1 + axis]
    new = as_bits(new.to(pages.dtype))
    bits = as_bits(pages)
    for j in range(s):
        phys, off = _resolve(cache_len, j, block_tables, pt)
        if axis == 0:
            bits[phys, off] = new[:, j]
        else:
            bits[phys, :, off] = new[:, :, j]
    return pages


def _resolve(cache_len: torch.Tensor, j: int, block_tables: torch.Tensor,
             pt: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, in-page offset) of each row's position ``cache_len
    + j``; positions past the mapped depth resolve to the null page 0."""
    p_max = block_tables.shape[1]
    pos = cache_len.long() + j
    logical = torch.clamp(pos // pt, max=p_max - 1)
    phys = torch.gather(block_tables.long(), 1, logical[:, None])[:, 0]
    return torch.where(pos < p_max * pt, phys, 0), pos % pt


def _paged_cache_write_q(pages: torch.Tensor, scales: torch.Tensor,
                         new: torch.Tensor, cache_len: torch.Tensor,
                         block_tables: torch.Tensor, axis: int,
                         scale_max=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 block-table token append with a monotone per-page scale, in
    place.

    The same ``cache_len + j -> (page, offset)`` resolution as
    :func:`_paged_cache_write`, over int8 codes plus one f32 amax-scale a
    page. Per appended token: the page's scale grows to ``max(old,
    amax(token) / 127)`` (monotone, so resident codes only get coarser and
    never clip), the resident codes are requantized at the grown scale and
    the token's codes land at its offset. At offset 0 the scale RESETS to
    the token's own: the page was just (re)allocated, and the previous
    tenant's amax must not coarsen this sequence. Junk rows resolve to
    null page 0 and write ``scales[0]`` too; with several such rows the
    scatter's winner there is unspecified, and nothing reads page 0.
    ``scale_max`` (a rank holding its share of the heads:
    ``tensor_parallel.kv_scale_reduce``) takes the token's absmax over
    every rank's heads before it meets the page's scale.
    """
    pt = pages.shape[1 + axis]
    s = new.shape[1 + axis]
    newf = new.float()
    ones = (1,) * (pages.ndim - 1)
    iota = torch.arange(pt, device=pages.device).reshape(
        (1,) * (1 + axis) + (pt,) + (1,) * (pages.ndim - 2 - axis))
    for j in range(s):
        phys, off = _resolve(cache_len, j, block_tables, pt)
        tok = newf[:, j] if axis == 0 else newf[:, :, j]
        fresh = tok.abs().amax(dim=tuple(range(1, tok.ndim))) / INT8_QMAX
        if scale_max is not None:
            fresh = scale_max(fresh)
        old = scales[phys]
        scl = torch.where(off == 0, fresh, torch.maximum(old, fresh))
        safe = torch.where(scl > 0, scl, torch.ones_like(scl))
        page_f = pages[phys].float() * old.reshape((-1,) + ones)
        page_new = torch.clamp(torch.round(page_f / safe.reshape((-1,) + ones)),
                               -INT8_QMAX, INT8_QMAX)
        tok_codes = torch.clamp(
            torch.round(tok / safe.reshape((-1,) + (1,) * (tok.ndim - 1))),
            -INT8_QMAX, INT8_QMAX)
        page_new = torch.where(iota == off.reshape((-1,) + ones),
                               tok_codes.unsqueeze(1 + axis), page_new)
        pages[phys] = page_new.to(torch.int8)
        scales[phys] = scl
    return pages, scales


# ---------------------------------------------------------------------- GQA

def init_gqa(cfg: ModelConfig, gen: torch.Generator, n: int = 1,
             leaf: layers.Leaf = layers.keep) -> Dict:
    """GQA weights, stacked ``n`` deep on a leading axis."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": leaf("wq", randn(gen, (n, d, hq * hd), s)),
        "wk": leaf("wk", randn(gen, (n, d, hkv * hd), s)),
        "wv": leaf("wv", randn(gen, (n, d, hkv * hd), s)),
        "wo": leaf("wo", randn(gen, (n, hq * hd, d),
                               1.0 / math.sqrt(hq * hd))),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = leaf(name, torch.zeros((n, width), dtype=torch.float32,
                                             device=gen.device))
    return p


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=torch.bfloat16) -> Dict:
    """The dense slab, over the KV heads a rank holds under a serving mesh
    (``tensor_parallel.kv_heads_local``)."""
    shape = (batch, tp.kv_heads_local(cfg.n_kv_heads), max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _page_leaves(shapes: Dict[str, Tuple[int, ...]], device, dtype,
                 quant_scales: bool) -> Dict:
    """Zeroed page leaves of ``shapes`` (each ``(n_pages, ...)``) at the
    tier codec's ``dtype``; with ``quant_scales`` (the int8 codec) one f32
    amax scale a page and leaf, in a sibling ``<leaf>_scale`` leaf of shape
    ``(n_pages,)`` that every tier copy and park moves with its codes."""
    out = {}
    for name, shape in shapes.items():
        if dtype == FP8:            # made as bits: zero bits are +0.0
            out[name] = torch.zeros(shape, dtype=torch.uint8,
                                    device=device).view(FP8)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    if quant_scales:
        for name, shape in shapes.items():
            out[name + "_scale"] = torch.zeros(
                (shape[0],), dtype=torch.float32, device=device)
    return out


def init_gqa_pages(cfg: ModelConfig, n_pages: int, page_tokens: int, device,
                   dtype=torch.bfloat16, quant_scales: bool = False) -> Dict:
    """Flat page pool replacing the per-slot slab (page 0 = null page), at
    the tier codec's ``dtype``: ``k`` / ``v`` of ``(n_pages, Hkv,
    page_tokens, D)``, plus ``k_scale`` / ``v_scale`` for int8; Hkv the
    KV heads a rank holds under a serving mesh."""
    shape = (n_pages, tp.kv_heads_local(cfg.n_kv_heads), page_tokens,
             cfg.head_dim)
    return _page_leaves({"k": shape, "v": shape}, device, dtype,
                        quant_scales)


def gqa_attention(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
                  kind: LayerKind,
                  positions: torch.Tensor,
                  cache: Optional[Dict] = None,
                  cache_len=None,
                  positions3: Optional[torch.Tensor] = None,
                  cross_kv: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
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
    With ``cross_kv`` (the encoder's K/V, (B, Hkv, Ss, D) each) this is
    cross-attention: no RoPE, no cache write, non-causal, through
    :func:`repro_torch.kernels.ops.attention` at offset 0 (the flash
    kernel on the card, one query row a decode step included). With
    ``positions3`` (3, B, S) and ``cfg.mrope``, Q and K take M-RoPE.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    # under a serving mesh: the rank's heads, or (pooled) every head
    pooled = tp.pooled(cfg.n_kv_heads)

    def project(w, bias, heads):
        out = layers.linear_column(x, p[w], p.get(bias), full=heads * hd,
                                   gather=pooled)
        return out.reshape(b, s, -1, hd).transpose(1, 2)

    q = project("wq", "bq", cfg.n_heads)
    hq = q.shape[1]
    if cross_kv is not None:
        k, v = cross_kv
        out = ops.attention(q, k, v, causal=False, window=kind.window,
                            plan=plan)
        out = out.transpose(1, 2).reshape(b, s, hq * hd)
        return linear(out, p["wo"]), None
    k = project("wk", "bk", cfg.n_kv_heads)
    v = project("wv", "bv", cfg.n_kv_heads)
    wo_rows = cfg.n_heads * hd
    if positions3 is not None and cfg.mrope:
        q = layers.apply_mrope(q, positions3, cfg.rope_theta,
                               cfg.mrope_sections)
        k = layers.apply_mrope(k, positions3, cfg.rope_theta,
                               cfg.mrope_sections)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and block_tables is not None:
        # an int8 pool (sibling scale leaves) takes the scale-aware write
        # and hands its scales to the dequantizing read; an fp8 pool needs
        # neither: the write's cast encodes, the read's upcast decodes
        scales = (cache.get("k_scale"), cache.get("v_scale"))
        for name, new, scale in (("k", k, scales[0]), ("v", v, scales[1])):
            if scale is None:
                _paged_cache_write(cache[name], new, cache_len, block_tables,
                                   axis=1)
            else:
                _paged_cache_write_q(
                    cache[name], scale, new, cache_len, block_tables, axis=1,
                    scale_max=tp.kv_scale_reduce(cfg.n_kv_heads))
        kw = dict(window=kind.window, causal=causal, k_scale=scales[0],
                  v_scale=scales[1], block_tables=block_tables)
        if pooled:
            out = _pooled_decode(q, cache["k"], cache["v"], cache_len, **kw)
        else:
            out = paged_decode_attention(q, cache["k"], cache["v"],
                                         kw.pop("block_tables"), cache_len,
                                         **kw)
        out = out.transpose(1, 2).reshape(b, s, hq * hd)
        return layers.linear_row(out, p["wo"], full=wo_rows), cache

    q_offset = 0
    if cache is not None:
        k = _cache_write(cache["k"], k, cache_len, axis=2)
        v = _cache_write(cache["v"], v, cache_len, axis=2)
        q_offset = cache_len

    if torch.is_tensor(q_offset) and pooled:
        out = _pooled_decode(q, k, v, q_offset, window=kind.window,
                             causal=causal)
    elif torch.is_tensor(q_offset):
        # decode with a device-side offset: direct masked attention over
        # the cache
        out = decode_attention_masked(q, k, v, q_offset, window=kind.window,
                                      causal=causal)
    else:
        out = ops.attention(q, k, v, causal=causal, window=kind.window,
                            q_offset=q_offset, plan=plan)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return layers.linear_row(out, p["wo"], full=wo_rows), cache


def _pooled_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cache_len, *, window: Optional[int], causal: bool,
                   block_tables: Optional[torch.Tensor] = None,
                   k_scale=None, v_scale=None) -> torch.Tensor:
    """The pooled decode of a rank whose caches hold every KV head: attend
    over this rank's range of each slot's positions (the slab through the
    masked oracle, the pool through the page walk), gather every rank's
    (output, log-sum-exp) and merge them in rank order, so every rank
    holds the same bits."""
    start, end = decode_range(cache_len, q.shape[2], tp.model_size(),
                              tp.model_rank(), batch=q.shape[0],
                              window=window)
    if block_tables is not None:
        out, lse = paged_decode_attention(
            q, k, v, block_tables, cache_len, window=window, causal=causal,
            k_scale=k_scale, v_scale=v_scale, span=(start, end))
    else:
        out, lse = decode_attention_lse(q, k, v, cache_len, window=window,
                                        causal=causal, start=start, end=end)
    return merge_ranges(*tp.gather_pairs(out, lse))


# ---------------------------------------------------------------------- MLA

def init_mla(cfg: ModelConfig, gen: torch.Generator, n: int = 1,
             leaf: layers.Leaf = layers.keep) -> Dict:
    """MLA weights in the reference's tree, stacked ``n`` deep."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
    lora, q_lora = cfg.kv_lora_rank, cfg.q_lora_rank

    def norm(width):
        return {"scale": leaf("scale", torch.ones(
            (n, width), dtype=torch.float32, device=gen.device))}

    p = {}
    if q_lora:
        p["wq_a"] = leaf("wq_a", randn(gen, (n, d, q_lora),
                                       1.0 / math.sqrt(d)))
        p["q_norm"] = norm(q_lora)
        p["wq_b"] = leaf("wq_b", randn(gen, (n, q_lora, h * (nope + rope_d)),
                                       1.0 / math.sqrt(q_lora)))
    else:
        p["wq_b"] = leaf("wq_b", randn(gen, (n, d, h * (nope + rope_d)),
                                       1.0 / math.sqrt(d)))
    p["wkv_a"] = leaf("wkv_a", randn(gen, (n, d, lora + rope_d),
                                     1.0 / math.sqrt(d)))
    p["kv_norm"] = norm(lora)
    p["wkv_b"] = leaf("wkv_b", randn(gen, (n, lora, h * (nope + vdim)),
                                     1.0 / math.sqrt(lora)))
    p["wo"] = leaf("wo", randn(gen, (n, h * vdim, d),
                               1.0 / math.sqrt(h * vdim)))
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=torch.bfloat16) -> Dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def init_mla_pages(cfg: ModelConfig, n_pages: int, page_tokens: int, device,
                   dtype=torch.bfloat16, quant_scales: bool = False) -> Dict:
    """Paged latent pool: ``ckv`` ``(n_pages, page_tokens, kv_lora)`` and
    ``krope`` ``(n_pages, page_tokens, rope)``, plus ``ckv_scale`` /
    ``krope_scale`` for int8 (see :func:`_page_leaves`)."""
    return _page_leaves(
        {"ckv": (n_pages, page_tokens, cfg.kv_lora_rank),
         "krope": (n_pages, page_tokens, cfg.qk_rope_head_dim)},
        device, dtype, quant_scales)


def _gather_latent(cache: Dict, name: str,
                   block_tables: torch.Tensor) -> torch.Tensor:
    """One latent leaf of the paged pool as each slot's contiguous ``(B,
    P * page_tokens, width)`` view: int8 codes times their page's scale, an
    fp8 page upcast to f32, bf16 as stored."""
    pages = cache[name]
    out = gather_kv_pages(pages, block_tables, seq_axis=0)
    scales = cache.get(name + "_scale")
    if scales is not None:
        pt = pages.shape[1]
        return out.float() * torch.repeat_interleave(
            scales[block_tables.long()], pt, dim=1)[:, :, None]
    if out.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        return out.float()
    return out


def mla_heads(p: Dict, cfg: ModelConfig) -> int:
    """The query heads ``p``'s MLA leaves hold: all ``cfg.n_heads``, or
    under a serving mesh a rank's ``n_heads / M`` (column shards of
    ``wq_b`` / ``wkv_b``, a row shard of ``wo``). Raises where the three
    disagree, or where a shard is not this mesh's share of the heads
    (``sharding`` keeps a leaf whole when a dim does not divide: one leaf
    cut and another whole would compute garbage)."""
    nope, rope_d, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
    h = p["wq_b"].shape[-1] // (nope + rope_d)
    held = (p["wq_b"].shape[-1], p["wkv_b"].shape[-1], p["wo"].shape[-2])
    want = (h * (nope + rope_d), h * (nope + vdim), h * vdim)
    if held != want or not (h == cfg.n_heads or tp.split(h, cfg.n_heads)):
        raise ValueError(
            f"MLA leaves wq_b / wkv_b / wo hold {held} columns / columns / "
            f"rows: not one share of {cfg.n_heads} heads over a model axis "
            f"of {tp.model_size()} (want {want} for {h} heads)")
    return h


def mla_attention(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
                  kind: LayerKind,
                  positions: torch.Tensor,
                  cache: Optional[Dict] = None,
                  cache_len=None,
                  plan: Optional[tiling.AttentionPlan] = None,
                  block_tables: Optional[torch.Tensor] = None,
                  positions3: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention. x: (B, S, d). Returns (out, cache).
    ``positions3`` is taken for the layer dispatch's one signature and
    not read: no MLA config uses M-RoPE.

    The cache holds only the latent: the slab or pool is written in place,
    then read back whole (the pool through the block tables: gathered,
    dequantized on the gather when int8, upcast when fp8). With a tensor
    ``cache_len`` and one token a row, or per-slot offsets (the verify
    chunk), attention runs in latent space, the reference's absorbed
    decode: ``q_nope`` folds through ``wkv_b``'s K half, scores and values
    are f32 einsums over the latent, and no per-head K/V is made. Otherwise
    (prefill, resumed prefill at a host-int offset, no cache) the latent
    decompresses through ``wkv_b`` into per-head K (nope + rope) and V and
    goes to :func:`repro_torch.kernels.ops.attention`: the flash kernel at
    D = nope + rope, Dv = v on the card.

    Under a serving mesh each rank computes all of this for its heads
    (:func:`mla_heads`) over the whole latent, and ``wo``'s f32 partials
    are summed over ``model`` before the cast."""
    b, s, _ = x.shape
    h = mla_heads(p, cfg)
    nope, rope_d, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
    lora = cfg.kv_lora_rank

    if cfg.q_lora_rank:
        # the q norm spans the whole q_lora row: gather wq_a's columns
        q_a = layers.linear_column(x, p["wq_a"], full=cfg.q_lora_rank,
                                   gather=True)
        q = linear(layers.rmsnorm(p["q_norm"], q_a), p["wq_b"])
    else:
        q = linear(x, p["wq_b"])
    q = q.reshape(b, s, h, nope + rope_d).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = linear(x, p["wkv_a"])                        # (B, S, lora + rope)
    ckv = layers.rmsnorm(p["kv_norm"], kv_a[..., :lora])
    k_rope = layers.apply_rope(kv_a[..., lora:][:, None], positions,
                               cfg.rope_theta)[:, 0]   # one shared head

    q_offset = 0
    if cache is not None and block_tables is not None:
        for name, new in (("ckv", ckv), ("krope", k_rope)):
            scale = cache.get(name + "_scale")
            if scale is None:
                _paged_cache_write(cache[name], new, cache_len, block_tables,
                                   axis=0)
            else:
                _paged_cache_write_q(cache[name], scale, new, cache_len,
                                     block_tables, axis=0)
        ckv = _gather_latent(cache, "ckv", block_tables)
        k_rope = _gather_latent(cache, "krope", block_tables)
        q_offset = cache_len
    elif cache is not None:
        ckv = _cache_write(cache["ckv"], ckv, cache_len, axis=1)
        k_rope = _cache_write(cache["krope"], k_rope, cache_len, axis=1)
        q_offset = cache_len

    scale = (nope + rope_d) ** -0.5
    if cache is not None and torch.is_tensor(q_offset) and (
            s == 1 or q_offset.ndim == 1):
        w = cast(p["wkv_b"]).float().reshape(lora, h, nope + vdim)
        wk, wv = w[..., :nope], w[..., nope:]           # (l, h, n) / (l, h, v)
        q_lat = torch.einsum("bhsn,lhn->bhsl", q_nope.float(), wk)
        ckv_f, kr_f = ckv.float(), k_rope.float()       # (B, T, l) / (B, T, r)
        scores = (torch.einsum("bhsl,btl->bhst", q_lat, ckv_f)
                  + torch.einsum("bhsr,btr->bhst", q_rope.float(), kr_f)
                  ) * scale
        t_pos = torch.arange(ckv.shape[1], device=x.device)[None, :]
        if q_offset.ndim == 1:                          # per-slot (B,)
            q_offset = q_offset.reshape(b, 1, 1, 1)
        q_pos = q_offset + torch.arange(s, device=x.device)[:, None]
        scores = torch.where(t_pos <= q_pos, scores, -torch.inf)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhst,btl->bhsl", probs, ckv_f)
        out = torch.einsum("bhsl,lhv->bhsv", o_lat, wv).to(x.dtype)
    else:
        kv = linear(ckv, p["wkv_b"]).reshape(*ckv.shape[:2], h, nope + vdim)
        k_nope = kv[..., :nope].transpose(1, 2)         # (B, H, Skv, nope)
        v = kv[..., nope:].transpose(1, 2)              # (B, H, Skv, v)
        k = torch.cat([k_nope, k_rope[:, None].expand(
            b, h, *k_rope.shape[1:])], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.attention(q_full, k, v, causal=True, window=kind.window,
                            scale=scale, q_offset=q_offset, plan=plan)
    out = out.transpose(1, 2).reshape(b, s, h * vdim)
    return layers.linear_row(out, p["wo"], full=cfg.n_heads * vdim), cache


INIT = {"gqa": init_gqa, "mla": init_mla}
APPLY = {"gqa": gqa_attention, "mla": mla_attention}
