"""Paged decode attention: walk a block table over a flat page pool.

The counterpart of ``src/repro/kernels/paged_attention.py``. KV lives in a
flat pool of fixed-size pages ``(n_pages, Hkv, page_tokens, D)`` and each
sequence slot maps logical page indices to physical pages through an int32
block table (page 0 is the null page). This module owns the decode math:

  * :func:`decode_attention_masked` — the dense masked decode-attention
    oracle (GQA without repeating K/V, per-row frontier masking). The dense
    slot-slab path calls it directly, and the paged plain path reduces to
    it after a gather, so paged == dense is bit-exact on the plain path.
  * :func:`gather_kv_pages` — block-table gather back to a per-slot
    contiguous view.
  * :func:`paged_flash_decode` — the Hopper page-walk kernel
    (``csrc/paged_attention.cu``) and, beside it,
    :func:`paged_flash_decode_plain`, its plain PyTorch version.
  * :func:`paged_decode_attention` — the entry, with the reference's
    dispatch rule: a single-token causal decode over unquantized pages on a
    CUDA tensor takes the kernel; multi-token queries, ``causal=False`` and
    CPU tensors take gather + oracle. Quantized pools are not ported yet.

The kernel reads each slot's frontier ``cache_len`` on the device, so no
wrapper here reads a device value on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

_LIB = "paged_attention"


# ------------------------------------------------------------------ oracle


def decode_attention_masked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, cache_len, *,
                            window: Optional[int] = None,
                            causal: bool = True) -> torch.Tensor:
    """Masked attention with a device-side valid-prefix length.

    GQA without repeating K/V: q is viewed as (B, Hkv, group, S, D) and
    contracted against the (B, Hkv, T, D) cache. ``cache_len`` is an int, a
    0-d tensor or a per-row ``(B,)`` tensor; positions at or past a row's
    frontier (stale K/V of a previous occupant included) are masked.
    """
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, group, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg.float(), k.float()) * scale
    if torch.is_tensor(cache_len) and cache_len.ndim == 1:
        cache_len = cache_len.reshape(b, 1, 1, 1, 1)
    qpos = cache_len + torch.arange(s, device=q.device)[:, None]
    tpos = torch.arange(skv, device=q.device)[None, :]
    mask = tpos < cache_len + s
    if causal:
        mask = mask & (tpos <= qpos)
    if window is not None:
        mask = mask & (tpos > qpos - window)
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.float())
    return out.reshape(b, hq, s, v.shape[-1]).to(q.dtype)


# ------------------------------------------------------------------ gather


def gather_kv_pages(pages: torch.Tensor, block_tables: torch.Tensor, *,
                    seq_axis: int) -> torch.Tensor:
    """Physical pages -> per-slot contiguous KV.

    ``pages`` is ``(n_pages, *page_shape)`` with ``page_shape[seq_axis] ==
    page_tokens``; ``block_tables`` is ``(B, P)``. Returns ``(B,
    *page_shape)`` with the seq axis widened to ``P * page_tokens``.
    Unmapped entries (null page 0) gather junk the frontier mask hides.
    """
    gathered = pages[block_tables.long()]              # (B, P, *page_shape)
    gathered = torch.movedim(gathered, 1, seq_axis + 1)
    shape = list(gathered.shape)
    merged = shape[:seq_axis + 1] + [shape[seq_axis + 1] * shape[seq_axis + 2]]
    return gathered.reshape(merged + shape[seq_axis + 3:])


# ---------------------------------------------------------- Hopper kernel


def paged_flash_decode_plain(q, k_pages, v_pages, block_tables, cache_len, *,
                             window: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`paged_flash_decode`: gather the
    slot's pages, then the masked oracle."""
    k = gather_kv_pages(k_pages, block_tables, seq_axis=1)
    v = gather_kv_pages(v_pages, block_tables, seq_axis=1)
    return decode_attention_masked(q, k, v, cache_len, window=window)


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       cache_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Page-walk decode attention on the card.

    q: (B, Hq, 1, D) bf16; k_pages/v_pages: (n_pages, Hkv, page_tokens, D)
    bf16, contiguous; block_tables: (B, P) int32; cache_len: (B,) int32.
    On a CUDA tensor this launches ``csrc/paged_attention.cu`` or raises;
    a CPU tensor takes :func:`paged_flash_decode_plain`. Block-table
    entries must lie in ``[0, n_pages)``: the scheduler's page allocator
    guarantees it, and checking it here would read the device from the
    host inside the decode chunk.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, block_tables,
                                        cache_len, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    b, hq, s, d = q.shape
    n_pages, hkv, pt, dk = k_pages.shape
    p_max = block_tables.shape[1]
    if s != 1:
        raise ValueError("paged decode attention is single-token")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"paged_flash_decode takes bf16 {name}, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("block_tables", block_tables), ("cache_len", cache_len)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise TypeError(f"{name} must be a contiguous int32 tensor on "
                            f"{q.device}, got {t.dtype} on {t.device}")
    lib = build.library(_LIB)
    if d != lib.paged_attention_head_dim() or dk != d \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_flash_decode takes D = Dv = "
                         f"{lib.paged_attention_head_dim()}, got q {q.shape}, "
                         f"pages {k_pages.shape} / {v_pages.shape}")
    if hq % hkv or hq // hkv > lib.paged_attention_max_group():
        raise ValueError(f"GQA group {hq}/{hkv} not supported (at most "
                         f"{lib.paged_attention_max_group()} per KV head)")
    if pt > lib.paged_attention_max_page_tokens():
        raise ValueError(f"page_tokens {pt} > "
                         f"{lib.paged_attention_max_page_tokens()}")
    if cache_len.shape != (b,) or block_tables.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"cache_len {tuple(cache_len.shape)} vs batch {b}")
    if q.stride(-1) != 1 or not k_pages.is_contiguous() \
            or not v_pages.is_contiguous():
        raise ValueError("paged_flash_decode needs unit stride on D for q "
                         "and contiguous pages")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    rc = lib.paged_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        b, hq, hkv, pt, p_max, q.stride(0), q.stride(1), d ** -0.5,
        int(window is not None), window or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(_LIB, rc)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


# ------------------------------------------------------------------ entry


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           cache_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           causal: bool = True,
                           impl: str = "auto",
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode attention over the paged pool; the dense math is the oracle.

    ``impl="auto"`` walks pages with the Hopper kernel for a single-token
    causal query on a CUDA tensor and takes gather +
    :func:`decode_attention_masked` otherwise (multi-token verify chunks,
    CPU tensors); ``impl="kernel"`` always calls :func:`paged_flash_decode`
    and ``impl="ref"`` always gathers. Quantized pools (int8 with
    ``k_scale``/``v_scale``, fp8 pages) are a later slice of the port.
    """
    quantized = (k_scale is not None or v_scale is not None
                 or k_pages.dtype not in (torch.bfloat16, torch.float16,
                                          torch.float32))
    if quantized:
        raise NotImplementedError(
            "quantized KV pools (int8/fp8 tier codecs) are not ported yet "
            "(ROADMAP A6)")
    single = q.shape[2] == 1
    use_kernel = impl == "kernel" or (impl == "auto" and q.is_cuda and single)
    if use_kernel and causal:
        return paged_flash_decode(q, k_pages, v_pages, block_tables,
                                  cache_len, window=window)
    k = gather_kv_pages(k_pages, block_tables, seq_axis=1)
    v = gather_kv_pages(v_pages, block_tables, seq_axis=1)
    return decode_attention_masked(q, k, v, cache_len, window=window,
                                   causal=causal)
