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
  * :func:`paged_flash_decode` — the Hopper split page-walk kernel
    (``csrc/paged_attention.cu``: one CTA per ``SPLIT_TOKENS`` positions
    of one (slot, KV head), partials merged in split order inside the same
    launch) and, beside it, :func:`paged_flash_decode_plain`, its plain
    PyTorch version. :func:`split_geometry` sizes its grid and workspace.
  * :func:`paged_decode_attention` — the entry, with the reference's
    dispatch rule: a single-token causal decode over unquantized pages on a
    CUDA tensor takes the kernel; multi-token queries, ``causal=False``,
    quantized pools and CPU tensors take gather + oracle.
  * :func:`quantize_page_int8` / :func:`dequantize_page_int8` — the int8
    tier codec: symmetric, one f32 scale (``amax / INT8_QMAX``) per page
    per leaf. The fp8-e4m3 codec is a plain cast; fp8 pages move as their
    ``uint8`` bits (:func:`as_bits`), so every fp8 copy is a bit copy and
    arithmetic only ever sees an f32 upcast.

The kernel reads each slot's frontier ``cache_len`` on the device, so no
wrapper here reads a device value on the host: the grid and the partials'
workspace are sized from the block table's width alone.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

_LIB = "paged_attention"
#: positions per split of the page walk (``SPLIT_TOKENS`` in the source; a
#: split is a whole number of pages); held equal to the source by the tests
#: and by the wrapper at its first launch
SPLIT_TOKENS = 64
#: splits a first-level merge takes (``NODE`` in the source): a slot whose
#: live splits span several such nodes merges each node, then the nodes
MERGE_NODE = 16
#: (slot, KV head) arrival counters of the in-launch merge, one buffer per
#: (device, CUDA stream): zeroed once, left zero by every launch, grown when
#: a call needs more. A launch on another stream never shares a buffer with
#: one in flight.
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}

INT8_QMAX = 127.0    # symmetric int8: codes in [-127, 127], -128 unused
FP8 = torch.float8_e4m3fn


# ------------------------------------------------------------ quantization


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for an fp8 tensor its ``uint8`` view: gathers,
    scatters and copies of fp8 pages run on the bits, so they need no
    Float8 kernel and cannot round."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def _expand(t: torch.Tensor, axes) -> torch.Tensor:
    for a in sorted(axes):
        t = t.unsqueeze(a)
    return t


def _axes(axes) -> Tuple[int, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def quantize_page_int8(x: torch.Tensor, axes) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Symmetric int8 with one scale per un-reduced index.

    ``axes`` are the reduced (per-page) axes: the scale is ``amax(|x|,
    axes) / 127`` and the codes ``round(x / scale)`` (half to even, as
    ``jnp.round``) clipped to [-127, 127]. An all-zero page gets scale 0 and
    zero codes. Returns ``(codes int8, scales f32)``."""
    axes = _axes(axes)
    xf = x.float()
    scales = xf.abs().amax(dim=axes) / INT8_QMAX
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.clamp(torch.round(xf / _expand(safe, axes)),
                        -INT8_QMAX, INT8_QMAX)
    return codes.to(torch.int8), scales


def dequantize_page_int8(codes: torch.Tensor, scales: torch.Tensor,
                         axes) -> torch.Tensor:
    """Inverse of :func:`quantize_page_int8` (f32 out); ``axes`` are the
    page axes the scales were reduced over."""
    return codes.float() * _expand(scales, _axes(axes))


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
    fp8 pages are gathered as their bits.
    """
    gathered = as_bits(pages)[block_tables.long()]     # (B, P, *page_shape)
    gathered = torch.movedim(gathered, 1, seq_axis + 1)
    shape = list(gathered.shape)
    merged = shape[:seq_axis + 1] + [shape[seq_axis + 1] * shape[seq_axis + 2]]
    return gathered.reshape(merged + shape[seq_axis + 3:]).view(pages.dtype)


# ---------------------------------------------------------- Hopper kernel


def paged_flash_decode_plain(q, k_pages, v_pages, block_tables, cache_len, *,
                             window: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`paged_flash_decode`: gather the
    slot's pages, then the masked oracle."""
    k = gather_kv_pages(k_pages, block_tables, seq_axis=1)
    v = gather_kv_pages(v_pages, block_tables, seq_axis=1)
    return decode_attention_masked(q, k, v, cache_len, window=window)


class SplitGeometry(NamedTuple):
    pages_per_split: int
    n_splits: int
    n_nodes: int           # first-level merge nodes of MERGE_NODE splits
    grid: tuple            # (n_splits, Hkv, B), as the kernel launches
    workspace_floats: int  # f32 partials (B, Hkv, n_splits + n_nodes,
                           # group, D + 2)
    counters: int          # per (slot, KV head): one a node, one for all


def split_geometry(batch: int, hkv: int, group: int, page_tokens: int,
                   p_max: int, head_dim: int) -> SplitGeometry:
    """The kernel's grid and workspace for a call: a function of the batch,
    the heads, the page size and the block table's width ``p_max`` only,
    never of a frontier (which lives on the device)."""
    pps = max(1, SPLIT_TOKENS // page_tokens)
    n_splits = -(-p_max // pps)
    n_nodes = -(-n_splits // MERGE_NODE)
    return SplitGeometry(
        pps, n_splits, n_nodes, (n_splits, hkv, batch),
        batch * hkv * (n_splits + n_nodes) * group * (head_dim + 2),
        batch * hkv * (n_nodes + 1))


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The merge's counter buffer of ``(device, stream)``, at least ``n``
    long. A grown buffer is made on ``stream``, so it is zero before any
    launch there reads it."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def counter_buffers() -> Dict[Tuple[torch.device, int], torch.Tensor]:
    """Every merge counter buffer made so far, by (device, stream): each
    must read all zeros whenever no launch is in flight."""
    return dict(_COUNTERS)


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       cache_len: torch.Tensor, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """Split page-walk decode attention on the card.

    q: (B, Hq, 1, D) bf16; k_pages/v_pages: (n_pages, Hkv, page_tokens, D)
    bf16, contiguous; block_tables: (B, P) int32; cache_len: (B,) int32.
    On a CUDA tensor this launches ``csrc/paged_attention.cu`` once or
    raises; a CPU tensor takes :func:`paged_flash_decode_plain`. Block-table
    entries must lie in ``[0, n_pages)``: the scheduler's page allocator
    guarantees it, and checking it here would read the device from the
    host inside the decode chunk. The merge's counters are one buffer per
    (device, stream), so launches on different streams never share one.
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_flash_decode copies pages in 16-byte pieces: "
                         "the pools must start 16-byte aligned")
    if p_max < 1:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} has no "
                         f"page column")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    if lib.paged_attention_split_tokens() != SPLIT_TOKENS:
        raise RuntimeError(f"paged_attention.cu splits every "
                           f"{lib.paged_attention_split_tokens()} positions, "
                           f"the wrapper sizes for {SPLIT_TOKENS}")
    geom = split_geometry(b, hkv, hq // hkv, pt, p_max, d)
    ws = torch.empty(geom.workspace_floats, dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counters(q.device, stream, geom.counters)
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    rc = lib.paged_decode_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), b, hq, hkv, pt, p_max,
        q.stride(0), q.stride(1), ws.numel(), counters.numel(), d ** -0.5,
        int(window is not None), window or 0, stream)
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
    causal query over bf16 pages on a CUDA tensor and takes gather +
    :func:`decode_attention_masked` otherwise (multi-token verify chunks,
    quantized pools, CPU tensors); ``impl="kernel"`` always calls
    :func:`paged_flash_decode` and ``impl="ref"`` always gathers.

    Quantized pools dequantize AFTER the block-table gather, as in the
    reference: int8 pages carry per-page ``k_scale`` / ``v_scale``
    ``(n_pages,)``, spread over each page's ``page_tokens`` positions;
    fp8-e4m3 pages (detected by dtype) upcast to f32. The page-walk kernel
    reads bf16 pages only, so a quantized pool never launches it and
    ``impl="kernel"`` raises there.
    """
    quantized = (k_scale is not None
                 or k_pages.dtype not in (torch.bfloat16, torch.float16,
                                          torch.float32))
    if quantized and impl == "kernel":
        raise NotImplementedError(
            "the paged decode kernel reads bf16 pages; quantized pools "
            "dequantize on gather (impl='auto')")
    single = q.shape[2] == 1
    use_kernel = impl == "kernel" or (impl == "auto" and q.is_cuda and single
                                      and not quantized)
    if use_kernel and causal:
        return paged_flash_decode(q, k_pages, v_pages, block_tables,
                                  cache_len, window=window)
    k = gather_kv_pages(k_pages, block_tables, seq_axis=1)
    v = gather_kv_pages(v_pages, block_tables, seq_axis=1)
    if k_scale is not None:
        # per-page scalar scales -> per-position columns of the gathered
        # view (an expand, so no output size is read back from the device)
        b, p_max = block_tables.shape
        pt = k_pages.shape[2]

        def columns(scale):
            return scale[block_tables.long()][:, :, None].expand(
                b, p_max, pt).reshape(b, 1, p_max * pt, 1)

        k = k.float() * columns(k_scale)
        v = v.float() * columns(v_scale)
    elif quantized:
        k, v = k.float(), v.float()
    return decode_attention_masked(q, k, v, cache_len, window=window,
                                   causal=causal)
