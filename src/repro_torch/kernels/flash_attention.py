"""Blockwise (flash) attention with causal / sliding-window masking.

The counterpart of ``src/repro/kernels/flash_attention.py``. The Hopper
kernel (``csrc/flash_attention.cu``) runs one CTA per (batch, query head,
64-row query tile), stages 64-key K/V tiles through shared memory and keeps
the f32 online-softmax state in registers. GQA maps query head ``h`` to KV
head ``h // group``, so K/V are never repeated in memory. KV tiles wholly
past the causal diagonal or behind the window are skipped, and ragged
``Sq``/``Skv`` edges are masked in the kernel: unlike the TPU kernel, no
length has to divide a block.

:func:`flash_attention_plain` beside it is the plain PyTorch version of the
same function; a CPU tensor takes it, a CUDA tensor takes the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

_LIB = "flash_attention"


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention` (f32 softmax)."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv).

    On a CUDA tensor: bf16 in and out, D = Dv = 128, unit stride on the
    last axis, an int ``q_offset``; anything else raises. A CPU tensor
    takes :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    bk, hkv, skv, dk = k.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention takes bf16 {name}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention needs unit stride on the last "
                             f"axis of {name}")
    lib = build.library(_LIB)
    head_dim = lib.flash_attention_head_dim()
    if d != head_dim or dk != d or v.shape != k.shape:
        raise ValueError(f"flash_attention takes D = Dv = {head_dim}, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if bk != b or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"share a batch / GQA grouping")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise TypeError(f"flash_attention takes a non-negative int q_offset, "
                        f"got {q_offset!r}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    rc = lib.flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(causal), int(window is not None), window or 0,
        q_offset, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(_LIB, rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
