"""Blockwise (flash) attention with causal / sliding-window masking.

The counterpart of ``src/repro/kernels/flash_attention.py``
(``_attn_kernel``, the Pallas TPU kernel). The Hopper kernel
(``csrc/flash_attention.cu``) runs on the tensor cores: one CTA per (batch,
query head, 64-row query tile), one consumer warpgroup and one producer
warp. TMA brings the Q tile in once and streams 64-key K and V tiles
through a 2-stage ring paced by mbarriers, into 128-byte-swizzled shared
memory; ``wgmma`` computes S = Q K^T from shared memory, the f32 online
softmax runs on its accumulator registers, and P, rounded to bf16 in
registers, is ``wgmma``'s A operand for O += P V. At the main path's
prefill shape (Sq 512 over Skv 576, 16 query heads over 2 KV heads) the
bytes (Q and O, 4.6 MB: 0.0014 ms) bound it just above the operations
(1.07 GFLOP causal: 0.0011 ms); far from both, the kernel is held by the
latency of each CTA's serial walk over its KV tiles. GQA maps query head ``h`` to KV head ``h // group``, so K/V
are never repeated in memory. KV tiles wholly past the causal diagonal or
behind the window are skipped, and ragged ``Sq``/``Skv`` edges are zero
filled by TMA and masked: unlike the TPU kernel, no length has to divide a
block. The tiles are fixed (64 x 64); sizing them from the ``h100``
planner is ROADMAP work. The kernel is built at five head-dim pairs
(:data:`HEAD_DIMS`): D = Dv = 128 (the GQA families), D = 192, Dv = 128
(multi-head latent attention's prefill: nope 128 + rope 64 for Q and K),
D = Dv = 64 (seamless-m4t-medium's encoder, decoder and
cross-attention, down to one query row a decode step), and D = Dv = 32
and 16 (the training examples' models and the smoke configs), which run on
the (64, 64) tile: TMA fills the columns past D with zeros, which change
neither Q K^T nor P V, and the store keeps the first D columns.

TMA reads the tensors through their own strides, so the model's
``transpose(1, 2)`` views go in without a copy; a tensor whose batch, head
or sequence stride is not a multiple of 8 elements (16 bytes), or whose
base is not 16-byte aligned, is copied to a contiguous one first.

:func:`flash_attention_plain` beside it is the plain PyTorch version of the
same function; a CPU tensor takes it, a CUDA tensor takes the kernel.

Training reaches the kernel through :class:`FlashAttention`, an autograd
Function whose forward is the kernel, unchanged, and whose backward is
:func:`flash_attention_plain_vjp`: the plain attention recomputed from the
saved q, k and v and differentiated (at qwen2.5-3b's training shape, 8 x
16 heads x 128 x 128 positions, its f32 scores are 8 MB a layer). The
JAX package has no backward kernel either: its gradients come from
autodiff of its oracle. A backward kernel is ROADMAP B6.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

_LIB = "flash_attention"
#: the (D, Dv) pairs the kernel is built at (``csrc/flash_attention.cu``)
HEAD_DIMS = ((128, 128), (192, 128), (64, 64), (32, 32), (16, 16))


def tma_strides(t: torch.Tensor) -> tuple:
    """The (batch, head, seq) strides of a (B, H, S, D) tensor as the
    kernel's tensor map reads them: a dim of size 1 is never stepped, so
    it takes a stride of D. None if TMA cannot read ``t`` in place (a
    stride not a multiple of 8 elements, or a base not 16-byte aligned)."""
    strides = tuple(t.stride(i) if t.shape[i] > 1 else t.shape[-1]
                    for i in range(3))
    if t.data_ptr() % 16 or any(s <= 0 or s % 8 for s in strides):
        return None
    return strides


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention` (f32 softmax)."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)


def check_inputs(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> tuple:
    """Raise for q / k / v the kernel does not take: bf16 on one device,
    unit stride on the last axis, (D, Dv) in :data:`HEAD_DIMS`, K and V of
    one (batch, head, sequence) shape, a batch and GQA grouping q shares.
    Returns the output's shape ``(B, Hq, Sq, Dv)``."""
    b, hq, sq, d = q.shape
    bk, hkv, skv, dk = k.shape
    dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention takes bf16 {name}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention needs unit stride on the last "
                             f"axis of {name}")
    if (d, dv) not in HEAD_DIMS or dk != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention takes (D, Dv) in {HEAD_DIMS}, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if bk != b or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"share a batch / GQA grouping")
    return b, hq, sq, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv).

    On a CUDA tensor: what :func:`check_inputs` takes and an int
    ``q_offset``; anything else raises. A CPU tensor takes
    :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out_shape = check_inputs(q, k, v)
    b, hq, sq, dv = out_shape
    hkv, skv, d = k.shape[1], k.shape[2], q.shape[-1]
    if not isinstance(q_offset, int) or q_offset < 0:
        raise TypeError(f"flash_attention takes a non-negative int q_offset, "
                        f"got {q_offset!r}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    lib = build.library(_LIB)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    if skv == 0:
        return out.zero_()
    views = []
    for t in (q, k, v):
        strides = tma_strides(t)
        if strides is None:         # a fresh allocation is aligned
            t = t.clone(memory_format=torch.contiguous_format)
            strides = tma_strides(t)
        views.append((t, strides))
    (q, qs), (k, ks), (v, vs) = views
    rc = lib.flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, d, dv, *qs, *ks, *vs,
        float(scale), int(causal), int(window is not None), window or 0,
        q_offset, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(_LIB, rc)
    flash_attention.launches += 1
    flash_attention.launches_by_dims[d, dv] += 1
    return out


#: launches of every instance, and of each (D, Dv) instance
flash_attention.launches = 0
flash_attention.launches_by_dims = dict.fromkeys(HEAD_DIMS, 0)


def flash_attention_plain_vjp(q, k, v, grad_out, *, causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None,
                              q_offset: int = 0) -> tuple:
    """``(dq, dk, dv)`` of :func:`flash_attention_plain` at ``(q, k, v)``
    against ``grad_out``, in the inputs' dtypes; a GQA head's dk and dv sum
    over its query group. Counts its calls."""
    flash_attention_plain_vjp.calls += 1
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset)
        return torch.autograd.grad(out, leaves, grad_out)


flash_attention_plain_vjp.calls = 0


class FlashAttention(torch.autograd.Function):
    """``forward(q, k, v, causal, window, scale, q_offset, fn)``: ``fn``
    (the kernel, :func:`flash_attention`; the tests hand it
    :func:`flash_attention_plain`) computes the output; the backward is
    :func:`flash_attention_plain_vjp`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, fn):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, scale=scale,
                        q_offset=q_offset)
        return fn(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, grad_out):
        grads = flash_attention_plain_vjp(*ctx.saved_tensors, grad_out,
                                          **ctx.args)
        return (*grads, None, None, None, None, None)
