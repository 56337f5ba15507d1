"""Public entry points of the kernel package.

The counterpart of ``src/repro/kernels/ops.py``. Models call these; they
dispatch to the Hopper kernel or to the plain PyTorch oracle with the
reference's rule: ``impl="auto"`` takes the kernel for CUDA tensors and the
oracle for CPU tensors, ``impl="kernel"`` / ``impl="ref"`` pin one side.

The matmul and selective-scan entries of the reference are not ported yet
(ROADMAP B3, B4).
"""

from __future__ import annotations

from typing import Literal, Optional, Union

import torch

from repro_torch.core import tiling
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as _flash

Impl = Literal["auto", "kernel", "ref"]


def _use_kernel(impl: Impl, x: torch.Tensor) -> bool:
    if impl == "auto":
        return x.is_cuda
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | kernel | ref)")
    return impl == "kernel"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None,
              scale: Optional[float] = None,
              q_offset: Union[int, torch.Tensor] = 0,
              plan: Optional[tiling.AttentionPlan] = None,
              impl: Impl = "auto") -> torch.Tensor:
    """Blockwise attention; q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D).

    A tensor-valued ``q_offset`` (chunked prefill resuming at a device-side
    cursor) takes the oracle, as in the reference: the offset only enters
    the mask arithmetic there. ``plan`` is accepted for the reference's
    signature; the Hopper kernel's tiles are fixed by its shared-memory
    layout (sizing them from an ``h100`` target is ROADMAP work).
    """
    del plan
    if not _use_kernel(impl, q) or torch.is_tensor(q_offset):
        # long sequences take the blockwise path (bounded transients)
        if q.shape[2] * k.shape[2] > 4096 * 4096:
            return ref.attention_ref_blockwise(
                q, k, v, causal=causal, window=window, scale=scale,
                q_offset=q_offset)
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)
    return _flash(q, k, v, causal=causal, window=window, scale=scale,
                  q_offset=int(q_offset))
