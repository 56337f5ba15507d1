"""Public entry points of the kernel package.

The counterpart of ``src/repro/kernels/ops.py``. Callers use these; they
dispatch to the Hopper kernel or to the plain PyTorch oracle with the
reference's rule: ``impl="auto"`` takes the kernel for CUDA tensors and the
oracle for CPU tensors, ``impl="kernel"`` / ``impl="ref"`` pin one side.

Matmul and scan plans come from the planner's cache for the current
target, as in the reference; the Hopper kernels take only plans that fit
one block's shared memory, so on the card the current target must be a GPU
target (``h100``). Unlike the reference, the selective scan's carried-state
calls (``h0`` / ``return_state``) take the kernel too on a CUDA tensor; see
:mod:`repro_torch.kernels.mamba_scan`.
"""

from __future__ import annotations

from typing import Literal, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import planner, tiling
from repro_torch.core.target import get_target
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.grouped_gemm import GroupedGemm
from repro_torch.kernels.grouped_gemm import grouped_gemm as _grouped
from repro_torch.kernels.matmul3d import (SMEM_BYTES, check_plan,
                                          kernel_blocks)
from repro_torch.kernels.matmul3d import matmul3d as _matmul
from repro_torch.kernels.mamba_scan import MambaScan, check_in_place
from repro_torch.kernels.mamba_scan import mamba_scan as _scan
from repro_torch.kernels.mamba_scan import mamba_scan_plain

Impl = Literal["auto", "kernel", "ref"]


def _use_kernel(impl: Impl, x: torch.Tensor) -> bool:
    if impl == "auto":
        return x.is_cuda
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | kernel | ref)")
    return impl == "kernel"


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _gpu_target(op: str, kernel: str):
    """The current target, which must be a GPU target when ``op`` plans
    for ``kernel`` on the card."""
    target = get_target()
    if target.kind != "gpu":
        raise ValueError(
            f"{op} plans from the current target {target.name}, whose "
            f"scratchpad holds {target.scratchpad_bytes} B; the {kernel} "
            f"kernel's tiles live in the {SMEM_BYTES} B of shared memory one "
            f"H100 block may claim: select a GPU target (h100)")
    return target


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()            # F.pad lists the last axis first
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return F.pad(x, widths)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           plan: Optional[tiling.MatmulPlan] = None,
           out_dtype: Optional[torch.dtype] = None,
           impl: Impl = "auto") -> torch.Tensor:
    """Capacity-aware tiled matmul; pads to block multiples then crops.

    ``plan=None`` plans from the current target, which must then be a GPU
    target; a given plan is checked against the kernel before it is
    clamped to the problem, and one that does not fit raises. The padding
    is to the blocks the kernel runs (``matmul3d.kernel_blocks``: for bf16,
    the clamped plan rounded up to the tensor-core grain).
    """
    if not _use_kernel(impl, a):
        return ref.matmul_ref(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    if plan is None:
        eff = planner.matmul_kernel_plan(
            m, k, n, in_bytes=a.element_size(),
            target=_gpu_target("ops.matmul", "matmul3d"))
    else:
        check_plan(plan, a.element_size())
        eff = planner.clamp_matmul_plan(plan, m, k, n)
    bm, bk, bn = kernel_blocks(eff, m, k, n, a.element_size())
    ap = _pad_to(_pad_to(a, 0, bm), 1, bk).contiguous()
    bp = _pad_to(_pad_to(b, 0, bk), 1, bn).contiguous()
    out = _matmul(ap, bp, plan=eff, out_dtype=out_dtype or a.dtype)
    return out[:m, :n]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None,
              scale: Optional[float] = None,
              q_offset: Union[int, torch.Tensor] = 0,
              plan: Optional[tiling.AttentionPlan] = None,
              impl: Impl = "auto") -> torch.Tensor:
    """Blockwise attention; q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v
    (B,Hkv,Skv,Dv); the output is (B,Hq,Sq,Dv). On the card the flash
    kernel takes (D, Dv) in ``flash_attention.HEAD_DIMS`` and raises for
    any other pair.

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
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale,
                                    int(q_offset), _flash)
    return _flash(q, k, v, causal=causal, window=window, scale=scale,
                  q_offset=int(q_offset))


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """The MoE's grouped expert product, the reference's ``ragged_dot``
    with f32 output: ``xs (m, K)`` rows sorted by expert, ``w (E, K, N)``,
    ``offs (E,)`` int32 ending each expert's rows (on ``xs``'s device: no
    count is read to the host). Returns ``(m, N)`` f32: the grouped_gemm
    kernel for a CUDA tensor, its plain version (f32-widened operands) for
    a CPU one. Under autograd it runs inside ``GroupedGemm``."""
    if _needs_grad(xs, w):
        return GroupedGemm.apply(xs, w, offs, _grouped)
    return _grouped(xs, w, offs)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                   plan: Optional[tiling.ScanChunkPlan] = None,
                   h0: Optional[torch.Tensor] = None,
                   return_state: bool = False,
                   state_in_place: bool = False,
                   impl: Impl = "auto"):
    """Mamba-1 selective scan (see ``ref.selective_scan_ref`` for shapes).

    ``plan=None`` plans from the current target, which must then be a GPU
    target; a given plan is clamped to the length. Both branches of the
    model's mamba block come here, so on the card every scan, with or
    without a carried state, runs the kernel. ``impl="kernel"`` needs a
    CUDA tensor. ``state_in_place`` (with ``h0`` and ``return_state``)
    writes the final state into ``h0`` and returns ``(y, h0)``.

    Under autograd the kernel runs inside ``MambaScan``, from a zero state
    and returning y alone: a CUDA tensor with ``h0`` or ``return_state``
    raises there, and ``state_in_place`` raises on either device.
    """
    grad = _needs_grad(x, dt, a, b, c, d)
    if state_in_place:
        if grad:
            raise ValueError("state_in_place overwrites h0, which autograd "
                             "cannot differentiate: a training scan carries "
                             "no state")
        check_in_place(h0, return_state)
    if not _use_kernel(impl, x):
        out = mamba_scan_plain(x, dt, a, b, c, d, h0=h0,
                               return_state=return_state)
        if state_in_place:
            h0.copy_(out[1])
            return out[0], h0
        return out
    if not x.is_cuda:
        raise ValueError(f"impl='kernel' runs the mamba_scan kernel on the "
                         f"card; x is on {x.device}")
    length, di, ds = x.shape[1], x.shape[2], a.shape[1]
    if plan is None:
        eff = planner.scan_kernel_plan(
            length, di, ds,
            target=_gpu_target("ops.selective_scan", "mamba_scan"))
    else:
        eff = planner.clamp_scan_plan(plan, length)
    if grad:
        if h0 is not None or return_state:
            raise ValueError("the mamba_scan kernel's autograd Function "
                             "scans from a zero state and returns y alone: "
                             "a training forward carries no state")
        return MambaScan.apply(
            x.contiguous(), dt.contiguous(), a.float().contiguous(),
            b.contiguous(), c.contiguous(), d.float().contiguous(),
            lambda *t: _scan(*t, plan=eff))
    return _scan(x.contiguous(), dt.contiguous(), a.float().contiguous(),
                 b.contiguous(), c.contiguous(), d.float().contiguous(),
                 plan=eff, return_state=return_state,
                 state_in_place=state_in_place,
                 h0=None if h0 is None else h0.float().contiguous())
