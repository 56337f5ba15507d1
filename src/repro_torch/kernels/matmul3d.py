"""The paper's kernel: capacity-planned tiled matmul on Hopper.

The counterpart of ``src/repro/kernels/matmul3d.py``. MemPool-3D keeps the
A, B and C tiles resident in the shared-L1 scratchpad and sizes them to fill
it; on the H100 the scratchpad is the shared memory one thread block may
claim (232448 B). The Hopper kernel (``csrc/matmul3d.cu``) runs one CTA per
``(bm, bn)`` output tile, double-buffers the A and B tiles in dynamic
shared memory sized from the plan, keeps the f32 C tile across
the whole K loop (in registers up to ``MAX_REG_BLOCK`` x ``MAX_REG_BLOCK``,
in shared memory beyond), and casts once on the store.

Block sizes come from :func:`repro_torch.core.tiling.plan_matmul` at run
time. The kernel takes plans with two buffers (every planner default),
and a plan whose working set
(``plan.vmem_bytes``: the buffered A/B tiles plus the f32 C tile, as the
planner counts it) or whose launch exceeds one block's shared memory is
refused, never shrunk: a plan sized for a TPU's VMEM raises here.

:func:`matmul3d_plain` beside it is the plain PyTorch version; a CPU tensor
takes it, a CUDA tensor takes the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hw_profiles import H100_SXM
from repro_torch.core.target import get_target
from repro_torch.core.tiling import MatmulPlan
from repro_torch.kernels import build, ref

_LIB = "matmul3d"
#: the kernel's limits (``csrc/matmul3d.cu``: MAX_REG_BLOCK, N_BUFFERS,
#: MAX_SMEM); held equal to the source by tests/test_torch_matmul.py
MAX_REG_BLOCK = 128
N_BUFFERS = 2
SMEM_BYTES = H100_SXM.smem_per_block
DTYPES = (torch.float32, torch.bfloat16)


def smem_bytes(plan: MatmulPlan, in_bytes: int) -> int:
    """Shared memory of one launch (``smem_bytes`` in the source): the
    buffered A/B tiles, then the f32 C tile at a 16-byte boundary when it
    is too large for registers."""
    streamed = plan.n_buffers * plan.streamed_bytes(in_bytes)
    if max(plan.bm, plan.bn) <= MAX_REG_BLOCK:
        return streamed
    return -(-streamed // 16) * 16 + plan.resident_bytes()


def check_plan(plan: MatmulPlan, in_bytes: int) -> None:
    """Raise unless the kernel takes ``plan`` for ``in_bytes``-wide inputs:
    ``N_BUFFERS`` buffers, and a working set (the planner's count) and a
    launch that both fit one H100 block's shared memory."""
    need = max(plan.vmem_bytes(in_bytes), smem_bytes(plan, in_bytes))
    if (need <= SMEM_BYTES and plan.n_buffers == N_BUFFERS
            and min(plan.bm, plan.bk, plan.bn) >= 1):
        return
    raise ValueError(
        f"matmul3d cannot take plan (bm, bk, bn) = ({plan.bm}, {plan.bk}, "
        f"{plan.bn}) x {plan.n_buffers} buffers (current target "
        f"{get_target().name}): its working set is {need} B for "
        f"{in_bytes}-byte inputs and an f32 C tile, and the kernel takes "
        f"{N_BUFFERS} buffers within the {SMEM_BYTES} B of shared memory "
        f"one H100 block may claim; plan from the h100 target")


def matmul3d_plain(a: torch.Tensor, b: torch.Tensor, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`matmul3d` (f32 accumulation)."""
    return ref.matmul_ref(a, b, out_dtype)


def matmul3d(a: torch.Tensor, b: torch.Tensor, *, plan: MatmulPlan,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with the plan's blocks; dims must divide them.

    As in the reference, blocks are first clamped to the problem
    (``min(plan.bm, M)``, ...). f32 or bf16 inputs (both the same), f32 or
    bf16 out (default: the input dtype). On a CUDA tensor the operands must
    be contiguous; anything the kernel does not take raises. A CPU tensor
    takes :func:`matmul3d_plain`.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul3d takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"matmul3d takes two f32 or two bf16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in DTYPES:
        raise TypeError(f"matmul3d writes f32 or bf16, not {out_dtype}")
    check_plan(plan, a.element_size())
    m, k = a.shape
    n = b.shape[1]
    bm, bk, bn = min(plan.bm, m), min(plan.bk, k), min(plan.bn, n)
    if min(bm, bk, bn) < 1 or m % bm or k % bk or n % bn:
        raise ValueError(f"pad first: {(m, k, n)} vs blocks {(bm, bk, bn)}")
    if m // bm > 65535:
        raise ValueError(f"matmul3d: {m // bm} row blocks exceed the grid's "
                         f"65535")
    if a.device.type == "cpu":
        return matmul3d_plain(a, b, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"matmul3d: unsupported device {a.device}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul3d takes contiguous row-major operands")
    lib = build.library(_LIB)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    launcher = (lib.matmul3d_f32 if a.dtype == torch.float32
                else lib.matmul3d_bf16)
    rc = launcher(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                  bm, bn, bk, plan.n_buffers,
                  int(out_dtype == torch.bfloat16),
                  torch.cuda.current_stream(a.device).cuda_stream)
    build.check(_LIB, rc)
    matmul3d.launches += 1
    return out


matmul3d.launches = 0
