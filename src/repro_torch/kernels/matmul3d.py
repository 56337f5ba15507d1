"""The paper's kernel: capacity-planned tiled matmul on Hopper.

The counterpart of ``src/repro/kernels/matmul3d.py`` (``_matmul_kernel``,
the Pallas TPU kernel). MemPool-3D keeps the A, B and C tiles resident in
the shared-L1 scratchpad and sizes them to fill it; on the H100 the
scratchpad is the shared memory one thread block may claim (232448 B).
``csrc/matmul3d.cu`` runs one CTA per ``(bm, bn)`` output tile, keeps the
plan's two buffers of A and B tiles in dynamic shared memory (the planner's
``n_buffers * streamed_bytes``, nothing more), holds the f32 C tile across
the whole K loop (in registers up to ``MAX_REG_BLOCK`` x ``MAX_REG_BLOCK``,
in shared memory beyond), and casts once on the store.

bf16 inputs run on the tensor cores: a producer warp keeps TMA loads of the
next A and B tiles in flight into the 2-stage ring (a full and an empty
mbarrier per stage, 64- or 128-byte swizzle), and ``bm / 64`` consumer
warpgroups issue ``wgmma`` m64n{bn}k16 over each stage, B read MN-major as
it lies. wgmma takes 64 rows per warpgroup and the kernel's chunks 32
columns, so the kernel runs blocks that are multiples of ``TC_M`` = 64
rows, ``TC_N`` = 32 columns and ``TC_K`` = 32 deep. Every ``h100`` plan of
a problem at least its own size is already on that grain; a plan clamped
to a small problem (``(32, 32, 19)`` for 37 x 45 x 19) is rounded up to it
(``(64, 32, 32)``) and the operands are zero-padded to match and the
result cropped, as ``ops.matmul`` pads to block multiples
(:func:`kernel_blocks`). No bf16 input reaches a scalar-FMA path. At the
paper sweep's M = 8192 the plan's own HBM traffic, not the operations,
should bound the kernel (16.25 GiB at the default (128, 64, 128): 5.2 ms
at 3.35 TB/s unless L2 catches the reuse, against 1.11 ms of operations).

f32 inputs stay on the CUDA cores (scalar FMAs, per-thread tile loads): no
tensor-core instruction multiplies full f32, and TF32's ~3 decimal digits
would miss the sweep's 1e-4 relative tolerance at K = 8192.

Block sizes come from :func:`repro_torch.core.tiling.plan_matmul` at run
time. The kernel takes plans with two buffers (every planner default), and
a plan whose working set (``plan.vmem_bytes``: the buffered A/B tiles plus
the f32 C tile, as the planner counts it) or whose launch exceeds one
block's shared memory is refused, never shrunk: a plan sized for a TPU's
VMEM raises here.

:func:`matmul3d_plain` beside it is the plain PyTorch version; a CPU tensor
takes it, a CUDA tensor takes the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.hw_profiles import H100_SXM
from repro_torch.core.target import get_target
from repro_torch.core.tiling import MatmulPlan
from repro_torch.kernels import build, ref

_LIB = "matmul3d"
#: the kernel's limits (``csrc/matmul3d.cu``: MAX_REG_BLOCK, N_BUFFERS,
#: MAX_SMEM, TC_M, TC_N, TC_K, BARRIER_BYTES); held equal to the source by
#: tests/test_torch_matmul.py
MAX_REG_BLOCK = 128
N_BUFFERS = 2
SMEM_BYTES = H100_SXM.smem_per_block
TC_M, TC_N, TC_K = 64, 32, 32       # the tensor-core kernel's block grain
BARRIER_BYTES = 2 * N_BUFFERS * 8    # its full and empty mbarriers
DTYPES = (torch.float32, torch.bfloat16)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def tensor_core_plan(plan: MatmulPlan) -> MatmulPlan:
    """``plan`` with its blocks rounded up to the tensor-core kernel's grain
    (rows to ``TC_M``, columns to ``TC_N``, depth to ``TC_K``)."""
    return MatmulPlan(_round_up(plan.bm, TC_M), _round_up(plan.bk, TC_K),
                      _round_up(plan.bn, TC_N), plan.n_buffers)


def kernel_blocks(plan: MatmulPlan, m: int, k: int, n: int,
                  in_bytes: int) -> Tuple[int, int, int]:
    """The (bm, bk, bn) the kernel runs for an (m, k) @ (k, n) problem:
    the plan clamped to the problem, as in the reference, then (bf16)
    rounded up to the tensor-core grain. Operands must be padded to
    multiples of these."""
    eff = MatmulPlan(min(plan.bm, m), min(plan.bk, k), min(plan.bn, n),
                     plan.n_buffers)
    if in_bytes == 2:
        eff = tensor_core_plan(eff)
    return eff.bm, eff.bk, eff.bn


def smem_bytes(plan: MatmulPlan, in_bytes: int) -> int:
    """Shared memory of one launch (``tc_smem_bytes`` / ``f32_smem_bytes``
    in the source). bf16: the ring of A/B tiles at the tensor-core grain,
    the f32 C tile when it is too large for registers, then the mbarriers.
    f32: the buffered A/B tiles, then the f32 C tile at a 16-byte boundary
    when it is too large for registers."""
    if in_bytes == 2:
        tc = tensor_core_plan(plan)
        tiles = tc.n_buffers * tc.streamed_bytes(2)
        if max(tc.bm, tc.bn) > MAX_REG_BLOCK:
            tiles += tc.resident_bytes()
        return tiles + BARRIER_BYTES
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

    The blocks are :func:`kernel_blocks`: clamped to the problem as in the
    reference (``min(plan.bm, M)``, ...), and for bf16 rounded up to the
    tensor-core grain (``ops.matmul`` pads to them). f32 or bf16 inputs
    (both the same), f32 or bf16 out (default: the input dtype). On a CUDA
    tensor the operands must be contiguous with 16-byte aligned bases (TMA
    reads them); anything the kernel does not take raises. A CPU tensor
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
    bm, bk, bn = kernel_blocks(plan, m, k, n, a.element_size())
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
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("matmul3d takes operands at 16-byte aligned "
                         "addresses")
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
