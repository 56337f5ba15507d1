"""Grouped expert GEMM: bf16 operands, f32 accumulation, f32 output.

The counterpart of ``jax.lax.ragged_dot(..., preferred_element_type=
jnp.float32)`` in the reference's ``_moe_ep_inner``
(``src/repro/models/moe.py``), which leaves it to XLA: ``out[i] = xs[i] @
w[g]`` for every row ``i`` of expert ``g``, the rows ``offs[g-1]:offs[g]``
of the MoE's hits sorted by expert. The Hopper kernel
(``csrc/grouped_gemm.cu``) runs the products on the tensor cores
(``mma.sync`` m16n8k16, bf16 in, f32 sums) over 64 x 128 output tiles,
each CTA finding its expert by a binary search over ``offs`` on the
device: the grid comes from the shapes alone, so nothing is read to the
host and the MoE runs inside the engine's sync-guarded decode chunks. The
output is f32, as the reference's: nothing rounds an expert's product to
bf16.

:func:`grouped_gemm_plain` beside it is the plain PyTorch version of the
same function (``F.grouped_mm`` over f32-widened operands, which computes
the same sums); a CPU tensor takes it, a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_LIB = "grouped_gemm"


def grouped_gemm_plain(xs: torch.Tensor, w: torch.Tensor,
                       offs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`grouped_gemm`: both operands
    widened to f32, one grouped GEMM, f32 out."""
    return F.grouped_mm(xs.float(), w.float(), offs=offs)


def check_inputs(xs: torch.Tensor, w: torch.Tensor,
                 offs: torch.Tensor) -> tuple:
    """Raise for operands the kernel does not take: bf16 ``xs (m, K)`` and
    ``w (E, K, N)``, contiguous, on one device; ``offs`` a contiguous
    ``(E,)`` int32 tensor there; K and N multiples of 8. Returns the
    output's shape ``(m, N)``."""
    for name, t in (("xs", xs), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"grouped_gemm takes bf16 {name}, got {t.dtype}")
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_gemm needs a contiguous {name}")
    if xs.ndim != 2 or w.ndim != 3 or w.shape[1] != xs.shape[1]:
        raise ValueError(f"grouped_gemm takes xs (m, K) and w (E, K, N), got "
                         f"xs {tuple(xs.shape)}, w {tuple(w.shape)}")
    k, n = w.shape[1], w.shape[2]
    if k % 8 or n % 8 or k == 0 or n == 0:
        raise ValueError(f"grouped_gemm copies 16-byte rows: K and N must be "
                         f"positive multiples of 8, got K {k}, N {n}")
    if (offs.dtype != torch.int32 or offs.shape != (w.shape[0],)
            or not offs.is_contiguous() or offs.device != xs.device):
        raise TypeError(f"offs must be a contiguous ({w.shape[0]},) int32 "
                        f"tensor on {xs.device}, got {offs.dtype} "
                        f"{tuple(offs.shape)} on {offs.device}")
    return xs.shape[0], n


def grouped_gemm(xs: torch.Tensor, w: torch.Tensor,
                 offs: torch.Tensor) -> torch.Tensor:
    """xs (m, K) bf16, w (E, K, N) bf16, offs (E,) int32 -> (m, N) f32.

    ``offs[g]`` ends expert ``g``'s rows (non-decreasing, at most m); rows
    at or past ``offs[E-1]`` are not computed. On a CUDA tensor what
    :func:`check_inputs` takes launches ``csrc/grouped_gemm.cu`` once;
    anything else raises. A CPU tensor takes :func:`grouped_gemm_plain`.
    """
    if xs.device.type == "cpu":
        return grouped_gemm_plain(xs, w, offs)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {xs.device}")
    m, n = check_inputs(xs, w, offs)
    lib = build.library(_LIB)
    if w.shape[0] > lib.grouped_gemm_max_experts():
        raise ValueError(f"grouped_gemm takes at most "
                         f"{lib.grouped_gemm_max_experts()} experts, got "
                         f"{w.shape[0]}")
    out = torch.empty((m, n), dtype=torch.float32, device=xs.device)
    rc = lib.grouped_gemm_bf16_f32(
        xs.data_ptr(), w.data_ptr(), offs.data_ptr(), out.data_ptr(), m,
        w.shape[1], n, w.shape[0],
        torch.cuda.current_stream(xs.device).cuda_stream)
    build.check(_LIB, rc)
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0
