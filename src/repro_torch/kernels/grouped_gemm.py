"""Grouped expert GEMM: bf16 operands, f32 accumulation, f32 output.

The counterpart of ``jax.lax.ragged_dot(..., preferred_element_type=
jnp.float32)`` in the reference's ``_moe_ep_inner``
(``src/repro/models/moe.py``), which leaves it to XLA: ``out[i] = xs[i] @
w[g]`` for every row ``i`` of expert ``g``, the rows ``offs[g-1]:offs[g]``
of the MoE's hits sorted by expert. The Hopper kernel
(``csrc/grouped_gemm.cu``) runs the products on ``wgmma`` fed by TMA over a
persistent grid: every CTA scans the device-side offsets into each
expert's tiles and walks the tiles that hold rows, so nothing is read to
the host and the MoE runs inside the engine's sync-guarded decode chunks.
The output is f32, as the reference's: nothing rounds an expert's product
to bf16.

:func:`launch_config` picks the tile shape, the rows' TMA box and the
grid from the shapes alone (never from the offsets' values):

* **decode** (``m <= DECODE_MAX_ROWS``): 64 x 64 tiles, one per hit expert
  and 64 columns, the rows' TMA box ``m`` rounded up to 8;
* **admission**: 128 columns a tile, 128 rows (two consumer warpgroups)
  where the experts average at least ``TALL_ROWS_PER_EXPERT`` rows (``m >=
  48 E``), so such an expert streams each weight slice once, else 64.

Each shape is the fastest of the three somewhere on an H100
(``benchmarks/grouped_gemm_ab.py`` forces each in turns): 64 x 64 at
qwen3-moe's and deepseek-v2's 4-token decode gates, 64 x 128 at their
16-token batches and at deepseek-v2's admission (38 rows an expert), 128
x 128 at qwen3-moe's admission (64 rows an expert). Every shape gives a
call the same bits.

The grid is ``min(SMs, max_items)``, ``max_items = (m // bm + min(m, E)) *
ceil(N / bn)`` bounding the work items any offsets can make: the kernel
takes item ``t * n_tiles + j`` as column tile ``j`` of the ``t``-th row
tile (experts in order, ``ceil(rows / bm)`` tiles each), CTA ``c`` the
items ``c, c + grid, ...``.

:func:`grouped_gemm_plain` beside it is the plain PyTorch version of the
same function (``F.grouped_mm`` over f32-widened operands, which computes
the same sums); a CPU tensor takes it, a CUDA tensor takes the kernel.

Training reaches the kernel through :class:`GroupedGemm`, an autograd
Function whose forward is the kernel, unchanged, and whose backward is
:func:`grouped_gemm_plain_vjp`: one product per expert over the rows its
offsets delimit, ``dxs = g @ w[e]^T`` and ``dw[e] = xs^T @ g``, in f32
(``F.grouped_mm``'s own backward refuses the CPU's strides). A backward
kernel is ROADMAP B6.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref

_LIB = "grouped_gemm"
#: experts the kernel's shared-memory tables hold (csrc MAX_EXPERTS)
MAX_EXPERTS = 1024
#: calls of at most this many rows take the decode regime's 64 x 64 tiles
DECODE_MAX_ROWS = 64
#: average rows an expert needs before an admission takes 128-row tiles
TALL_ROWS_PER_EXPERT = 48
#: the kernel's tile shapes by config id: (rows, columns)
TILES = {0: (64, 64), 1: (64, 128), 2: (128, 128)}
#: streaming multiprocessors of an H100 SXM (the grid's default bound)
H100_SMS = 132


class LaunchConfig(NamedTuple):
    regime: str     # "decode" or "admission"
    config: int     # the kernel's tile shape, a key of TILES
    bm: int         # rows a tile
    bn: int         # columns a tile
    a_rows: int     # rows of one TMA box of xs
    max_items: int  # work items any offsets can make at these shapes
    grid: int       # persistent CTAs: min(sms, max_items)


@functools.lru_cache(maxsize=256)
def launch_config(m: int, k: int, n: int, e: int, sms: int = H100_SMS,
                  config: Optional[int] = None) -> LaunchConfig:
    """The kernel's tile shape, rows' box and grid for ``xs (m, K)``, ``w
    (E, K, N)`` on a card of ``sms`` SMs: a function of the shapes alone.
    ``config`` (a key of TILES) forces a tile shape, to measure the
    shapes against each other; by default the regime picks it."""
    if config is None:
        if m <= DECODE_MAX_ROWS:
            config = 0
        else:
            config = 2 if m >= TALL_ROWS_PER_EXPERT * e else 1
    regime = "decode" if config == 0 else "admission"
    bm, bn = TILES[config]
    a_rows = min(bm, -(-max(m, 1) // 8) * 8)
    max_items = (m // bm + min(m, e)) * -(-n // bn)
    return LaunchConfig(regime, config, bm, bn, a_rows, max_items,
                        max(1, min(sms, max_items)))


def _expert_rows(offs: torch.Tensor):
    """``(expert, first row, end row)`` of every expert that holds rows
    (the offsets read to the host)."""
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            yield e, start, end
        start = max(start, end)


def grouped_gemm_plain(xs: torch.Tensor, w: torch.Tensor,
                       offs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`grouped_gemm`: both operands
    widened to f32, one grouped GEMM, f32 out. f64 operands (gradient
    checks; ``F.grouped_mm`` takes none) take one product per expert."""
    f = ref.wide(xs.dtype)
    if f == torch.float32:
        return F.grouped_mm(xs.float(), w.float(), offs=offs)
    out = xs.new_zeros((xs.shape[0], w.shape[2]), dtype=f)
    for e, lo, hi in _expert_rows(offs):
        out[lo:hi] = xs[lo:hi].to(f) @ w[e].to(f)
    return out


def grouped_gemm_plain_vjp(xs: torch.Tensor, w: torch.Tensor,
                           offs: torch.Tensor, grad_out: torch.Tensor
                           ) -> tuple:
    """``(dxs, dw)`` of :func:`grouped_gemm_plain` against ``grad_out``
    ``(m, N)``, in the operands' dtypes: each expert's rows' product with
    its transposed weights, and its weights' gradient from its rows, in
    f32 (f64 for f64 operands). Rows at or past ``offs[E-1]`` and experts
    without rows get zeros. Counts its calls."""
    grouped_gemm_plain_vjp.calls += 1
    f = ref.wide(xs.dtype)
    dxs = torch.zeros(xs.shape, dtype=f, device=xs.device)
    dw = torch.zeros(w.shape, dtype=f, device=w.device)
    for e, lo, hi in _expert_rows(offs):
        g = grad_out[lo:hi].to(f)
        dxs[lo:hi] = g @ w[e].to(f).t()
        dw[e] = xs[lo:hi].to(f).t() @ g
    return dxs.to(xs.dtype), dw.to(w.dtype)


grouped_gemm_plain_vjp.calls = 0


class GroupedGemm(torch.autograd.Function):
    """``forward(xs, w, offs, fn)``: ``fn`` (the kernel,
    :func:`grouped_gemm`; the tests hand it :func:`grouped_gemm_plain`)
    computes the f32 output; the backward is
    :func:`grouped_gemm_plain_vjp`."""

    @staticmethod
    def forward(ctx, xs, w, offs, fn):
        ctx.save_for_backward(xs, w, offs)
        return fn(xs, w, offs)

    @staticmethod
    def backward(ctx, grad_out):
        return (*grouped_gemm_plain_vjp(*ctx.saved_tensors, grad_out),
                None, None)


def check_inputs(xs: torch.Tensor, w: torch.Tensor,
                 offs: torch.Tensor) -> tuple:
    """Raise for operands the kernel does not take: bf16 ``xs (m, K)`` and
    ``w (E, K, N)``, contiguous, on one device; ``offs`` a contiguous
    ``(E,)`` int32 tensor there; K and N multiples of 8; at most
    MAX_EXPERTS experts. Returns the output's shape ``(m, N)``."""
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
    if not 1 <= w.shape[0] <= MAX_EXPERTS:
        raise ValueError(f"grouped_gemm takes 1 to {MAX_EXPERTS} experts, got "
                         f"{w.shape[0]}")
    return xs.shape[0], n


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry, looked up once (building on first use); the
    library's expert limit is held to MAX_EXPERTS there."""
    lib = build.library(_LIB)
    if lib.grouped_gemm_max_experts() != MAX_EXPERTS:
        raise RuntimeError(f"csrc/grouped_gemm.cu takes "
                           f"{lib.grouped_gemm_max_experts()} experts, the "
                           f"wrapper {MAX_EXPERTS}")
    return lib.grouped_gemm_bf16_f32


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grouped_gemm(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                 config: Optional[int] = None) -> torch.Tensor:
    """xs (m, K) bf16, w (E, K, N) bf16, offs (E,) int32 -> (m, N) f32.

    ``offs[g]`` ends expert ``g``'s rows (non-decreasing, at most m); rows
    at or past ``offs[E-1]`` are not computed. On a CUDA tensor what
    :func:`check_inputs` takes launches ``csrc/grouped_gemm.cu`` once (m =
    0 launches nothing) with :func:`launch_config`'s tiles (``config``
    forces a shape of TILES); anything else raises. A CPU tensor takes
    :func:`grouped_gemm_plain`.
    """
    if xs.device.type == "cpu":
        return grouped_gemm_plain(xs, w, offs)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {xs.device}")
    m, n = check_inputs(xs, w, offs)
    out = torch.empty((m, n), dtype=torch.float32, device=xs.device)
    if m == 0:
        return out
    e, k = w.shape[0], w.shape[1]
    conf = launch_config(m, k, n, e, _sms(xs.device.index), config)
    rc = _entry()(xs.data_ptr(), w.data_ptr(), offs.data_ptr(),
                  out.data_ptr(), m, k, n, e, conf.config, conf.a_rows,
                  conf.grid, torch.cuda.current_stream(xs.device).cuda_stream)
    if rc:
        build.check(_LIB, rc)
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0
