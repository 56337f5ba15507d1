"""Mamba-1 selective scan on Hopper, with an optional carried state.

The counterpart of ``src/repro/kernels/mamba_scan.py``. The Hopper kernel
(``csrc/mamba_scan.cu``) runs one CTA per block of ``BLOCK_D`` channels of
one batch row and walks the whole sequence inside it, ``plan.chunk`` time
steps per phase staged in shared memory; each channel's ``Ds`` f32 states
stay in registers (``SPLIT`` threads share a channel). The chunk only sizes
the staging, so every plan gives the same output bit for bit.

Beyond the TPU kernel, which starts from a zero state and returns only y,
this one takes an optional initial state ``h0`` (B, Di, Ds) f32 and, with
``return_state``, writes the final state. That is no new feature: it is the
function the reference computes for its carried-state calls (prefill and
decode of a recurrent cache), which it sends to its oracle
(``src/repro/kernels/ops.py:126-130``), a ``lax.scan`` that XLA compiles on
the TPU. The port's plain version takes one Python step per position, so
on the card those calls take the kernel too.

The kernel holds at most ``MAX_DS`` states per channel; a larger ``Ds``, a
length the chunk does not divide, or a plan whose staging does not fit one
block's 232448 B of shared memory is refused with the numbers, never
shrunk. :func:`mamba_scan_plain` beside it is the plain PyTorch version; a
CPU tensor takes it, a CUDA tensor takes the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.hw_profiles import H100_SXM
from repro_torch.core.tiling import ScanChunkPlan
from repro_torch.kernels import build, ref

_LIB = "mamba_scan"
#: the kernel's limits (``csrc/mamba_scan.cu``: MAX_DS, BD, SPLIT,
#: MAX_SMEM); held equal to the source by tests/test_torch_ssm.py
MAX_DS = 16
BLOCK_D = 32
SPLIT = 4
SMEM_BYTES = H100_SXM.smem_per_block
DTYPES = (torch.float32, torch.bfloat16)


def staging_bytes(chunk: int, d_state: int) -> int:
    """Shared memory of one launch (``smem_bytes`` in the source): ``chunk``
    steps of the block's x and dt columns and of B_t, C_t, as f32."""
    return 4 * chunk * (2 * BLOCK_D + 2 * d_state)


def check_plan(plan: ScanChunkPlan, length: int, d_state: int) -> int:
    """The chunk the kernel runs for ``plan`` at ``length`` (the plan's
    chunk clamped to the length, as in the reference); raise unless the
    kernel takes it."""
    chunk = min(plan.chunk, length)
    if not 1 <= d_state <= MAX_DS:
        raise ValueError(f"mamba_scan holds at most {MAX_DS} states per "
                         f"channel in registers, got d_state = {d_state}")
    if chunk < 1 or length % chunk:
        raise ValueError(f"mamba_scan: chunk {chunk} does not divide the "
                         f"length {length}")
    need = staging_bytes(chunk, d_state)
    if need > SMEM_BYTES:
        raise ValueError(
            f"mamba_scan cannot take chunk {chunk}: staging {chunk} steps of "
            f"{BLOCK_D} channels and {d_state} states takes {need} B, more "
            f"than the {SMEM_BYTES} B of shared memory one H100 block may "
            f"claim; plan from the h100 target")
    return chunk


def scan_work(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
              h0: Optional[torch.Tensor] = None,
              return_state: bool = False) -> Tuple[int, int]:
    """What the scan must do for these inputs, whatever the kernel: the
    bytes it moves (each input read once, y and the final state written
    once) and the ``B * L * Di * Ds`` exponentials it computes."""
    ins = (x, dt, a, b, c, d) + (() if h0 is None else (h0,))
    n_bytes = sum(t.numel() * t.element_size() for t in ins)
    n_bytes += x.numel() * x.element_size()
    if return_state:
        n_bytes += 4 * x.shape[0] * x.shape[2] * a.shape[1]
    return n_bytes, x.numel() * a.shape[1]


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                     h0: Optional[torch.Tensor] = None,
                     return_state: bool = False):
    """The plain PyTorch version of :func:`mamba_scan`; counts its calls."""
    mamba_scan_plain.calls += 1
    return ref.selective_scan_ref(x, dt, a, b, c, d, h0=h0,
                                  return_state=return_state)


mamba_scan_plain.calls = 0


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
               plan: ScanChunkPlan, h0: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """x, dt: (B, L, Di); a: (Di, Ds); b, c: (B, L, Ds); d: (Di,) ->
    y (B, L, Di) in x's dtype, and the final f32 state (B, Di, Ds) with
    ``return_state``.

    x, b and c share one dtype, f32 or bf16 (the model gives bf16); dt,
    a, d and ``h0`` are f32 (the model's dt is softplus of a bf16
    projection plus an f32 bias). All contiguous on a CUDA tensor, and
    anything the kernel does not take raises. A CPU tensor takes
    :func:`mamba_scan_plain`.
    """
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"mamba_scan takes x, dt (B, L, Di), got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    bsz, length, di = x.shape
    if a.dim() != 2 or a.shape[0] != di or d.shape != (di,):
        raise ValueError(f"mamba_scan takes a (Di, Ds) and d (Di,) with Di "
                         f"= {di}, got {tuple(a.shape)} and {tuple(d.shape)}")
    ds = a.shape[1]
    if b.shape != (bsz, length, ds) or c.shape != b.shape:
        raise ValueError(f"mamba_scan takes b, c {(bsz, length, ds)}, got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    if h0 is not None and h0.shape != (bsz, di, ds):
        raise ValueError(f"h0 must be {(bsz, di, ds)}, got "
                         f"{tuple(h0.shape)}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"mamba_scan takes x = b = c in f32 or bf16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, a, d) + (
            () if h0 is None else (h0,))):
        raise TypeError("mamba_scan takes f32 dt, a, d and h0")
    if length < 1 or bsz < 1:
        raise ValueError(f"mamba_scan: empty input {tuple(x.shape)}")
    chunk = check_plan(plan, length, ds)
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, a, b, c, d, h0=h0,
                                return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    tensors = (x, dt, a, b, c, d) + (() if h0 is None else (h0,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("mamba_scan: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_scan takes contiguous operands")
    if bsz > 65535:
        raise ValueError(f"mamba_scan: batch {bsz} exceeds the grid's 65535")
    lib = build.library(_LIB)
    y = torch.empty_like(x)
    ht = (torch.empty((bsz, di, ds), dtype=torch.float32, device=x.device)
          if return_state else None)
    rc = lib.mamba_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), None if ht is None else ht.data_ptr(),
        bsz, length, di, ds, chunk, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(_LIB, rc)
    mamba_scan.launches += 1
    return (y, ht) if return_state else y


mamba_scan.launches = 0
