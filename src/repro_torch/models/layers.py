"""Shared building blocks: norms, linear, SwiGLU, embeddings, RoPE and
multimodal RoPE.

The counterpart of ``src/repro/models/layers.py``, with the same numerics:
weights are stored f32 and used as bf16, products accumulate in f32, a
bias is added in f32 before the cast back, and logits stay f32 (a bf16
rounding of 150k logits would tie and move the argmax).

Under a serving mesh (``distributed.tensor_parallel.use_mesh``) a rank
holds its shards of the weights: :func:`linear_column`, :func:`linear_row`,
:func:`mlp` and :func:`embed` compute on them and talk to the other ranks
of the ``model`` axis where a dim is cut; the logits are the rank's
columns. Without a mesh they are the single-device computation.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    return x.to(dtype)


#: What the init functions do with each leaf the moment it is made:
#: ``leaf(name, tensor)`` returns what the tree keeps under ``name``.
#: :func:`keep` keeps the f32 leaf; the serving copy's rule
#: (``repro_torch.models.api``) casts it there, so the f32 leaf is freed
#: before the next one is drawn.
Leaf = Callable[[str, torch.Tensor], torch.Tensor]


def keep(name: str, x: torch.Tensor) -> torch.Tensor:
    return x


class _DotF32(torch.autograd.Function):
    """``x (M, K) @ w (K, N)``, bf16 operands, f32 out, on cuBLAS — an op
    without an autograd formula, so this Function gives it one. The
    backward rounds the f32 cotangent to bf16 and takes the same GEMM for
    ``dx = g w^T`` and ``dw = x^T g`` (f32 sums, cast to the operands'
    bf16): the reference's transposed dots multiply an f32 cotangent by a
    bf16 operand, which the TPU's default precision runs as one bf16
    pass."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(COMPUTE_DTYPE)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.t(), out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x.t(), g, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 output from bf16 weights: every product is exact
    in f32 and the sum accumulates in f32 (the reference's
    ``preferred_element_type=jnp.float32``). On the card a bf16 ``x`` takes
    cuBLAS's bf16 GEMM with an f32 output (under autograd through
    :class:`_DotF32`); elsewhere both sides widen to f32 first, which
    computes the same sums."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        x2, wb = x.reshape(-1, x.shape[-1]), cast(w)
        if torch.is_grad_enabled() and (x2.requires_grad or wb.requires_grad):
            out = _DotF32.apply(x2, wb)
        else:
            out = torch.mm(x2, wb, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), cast(w).float())


# --------------------------------------------------------------------- norms

def init_rmsnorm(d: int, device, leaf: Leaf = keep) -> Dict:
    return {"scale": leaf("scale", torch.ones((d,), dtype=torch.float32,
                                              device=device))}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


# ----------------------------------------------------------------- linear

def randn(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Standard-normal f32 weights times ``scale``, on ``gen``'s device
    (scaled in place: one tensor, the same bits as ``randn(...) *
    scale``)."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(scale)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = dot_f32(x, w)
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def linear_column(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, full: int,
                  gather: bool = False) -> torch.Tensor:
    """:func:`linear` over the columns of ``w`` (``full`` in all) a rank
    holds; with ``gather`` every rank's columns, whole."""
    out = linear(x, w, b)
    if gather and tp.model_size() > 1 and tp.split(w.shape[-1], full):
        out = tp.all_gather(out, -1)
    return out


def linear_row(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               full: int) -> torch.Tensor:
    """:func:`linear` where ``w`` holds a rank's rows (``full`` in all):
    the f32 product of the rank's slice of ``x`` (``x`` itself where it
    already is that slice), summed over ``model``, then the bias and the
    cast. A ``w`` held whole is :func:`linear`."""
    n = w.shape[-2]
    if not tp.split(n, full):
        return linear(x, w, b)
    if x.shape[-1] != n:
        r = tp.model_rank()
        x = x[..., r * n:(r + 1) * n]
    out = tp.all_sum(dot_f32(x, w))
    if b is not None:
        out = out + b
    return out.to(x.dtype)


# ----------------------------------------------------------------- SwiGLU

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             n: int = 1, leaf: Leaf = keep) -> Dict:
    """SwiGLU weights, stacked ``n`` deep on a leading axis."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": leaf("w_gate", randn(gen, (n, d_model, d_ff), s_in)),
        "w_up": leaf("w_up", randn(gen, (n, d_model, d_ff), s_in)),
        "w_down": leaf("w_down", randn(gen, (n, d_ff, d_model), s_out)),
    }


def mlp(p: Dict, x: torch.Tensor, d_ff: Optional[int] = None
        ) -> torch.Tensor:
    """SwiGLU; given its width ``d_ff``, tensor-parallel under a serving
    mesh (``w_gate`` / ``w_up`` column shards, ``w_down`` a row shard)."""
    h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    if d_ff is None:
        return linear(h, p["w_down"])
    return linear_row(h, p["w_down"], full=d_ff)


# ------------------------------------------------------------- embeddings

def init_embed(gen: torch.Generator, vocab: int, d_model: int, *,
               tie: bool, leaf: Leaf = keep) -> Dict:
    p = {"embed": leaf("embed", randn(gen, (vocab, d_model), 0.02))}
    if not tie:
        p["unembed"] = leaf("unembed", randn(gen, (vocab, d_model), 0.02))
    return p


def embed(p: Dict, tokens: torch.Tensor,
          vocab: Optional[int] = None) -> torch.Tensor:
    """The lookup; given the table's ``vocab`` rows, under a serving mesh
    from a rank's rows of it: the rows it holds, zeros for the others,
    summed over ``model`` (exact: one rank adds a non-zero row)."""
    table = cast(p["embed"])
    n = table.shape[0]
    if vocab is None or not tp.split(n, vocab):
        return table[tokens.long()]
    idx = tokens.long() - tp.model_rank() * n
    inside = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)].float()
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return tp.all_sum(rows).to(table.dtype)


def unembed_logits(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits ``(..., padded_vocab)``; under a serving mesh the
    columns of the rank's vocabulary rows."""
    table = p.get("unembed", p["embed"])
    return dot_f32(x, cast(table).t())


# ------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[:, None, :, None].float() * freqs       # (B,1,S,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): the ``head_dim / 2`` frequencies split
    into (temporal, height, width) sections, each driven by its own
    position stream. x: (B, H, S, D); positions3: (3, B, S) int."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim "
                         f"/ 2 = {half}")
    freqs = rope_freqs(d, theta, x.device)                     # (half,)
    # which of the 3 position streams drives each frequency (made on the
    # device from the section bounds: no host data inside a decode chunk)
    idx = torch.arange(half, device=x.device)
    sect_id = ((idx >= sections[0]).long()
               + (idx >= sections[0] + sections[1]).long())    # (half,)
    pos = positions3[sect_id]                                  # (half,B,S)
    angles = pos.permute(1, 2, 0).float() * freqs              # (B,S,half)
    cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
