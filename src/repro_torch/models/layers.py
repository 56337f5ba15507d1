"""Shared building blocks: norms, linear, SwiGLU, embeddings, RoPE.

The counterpart of ``src/repro/models/layers.py``, with the same numerics:
weights are stored f32 and used as bf16, products accumulate in f32, a
bias is added in f32 before the cast back, and logits stay f32 (a bf16
rounding of 150k logits would tie and move the argmax).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    return x.to(dtype)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 output from bf16 weights: every product is exact
    in f32 and the sum accumulates in f32 (the reference's
    ``preferred_element_type=jnp.float32``). On the card a bf16 ``x`` takes
    cuBLAS's bf16 GEMM with an f32 output; elsewhere both sides widen to
    f32 first, which computes the same sums."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), cast(w),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), cast(w).float())


# --------------------------------------------------------------------- norms

def init_rmsnorm(d: int, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


# ----------------------------------------------------------------- linear

def randn(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Standard-normal f32 weights times ``scale``, on ``gen``'s device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = dot_f32(x, w)
    if b is not None:
        out = out + b
    return out.to(x.dtype)


# ----------------------------------------------------------------- SwiGLU

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             n: int = 1) -> Dict:
    """SwiGLU weights, stacked ``n`` deep on a leading axis."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": randn(gen, (n, d_model, d_ff), s_in),
        "w_up": randn(gen, (n, d_model, d_ff), s_in),
        "w_down": randn(gen, (n, d_ff, d_model), s_out),
    }


def mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    return linear(h, p["w_down"])


# ------------------------------------------------------------- embeddings

def init_embed(gen: torch.Generator, vocab: int, d_model: int, *,
               tie: bool) -> Dict:
    p = {"embed": randn(gen, (vocab, d_model), 0.02)}
    if not tie:
        p["unembed"] = randn(gen, (vocab, d_model), 0.02)
    return p


def embed(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return cast(p["embed"])[tokens.long()]


def unembed_logits(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits ``(..., padded_vocab)``."""
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
