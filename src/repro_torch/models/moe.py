"""Mixture-of-experts: top-k routing, shared experts, grouped expert FFNs.

The counterpart of ``src/repro/models/moe.py`` on one device. Two
implementations of the same function:

* ``dense`` — the plain version, the reference's ``_moe_dense``: every
  expert runs every token, in f32 with f32 weights. The CPU runs it, as
  the reference does on one device.
* ``grouped`` — the reference's ``_moe_ep_inner`` at one shard (no psum):
  the token -> expert hits are sorted by expert, the expert FFNs run on
  bf16 operands with f32 accumulation and f32 output, as the reference's
  ``ragged_dot(..., preferred_element_type=f32)``, ``act`` is cast back to
  the activation dtype, and the gate-weighted combine runs in f32. At one
  shard the capacity is ``min(t k, ceil(capacity_factor t k))``, so at the
  configs' factor of 2 no hit is dropped. The card runs it: the dense
  version would read every expert's weights on every decode step.

The grouped products are one grouped GEMM per projection
(:func:`repro_torch.kernels.ops.grouped_matmul`: on the card the
hand-written ``grouped_gemm`` kernel, on the CPU its plain version over
f32-widened operands; the reference leaves ``jax.lax.ragged_dot`` to XLA)
over the hits sorted by expert, delimited by offsets computed on the
device: no count is read to the host, so the same code runs in a prefill
and inside the engine's sync-guarded decode chunks, and each hit expert's
weights are read once.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cast, randn

def init_moe(cfg: ModelConfig, gen: torch.Generator, n: int = 1,
             leaf: layers.Leaf = layers.keep) -> Dict:
    """MoE weights in the reference's tree, stacked ``n`` deep: ``router``
    ``(d, E)``, ``we_gate`` / ``we_up`` ``(E, d, f)``, ``we_down`` ``(E, f,
    d)`` and, with shared experts, ``shared``: one SwiGLU of width
    ``moe_d_ff * n_shared_experts``. Each expert leaf is one draw, however
    large (the draws' order and shapes fix the bits)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": leaf("router", randn(gen, (n, d, e), s_in)),
        "we_gate": leaf("we_gate", randn(gen, (n, e, d, f), s_in)),
        "we_up": leaf("we_up", randn(gen, (n, e, d, f), s_in)),
        "we_down": leaf("we_down", randn(gen, (n, e, f, d), s_out)),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(gen, d, f * cfg.n_shared_experts, n,
                                      leaf)
    return p


def _route(router_w: torch.Tensor, xt: torch.Tensor, top_k: int):
    """Returns (gates (T, k) f32, idx (T, k), probs (T, E) f32)."""
    probs = torch.softmax(xt.float() @ router_w.float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Load-balancing loss (Switch / GShard): ``E * sum_e f_e * P_e``.
    Under a sharded train step f_e and P_e are averaged over the ranks the
    batch is split over before the product (``sharding.batch_mean``), so
    the sharded aux equals the single-device one, as the reference's
    ``batch_axes`` make it."""
    hits = F.one_hot(idx, n_experts).float().sum(1)            # (T, E)
    f_e = shd.batch_mean(hits.mean(0))
    p_e = shd.batch_mean(probs.mean(0))
    return n_experts * torch.sum(f_e * p_e)


# ------------------------------------------------------------------ dense

def _moe_dense(p: Dict, xt: torch.Tensor, cfg: ModelConfig):
    gates, idx, probs = _route(p["router"], xt, cfg.top_k)
    xf = xt.float()
    h = torch.einsum("td,edf->tef", xf, p["we_gate"].float())
    u = torch.einsum("td,edf->tef", xf, p["we_up"].float())
    y_e = torch.einsum("tef,efd->ted", F.silu(h) * u, p["we_down"].float())
    w_te = (F.one_hot(idx, cfg.n_experts).float()
            * gates[..., None]).sum(1)                          # (T, E)
    y = torch.einsum("ted,te->td", y_e, w_te)
    return y.to(xt.dtype), _aux_loss(probs, idx, cfg.n_experts)


# ---------------------------------------------------------------- grouped

def _offsets(sel_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The end of each expert's run in the sorted hit experts ``sel_e``
    (int32, the running sum of the per-expert counts), computed on
    ``sel_e``'s device: no count is read to the host."""
    experts = torch.arange(n_experts, device=sel_e.device, dtype=sel_e.dtype)
    return torch.searchsorted(sel_e, experts, right=True, out_int32=True)


def _grouped(xs: torch.Tensor, w: torch.Tensor,
             offs: torch.Tensor) -> torch.Tensor:
    """``xs[i] @ w[g]`` for every sorted hit ``i`` of expert ``g`` (the rows
    ``offs[g-1]:offs[g]``): bf16 operands, f32 accumulation, f32 out, on
    either device (:func:`repro_torch.kernels.ops.grouped_matmul`)."""
    return ops.grouped_matmul(cast(xs), cast(w), offs)


def _moe_grouped(p: Dict, xt: torch.Tensor, cfg: ModelConfig):
    t, d = xt.shape
    k, e = cfg.top_k, cfg.n_experts
    gates, idx, probs = _route(p["router"], xt, k)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    cap = min(t * k, int(math.ceil(cfg.capacity_factor * t * k)))
    sel = order[:cap]
    sel_e = flat_e[sel]
    offs = _offsets(sel_e, e)
    xs = xt[sel // k]                                        # (cap, d)
    h = _grouped(xs, p["we_gate"], offs)
    u = _grouped(xs, p["we_up"], offs)
    act = (F.silu(h) * u).to(xt.dtype)
    out = _grouped(act, p["we_down"], offs)                  # (cap, d) f32
    # the combine: each hit back at its (token, rank) place, weighted by its
    # gate, then summed over the k ranks in f32 (a fixed order: no atomics)
    contrib = out.new_zeros((t * k, d))
    contrib[sel] = out * gates.reshape(-1)[sel, None]
    y = contrib.reshape(t, k, d).sum(1)
    return y.to(xt.dtype), _aux_loss(probs, idx, e)


# ------------------------------------------------------------------ public

def moe_block(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Adds shared experts if configured.

    ``impl="auto"`` runs ``grouped`` on a CUDA tensor and ``dense`` on the
    CPU."""
    b, s, d = x.shape
    if impl == "auto":
        impl = "grouped" if x.is_cuda else "dense"
    if impl == "dense":
        y, aux = _moe_dense(p, x.reshape(b * s, d), cfg)
    elif impl == "grouped":
        y, aux = _moe_grouped(p, x.reshape(b * s, d), cfg)
    else:
        raise ValueError(f"unknown MoE impl {impl!r} (auto | dense | "
                         f"grouped)")
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + layers.mlp(p["shared"], x)
    return y, aux

