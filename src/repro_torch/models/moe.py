"""Mixture-of-experts: top-k routing, shared experts, grouped expert FFNs,
expert parallelism.

The counterpart of ``src/repro/models/moe.py``. Three implementations of
the same function:

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
* ``ep`` — the reference's ``_moe_ep`` on a serving mesh ``(data 1, model
  M)`` (``distributed.tensor_parallel.use_mesh``): the experts sit on
  ``model``, ``n_experts / M`` a rank (the paper's remote banks: a token
  reaches expert weights held in another card's memory). Every rank routes
  every token with the replicated f32 router, keeps its own experts' hits
  (the others sort last, behind a stable argsort of the local expert id)
  up to ``cap = min(t k, ceil(capacity_factor t k / M))`` rows, runs the
  grouped body over its experts and sums the combined outputs over
  ``model``. Hits past the cap are dropped (they add zero, as in GShard),
  so which are dropped depends on every row of the call. The reference's
  byte rule (:func:`ep_body`) picks one of its two data-movement bodies,
  which at ``data`` = 1 differ only in the sum's precision: the
  weight-gather body casts to the activation dtype and sums in it, the
  partial-K body sums f32 and casts once. ``impl="auto"`` runs it under a
  serving mesh whose model axis is above 1 and divides the experts. Shared
  experts (deepseek-v2's) are one SwiGLU, tensor-parallel over ``model``
  as the reference's rules place any SwiGLU, added after the routed sum.

The grouped products are one grouped GEMM per projection
(:func:`repro_torch.kernels.ops.grouped_matmul`: on the card the
hand-written ``grouped_gemm`` kernel, on the CPU its plain version over
f32-widened operands; the reference leaves ``jax.lax.ragged_dot`` to XLA)
over the hits sorted by expert, delimited by offsets computed on the
device: no count is read to the host, so the same code runs in a prefill
and inside the engine's sync-guarded decode chunks, and each hit expert's
weights are read once. Rows at or past the last offset (a rank's hits of
other ranks' experts) are not computed, and hold whatever the output's
memory held: they are dropped by ``torch.where``, never multiplied by 0.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
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
    y, aux = _ep_partial(p, xt, cfg, 0, 1)
    return y.to(xt.dtype), aux


# --------------------------------------------------------------------- ep

WEIGHT_GATHER, PARTIAL_K = "weight_gather", "partial_k"

class EpCount(NamedTuple):
    """What the expert-parallel calls inside a :func:`count_ep` block did:
    ``bodies`` the calls by the body each took, ``drops`` this rank's
    dropped hits (its own experts' hits past the cap) of each call, as
    device scalars, or None where the block counts no drops."""
    bodies: collections.Counter
    drops: Optional[list]


_COUNTS: list = []


@contextlib.contextmanager
def count_ep(drops: bool = True):
    """Count the expert-parallel calls made inside the block into the
    :class:`EpCount` it yields (the innermost block counts). The drops are
    read after the block (a host read, so never around a sync-guarded
    decode chunk); ``drops=False`` leaves them uncomputed."""
    rec = EpCount(collections.Counter(), [] if drops else None)
    _COUNTS.append(rec)
    try:
        yield rec
    finally:
        _COUNTS.pop()


def ep_body(cfg: ModelConfig, b: int, s: int, m: int) -> str:
    """The data-movement body the reference's ``_moe_ep`` picks for a
    ``(b, s)`` batch on a serving mesh ``(data 1, model m)``
    (``src/repro/models/moe.py:224-250``; at ``data`` = 1 its batch axes
    are ``("data",)``, the 2D split holds and the gather spans one rank, so
    the rule is its byte test on all ``b s`` tokens): partial-K where the
    tokens, the capacity rows' activations and the partial sums move fewer
    bytes than a gather of the rank's bf16 expert weights, else
    weight-gather."""
    d, t = cfg.d_model, b * s
    weight_bytes = 3 * (cfg.n_experts // m) * d * cfg.moe_d_ff * 2
    cap = int(math.ceil(cfg.capacity_factor * t * cfg.top_k / m))
    token_bytes = t * d * 2 + 4 * cap * cfg.moe_d_ff * 4 + 2 * t * d * 4
    return PARTIAL_K if token_bytes < weight_bytes else WEIGHT_GATHER


class EpRoute(NamedTuple):
    """One rank's routes: ``gates`` / ``idx`` (T, k) and ``probs`` (T, E)
    of every token; ``sel`` (cap,) the flat hits (``token k + j``) it
    keeps in order, ``sel_e`` their local experts (``E_loc`` for another
    rank's expert, sorted last) and ``local`` (T k,) which hits are its
    own."""
    gates: torch.Tensor
    idx: torch.Tensor
    probs: torch.Tensor
    sel: torch.Tensor
    sel_e: torch.Tensor
    local: Optional[torch.Tensor]


def ep_route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
             rank: int, n_shards: int) -> EpRoute:
    """Rank ``rank`` of ``n_shards``'s routes of every token of ``xt``
    (the reference's ``_moe_ep_inner`` up to its ``sel``): local experts
    first by a stable argsort of ``loc_e``, cut at the reference's ``cap =
    min(t k, ceil(capacity_factor t k / n_shards))`` (a host integer), on
    the device. At one shard every hit is local (``local`` is None)."""
    t, k = xt.shape[0], cfg.top_k
    e_loc = cfg.n_experts // n_shards
    gates, idx, probs = _route(router, xt, k)
    flat_e = idx.reshape(-1)
    local = None
    if n_shards > 1:
        lo = rank * e_loc
        local = (flat_e >= lo) & (flat_e < lo + e_loc)
        flat_e = torch.where(local, flat_e - lo, e_loc)
    order = torch.argsort(flat_e, stable=True)
    cap = min(t * k, int(math.ceil(cfg.capacity_factor * t * k / n_shards)))
    sel = order[:cap]
    return EpRoute(gates, idx, probs, sel, flat_e[sel], local)


def _ep_partial(p: Dict, xt: torch.Tensor, cfg: ModelConfig, rank: int,
                n_shards: int):
    """Rank ``rank`` of ``n_shards``'s share of the MoE output, f32 (T,
    d), before the sum over ``model``, and the aux loss. ``p`` holds the
    rank's ``E / n_shards`` experts. The rows it keeps of other ranks'
    experts sit past the last offset: the grouped products leave them
    uncomputed and ``torch.where`` drops them from the activation and the
    combine."""
    t, d = xt.shape
    k, e_loc = cfg.top_k, cfg.n_experts // n_shards
    r = ep_route(p["router"], xt, cfg, rank, n_shards)
    offs = _offsets(r.sel_e, e_loc)
    xs = xt[r.sel // k]                                      # (cap, d)
    h = _grouped(xs, p["we_gate"], offs)
    u = _grouped(xs, p["we_up"], offs)
    act = F.silu(h) * u
    out_gate = r.gates.reshape(-1)[r.sel, None]
    if r.local is not None:
        valid = (r.sel_e < e_loc)[:, None]
        if _COUNTS and _COUNTS[-1].drops is not None:
            _COUNTS[-1].drops.append(r.local.sum() - valid.sum())
        act = torch.where(valid, act, 0.0)
    out = _grouped(act.to(xt.dtype), p["we_down"], offs)     # (cap, d) f32
    out = out * out_gate
    if r.local is not None:
        out = torch.where(valid, out, 0.0)
    # the combine: each hit back at its (token, rank) place, weighted by its
    # gate, then summed over the k ranks in f32 (a fixed order: no atomics)
    contrib = out.new_zeros((t * k, d))
    contrib[r.sel] = out
    y = contrib.reshape(t, k, d).sum(1)
    return y, _aux_loss(r.probs, r.idx, cfg.n_experts)


def use_ep(cfg: ModelConfig) -> bool:
    """The reference's ``use_ep`` under ``impl="auto"``: a serving mesh
    whose model axis is above 1 and divides the experts. Training's mesh
    is not a serving one: its train step gathers the experts at use."""
    m = tp.model_size()
    return tp.active() is not None and m > 1 and cfg.n_experts % m == 0


def _moe_ep(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    mesh = tp.active()
    if mesh is None:
        raise ValueError("impl='ep' runs on a serving mesh "
                         "(distributed.tensor_parallel.use_mesh)")
    shape = dict(mesh.shape)
    others = {a: n for a, n in shape.items()
              if a != shd.MODEL_AXIS and n > 1}
    if others:
        raise NotImplementedError(
            f"expert-parallel MoE runs at data = 1; "
            f"{', '.join(f'{a}={n}' for a, n in others.items())} (its fsdp "
            f"gathers and the 2D split) is not ported yet (ROADMAP A13c)")
    m = shape.get(shd.MODEL_AXIS, 1)
    if cfg.n_experts % m:
        raise ValueError(f"{cfg.n_experts} experts do not split over a "
                         f"model axis of {m}")
    b, s, d = x.shape
    body = ep_body(cfg, b, s, m)
    if _COUNTS:
        _COUNTS[-1].bodies[body] += 1
    y, aux = _ep_partial(p, x.reshape(b * s, d), cfg, tp.model_rank(), m)
    if body == WEIGHT_GATHER:   # the reference's psum in the activation dtype
        y = tp.all_sum(y.to(x.dtype))
    else:                       # its f32 psum, cast once
        y = tp.all_sum(y).to(x.dtype)
    return y.reshape(b, s, d), aux


# ------------------------------------------------------------------ public

def moe_block(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
              impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Adds shared experts if configured
    (under a serving mesh a tensor-parallel SwiGLU: each rank's column
    shards of ``w_gate`` / ``w_up`` and row shard of ``w_down``).

    ``impl="auto"`` runs ``ep`` where :func:`use_ep` holds, else
    ``grouped`` on a CUDA tensor and ``dense`` on the CPU."""
    b, s, d = x.shape
    if impl == "auto":
        impl = ("ep" if use_ep(cfg) else "grouped" if x.is_cuda
                else "dense")
    if impl == "dense":
        y, aux = _moe_dense(p, x.reshape(b * s, d), cfg)
    elif impl == "grouped":
        y, aux = _moe_grouped(p, x.reshape(b * s, d), cfg)
    elif impl == "ep":
        y, aux = _moe_ep(p, x, cfg)
    else:
        raise ValueError(f"unknown MoE impl {impl!r} (auto | dense | "
                         f"grouped | ep)")
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        # one SwiGLU, tensor-parallel under a serving mesh, added after the
        # routed sum as the reference adds it
        y = y + layers.mlp(p["shared"], x,
                           d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return y, aux

