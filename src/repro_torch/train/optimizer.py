"""AdamW with optional 8-bit (blockwise-quantized) moments.

The counterpart of ``src/repro/train/optimizer.py``: the same schedule,
the same last-dim blockwise absmax int8 codec (``QBLOCK`` values a block,
one f32 scale each, the payload keeping the parameter's own shape), the
same update, written as functions on the params tree (nested dicts of
tensors) on the params' device, under ``torch.no_grad()``. No weight decay
on leaves below 2-D; gradients are clipped by their global norm.

:func:`adamw_update` writes the new params and the f32 moments into the
tensors it is given (on the card a functional update would hold a second
copy of the largest leaves; the reference's XLA program donates its
buffers to the same end) and returns them; int8 moments are re-encoded
into new ``QTensor``\\ s.

Under a mesh (``mesh`` and the params' ``specs``) every leaf is this
rank's shard and the update is elementwise on it. The global norm sums
each leaf's squares over its distinct shards: a leaf held by several ranks
(replicated, or split over fewer axes than the mesh has) counts once. The
int8 codec's blocks run along the last dim, so a leaf split on its last
dim keeps the single-device blocks only where the shard width is a
multiple of ``QBLOCK``; the int8 moments of any other leaf split on its
last dim are kept whole (replicated) on every rank and updated from the
gathered gradient (:func:`moments_whole`), so the codec sees the blocks it
sees on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd

QBLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized_moments: bool = False


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; f32 0-d on
    ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ------------------------------------------------------- int8 moment codec

class QTensor(NamedTuple):
    q: torch.Tensor       # int8, same shape as the parameter
    scale: torch.Tensor   # f32, (..., ceil(last / QBLOCK))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Last-dim blockwise absmax int8. Returns (q int8 of x's shape, scale
    f32 of shape ``x.shape[:-1] + (ceil(last / QBLOCK),)``)."""
    last = x.shape[-1] if x.dim() else 1
    xr = x.reshape(tuple(x.shape) or (1,))
    nb = -(-last // QBLOCK)
    xp = F.pad(xr, (0, nb * QBLOCK - last))
    blocks = xp.reshape(*xr.shape[:-1], nb, QBLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0                  # (..., nb)
    rep = scale.repeat_interleave(QBLOCK, dim=-1)[..., :last]
    q = torch.round(xr / torch.clamp(rep, min=1e-20)).to(torch.int8)
    return q.reshape(x.shape), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    last = shape[-1] if len(shape) else 1
    qr = q.reshape(tuple(q.shape) or (1,))
    rep = scale.repeat_interleave(QBLOCK, dim=-1)[..., :last]
    return (qr.float() * rep).reshape(shape)


Moment = Union[torch.Tensor, QTensor]


def _enc(x: torch.Tensor, quantized: bool) -> Moment:
    return QTensor(*_quantize(x)) if quantized else x


def _dec(t: Moment, shape, quantized: bool) -> torch.Tensor:
    return _dequantize(t.q, t.scale, shape) if quantized else t


# ------------------------------------------------------------------ trees

def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (a tensor or a QTensor is a
    leaf), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


# ----------------------------------------------------------------- adamw

def moments_whole(p: torch.Tensor, spec, mesh, quantized: bool) -> bool:
    """True where a shard ``p`` of ``spec`` keeps whole int8 moments: its
    last dim is split and the shard's width is not a multiple of
    ``QBLOCK``."""
    if mesh is None or spec is None or not quantized or not p.dim():
        return False
    split = any(shd.axis_size(mesh, n) > 1 for n in shd.spec_axes(spec[-1:]))
    return split and p.shape[-1] % QBLOCK != 0


def _no_specs(params: Any, specs: Any) -> Any:
    return specs if specs is not None else tree_map(lambda _: None, params)


def init_opt_state(params: Any, cfg: OptConfig, *, mesh=None,
                   specs: Any = None) -> Dict[str, Any]:
    """Zero moments (f32, or int8 ``QTensor``\\ s) beside every leaf and a
    0-d int32 step, on the params' device; under a mesh each beside its
    shard, or whole (:func:`moments_whole`)."""
    def zeros(p, spec):
        shape = (shd.global_shape(p.shape, spec, mesh)
                 if moments_whole(p, spec, mesh, cfg.quantized_moments)
                 else p.shape)
        return _enc(torch.zeros(shape, dtype=torch.float32,
                                device=p.device), cfg.quantized_moments)
    specs = _no_specs(params, specs)
    return {"m": tree_map(zeros, params, specs),
            "v": tree_map(zeros, params, specs),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def global_norm(tree: Any, *, mesh=None, specs: Any = None) -> torch.Tensor:
    """The L2 norm over every leaf; under a mesh over the shards of
    ``specs``, each leaf counted once."""
    if mesh is None:
        return torch.sqrt(torch.sum(torch.stack(
            [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)])))
    parts = []
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        sq = torch.sum(torch.square(x.float()))
        share = shd.shard_count(spec, mesh) / mesh.size
        parts.append(sq if share == 1 else sq * share)
    total = torch.sum(torch.stack(parts))
    if mesh.size > 1:
        dist.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: OptConfig, *, mesh=None, specs: Any = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: returns ``(params, state, {lr, grad_norm})``. The
    params and f32 moments are updated in place (see the module's
    docstring); the step, the lr and the norm stay on the device. Under a
    mesh the params and grads are this rank's shards of ``specs``."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    quant = cfg.quantized_moments

    def upd(p, g, m_t, v_t, spec):
        whole = moments_whole(p, spec, mesh, quant)
        if whole:                 # the moments' blocks need the whole leaf
            g = shd.gather_full(g.contiguous(), spec, mesh)
        shape = g.shape
        g = g.float() * scale
        m = cfg.b1 * _dec(m_t, shape, quant) + (1 - cfg.b1) * g
        v = cfg.b2 * _dec(v_t, shape, quant) + (1 - cfg.b2) * g * g
        del g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if whole:
            u = shd.local_shard(u, spec, mesh)
        if p.dim() >= 2:                              # no wd on norms
            u = u + cfg.weight_decay * p
        p.copy_(p - lr * u)
        if quant:
            return p, _enc(m, True), _enc(v, True)
        m_t.copy_(m)
        v_t.copy_(v)
        return p, m_t, v_t

    out = tree_map(upd, params, grads, state["m"], state["v"],
                   _no_specs(params, specs))
    pick = lambda i: tree_map(lambda o: o[i], out)        # noqa: E731
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"lr": lr, "grad_norm": gnorm})
