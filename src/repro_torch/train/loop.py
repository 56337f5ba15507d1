"""Train step factory: mixed precision, gradient accumulation, remat.

The counterpart of ``src/repro/train/loop.py`` on one device. The params
are f32 masters; every step casts the leaves of 2-D and above to bf16
compute copies inside the graph (:func:`_cast_params_for_compute`, the
reference's rule, which is not the serving ``Model.prepare`` rule), so the
gradients flow back through the casts to the f32 leaves. Microbatch
gradients accumulate in f32 and are averaged, then AdamW applies them.

Memory on the card: f32 params, grads and moments, the transient bf16
copy, and with ``remat`` one layer's activations at a time (each layer
keeps only its input; the backward recomputes it). The sharded variants
(``make_compressed_train_step``, the gradients pinned to the params'
shardings) wait for the port of ``distributed/`` (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.api import Model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import tree_leaves, tree_map

#: params kept in f32 for compute even under mixed precision (numerics):
#: norm scales (1-D anyway), SSM decay logs, dt bias, router logits.
_F32_PARAM_NAMES = ("a_log", "scale", "dt_bias", "router")


def _cast_params_for_compute(params: Any, path: str = "") -> Any:
    """bf16 compute copies of the f32 leaves of 2-D and above, except the
    leaves whose ``/``-joined path names one of ``_F32_PARAM_NAMES``; the
    casts are recorded by autograd."""
    if isinstance(params, dict):
        return {k: _cast_params_for_compute(v, f"{path}/{k}")
                for k, v in params.items()}
    keep_f32 = (params.dim() < 2 or params.dtype != torch.float32
                or any(n in path.lower() for n in _F32_PARAM_NAMES))
    return params if keep_f32 else params.to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_mod.OptConfig = opt_mod.OptConfig()
    n_microbatches: int = 1
    remat: bool = True


def _split_micro(batch: Dict[str, torch.Tensor], n: int
                 ) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (n, B/n, ...) for the accumulation loop."""
    def f(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    return {k: f(v) for k, v in batch.items()}


def value_and_grad(model: Model, params: Any, batch: Dict[str, torch.Tensor],
                   *, remat: bool = True) -> Tuple[torch.Tensor, Dict, Any]:
    """``(total loss, loss metrics, grads)`` of ``model.loss`` at the f32
    master ``params`` through their compute casts, the counterpart of the
    reference's ``jax.value_and_grad(loss_fn)``: ``grads`` is a tree like
    ``params`` (zeros where a leaf does not reach the loss); the params'
    own ``requires_grad`` is left as it was."""
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    live = tree_leaves(tree)
    with torch.enable_grad():
        loss, metrics = model.loss(_cast_params_for_compute(tree), batch,
                                   remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(live, grads)])
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(grads), params)


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; ``batch`` holds ``(global_batch, ...)`` tensors on the
    model's device. The metrics (0-d tensors on the device) are the
    loss's (``loss``, ``aux``, ``tokens``; of the last microbatch), the
    optimizer's (``lr``, ``grad_norm``) and ``total_loss``, the total
    averaged over the microbatches."""

    def train_step(params, opt_state, batch):
        n = tcfg.n_microbatches
        if n <= 1:
            loss, metrics, grads = value_and_grad(model, params, batch,
                                                  remat=tcfg.remat)
        else:
            micro = _split_micro(batch, n)
            grads, loss = None, 0.0
            for i in range(n):
                l_i, metrics, g_i = value_and_grad(
                    model, params, {k: v[i] for k, v in micro.items()},
                    remat=tcfg.remat)
                loss = loss + l_i
                if grads is None:
                    grads = tree_map(lambda g: g.float(), g_i)
                else:
                    tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
                del g_i
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
        new_params, new_opt, opt_metrics = opt_mod.adamw_update(
            params, grads, opt_state, tcfg.opt)
        return new_params, new_opt, dict(metrics, **opt_metrics,
                                         total_loss=loss)

    return train_step


def make_compressed_train_step(model: Model, tcfg: TrainConfig, mesh):
    """The multi-pod variant (int8 + error-feedback gradient sync across
    the ``pod`` axis) needs a device mesh, which the port does not have
    yet."""
    raise NotImplementedError(
        "make_compressed_train_step syncs gradients across pods of a "
        "device mesh: it waits for the port of distributed/ (ROADMAP A13)")
