"""Train step factory: mixed precision, gradient accumulation, remat.

The counterpart of ``src/repro/train/loop.py`` on one device. The params
are f32 masters; every step casts the leaves of 2-D and above to bf16
compute copies inside the graph (:func:`_cast_params_for_compute`, the
reference's rule, which is not the serving ``Model.prepare`` rule), so the
gradients flow back through the casts to the f32 leaves. Microbatch
gradients accumulate in f32 and are averaged, then AdamW applies them.

Memory on the card: f32 params, grads and moments, the transient bf16
copy, and with ``remat`` one layer's activations at a time (each layer
keeps only its input; the backward recomputes it).

Under a mesh (``make_train_step(..., mesh=, specs=)``) each rank keeps its
shard of every param, gradient and moment as ``spec_for_param`` places it
(:func:`place`). The global batch splits over the ``pod`` and ``data``
axes and is replicated over ``model``; microbatches split the rank's
slice. Each leaf is gathered at use (``sharding.gather``), whose backward
reduce-scatters the gradient onto the shard as the mean over the batch
slices. Each rank's loss is weighted by its share of the labelled tokens,
so the step's loss and gradients are those of the whole batch, as the
single-device step computes them. A rank computes the whole model: the
``model`` axis shards the weights but not the compute (training on the
tensor-parallel layers that serving runs is ROADMAP A13c).
:func:`make_compressed_train_step` syncs each
pod's gradients over the ``pod`` axis as int8 with error feedback.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
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


def make_train_step(model: Model, tcfg: TrainConfig, *,
                    mesh: Optional[shd.Mesh] = None,
                    specs: Any = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; ``batch`` holds ``(global_batch, ...)`` tensors on the
    model's device. The metrics (0-d tensors on the device) are the
    loss's (``loss``, ``aux``, ``tokens``; of the last microbatch), the
    optimizer's (``lr``, ``grad_norm``) and ``total_loss``, the total
    averaged over the microbatches. Under ``mesh`` the params and the
    moments are this rank's shards of ``specs`` (:func:`place`) and
    ``batch`` is still the global batch: the step takes its rank's
    slice."""
    if mesh is not None:
        return _sharded_step(model, tcfg, mesh, specs)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _accumulate(
            lambda b: value_and_grad(model, params, b, remat=tcfg.remat),
            tcfg.n_microbatches, batch)
        new_params, new_opt, opt_metrics = opt_mod.adamw_update(
            params, grads, opt_state, tcfg.opt)
        return new_params, new_opt, dict(metrics, **opt_metrics,
                                         total_loss=loss)

    return train_step


def place(params: Any, mesh: shd.Mesh) -> Tuple[Any, Any]:
    """``(this rank's shards, specs)`` of the full ``params`` under the
    reference's rules (``sharding.param_specs``); a leaf the mesh does not
    split is kept as it is."""
    specs = shd.param_specs(params, mesh)
    return tree_map(lambda p, s: shd.local_shard(p, s, mesh), params,
                    specs), specs


def state_placements(params: Any, specs: Any, mesh: shd.Mesh,
                     opt_cfg: opt_mod.OptConfig) -> Dict[str, Any]:
    """Where each leaf of ``{"params", "opt"}`` lives, for the checkpoint
    manager: the params and their moments as ``specs`` place them, an
    int8 moment's scales beside its codes, whole moments
    (``optimizer.moments_whole``) and the step on every rank whole."""
    def moment(p, spec):
        if opt_mod.moments_whole(p, spec, mesh, opt_cfg.quantized_moments):
            return (opt_mod.QTensor(None, None)
                    if opt_cfg.quantized_moments else None)
        place = shd.Placement(mesh, spec)
        return (opt_mod.QTensor(place, place)
                if opt_cfg.quantized_moments else place)
    moments = tree_map(moment, params, specs)
    return {"params": tree_map(lambda s: shd.Placement(mesh, s), specs),
            "opt": {"m": moments, "v": moments, "step": None}}


def batch_axes(mesh: shd.Mesh) -> Tuple[str, ...]:
    """The mesh axes the batch splits over, major first."""
    return tuple(a for a in shd.BATCH if a in mesh.axis_names)


def rank_slice(batch: Dict[str, torch.Tensor], mesh: shd.Mesh,
               axes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch split over ``axes``."""
    index, count = shd.batch_index(mesh, axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"global batch {v.shape[0]} does not split "
                             f"over {count} ranks ({', '.join(axes)})")
        out[k] = v.chunk(count, 0)[index] if count > 1 else v
    return out


def _all_sum(x: torch.Tensor, mesh: shd.Mesh, axes) -> torch.Tensor:
    x = x.clone()
    for name in axes:
        if shd.axis_size(mesh, name) > 1:
            dist.all_reduce(x, group=mesh.group(name))
    return x


def _sharded_grads(model: Model, tcfg: TrainConfig, mesh: shd.Mesh,
                   specs: Any, params: Any, batch: Dict[str, torch.Tensor],
                   axes: Tuple[str, ...], cast: bool):
    """``(objective, metrics, grads)`` of one microbatch, this rank's slice
    of it in ``batch``: the params gathered at use, the gradient of each
    shard the mean over the ranks of ``axes`` (the batch axes the step
    reduces over). The objective weights the rank's loss by its share of
    the labelled tokens over ``axes``, so its mean over them is the loss
    of the whole microbatch."""
    count = shd.batch_index(mesh, axes)[1]
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    live = tree_leaves(tree)
    tokens = (batch["labels"] >= 0).sum().float()
    weight = (count * tokens / _all_sum(tokens, mesh, axes)
              if count > 1 else None)
    with torch.enable_grad(), shd.use_batch_axes(mesh, axes):
        full = tree_map(lambda p, s: shd.gather(p, s, mesh, axes), tree,
                        specs)
        if cast:
            full = _cast_params_for_compute(full)
        total, metrics = model.loss(full, batch, remat=tcfg.remat)
        del full
        objective = total
        if weight is not None:
            objective = total + (weight - 1) * metrics["loss"]
        grads = torch.autograd.grad(objective, live, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(live, grads)])
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    if weight is not None:
        metrics["loss"] = metrics["loss"] * weight
    return objective.detach(), metrics, tree_map(lambda _: next(grads),
                                                params)


def _batch_metrics(objective, metrics, mesh, axes) -> Tuple:
    """The objective and the loss averaged over the ranks of ``axes``, the
    labelled tokens summed over them."""
    count = shd.batch_index(mesh, axes)[1]
    if count == 1:
        return objective, metrics
    stacked = _all_sum(torch.stack([objective, metrics["loss"],
                                    metrics["tokens"].float()]), mesh, axes)
    metrics = dict(metrics, loss=stacked[1] / count,
                   tokens=stacked[2].to(metrics["tokens"].dtype))
    return stacked[0] / count, metrics


def _accumulate(grad_fn: Callable, n: int, batch: Dict[str, torch.Tensor]):
    """``grad_fn`` (a microbatch -> ``(loss, metrics, grads)``) over ``n``
    microbatches of ``batch``: the loss and grads averaged (grads summed in
    f32), the metrics of the last microbatch."""
    if n <= 1:
        return grad_fn(batch)
    micro = _split_micro(batch, n)
    grads, loss = None, 0.0
    for i in range(n):
        l_i, metrics, g_i = grad_fn({k: v[i] for k, v in micro.items()})
        loss = loss + l_i
        if grads is None:
            grads = tree_map(lambda g: g.float(), g_i)
        else:
            tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
        del g_i
    return loss / n, metrics, tree_map(lambda g: g / n, grads)


def _sharded_accumulate(model, tcfg, mesh, specs, params, batch, axes, cast):
    """:func:`_accumulate` of :func:`_sharded_grads` over this rank's
    slice ``batch``."""
    return _accumulate(lambda b: _sharded_grads(
        model, tcfg, mesh, specs, params, b, axes, cast),
        tcfg.n_microbatches, batch)


def _sharded_step(model: Model, tcfg: TrainConfig, mesh: shd.Mesh,
                  specs: Any) -> Callable:
    if specs is None:
        raise ValueError("a sharded train step needs the params' specs "
                         "(loop.place)")
    axes = batch_axes(mesh)

    def train_step(params, opt_state, batch):
        local = rank_slice(batch, mesh, axes)
        loss, metrics, grads = _sharded_accumulate(
            model, tcfg, mesh, specs, params, local, axes, cast=True)
        loss, metrics = _batch_metrics(loss, metrics, mesh, axes)
        new_params, new_opt, opt_metrics = opt_mod.adamw_update(
            params, grads, opt_state, tcfg.opt, mesh=mesh, specs=specs)
        return new_params, new_opt, dict(metrics, **opt_metrics,
                                         total_loss=loss)

    return train_step


def make_compressed_train_step(model: Model, tcfg: TrainConfig,
                               mesh: shd.Mesh, specs: Any) -> Callable:
    """The multi-pod variant: returns ``train_step(params, opt_state, err,
    batch) -> (params, opt, err, metrics)``. Each pod computes the
    gradients of its slice of the batch (reduced over its own ``data``
    ranks, the loss on the f32 params as the reference's variant takes
    them), then the pods sync them over the ``pod`` axis as int8 with
    error feedback (``collectives.compressed_grad_sync``); ``err`` holds
    the residuals, pod-local, one beside every shard
    (``collectives.init_error_feedback(params)``)."""
    if shd.POD_AXIS not in mesh.axis_names:
        raise ValueError(f"the compressed step syncs over a 'pod' axis; "
                         f"the mesh has {mesh.axis_names}")
    n_pods = mesh.shape[shd.POD_AXIS]
    axes = batch_axes(mesh)
    within = tuple(a for a in axes if a != shd.POD_AXIS)

    def train_step(params, opt_state, err, batch):
        local = rank_slice(batch, mesh, axes)
        loss, metrics, grads = _sharded_accumulate(
            model, tcfg, mesh, specs, params, local, within, cast=False)
        loss, metrics = _batch_metrics(loss, metrics, mesh, within)
        grads, new_err = collectives.compressed_grad_sync(
            grads, err, mesh.group(shd.POD_AXIS), n_pods)
        loss, metrics = _batch_metrics(loss, metrics, mesh,
                                       (shd.POD_AXIS,))
        new_params, new_opt, opt_metrics = opt_mod.adamw_update(
            params, grads, opt_state, tcfg.opt, mesh=mesh, specs=specs)
        return new_params, new_opt, new_err, dict(metrics, **opt_metrics,
                                                  total_loss=loss)

    return train_step
