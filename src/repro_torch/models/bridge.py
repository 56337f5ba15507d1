"""Weight bridge: a params tree of numpy arrays <-> a tree of tensors.

The port keeps the reference's parameter tree (``params["groups"][name]
["pos{i}"]``, stacked over repeats, matrices stored ``(d_in, d_out)``), so
weights made by the reference's ``Model.init`` and converted to numpy by
the caller load here by a plain tree map: same keys, same shapes, no
transposes. Under a mesh the same full tree is cut to each rank's shards
(:func:`sharded_from_numpy`) and put back together
(:func:`sharded_to_numpy`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.train.optimizer import QTensor, tree_map


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device`` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy`."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def opt_state_from_numpy(state: Any, device) -> Any:
    """An optimizer state of numpy arrays (the reference's ``{m, v, step}``
    converted by the caller, its int8 moments any object with ``q`` and
    ``scale`` fields) -> the port's, on ``device``: int8 moments become
    :class:`repro_torch.train.optimizer.QTensor`\\ s of tensors."""
    if isinstance(state, dict):
        return {k: opt_state_from_numpy(v, device) for k, v in state.items()}
    if hasattr(state, "q") and hasattr(state, "scale"):
        return QTensor(params_from_numpy(state.q, device),
                       params_from_numpy(state.scale, device))
    return params_from_numpy(state, device)


def opt_state_to_numpy(state: Any) -> Any:
    """The inverse of :func:`opt_state_from_numpy`; int8 moments stay
    ``QTensor``\\ s, of numpy arrays."""
    if isinstance(state, dict):
        return {k: opt_state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, QTensor):
        return QTensor(params_to_numpy(state.q), params_to_numpy(state.scale))
    return params_to_numpy(state)


def sharded_from_numpy(tree: Any, mesh) -> tuple:
    """A full numpy params tree -> ``(this rank's shards, specs)`` on
    ``mesh``'s device (``train.loop.place``: the reference's rules)."""
    from repro_torch.train.loop import place
    return place(params_from_numpy(tree, mesh.device), mesh)


def sharded_to_numpy(tree: Any, specs: Any, mesh) -> Any:
    """This rank's shards -> the full numpy tree (collective: every rank of
    ``mesh`` calls it; each leaf is all-gathered)."""
    return tree_map(lambda p, s: shd.gather_full(
        p.detach().contiguous(), s, mesh).cpu().numpy(), tree, specs)
