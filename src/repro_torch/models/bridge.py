"""Weight bridge: a params tree of numpy arrays <-> a tree of tensors.

The port keeps the reference's parameter tree (``params["groups"][name]
["pos{i}"]``, stacked over repeats, matrices stored ``(d_in, d_out)``), so
weights made by the reference's ``Model.init`` and converted to numpy by
the caller load here by a plain tree map: same keys, same shapes, no
transposes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


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
