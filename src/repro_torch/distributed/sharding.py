"""Sharding rules: FSDP x TP x EP over a ``torch.distributed`` mesh.

The counterpart of ``src/repro/distributed/sharding.py``. The rules are
the reference's, copied: the ``model`` axis (MemPool's "group" level)
carries tensor- and expert-parallel placement; the ``data`` axis carries
the FSDP parameter shards and the data-parallel batch; the ``pod`` axis
(the "cluster" level) carries only the batch and its gradient reduction.
A spec is a plain tuple with one entry a dim: ``None`` (replicated), one
axis name, or a tuple of axis names (major first). A dim that does not
divide its axes falls back to replication, as there.

What the reference gets from ``NamedSharding`` is two operations here:

  * :func:`local_shard` cuts a full tensor to this rank's shard of a spec;
  * :func:`gather` puts the shards back together (all-gather, axis by
    axis). Under autograd its backward reduce-scatters the full gradient
    onto the shard: summed over the ranks that share the shard's
    coordinates and the batch axes given, and divided by their count, so
    the shard receives the mean over the batch slices of the gradient.

A training rank computes the whole model on its slice of the batch, so
there the ``model`` axis holds replicas of the computation over shards of
the weights (training on the tensor-parallel layers is ROADMAP A13c).
Serving computes on the shards themselves: ``tensor_parallel`` holds the
serving mesh's collectives, ``models.layers`` its products.

:func:`use_batch_axes` names the mesh axes the batch is split over while a
loss is computed; :func:`batch_mean` (the MoE's load-balancing loss)
averages over them, as the reference's ``_aux_loss`` ``pmean``s over its
``batch_axes``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
POD_AXIS = "pod"

#: batch-dimension sharding: span the pod axis too (multi-pod data
#: parallelism); axes absent from the mesh are dropped by ``_fix_spec``.
BATCH = (POD_AXIS, DATA_AXIS)

#: the DP-dominant layout's batch: the batch dim spans ``model`` too
BATCH_ALL = (POD_AXIS, DATA_AXIS, MODEL_AXIS)

Spec = Tuple[Any, ...]


class Mesh:
    """A named device mesh over ``torch.distributed``: the axis names, their
    sizes (``shape`` maps name to size, as a JAX mesh's does), the rank's
    coordinate on each axis and each axis's process group, from a
    ``DeviceMesh`` (``launch/mesh.py`` makes them)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.sizes = tuple(int(n) for n in device_mesh.mesh.shape)
        self.shape = dict(zip(self.axis_names, self.sizes))
        self.device = device

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def coordinate(self, name: str) -> int:
        return int(self.device_mesh.get_local_rank(name))

    def group(self, name: str):
        return self.device_mesh.get_group(name)


class Placement(NamedTuple):
    """Where one leaf lives: its spec over ``mesh``."""
    mesh: Mesh
    spec: Spec


def layout() -> str:
    """Activation layout: "tp" (model axis partitions hidden dims), "dp"
    (model axis joins data parallelism) or "infer" (serving: non-expert
    weights drop their data factor). Read from ``REPRO_LAYOUT``, as in the
    reference."""
    return os.environ.get("REPRO_LAYOUT", "tp")


def _apply_layout(spec: Spec) -> Spec:
    if layout() != "dp":
        return spec
    out = []
    for names in spec:
        if names == BATCH:
            out.append(BATCH_ALL)
        elif names == MODEL_AXIS:
            out.append(None)                  # hidden dims replicate
        elif isinstance(names, tuple):
            kept = tuple(n for n in names if n != MODEL_AXIS)
            out.append(kept or None)
        else:
            out.append(names)
    return tuple(out)


def axis_size(mesh, name: str) -> int:
    try:
        return mesh.shape[name]
    except (KeyError, TypeError):
        return 1


def _fix_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    fixed = []
    for i, names in enumerate(spec):
        if names is None:
            fixed.append(None)
            continue
        names_t = names if isinstance(names, tuple) else (names,)
        names_t = tuple(n for n in names_t if n in mesh.axis_names)
        # greedy prefix: the longest leading run of axes whose product
        # divides the dim
        kept = []
        prod = 1
        for n in names_t:
            size = axis_size(mesh, n)
            if shape[i] % (prod * size) == 0:
                kept.append(n)
                prod *= size
            else:
                break
        if not kept:
            fixed.append(None)
        else:
            fixed.append(tuple(kept) if len(kept) > 1 else kept[0])
    fixed += [None] * (len(shape) - len(fixed))
    return tuple(fixed[:len(shape)])


def fix_spec_for(mesh, spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Public divisibility fixer for out-of-step use (e.g. the batch)."""
    return _fix_spec(tuple(spec), shape, mesh)


def model_axis_size(mesh=None) -> int:
    """Size of the ``model`` axis on ``mesh``; 1 without one (the port has
    no ambient mesh)."""
    if mesh is None or not getattr(mesh, "axis_names", ()):
        return 1
    return axis_size(mesh, MODEL_AXIS)


def heads_divide(n_heads: int, mesh=None) -> bool:
    """True iff the model axis is > 1 and divides ``n_heads``: the gate for
    head-axis KV placement."""
    m = model_axis_size(mesh)
    return m > 1 and n_heads % m == 0


# ---------------------------------------------------------------------------
# Parameter partitioning rules (by path name patterns), the reference's.
# ---------------------------------------------------------------------------

#: (substring pattern, spec). First match wins. Specs may be longer than the
#: param rank: stacked params get the leading axes replicated.
_RULES: Tuple[Tuple[str, Spec], ...] = (
    ("embed", (MODEL_AXIS, DATA_AXIS)),
    ("unembed", (MODEL_AXIS, DATA_AXIS)),
    ("wq_a", (DATA_AXIS, MODEL_AXIS)),
    ("wq_b", (DATA_AXIS, MODEL_AXIS)),
    ("wkv_a", (DATA_AXIS, None)),
    ("wkv_b", (DATA_AXIS, MODEL_AXIS)),
    ("wq", (DATA_AXIS, MODEL_AXIS)),
    ("wk", (DATA_AXIS, MODEL_AXIS)),
    ("wv", (DATA_AXIS, MODEL_AXIS)),
    ("wo", (MODEL_AXIS, DATA_AXIS)),
    ("bq", (MODEL_AXIS,)),
    ("bk", (MODEL_AXIS,)),
    ("bv", (MODEL_AXIS,)),
    ("w_gate", (DATA_AXIS, MODEL_AXIS)),
    ("w_up", (DATA_AXIS, MODEL_AXIS)),
    ("w_down", (MODEL_AXIS, DATA_AXIS)),
    ("router", (None, None)),
    ("we_gate", (MODEL_AXIS, DATA_AXIS, None)),
    ("we_up", (MODEL_AXIS, DATA_AXIS, None)),
    ("we_down", (MODEL_AXIS, None, DATA_AXIS)),
    ("in_proj", (DATA_AXIS, MODEL_AXIS)),
    ("conv_w", (None, MODEL_AXIS)),
    ("conv_b", (MODEL_AXIS,)),
    ("x_proj", (MODEL_AXIS, None)),
    ("dt_proj", (None, MODEL_AXIS)),
    ("dt_bias", (MODEL_AXIS,)),
    ("a_log", (MODEL_AXIS, None)),
    ("ssm_d", (MODEL_AXIS,)),
    ("out_proj", (MODEL_AXIS, DATA_AXIS)),
)

#: KV-cache leaves with a head axis third from the right (dense slab and
#: paged pool alike); only the head axis shards
_CACHE_HEAD_LEAVES = frozenset({"k", "v"})
#: cache leaves with no head axis (MLA latent, SSM state): replicated
_CACHE_STATE_LEAVES = frozenset({"ckv", "krope", "conv", "ssm"})


def spec_for_cache(path: str, shape: Tuple[int, ...], mesh) -> Optional[Spec]:
    """Spec for a KV-cache / paged-pool leaf, or None if ``path`` does not
    name one (matched by its last component, not by substring)."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in _CACHE_HEAD_LEAVES and len(shape) >= 3:
        base = (None,) * (len(shape) - 3) + (MODEL_AXIS, None, None)
        return _fix_spec(base, shape, mesh)
    if leaf in _CACHE_STATE_LEAVES:
        return (None,) * len(shape)
    return None


def spec_for_param(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Spec for one parameter, by name pattern and divisibility; under the
    "infer" layout non-expert weights drop their ``data`` factor."""
    cache_spec = spec_for_cache(path, shape, mesh)
    if cache_spec is not None:
        return cache_spec
    for pat, spec in _RULES:
        if pat in path:
            base = tuple(spec)
            if layout() == "infer" and not pat.startswith("we_"):
                base = tuple(None if n == DATA_AXIS else n for n in base)
            extra = len(shape) - len(base)
            if extra > 0:
                base = (None,) * extra + base
            elif extra < 0:
                base = base[-len(shape):] if shape else ()
            return _fix_spec(base, shape, mesh)
    return _fix_spec((None,) * len(shape), shape, mesh)


def _paths(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def _rebuild(tree: Any, values: Iterator) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    return next(values)


def param_specs(params: Any, mesh) -> Any:
    """Spec tree matching ``params`` (nested dicts of tensors or arrays)."""
    specs = (spec_for_param(name.lower(), tuple(leaf.shape), mesh)
             for name, leaf in _paths(params))
    return _rebuild(params, specs)


# ---------------------------------------------------------------------------
# Shards over a Mesh.
# ---------------------------------------------------------------------------

def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec splits over, in the order they appear."""
    return tuple(n for entry in spec for n in _names(entry))


def shard_count(spec: Spec, mesh) -> int:
    """How many distinct shards a spec cuts a tensor into."""
    n = 1
    for name in spec_axes(spec):
        n *= axis_size(mesh, name)
    return n


def global_shape(local: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The full shape of a tensor whose shard of ``spec`` has ``local``."""
    out = list(local)
    for dim, entry in enumerate(spec):
        for name in _names(entry):
            out[dim] *= axis_size(mesh, name)
    return tuple(out)


def local_shard(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``spec`` (a copy of
    its own, so the full tensor can be freed; ``x`` itself where the spec
    splits nothing on this mesh). A dim split over several axes is cut
    major axis first."""
    if not moves(spec, mesh):
        return x
    return local_view(x, spec, mesh).clone()


def local_view(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """:func:`local_shard` as a view of ``x``, not a copy."""
    for dim, entry in enumerate(spec):
        for name in _names(entry):
            n = axis_size(mesh, name)
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {name} ({n})")
            x = x.chunk(n, dim)[mesh.coordinate(name)]
    return x


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    # the *_single names replace *_tensor in newer torch releases
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, xt, group=group)
    return out.movedim(0, dim)


def gather_full(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's shard of ``spec`` (collective:
    every rank of the mesh calls it), no autograd."""
    for dim in reversed(range(len(spec))):
        for name in reversed(_names(spec[dim])):
            n = axis_size(mesh, name)
            if n > 1:
                x = _all_gather(x, dim, mesh.group(name), n)
    return x


def reduce_to_shard(g: torch.Tensor, spec: Spec, mesh: Mesh,
                    reduce_axes: Sequence[str] = ()) -> torch.Tensor:
    """The mean, over the ranks that differ in the spec's axes or in
    ``reduce_axes``, of the full tensor ``g``, cut to this rank's shard:
    reduce-scatter over each split axis, then all-reduce over the rest of
    ``reduce_axes``, then one division by the ranks summed."""
    count = 1
    for dim, entry in enumerate(spec):
        for name in _names(entry):
            n = axis_size(mesh, name)
            if n > 1:
                g = _reduce_scatter(g, dim, mesh.group(name), n)
                count *= n
    split = set(spec_axes(spec))
    for name in reduce_axes:
        n = axis_size(mesh, name)
        if name not in split and n > 1:
            g = g.contiguous()
            dist.all_reduce(g, group=mesh.group(name))
            count *= n
    return g / count if count > 1 else g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, reduce_axes):
        ctx.spec, ctx.mesh, ctx.reduce_axes = spec, mesh, reduce_axes
        return gather_full(x, spec, mesh)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_to_shard(grad, ctx.spec, ctx.mesh, ctx.reduce_axes),
                None, None, None)


def moves(spec: Spec, mesh, reduce_axes: Sequence[str] = ()) -> bool:
    """True iff gathering a shard of ``spec`` (or reducing its gradient
    over ``reduce_axes``) talks to another rank."""
    return any(axis_size(mesh, n) > 1
               for n in (*spec_axes(spec), *reduce_axes))


def gather(x: torch.Tensor, spec: Spec, mesh: Mesh,
           reduce_axes: Sequence[str] = ()) -> torch.Tensor:
    """The full tensor from its shard ``x``, differentiable: the gradient
    arrives on ``x`` reduce-scattered (:func:`reduce_to_shard`). On a mesh
    where nothing moves it is ``x`` itself."""
    if not moves(spec, mesh, reduce_axes):
        return x
    return _Gather.apply(x, spec, mesh, tuple(reduce_axes))


def batch_index(mesh: Mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """This rank's slice of a batch split over ``axes`` (major first):
    ``(index, count)``."""
    index, count = 0, 1
    for name in axes:
        n = axis_size(mesh, name)
        index = index * n + (mesh.coordinate(name) if n > 1 else 0)
        count *= n
    return index, count


# ---------------------------------------------------------------------------
# The batch axes of the loss being computed.
# ---------------------------------------------------------------------------

_BATCH_AXES: list = []


@contextlib.contextmanager
def use_batch_axes(mesh: Mesh, axes: Sequence[str]):
    """While a loss is computed on this rank's slice of a batch split over
    ``axes``: :func:`batch_mean` averages over them."""
    _BATCH_AXES.append((mesh, tuple(a for a in axes
                                    if axis_size(mesh, a) > 1)))
    try:
        yield
    finally:
        _BATCH_AXES.pop()


class _BatchMean(torch.autograd.Function):
    """The mean over the batch axes' ranks; its backward is the same mean
    of the gradients (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _mean(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return _mean(grad, ctx.mesh, ctx.axes), None, None


def _mean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    x = x.detach().clone().contiguous()
    n = 1
    for name in axes:
        dist.all_reduce(x, group=mesh.group(name))
        n *= axis_size(mesh, name)
    return x / n


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks of the current batch axes
    (:func:`use_batch_axes`); ``x`` itself outside any, or where they are
    all of size 1."""
    if not _BATCH_AXES or not _BATCH_AXES[-1][1]:
        return x
    mesh, axes = _BATCH_AXES[-1]
    return _BatchMean.apply(x, mesh, axes)
