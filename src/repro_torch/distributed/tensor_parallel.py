"""Tensor-parallel serving over the ``model`` axis: what a rank holding its
shards of the weights needs to compute the model.

The counterpart of what the reference gets from GSPMD when it serves under
a mesh (``src/repro/serve/engine.py``, ``src/repro/models/attention.py``):
the weights sit where ``sharding.spec_for_param`` puts them, so a rank
holds column shards of ``wq`` / ``wk`` / ``wv`` (and their biases) and of
``w_gate`` / ``w_up``, row shards of ``wo`` and ``w_down``, and the rows of
the embedding table for its slice of the (padded) vocabulary. A layer
sees its shard's shape and asks :func:`split` whether a dim is cut.

While :func:`use_mesh` is active (the products themselves are
``models.layers.linear_column`` / ``linear_row`` / ``embed``):

  * a column-parallel product gives this rank's output columns, gathered
    whole where the caller needs every column;
  * a row-parallel product sums this rank's f32 partials over ``model``
    (:func:`all_sum`) before the bias and the cast, so a world of M
    differs from one device only in the order of one f32 addition;
  * the embedding looks up this rank's vocabulary rows, zero for the
    others, and sums over ``model`` (exact: one rank adds a non-zero
    value); the logits are each rank's f32 columns, :func:`greedy` merges
    each rank's ``(max, global index)`` (ties to the lowest index, as
    ``torch.argmax`` over the whole row), :func:`gather_logits` puts the
    row back together where an API returns logits;
  * the KV heads split over ``model`` where they divide it
    (:func:`kv_heads_local`), and an int8 page's scale is the max over
    ``model`` of each rank's (:func:`kv_scale_reduce`), so each rank's
    codes and scales are one device's for its heads; where the KV heads do
    not divide (:func:`pooled`) the attention projections are gathered
    whole after the column product, the caches are whole on every rank,
    and decode splits each slot's positions into M ranges
    (``kernels.paged_attention.decode_range``) whose (output,
    log-sum-exp) pairs :func:`gather_pairs` brings to every rank.

The collectives run without autograd, in one order on every rank (every
rank runs the same host scheduler on the same requests). Without a mesh
every function here is the single-device computation itself; at a model
axis of 1 every collective spans one rank.

  * the MoE layers of an expert-parallel decoder (:func:`ep_moe_decoder`)
    hold ``n_experts / M`` experts a rank and sum each rank's combined
    output over ``model`` (``models.moe``'s ``ep``), in f32 or in the
    activation dtype as the reference's byte rule picks (:func:`all_sum`
    takes both); its shared experts are one tensor-parallel SwiGLU
    (column shards of ``shared/w_gate`` / ``w_up``, a row shard of
    ``w_down``) added after that sum;
  * multi-head latent attention (deepseek-v2) shards its heads and keeps
    the latent whole, as the reference's absorbed decode does where the
    heads divide ``model``: ``wq_a`` is a column shard gathered whole
    before the q norm, ``wq_b`` and ``wkv_b`` column shards of the rank's
    ``n_heads / M`` heads, ``wkv_a`` whole on every rank (so every rank
    computes and caches the same latent, and an int8 latent page's scale
    needs no max over ``model``), ``wo`` a row shard.

:func:`check_serving` names what sharded serving does not run yet
(ROADMAP A13c): the ``data`` (or any other) axis above 1, and at a model
axis above 1 any config but a dense GQA decoder or an expert-parallel MoE
decoder (GQA or MLA attention) whose experts, and for MLA whose heads,
the axis divides.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd

_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Serve on ``mesh`` inside the block (``None``: the single-device
    path, a no-op)."""
    if mesh is None:
        yield
        return
    _MESHES.append(mesh)
    try:
        yield
    finally:
        _MESHES.pop()


def active():
    """The mesh being served on, or None."""
    return _MESHES[-1] if _MESHES else None


def model_size() -> int:
    return shd.model_axis_size(active())


def model_rank() -> int:
    mesh = active()
    return mesh.coordinate(shd.MODEL_AXIS) if mesh is not None else 0


def _group():
    return active().group(shd.MODEL_AXIS)


def split(local: int, full: int) -> bool:
    """True iff a mesh is served on and a dim of ``full`` is held as this
    rank's ``model`` shard of ``local`` (at a model axis of 1 the shard is
    the whole dim)."""
    return active() is not None and local * model_size() == full


def pooled(n_kv_heads: int) -> bool:
    """True iff the KV heads do not divide a model axis above 1: the
    caches are whole on every rank and decode runs over position ranges."""
    m = model_size()
    return m > 1 and n_kv_heads % m != 0


def kv_heads_local(n_kv_heads: int) -> int:
    """The KV heads a rank's caches hold: its share where they divide the
    model axis, else all of them."""
    if active() is None or pooled(n_kv_heads):
        return n_kv_heads
    return n_kv_heads // model_size()


def kv_scale_reduce(n_kv_heads: int, attn: str = "gqa"
                    ) -> Optional[Callable]:
    """What an int8 page's per-page scales pass through before the codes
    are taken: the max over ``model`` where each rank holds its own heads
    of a GQA layer (one absmax over every head of a token, as one device
    takes it), else nothing (an MLA latent is whole and the same on every
    rank)."""
    if active() is None or attn != "gqa" or pooled(n_kv_heads):
        return None
    return all_max


# ------------------------------------------------------------ collectives


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of an f32 or bf16 tensor, in its dtype (in
    place on a contiguous ``x``, which it returns)."""
    x = x.contiguous()
    dist.all_reduce(x, group=_group())
    return x


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model``."""
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group())
    return x


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order,
    contiguous (the kernels take unit stride on the last axis)."""
    return shd._all_gather(x, dim % x.ndim, _group(),
                           model_size()).contiguous()


def gather_pairs(out: torch.Tensor, lse: torch.Tensor
                 ) -> Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]:
    """Every rank's (range output, range log-sum-exp), in rank order."""
    outs = all_gather(out[None], 0)
    lses = all_gather(lse[None].float(), 0)
    return list(outs.unbind(0)), list(lses.unbind(0))


# ---------------------------------------------------------------- logits


def local_greedy(logits: torch.Tensor, rank: int, vocab_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s candidate from its columns of the logits (the
    columns ``[rank * n, (rank + 1) * n)`` of the row): its first maximum
    among the columns below ``vocab_size`` and that column's global index,
    ``(value f32, index int64)``."""
    n = logits.shape[-1]
    off = rank * n
    col = off + torch.arange(n, device=logits.device)
    x = torch.where(col < vocab_size, logits.float(), -torch.inf)
    idx = torch.argmax(x, dim=-1)
    return torch.gather(x, -1, idx[..., None])[..., 0], idx + off


def merge_greedy(vals: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """The pick among every rank's candidate (``vals`` / ``idxs`` stacked
    in rank order on dim 0): the largest value, on ties the first rank's,
    whose index is the lowest (the ranks hold the columns in order)."""
    first = (vals == vals.amax(dim=0, keepdim=True)).int().argmax(dim=0)
    return torch.gather(idxs, 0, first[None])[0]


def greedy(logits: torch.Tensor, vocab_size: int,
           full: int) -> torch.Tensor:
    """The greedy token (int64, over the last dim) among the first
    ``vocab_size`` of ``full`` columns, from logits whose last dim is this
    rank's columns: every rank's :func:`local_greedy` candidate gathered
    and merged (:func:`merge_greedy`), so every rank picks what
    ``torch.argmax`` over the whole row picks."""
    n = logits.shape[-1]
    if not split(n, full):
        return torch.argmax(logits[..., :vocab_size], dim=-1)
    val, idx = local_greedy(logits, model_rank(), vocab_size)
    return merge_greedy(all_gather(val[None].contiguous(), 0),
                        all_gather(idx[None].contiguous(), 0))


def gather_logits(logits: torch.Tensor, full: int) -> torch.Tensor:
    """The whole logit row from each rank's columns."""
    if model_size() > 1 and split(logits.shape[-1], full):
        return all_gather(logits.contiguous(), -1)
    return logits


# ---------------------------------------------------------------- refusals


def gqa_decoder(cfg) -> bool:
    """A dense decoder of GQA attention and SwiGLU MLP layers with token
    prompts: the configs sharded serving runs at a model axis above 1."""
    if cfg.family != "dense" or cfg.frontend_len:
        return False
    return all(kind.attn == "gqa" and kind.mlp == "mlp"
               for group in cfg.layer_groups() for kind in group.pattern)


def ep_moe_decoder(cfg) -> bool:
    """A ``moe``-family decoder of GQA or multi-head latent attention
    layers whose MLP layers are MoE or SwiGLU, with token prompts, its
    shared experts (if any) a SwiGLU beside the routed ones: the configs
    expert-parallel serving runs at a model axis above 1 that divides
    their experts (qwen3-moe-30b-a3b, GQA; deepseek-v2-236b, MLA with 2
    shared experts)."""
    if cfg.family != "moe" or cfg.frontend_len or not cfg.n_experts:
        return False
    return all(kind.attn in ("gqa", "mla") and kind.mlp in ("mlp", "moe")
               for group in cfg.layer_groups() for kind in group.pattern)


def check_serving(cfg, shape: Dict[str, int]) -> None:
    """Raise ``NotImplementedError`` (ROADMAP A13c) for a mesh of axis
    sizes ``shape`` that sharded serving does not run yet: any axis but
    ``model`` above 1, or at a model axis above 1 a config that is neither
    a dense GQA decoder nor an expert-parallel MoE decoder whose experts
    the axis divides and, with MLA, whose heads it divides (mamba and
    hybrid layers, frontends and encoders; MLA's seq-sharded latent where
    the heads do not divide)."""
    others = {name: n for name, n in shape.items()
              if name != shd.MODEL_AXIS and n > 1}
    if others:
        raise NotImplementedError(
            f"sharded serving runs on the model axis alone; "
            f"{', '.join(f'{k}={v}' for k, v in others.items())} is not "
            f"ported yet (ROADMAP A13c)")
    m = shape.get(shd.MODEL_AXIS, 1)
    if m == 1 or gqa_decoder(cfg):
        return
    if ep_moe_decoder(cfg):
        if cfg.n_experts % m:
            raise NotImplementedError(
                f"{cfg.name}: expert-parallel serving puts n_experts / M "
                f"experts on each rank; {cfg.n_experts} experts do not split "
                f"over a model axis of {m} (ROADMAP A13c)")
        if cfg.use_mla and cfg.n_heads % m:
            raise NotImplementedError(
                f"{cfg.name}: sharded MLA puts n_heads / M heads on each "
                f"rank beside the whole latent; {cfg.n_heads} heads do not "
                f"split over a model axis of {m}, which takes the "
                f"reference's seq-sharded latent "
                f"(src/repro/models/attention.py:503-504), not ported yet "
                f"(ROADMAP A13c)")
        return
    raise NotImplementedError(
        f"{cfg.name} ({cfg.family}): sharded serving at a model axis above 1 "
        f"runs dense GQA decoders and expert-parallel MoE decoders (GQA or "
        f"MLA); mamba and hybrid layers, frontends and encoders are not "
        f"ported yet (ROADMAP A13c)")
