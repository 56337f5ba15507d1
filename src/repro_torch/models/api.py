"""Model facade: init / loss / prefill / decode_step / verify_step / the
row moves.

The counterpart of ``src/repro/models/api.py`` for ``family="dense"``,
``family="moe"`` (GQA or MLA attention), ``family="ssm"``,
``family="hybrid"`` (jamba), ``family="vlm"``
(M-RoPE, a stub frontend's embeddings before the text) and
``family="encdec"`` (:mod:`repro_torch.models.encdec`). The last two serve
one-shot only, as in the reference: the pools, resumed prefill and
speculative verify refuse them.
A :class:`Model` lives on one device: CUDA unless the caller passes
``device="cpu"``. With no card and no explicit CPU it raises — the port
never drops to the CPU silently.

Under a serving mesh (``distributed.tensor_parallel.use_mesh``, which the
engine enters) the params are a rank's shards (:meth:`Model.init_serving`
with ``mesh=``, or ``bridge.sharded_from_numpy``), and the logits that
``prefill`` / ``decode_step`` / ``verify_step`` return are gathered whole
unless the caller asks for the rank's columns (``full_logits=False``, the
engine's greedy pick).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.planner import KernelPlans, Mem3DPlanner
from repro_torch.core.target import HardwareTarget
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.paged_attention import (as_bits,
                                                 dequantize_page_int8,
                                                 quantize_page_int8)
from repro_torch.models import encdec, layers, transformer
from repro_torch.models.config import ModelConfig

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means the card; raise if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller passes device='cpu' (--device cpu)")
    return dev


#: the mamba leaves the reference casts to bf16 inside every op
#: (``src/repro/models/ssm.py``); ``a_log``, ``dt_bias`` and ``ssm_d`` stay f32
_MAMBA_MATRICES = ("in_proj", "x_proj", "dt_proj", "out_proj", "conv_w",
                   "conv_b")
#: the routed experts' weights: the grouped MoE (the card's) casts them to
#: bf16 inside every call, the plain one (the CPU's) computes in f32
_EXPERT_MATRICES = ("we_gate", "we_up", "we_down")


def _is_matrix(name: str, grouped_moe: bool) -> bool:
    """Leaves the reference casts to bf16 inside every op: projection
    matrices (``w*``; the routed experts' only where the grouped MoE runs
    them), the embedding tables and the mamba projections and conv
    weights. The MoE router (``router``) stays f32 everywhere."""
    if name in _EXPERT_MATRICES:
        return grouped_moe
    return (name.startswith("w") or name in ("embed", "unembed")
            or name in _MAMBA_MATRICES)


def _serving_leaf(grouped_moe: bool) -> layers.Leaf:
    """The serving copy's rule for one leaf: a matrix (:func:`_is_matrix`)
    cast to bf16, anything else kept as it is."""
    def leaf(name: str, x: torch.Tensor) -> torch.Tensor:
        return layers.cast(x) if _is_matrix(name, grouped_moe) else x
    return leaf


def _cast_tree(params: Any, leaf: layers.Leaf) -> Any:
    """``params`` with every leaf passed through ``leaf``."""
    return {k: (_cast_tree(v, leaf) if isinstance(v, dict) else leaf(k, v))
            for k, v in params.items()}


class Model:
    """Facade over the dense / MoE transformer and Mamba-1 substrate on one
    device.

    The model owns a :class:`Mem3DPlanner` for the given hardware target
    (default: the process-wide current target), as in the reference.
    """

    def __init__(self, cfg: ModelConfig,
                 target: Optional[HardwareTarget] = None,
                 device: Device = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        transformer.check_supported(cfg, self.device)
        self.planner = Mem3DPlanner(target)

    # ------------------------------------------------------------ plans
    def kernel_plans(self, seq_q: int, seq_kv: Optional[int] = None, *,
                     tokens: Optional[int] = None) -> KernelPlans:
        """Capacity-partitioned block plans for this arch at one shape cell."""
        cfg = self.cfg
        seq_kv = seq_q if seq_kv is None else seq_kv
        if cfg.use_mla:
            head_dim = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                        + cfg.v_head_dim) // 2
        else:
            head_dim = cfg.head_dim if cfg.n_heads else 0
        return self.planner.plan_for(
            d_model=cfg.d_model, d_ff=max(cfg.d_ff, cfg.moe_d_ff),
            seq_q=max(seq_q, 1), seq_kv=max(seq_kv, 1), head_dim=head_dim,
            tokens_per_device=max(tokens or seq_q, 1),
            ssm_d_inner=cfg.ssm_d_inner if cfg.ssm_d_state else 0,
            ssm_d_state=cfg.ssm_d_state)

    # ------------------------------------------------------------- init
    def init(self, gen: torch.Generator) -> Any:
        """Random f32 params from ``gen``, made directly on the model's
        device (``gen`` must live there)."""
        return self._draw(gen, layers.keep)

    def init_serving(self, gen: torch.Generator, mesh=None) -> Any:
        """The serving copy ``prepare(init(gen))``, bit for bit, built
        leaf by leaf: each leaf is drawn (the same draws in the same order
        as :meth:`init`), scaled in place and cast by :meth:`prepare`'s
        rule before the next is drawn, so the f32 tree never exists. The
        peak is the serving copy plus its largest f32 leaf.

        Under ``mesh`` each whole f32 leaf is cut to this rank's shard
        (``sharding.spec_for_param``; the routed experts on ``model``)
        before the cast, and freed before the next draw: every rank draws
        the same full leaves from the same generator, and the cast is
        elementwise, so rank r holds ``local_shard(prepare(init(gen)))``
        bit for bit, at a peak of its shards plus one whole f32 leaf plus
        that leaf's cast shard."""
        leaf = self._leaf()
        if mesh is None:
            return self._draw(gen, leaf)

        def shard(name: str, x: torch.Tensor) -> torch.Tensor:
            spec = shd.spec_for_param(name.lower(), tuple(x.shape), mesh)
            if not shd.moves(spec, mesh):
                return leaf(name, x)
            view = shd.local_view(x, spec, mesh)
            out = leaf(name, view)
            # a leaf kept as it is must not pin the whole one behind it
            return out.clone() if out is view else out.contiguous()
        return self._draw(gen, shard)

    def _draw(self, gen: torch.Generator, leaf: layers.Leaf) -> Any:
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        if self.cfg.family == "encdec":
            return encdec.init_encdec(self.cfg, gen, leaf)
        return transformer.init_lm(self.cfg, gen, leaf)

    def _leaf(self) -> layers.Leaf:
        return _serving_leaf(grouped_moe=self.device.type == "cuda")

    def prepare(self, params: Any) -> Any:
        """The serving copy of ``params``: matrices cast to bf16 ONCE
        (the reference casts them inside every op; the cast is
        deterministic, so the results are bit-identical), vectors (biases,
        norm scales) and the MoE router left f32. The routed experts'
        weights follow the MoE the model's device runs
        (:func:`repro_torch.models.moe.moe_block`): bf16 for the card's
        grouped version, f32 for the CPU's plain one, which computes in f32
        as the reference's ``_moe_dense`` does. On a prepared copy it
        returns the same tensors (a cast to a leaf's own dtype is the
        leaf)."""
        return _cast_tree(params, self._leaf())

    # ------------------------------------------------------------- loss
    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             remat: bool = True, plans: Optional[KernelPlans] = None):
        """Causal LM loss of one full-sequence forward (no caches):
        ``batch`` holds ``tokens`` and ``labels`` (B, S), -1 = ignore, and
        for a frontend model ``frontend_embeds`` (B, Sf, d), for an enc-dec
        model ``src_embeds`` (B, Ss, d). Returns ``(total, {loss, aux,
        tokens})`` as the reference. Differentiable: where ``params``
        require grad, autograd records the forward (on the card through
        the kernels' autograd Functions), and ``remat`` recomputes each
        layer and each loss chunk in the backward instead of keeping its
        activations."""
        cfg = self.cfg
        if cfg.family == "encdec":
            plans = plans or self.kernel_plans(batch["src_embeds"].shape[1])
            return encdec.encdec_loss(cfg, params, batch["src_embeds"],
                                      batch["tokens"], batch["labels"],
                                      remat=remat, plans=plans)
        plans = plans or self.kernel_plans(batch["tokens"].shape[1]
                                           + cfg.frontend_len)
        return transformer.lm_loss(
            cfg, params, batch["tokens"], batch["labels"],
            frontend_embeds=batch.get("frontend_embeds"), remat=remat,
            plans=plans)

    # ---------------------------------------------------------- serving
    def prefill(self, params, batch: Dict[str, torch.Tensor], max_len: int,
                *, plans: Optional[KernelPlans] = None,
                last_pos: Optional[torch.Tensor] = None,
                prefix_len: int = 0,
                prefix_state: Optional[Dict[str, Any]] = None,
                full_logits: bool = True):
        """Run the prompt, building ``max_len``-deep KV caches.

        Returns ``(logits f32 (B, 1, padded_vocab), state)``. Logits come
        from the final position, or per row from ``last_pos`` ``(B,)``.

        ``prefix_len``/``prefix_state`` run a *resumed* prefill (the
        prefix-share suffix and the chunked-prefill chunk): the state
        already caches the first ``prefix_len`` positions, ``tokens`` is the
        tail only, and RoPE positions start at ``prefix_len``. The tail's
        K/V are written into ``prefix_state``'s caches in place.
        ``prefix_len`` is a host int. Attention-only decoder models with
        token prompts only: recurrent SSM state has no resumable KV prefix.

        A frontend model's ``batch`` also holds ``frontend_embeds`` (B, Sf,
        d), which take the first Sf cache positions; an enc-dec model's
        holds ``src_embeds`` (B, Ss, d): the encoder runs once, its output
        rides in the state as ``enc_out``, and ``tokens`` is the decoder's
        prompt. ``full_logits`` (under a serving mesh): see the module
        docstring.
        """
        cfg = self.cfg
        if (prefix_len or prefix_state is not None) and (
                cfg.family == "encdec" or cfg.frontend_len):
            raise NotImplementedError(
                "resumed prefill targets decoder-only token-prompt models")
        if (prefix_len or prefix_state is not None) and \
                has_recurrent_state(cfg):
            raise NotImplementedError(
                "resumed prefill requires attention-only token-prompt "
                "models: recurrent SSM state has no resumable KV prefix")
        tokens = batch["tokens"]

        def last(x):
            if last_pos is None:
                return x[:, -1:]
            idx = last_pos.long().reshape(-1, 1, 1).expand(
                x.shape[0], 1, x.shape[2])
            return torch.gather(x, 1, idx)

        if cfg.family == "encdec":
            src = batch["src_embeds"]
            plans = plans or self.kernel_plans(src.shape[1], max_len)
            enc_out = encdec.encode(cfg, params, src, plans=plans)
            caches = encdec.init_dec_caches(cfg, tokens.shape[0], max_len,
                                            tokens.device)
            x, caches = encdec.decode(cfg, params, tokens, enc_out,
                                      caches=caches, cache_len=0,
                                      plans=plans)
            return (layers.unembed_logits(params["tok"], last(x)),
                    {"caches": caches, "enc_out": enc_out})
        plans = plans or self.kernel_plans(tokens.shape[1] + cfg.frontend_len,
                                           max_len)
        x, caches = transformer.prefill(
            cfg, params, tokens, max_len,
            frontend_embeds=batch.get("frontend_embeds"), plans=plans,
            caches=(prefix_state or {}).get("caches"), prefix_len=prefix_len)
        return (self._logits(layers.unembed_logits(params["tok"], last(x)),
                             full_logits), {"caches": caches})

    def decode_step(self, params, tokens: torch.Tensor,
                    state: Dict[str, Any], cache_len: torch.Tensor, *,
                    plans: Optional[KernelPlans] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    full_logits: bool = True):
        """One decode step for every row; ``cache_len`` is 0-d (one-shot)
        or ``(B,)`` (slots). With ``block_tables`` the state holds the
        paged pool. All masking stays on the device. An enc-dec model's
        state carries ``enc_out``, which every step's cross-attention
        reads."""
        if self.cfg.family == "encdec":
            x, caches = encdec.decode(self.cfg, params, tokens,
                                      state["enc_out"],
                                      caches=state["caches"],
                                      cache_len=cache_len, plans=plans)
            return (layers.unembed_logits(params["tok"], x),
                    {**state, "caches": caches})
        logits, caches = transformer.decode_step(
            self.cfg, params, tokens, state["caches"], cache_len,
            plans=plans, block_tables=block_tables)
        return self._logits(logits, full_logits), {**state, "caches": caches}

    def verify_step(self, params, tokens: torch.Tensor,
                    state: Dict[str, Any], cache_len: torch.Tensor, *,
                    plans: Optional[KernelPlans] = None,
                    block_tables: Optional[torch.Tensor] = None,
                    full_logits: bool = True):
        """Score k draft tokens per slot in ONE batched forward, the verify
        half of speculative decoding. ``tokens`` is ``(B, k+1)``: each
        slot's last emitted token, then its drafts; ``cache_len`` is the
        ``(B,)`` frontier. Returns ``(logits f32 (B, k+1, Vpad), state)``,
        logits column ``j`` being what :meth:`decode_step` gives after
        ``tokens[:, :j+1]``. All k+1 K/V rows are written at ``cache_len +
        j`` (slab or, with ``block_tables``, pages); the engine rolls a
        rejected suffix back by not advancing ``cache_len`` over it.
        Attention-only decoder models: recurrent SSM state integrates every
        token it sees and cannot roll back."""
        cfg = self.cfg
        if cfg.family == "encdec" or cfg.frontend_len:
            raise NotImplementedError(
                "speculative verify targets decoder-only token-prompt "
                "models; others go through one-shot generate()")
        if has_recurrent_state(cfg):
            raise ValueError(
                "speculative decoding requires attention-only models: "
                "recurrent SSM state cannot roll back rejected draft tokens")
        logits, caches = transformer.verify_step(
            cfg, params, tokens, state["caches"], cache_len, plans=plans,
            block_tables=block_tables)
        return self._logits(logits, full_logits), {**state, "caches": caches}

    def _logits(self, logits: torch.Tensor, full: bool) -> torch.Tensor:
        """The whole row (gathered over a serving mesh's ``model`` axis),
        or with ``full`` False the rank's columns as computed."""
        return tp.gather_logits(logits, self.cfg.padded_vocab) if full \
            else logits

    def slot_update(self, pool_state: Dict[str, Any],
                    row_state: Dict[str, Any], slot: int) -> Dict[str, Any]:
        """Write a prefilled row state (batch 1, or a run of rows) into the
        slot-major pool at ``slot``, in place — the dense slot slab's
        admission scatter. Every cache leaf is stacked ``(n_repeat, B,
        ...)``, so recurrent SSM rows (conv tail, state) move exactly like
        K/V rows."""
        def walk(pool, row):
            if torch.is_tensor(pool):
                pool[:, slot:slot + row.shape[1]] = row.to(pool.dtype)
                return
            for name, leaf in pool.items():
                walk(leaf, row[name])

        walk(pool_state["caches"], row_state["caches"])
        return pool_state

    def gather_row(self, pool_state: Dict[str, Any], slot: int
                   ) -> Dict[str, Any]:
        """A copy of one slot's dense (batch-1) cache view from the
        slot-major pool — the read half of dense chunked prefill and the
        inverse of :meth:`slot_update`. Unwritten positions hold whatever
        the slab holds there, which the resumed prefill's causal mask
        hides. Attention-only models."""
        if has_recurrent_state(self.cfg):
            raise NotImplementedError(
                "chunked prefill requires attention-only models: recurrent "
                "SSM state has no resumable KV prefix")

        def take(tree):
            if torch.is_tensor(tree):
                return tree[:, slot:slot + 1].clone()
            return {k: take(v) for k, v in tree.items()}

        return {"caches": take(pool_state["caches"])}

    def gather_row_paged(self, pool_state: Dict[str, Any],
                         block_row: torch.Tensor, page_tokens: int
                         ) -> Dict[str, Any]:
        """A copy of one slot's dense (batch-1) cache view read from the
        paged pool through ``block_row`` — the inverse of
        :meth:`slot_update_paged`'s page cut. Null entries read page 0,
        whose content the resumed prefill's causal mask hides. This is the
        read half of suffix prefill and of paged chunked prefill: shared
        prefix pages (and the copy-on-write source) are gathered into the
        contiguous view the tail attends over. Attention-only models.

        Quantized pools dequantize here into bf16 rows (int8: codes x page
        scale; fp8: upcast), so a resumed prefill computes exactly as on an
        fp16 pool."""
        if has_recurrent_state(self.cfg):
            raise NotImplementedError(
                "prefix sharing requires attention-only models: recurrent "
                "SSM state is per-sequence, not per-page")
        rows = block_row.long()
        p_max = rows.shape[0]
        caches: Dict[str, Any] = {}
        for gname, key, attn in transformer.cache_attn_kinds(self.cfg):
            leaf = pool_state["caches"][gname][key]
            out = {}
            for name, pages in leaf.items():
                if name.endswith("_scale"):
                    continue                    # read with their codes
                sel = as_bits(pages)[:, rows].view(pages.dtype)
                scale = leaf.get(name + "_scale")
                if scale is not None:
                    sel = dequantize_page_int8(sel, scale[:, rows],
                                               tuple(range(2, sel.ndim)))
                if sel.dtype != torch.bfloat16:
                    sel = sel.to(torch.bfloat16)
                if attn == "mla":               # (r, P, pt, width)
                    r = sel.shape[0]
                    out[name] = sel.reshape(r, p_max * page_tokens,
                                            -1)[:, None]
                    continue
                r, _, hkv, _, hd = sel.shape    # (r, P, hkv, pt, hd)
                out[name] = torch.movedim(sel, 1, 2).reshape(
                    r, hkv, p_max * page_tokens, hd)[:, None]
            caches.setdefault(gname, {})[key] = out
        return {"caches": caches}

    def slot_update_paged(self, pool_state: Dict[str, Any],
                          row_state: Dict[str, Any], slot: int,
                          block_row: torch.Tensor, page_tokens: int
                          ) -> Dict[str, Any]:
        """Scatter a prefilled dense row into the paged pool, in place.

        The row's contiguous ``depth = P * page_tokens`` KV is cut into P
        pages and written at the physical pages ``block_row`` maps (the
        slot's block-table row; unmapped tail entries point at null page
        0, so their junk lands where no sequence reads). Recurrent SSM
        state is written to the slot's own row at ``slot``.

        An int8 pool quantizes each page cut with FRESH per-page scales
        written beside the codes (a re-scattered chunked-prefill frontier
        page requantizes cleanly, and a reused page's stale scale never
        leaks in); an fp8 pool casts the cut and writes it as bits.
        """
        p_max = block_row.shape[0]
        rows = block_row.long()
        for gname, key, attn in transformer.cache_attn_kinds(self.cfg):
            pool_leaf = pool_state["caches"][gname][key]
            row_leaf = row_state["caches"][gname][key]
            for name, pool in pool_leaf.items():
                if name.endswith("_scale"):
                    continue                       # written with the codes
                row = row_leaf[name]
                if attn == "mamba":                # (r, 1, ...) -> slot
                    pool[:, slot] = row[:, 0].to(pool.dtype)
                    continue
                if attn == "mla":                  # (r, 1, depth, width)
                    cut = row[:, 0].reshape(row.shape[0], p_max,
                                            page_tokens, -1)
                else:                              # (r, 1, hkv, depth, hd)
                    r, _, hkv, _, hd = row.shape
                    cut = torch.movedim(row[:, 0].reshape(
                        r, hkv, p_max, page_tokens, hd), 2, 1)
                scale = pool_leaf.get(name + "_scale")
                if scale is not None:
                    codes, scales = quantize_page_int8(
                        cut, tuple(range(2, cut.ndim)),
                        scale_max=tp.kv_scale_reduce(self.cfg.n_kv_heads,
                                                     attn))
                    pool[:, rows] = codes
                    scale[:, rows] = scales
                else:
                    as_bits(pool)[:, rows] = as_bits(cut.to(pool.dtype))
        return pool_state


def has_recurrent_state(cfg: ModelConfig) -> bool:
    """Whether any layer of ``cfg`` keeps recurrent (mamba) state."""
    return any(kind.attn == "mamba" for group in cfg.layer_groups()
               for kind in group.pattern)


def build_model(cfg: ModelConfig, target: Optional[HardwareTarget] = None,
                device: Device = None) -> Model:
    return Model(cfg, target, device)
