"""Decoder-only LM: init / forward / loss / prefill / decode.

The counterpart of ``src/repro/models/transformer.py`` for dense GQA
stacks (with sliding-window layers: gemma3), mixture-of-experts stacks with
GQA or multi-head latent attention (``family="moe"``), attention-free
Mamba-1 stacks (``family="ssm"``), the hybrid attention + Mamba stack
with MoE layers (``family="hybrid"``, jamba) and the
vision-language stack with M-RoPE and a stub frontend's embeddings before
the text (``family="vlm"``). The encoder-decoder family is
:mod:`repro_torch.models.encdec`.
Each layer dispatches on its kind: the attention (``gqa`` / ``mla`` /
``mamba``) and the MLP (``mlp`` / ``moe`` / none). The layer
stack is factorized into repeated superblocks
(:meth:`ModelConfig.layer_groups`) whose params are stacked on a leading
axis; a Python loop over the repeats replaces the reference's
``lax.scan``. Caches are stacked the same way, and each layer reads and
writes its slice in place (:mod:`repro_torch.models.attention`,
:mod:`repro_torch.models.ssm`). Attention layers keep K/V (MLA: the
latent), paged or in a dense slab; mamba layers keep one recurrent row
per sequence, never paged.

A training forward (no caches, grad enabled, ``remat``) runs each layer
and each chunk of the loss under ``torch.utils.checkpoint``, keeping only
the layer's input, the counterpart of the reference's ``jax.checkpoint``
with ``nothing_saveable`` per superblock and the loss chunks that save
only the unembed table: the backward recomputes the layer's forward, so
each attention layer's kernel runs twice a training step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.planner import KernelPlans
from repro_torch.kernels.paged_attention import as_bits
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import LayerKind, ModelConfig

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig, device) -> None:
    """Raise for a family the port does not run, on any device."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported")


# ----------------------------------------------------------------- init

def _init_layer(cfg: ModelConfig, kind: LayerKind, gen: torch.Generator,
                n: int, leaf: layers.Leaf) -> Params:
    d = cfg.d_model

    def norm():
        return {"scale": leaf("scale", torch.ones(
            (n, d), dtype=torch.float32, device=gen.device))}

    p: Params = {"ln1": norm()}
    if kind.attn == "mamba":
        p["mamba"] = ssm.init_mamba(cfg, gen, n, leaf)
        if kind.mlp != "none":
            p["ln2"] = norm()
    else:
        p["attn"] = attn_mod.INIT[kind.attn](cfg, gen, n, leaf)
        p["ln2"] = norm()
    if kind.mlp == "mlp":
        p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, n, leaf)
    elif kind.mlp == "moe":
        p["moe"] = moe_mod.init_moe(cfg, gen, n, leaf)
    return p


def init_lm(cfg: ModelConfig, gen: torch.Generator,
            leaf: layers.Leaf = layers.keep) -> Params:
    """Random f32 params on ``gen``'s device, in the reference's tree:
    ``params["groups"][name]["pos{i}"]`` stacked over repeats, matrices
    stored ``(d_in, d_out)``. Each leaf goes through ``leaf`` as it is
    made (:data:`repro_torch.models.layers.Leaf`)."""
    check_supported(cfg, gen.device)
    params: Params = {
        "tok": layers.init_embed(gen, cfg.padded_vocab, cfg.d_model,
                                 tie=cfg.tie_embeddings, leaf=leaf),
        "final_norm": layers.init_rmsnorm(cfg.d_model, gen.device, leaf),
        "groups": {},
    }
    for group in cfg.layer_groups():
        params["groups"][group.name] = {
            f"pos{pos}": _init_layer(cfg, kind, gen, group.n_repeat, leaf)
            for pos, kind in enumerate(group.pattern)}
    return params


# ----------------------------------------------------------- layer apply

def _apply_layer(cfg: ModelConfig, kind: LayerKind, p: Params,
                 x: torch.Tensor, *, positions, cache, cache_len,
                 positions3=None, plans: Optional[KernelPlans] = None,
                 block_tables=None):
    """Returns (x, aux): the MoE layer's aux loss, 0.0 for other layers (a
    float, so a dense stack launches nothing for it)."""
    aux = 0.0
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind.attn == "mamba":
        # recurrent state is a per-slot row, never paged: block tables only
        # address the attention page pools
        y, _ = ssm.mamba_block(p["mamba"], h, cfg=cfg, cache=cache,
                               plan=plans.scan_chunk if plans else None)
    else:
        y, _ = attn_mod.APPLY[kind.attn](
            p["attn"], h, cfg=cfg, kind=kind, positions=positions,
            positions3=positions3, cache=cache, cache_len=cache_len,
            plan=plans.attention if plans else None,
            block_tables=block_tables)
    x = x + y
    if kind.mlp == "mlp":
        x = x + layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x,
                                                     cfg.norm_eps),
                           d_ff=cfg.d_ff)
    elif kind.mlp == "moe":
        y, aux = moe_mod.moe_block(
            p["moe"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg=cfg)
        x = x + y
    return x, aux


def remat_call(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward (its
    activations not kept) when ``remat`` and autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)


def _index(tree, i: int):
    if torch.is_tensor(tree):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


def _run_groups(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                positions, positions3=None, caches=None, cache_len=None,
                plans: Optional[KernelPlans] = None, block_tables=None,
                remat: bool = False):
    """Returns (x, aux summed over the layers). ``remat`` recomputes each
    layer in the backward (a forward without caches only)."""
    remat = remat and caches is None
    aux = 0.0
    for group in cfg.layer_groups():
        stacked = params["groups"][group.name]
        g_caches = caches.get(group.name) if caches else None
        for r in range(group.n_repeat):
            for pos, kind in enumerate(group.pattern):
                key = f"pos{pos}"
                cache = _index(g_caches[key], r) if g_caches else None
                x, aux_i = remat_call(
                    remat, _apply_layer, cfg, kind, _index(stacked[key], r),
                    x, positions=positions, cache=cache,
                    cache_len=cache_len, positions3=positions3, plans=plans,
                    block_tables=block_tables)
                aux = aux + aux_i
    return x, aux


# ----------------------------------------------------------------- public

def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            frontend_embeds: Optional[torch.Tensor] = None,
            caches=None, cache_len=None,
            positions: Optional[torch.Tensor] = None,
            plans: Optional[KernelPlans] = None,
            block_tables: Optional[torch.Tensor] = None,
            remat: bool = False):
    """tokens: (B, S) int; optional ``frontend_embeds`` (B, Sf, d), a stub
    frontend's patch or frame embeddings, go before the token embeddings.
    Returns (final-normed hidden (B, Sf + S, d), the MoE aux loss summed
    over the layers (0.0 without MoE layers), caches); the caches are
    updated in place. An M-RoPE model's three position streams are the
    positions broadcast three times, as in the reference. ``remat``: see
    :func:`_run_groups`."""
    x = layers.embed(params["tok"], tokens, vocab=cfg.padded_vocab)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        start = cache_len if cache_len is not None else 0
        if torch.is_tensor(start) and start.ndim == 1:
            start = start[:, None]      # per-slot frontiers (B,)
        positions = start + torch.arange(s, dtype=torch.int32,
                                         device=x.device)[None, :]
        positions = torch.broadcast_to(positions, (b, s))
    positions3 = None
    if cfg.mrope:
        positions3 = torch.broadcast_to(positions[None], (3, b, s))
    x, aux = _run_groups(cfg, params, x, positions=positions,
                         positions3=positions3, caches=caches,
                         cache_len=cache_len, plans=plans,
                         block_tables=block_tables, remat=remat)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux, caches


def lm_loss(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor, *, frontend_embeds=None,
            remat: bool = True, loss_chunk: int = 2048,
            plans: Optional[KernelPlans] = None):
    """Causal LM loss of a full-sequence forward. labels: (B, S) int, -1 =
    ignore. As in the reference, the vocab projection and the softmax run
    in sequence chunks (the largest power-of-two share of ``loss_chunk``
    that divides S), with the padded vocab masked, so the (tokens x vocab)
    logits never materialize whole. Returns (total, {loss, aux, tokens}),
    ``total = loss + router_aux_weight * aux``. Frontend positions carry
    no label. ``remat`` recomputes each layer and each loss chunk in the
    backward."""
    x, aux, _ = forward(cfg, params, tokens, frontend_embeds=frontend_embeds,
                        plans=plans, remat=remat)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    if frontend_embeds is not None:
        pad = labels.new_full(frontend_embeds.shape[:2], -1)
        labels = torch.cat([pad, labels], dim=1)
    return chunked_xent(cfg, params, x, labels, aux, loss_chunk, remat=remat)


def _chunk_nll(cfg: ModelConfig, tok: Params, xi: torch.Tensor,
               li: torch.Tensor):
    """One loss chunk: (summed NLL over labelled positions, their count)."""
    neg = torch.finfo(torch.float32).min
    col = torch.arange(cfg.padded_vocab, device=xi.device)
    logits = layers.unembed_logits(tok, xi)
    logits = torch.where(col < cfg.vocab_size, logits.float(), neg)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li.clamp(min=0).long()[..., None])[..., 0]
    valid = (li >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def chunked_xent(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 labels: torch.Tensor, aux, loss_chunk: int = 2048, *,
                 remat: bool = False):
    """The chunked LM cross-entropy of final hidden states ``x`` against
    ``labels`` (-1 = ignore), shared by the decoder-only and the enc-dec
    losses. Returns (loss + router_aux_weight * aux, {loss, aux,
    tokens}). ``remat`` recomputes each chunk's logits in the backward."""
    b, s, _ = x.shape
    chunk = min(loss_chunk, s)
    while s % chunk:
        chunk //= 2
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        nll, n = remat_call(remat, _chunk_nll, cfg, params["tok"],
                            x[:, i:i + chunk], labels[:, i:i + chunk])
        tot = tot + nll
        cnt = cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + cfg.router_aux_weight * aux, {"loss": loss, "aux": aux,
                                                 "tokens": cnt}


# -------------------------------------------------------------- caches

def _stack(one: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    return {k: as_bits(a).unsqueeze(0).repeat((n,) + (1,) * a.ndim)
            .view(a.dtype) for k, a in one.items()}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Per-layer dense decode caches ``{group: {posN: {leaf: tensor}}}``,
    stacked on the repeats: GQA layers ``{k, v}`` of ``(n_repeat, B, Hkv,
    max_len, D)``, MLA layers ``{ckv, krope}`` of ``(n_repeat, B, max_len,
    width)``, mamba layers ``{conv, ssm}`` with one f32 row per
    sequence."""
    def one(kind):
        if kind.attn == "mamba":
            return ssm.init_mamba_cache(cfg, batch, device)
        init = (attn_mod.init_mla_cache if kind.attn == "mla"
                else attn_mod.init_gqa_cache)
        return init(cfg, batch, max_len, device, dtype)

    return {group.name: {f"pos{pos}": _stack(one(kind), group.n_repeat)
                         for pos, kind in enumerate(group.pattern)}
            for group in cfg.layer_groups()}


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_tokens: int, device, dtype=torch.bfloat16,
                      quant_scales: bool = False) -> Dict[str, Any]:
    """Paged pool caches: every attention layer owns a flat page pool
    (page 0 = null): GQA ``(n_repeat, n_pages, Hkv, page_tokens, D)``, MLA
    latent pages ``(n_repeat, n_pages, page_tokens, width)``; recurrent
    SSM state stays a resident row per slot (``batch`` rows; in the spill
    tier, one seat per spill page), exactly as in :func:`init_caches`.
    ``dtype`` / ``quant_scales`` come from the tier's codec: an int8 tier
    adds a ``<leaf>_scale`` leaf ``(n_repeat, n_pages)``, f32, beside each
    page leaf. Recurrent state never quantizes (quantized geometries refuse
    recurrent families upstream)."""
    def one(kind):
        if kind.attn == "mamba":
            return ssm.init_mamba_cache(cfg, batch, device)
        init = (attn_mod.init_mla_pages if kind.attn == "mla"
                else attn_mod.init_gqa_pages)
        return init(cfg, n_pages, page_tokens, device, dtype, quant_scales)

    return {group.name: {f"pos{pos}": _stack(one(kind), group.n_repeat)
                         for pos, kind in enumerate(group.pattern)}
            for group in cfg.layer_groups()}


def cache_attn_kinds(cfg: ModelConfig):
    """Yield ``(group_name, pos_key, attention kind)`` for every cache
    entry — the walk order spill/restore, page scatter and the row moves
    share. The kind (``gqa`` / ``mla`` / ``mamba``) picks how a row is cut
    into pages."""
    for group in cfg.layer_groups():
        for pos, kind in enumerate(group.pattern):
            yield group.name, f"pos{pos}", kind.attn


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int, *, frontend_embeds=None,
            plans: Optional[KernelPlans] = None,
            caches=None, prefix_len: int = 0):
    """Run the prompt into ``max_len``-deep caches. Attention runs over the
    whole cache depth at ``q_offset = prefix_len``, as in the reference.
    Returns (hidden, caches).

    ``caches``/``prefix_len`` run a *resumed* prefill (prefix-share
    suffixes, chunked-prefill chunks): ``caches`` already holds the K/V of
    the first ``prefix_len`` positions, ``tokens`` is the tail only, RoPE
    positions start at ``prefix_len`` and the tail's K/V land at
    ``[prefix_len, prefix_len + S)``, in place. ``prefix_len`` is a host
    int: the reference traces its chunk cursor only to bound XLA compiles,
    so here every tail reaches the flash kernel at a static offset.
    """
    if caches is None:
        caches = init_caches(cfg, tokens.shape[0], max_len, tokens.device)
    x, _, caches = forward(cfg, params, tokens,
                           frontend_embeds=frontend_embeds, caches=caches,
                           cache_len=int(prefix_len), plans=plans)
    return x, caches


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                caches, cache_len: torch.Tensor,
                plans: Optional[KernelPlans] = None,
                block_tables: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1); cache_len: 0-d or per-slot (B,).
    With ``block_tables`` (B, P) the caches are the paged pool. Returns
    (logits f32 (B, 1, Vpad), caches); under a serving mesh the logits are
    the rank's vocabulary columns."""
    x, _, caches = forward(cfg, params, tokens, caches=caches,
                           cache_len=cache_len, plans=plans,
                           block_tables=block_tables)
    return layers.unembed_logits(params["tok"], x), caches


def verify_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                caches, cache_len: torch.Tensor,
                plans: Optional[KernelPlans] = None,
                block_tables: Optional[torch.Tensor] = None):
    """Multi-position decode for speculative verify: ``tokens`` is ``(B,
    k+1)`` (each slot's last token, then its k drafts) and ``cache_len``
    the per-slot ``(B,)`` frontier. Column ``j`` runs at RoPE position
    ``cache_len + j`` with a causal-within-chunk mask over the (dense or
    paged) cache and appends its K/V at ``cache_len + j``, so logits column
    ``j`` scores the token after ``tokens[:, :j+1]`` as ``j`` successive
    :func:`decode_step` calls would. This is :func:`decode_step` at S =
    k+1; the name carries the verify contract, as in the reference."""
    return decode_step(cfg, params, tokens, caches, cache_len, plans=plans,
                       block_tables=block_tables)
